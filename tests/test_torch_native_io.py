"""The port's native IO (seevcn_torch.utils.native_io) against the JAX
package's, both routes: the library the port builds from
native/seevcn_io.cpp against the one JAX builds, and the numpy route (the
plain version, forced in both packages by setting the module's library to
False). Every read is held bit for bit. The native prefetcher leaves an
ascii .pcd unread (its count -2), in both packages.
"""
import numpy as np
import pytest

from seevcn_tpu.utils import native_io as JN
from seevcn_torch.geom.pcd_io import write_pcd
from seevcn_torch.utils import native_io as TN


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    if request.param == "native":
        assert TN.native_available(), "the port's native IO library did not build"
        assert TN.library_path().parent == TN.BUILD_DIR
    else:
        monkeypatch.setattr(TN, "_lib", False)
        monkeypatch.setattr(JN, "_lib", False)
        assert not TN.native_available()
    return request.param


@pytest.fixture
def files(tmp_path):
    rng = np.random.RandomState(0)
    bins = []
    for i in range(5):
        pts = rng.randn(rng.randint(50, 700), 4).astype(np.float32)
        pts.tofile(tmp_path / f"{i}.bin")
        bins.append((str(tmp_path / f"{i}.bin"), pts))
    xyz = rng.randn(333, 3).astype(np.float32)
    write_pcd(str(tmp_path / "b.pcd"), xyz)
    write_pcd(str(tmp_path / "a.pcd"), xyz, binary=False)
    return tmp_path, bins, xyz


def test_read_bin_matches_jax(route, files):
    _, bins, _ = files
    for path, pts in bins:
        for max_rows in (10_000, 40):
            got = TN.read_bin(path, max_rows=max_rows)
            np.testing.assert_array_equal(got, pts[:max_rows])
            np.testing.assert_array_equal(got, JN.read_bin(path, max_rows=max_rows))
        np.testing.assert_array_equal(TN.read_bin(path, row_floats=2),
                                      pts.reshape(-1, 2))


@pytest.mark.parametrize("name", ["b.pcd", "a.pcd"], ids=["binary", "ascii"])
def test_read_pcd_matches_jax(route, files, name):
    root, _, xyz = files
    path = str(root / name)
    for max_rows in (1000, 17):
        got = TN.read_pcd(path, max_rows=max_rows)
        ref = JN.read_pcd(path, max_rows=max_rows)
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (min(max_rows, 333), 3)
    if name == "b.pcd":
        np.testing.assert_array_equal(TN.read_pcd(path), xyz)


def test_prefetcher_matches_jax(route, files):
    root, bins, xyz = files
    pcds = [(str(root / "b.pcd"), "pcd"), (str(root / "a.pcd"), "pcd")]
    cases = [([(p, "bin") for p, _ in bins], 500)]
    if JN.native_available() == TN.native_available():   # the same route in both
        cases.append((pcds, 200))
    for entries, rows in cases:
        got = TN.Prefetcher(3).load(entries, max_rows=rows)
        ref = JN.Prefetcher(3).load(entries, max_rows=rows)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    bufs, counts = TN.Prefetcher(2).load([(p, "bin") for p, _ in bins], max_rows=500)
    for i, (_, pts) in enumerate(bins):
        assert counts[i] == min(len(pts), 500)
        np.testing.assert_array_equal(bufs[i, :counts[i]], pts[:500])
        assert not bufs[i, counts[i]:].any()
    bufs, counts = TN.Prefetcher(2).load(pcds, max_rows=200)
    np.testing.assert_array_equal(bufs[0], xyz[:200])
    assert counts.tolist() == ([200, -2] if route == "native" else [200, 200])


def test_missing_file_raises(route, tmp_path):
    with pytest.raises(FileNotFoundError):
        TN.read_bin(str(tmp_path / "nope.bin"))
    with pytest.raises(FileNotFoundError):
        TN.read_pcd(str(tmp_path / "nope.pcd"))
