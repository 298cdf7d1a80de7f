"""The min-distance kernels of the port against the JAX Pallas kernels in
interpret mode and against their XLA reference. The pruned form (K1) is
held to its contract: the within-radius set is equal, values are exact
(atol 1e-4) where the truth is <= r^2, and no value is below the truth. The
unpruned difference form (K2) is held to the Pallas kernel at f32 rounding,
the Gram form (K3) at the reference's own tolerance for it (atol 2e-3,
rtol 1e-3).

The tests marked ``cuda`` import no JAX, so they also run on a machine with
a card and no JAX: ``python -m pytest tests/test_torch_min_dist.py -m cuda
--noconftest``."""
import numpy as np
import pytest
import torch

from seevcn_torch.ops.cuda.min_dist import (min_sqdist, min_sqdist_gram_plain,
                                          min_sqdist_plain)
from seevcn_torch.testing import to_numpy, to_torch


def _wide_vs_clustered(seed, n, k_centres, per, r):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    centres = rng.uniform(-40, 40, (k_centres, 3)).astype(np.float32)
    b = (centres[:, None, :] + rng.uniform(-2, 2, (k_centres, per, 3))
         ).reshape(-1, 3).astype(np.float32)
    # queries scattered on the supports, so the within-radius set is not empty
    a[: n // 4] = b[rng.randint(0, len(b), n // 4)] + rng.uniform(
        -r, r, (n // 4, 3)).astype(np.float32)
    return a, b, None


def _case(name):
    rng = np.random.RandomState(10 + CASES.index(name))
    if name == "wide_vs_clustered":        # test_pallas_min_dist.py:56-74
        return (*_wide_vs_clustered(3, 2500, 4, 300, 0.8), 0.8)
    if name == "randn_scaled":             # test_pallas_min_dist.py:8-14
        return (rng.randn(700, 3).astype(np.float32) * 5,
                rng.randn(1300, 3).astype(np.float32) * 5, None, 1.0)
    if name == "invalid_rows":             # test_pallas_min_dist.py:77-84
        a = np.array([[10.0, 0, 0], [-30.0, 2, 1]], np.float32)
        b = np.array([[10.1, 0, 0], [15.0, 0, 0]], np.float32)
        return a, b, np.array([True, False]), 0.5
    if name == "tiny_ragged":              # N, M far from tile multiples
        return (rng.randn(3, 3).astype(np.float32),
                rng.randn(5, 3).astype(np.float32), None, 1.0)
    if name == "ragged_past_tiles":
        a, b, _ = _wide_vs_clustered(5, 1029, 3, 347, 0.3)
        valid = rng.rand(len(b)) > 0.2
        return a, b, valid, 0.3
    if name == "all_invalid":
        a, b, _ = _wide_vs_clustered(6, 300, 2, 100, 0.5)
        return a, b, np.zeros(len(b), bool), 0.5
    if name == "single_query":
        a, b, _ = _wide_vs_clustered(7, 4, 2, 600, 0.5)
        return a[:1], b, None, 0.5
    raise KeyError(name)


CASES = ["wide_vs_clustered", "randn_scaled", "invalid_rows", "tiny_ragged",
         "ragged_past_tiles", "all_invalid", "single_query"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _truth64(a, b, valid):
    d = ((a[:, None, :].astype(np.float64) - b[None].astype(np.float64)) ** 2
         ).sum(-1)
    if valid is not None:
        d = np.where(valid[None], d, np.inf)
    return d.min(1) if d.shape[1] else np.full(len(a), np.inf)


def assert_contract(got, truth, r):
    r2 = np.float32(r * r)
    got_in, ref_in = got <= r2, truth <= r2
    np.testing.assert_array_equal(got_in, ref_in)
    np.testing.assert_allclose(got[ref_in], truth[ref_in], atol=1e-4)
    finite = np.isfinite(truth)
    assert (got[finite] >= truth[finite] * (1 - 1e-5) - 1e-4).all()
    assert (got[~finite] >= 1e17).all()


@pytest.mark.parametrize("name", CASES)
def test_plain_and_dispatch_match_jax_on_contract(name):
    import jax.numpy as jnp

    from seevcn_tpu.ops.pallas.min_dist import min_sqdist as jax_min_sqdist
    from seevcn_tpu.ops.pallas.min_dist import min_sqdist_reference

    a, b, valid, r = _case(name)
    # precondition: no true distance within 1e-5 r^2 of the threshold, where
    # the Gram and difference forms could round to different sides
    t64 = _truth64(a, b, valid)
    assert not (np.abs(t64 - r * r) <= 1e-5 * r * r).any()

    jv = None if valid is None else jnp.asarray(valid)
    jax_pruned = np.asarray(jax_min_sqdist(jnp.asarray(a), jnp.asarray(b),
                                           b_valid=jv, interpret=True,
                                           prune_radius=r))
    truth = np.asarray(min_sqdist_reference(jnp.asarray(a), jnp.asarray(b), jv))

    tv = None if valid is None else to_torch(valid)
    plain = to_numpy(min_sqdist_plain(to_torch(a), to_torch(b), tv))
    disp = to_numpy(min_sqdist(to_torch(a), to_torch(b), tv, prune_radius=r))

    np.testing.assert_array_equal(disp, plain)       # CPU dispatch = plain
    np.testing.assert_allclose(plain, truth, atol=1e-4, rtol=1e-5)
    assert_contract(plain, truth, r)
    assert_contract(jax_pruned, truth, r)            # the reference kernel too
    r2 = np.float32(r * r)
    np.testing.assert_array_equal(plain <= r2, jax_pruned <= r2)
    inside = truth <= r2
    np.testing.assert_allclose(plain[inside], jax_pruned[inside], atol=1e-4)


def test_unported_forms_raise():
    # every form of the reference is ported; an unknown one still raises
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="form"):
        min_sqdist(a, a, form="cosine")
    with pytest.raises(ValueError, match="form"):
        min_sqdist(a, a, form="cosine", prune_radius=0.1)
    assert min_sqdist(a, a).shape == (4,)
    assert min_sqdist(a, a, form="gram", prune_radius=0.1).shape == (4,)


def test_plain_is_chunk_invariant():
    a, b, _, r = _case("ragged_past_tiles")
    full = min_sqdist_plain(to_torch(a), to_torch(b))
    chunked = min_sqdist_plain(to_torch(a), to_torch(b), chunk=100)
    torch.testing.assert_close(chunked, full, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name, cuda_device):
    a, b, valid, r = _case(name)
    tv = None if valid is None else to_torch(valid, cuda_device)
    got = min_sqdist(to_torch(a, cuda_device), to_torch(b, cuda_device), tv,
                     prune_radius=r)
    torch.cuda.synchronize()
    plain = min_sqdist_plain(to_torch(a, cuda_device),
                             to_torch(b, cuda_device), tv)
    assert_contract(to_numpy(got), to_numpy(plain), r)


# --- K2 (form="diff", no radius) and K3 (form="gram") ----------------------

def _dense_case(name):
    if name == "lidar_range":              # test_pallas_min_dist.py:35-44
        rng = np.random.RandomState(2)
        a = rng.randn(500, 3).astype(np.float32) * 3 + [45.0, -20.0, 0.0]
        b = rng.randn(900, 3).astype(np.float32) * 3 + [44.0, -19.0, 0.0]
        return a.astype(np.float32), b.astype(np.float32), None
    if name == "gram_invalid_rows":        # test_pallas_min_dist.py:47-53
        return (np.array([[10.0, 0, 0]], np.float32),
                np.array([[10.1, 0, 0], [15.0, 0, 0]], np.float32),
                np.array([False, True]))
    if name == "past_two_tiles":           # N, M past tile multiples, invalid rows
        rng = np.random.RandomState(4)
        a = rng.uniform(-30, 30, (2051, 3)).astype(np.float32)
        b = rng.uniform(-30, 30, (2305, 3)).astype(np.float32)
        return a, b, rng.rand(2305) > 0.3
    a, b, valid, _ = _case(name)
    return a, b, valid


DENSE_CASES = CASES + ["lidar_range", "gram_invalid_rows", "past_two_tiles"]
# K3 against the exact difference form: the reference's own tolerance for
# its Gram kernel (test_pallas_min_dist.py:44)
GRAM_ATOL, GRAM_RTOL = 2e-3, 1e-3


@pytest.mark.parametrize("form", ["diff", "gram"])
@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_forms_match_jax(name, form):
    import jax.numpy as jnp

    from seevcn_tpu.ops.pallas.min_dist import min_sqdist as jax_min_sqdist
    from seevcn_tpu.ops.pallas.min_dist import min_sqdist_reference

    a, b, valid = _dense_case(name)
    jv = None if valid is None else jnp.asarray(valid)
    jax_k = np.asarray(jax_min_sqdist(jnp.asarray(a), jnp.asarray(b),
                                      b_valid=jv, interpret=True, form=form))
    truth = np.asarray(min_sqdist_reference(jnp.asarray(a), jnp.asarray(b), jv))
    tv = None if valid is None else to_torch(valid)
    got = to_numpy(min_sqdist(to_torch(a), to_torch(b), tv, form=form))
    assert got.shape == (len(a),) and got.dtype == np.float32

    finite = np.isfinite(truth)
    if form == "diff":
        # the same f32 difference form as the Pallas kernel: only the
        # compiler's rounding of the sums can differ
        np.testing.assert_allclose(got, jax_k, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got[finite], truth[finite], rtol=1e-6,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got, jax_k, rtol=GRAM_RTOL, atol=GRAM_ATOL)
        np.testing.assert_allclose(got[finite], truth[finite],
                                   rtol=GRAM_RTOL, atol=GRAM_ATOL)
    # a support with no valid row: both routes give what the reference
    # kernel gives (every support row at 1e9, about 3e18), not the
    # reference's inf
    assert (np.isfinite(got[~finite]) & (got[~finite] > 1e18)).all()
    np.testing.assert_allclose(got[~finite], jax_k[~finite], rtol=1e-6)


def test_dense_forms_cpu_route_is_plain():
    a, b, valid = _dense_case("past_two_tiles")
    ta, tb, tv = to_torch(a), to_torch(b), to_torch(valid)
    far = torch.where(tv[:, None], tb, 1e9)
    torch.testing.assert_close(min_sqdist(ta, tb, tv), min_sqdist_plain(ta, far),
                               rtol=0, atol=0)
    torch.testing.assert_close(min_sqdist(ta, tb, tv, form="gram"),
                               min_sqdist_gram_plain(ta, tb, tv), rtol=0, atol=0)
    torch.testing.assert_close(min_sqdist_gram_plain(ta, tb, tv, chunk=97),
                               min_sqdist_gram_plain(ta, tb, tv), rtol=0, atol=0)
    # an empty support reads as the reference's tile padding: about 3e18
    empty = torch.zeros((0, 3))
    for form in ("diff", "gram"):
        d = min_sqdist(ta[:5], empty, form=form)
        assert torch.isfinite(d).all() and (d > 1e18).all()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["diff", "gram"])
@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_kernel_matches_plain_on_card(name, form, cuda_device):
    """K2 and K3 against their plain versions on the same card, bit for bit,
    and K3 against the exact difference form at the reference's tolerance."""
    from seevcn_torch.ops.cuda.min_dist import gram_inputs, push_invalid

    a, b, valid = _dense_case(name)
    ta, tb = to_torch(a, cuda_device), to_torch(b, cuda_device)
    tv = None if valid is None else to_torch(valid, cuda_device)
    got = min_sqdist(ta, tb, tv, form=form)
    torch.cuda.synchronize()
    if form == "diff":
        plain = min_sqdist_plain(ta, push_invalid(tb, tv))
    else:
        plain = min_sqdist_gram_plain(ta, tb, tv)
        ga, gb = gram_inputs(ta, tb, tv)
        exact = min_sqdist_plain(ga, gb)
        ok = torch.isfinite(min_sqdist_plain(ta, tb, tv))
        torch.testing.assert_close(got[ok], exact[ok],
                                   rtol=GRAM_RTOL, atol=GRAM_ATOL)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
