"""The port's spinning-lidar DA frames (seevcn_torch.data.synth_da) against
the JAX package's (seevcn_tpu.data.synth_da), bit for bit: the ray grid,
single frames (with and without each car's points) and stacked DA sets
drawn from the same RandomState seeds. Both are numpy on the host over
the same raycaster, so nothing may differ."""
import numpy as np
import pytest

from seevcn_torch.data import synth_da as T
from seevcn_tpu.data import synth_da as J


def _equal_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_tree(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_beams,res,jitter", [(16, 0.5, None), (64, 0.25, 3)])
def test_ray_dirs_match_jax(n_beams, res, jitter):
    rng = (lambda: np.random.RandomState(jitter)) if jitter is not None else (lambda: None)
    _equal_tree(T.lidar_ray_dirs(n_beams, azim_res_deg=res, jitter_rng=rng()),
                J.lidar_ray_dirs(n_beams, azim_res_deg=res, jitter_rng=rng()))


@pytest.mark.parametrize("seed,n_beams,n_cars", [(0, 64, 2), (1, 16, None), (4, 32, 3)])
def test_frames_match_jax(seed, n_beams, n_cars):
    kw = dict(n_beams=n_beams, azim_res_deg=0.5, n_cars=n_cars, max_pts=6000,
              return_car_pts=True)
    got = T.spinning_lidar_frame(np.random.RandomState(seed), **kw)
    ref = J.spinning_lidar_frame(np.random.RandomState(seed), **kw)
    _equal_tree(got, ref)
    assert got["n_pts"] > 500 and len(got["cars"]) == len(got["gt_boxes"]) >= 1


def test_da_sets_match_jax():
    """A 16-beam and a 64-beam set: points, validity, boxes (class 1 in
    column 7) and masks."""
    for beams in (16, 64):
        got = T.generate_da_set(5, 2, beams, azim_res_deg=0.6, max_pts=4000)
        _equal_tree(got, J.generate_da_set(5, 2, beams, azim_res_deg=0.6, max_pts=4000))
        assert got[0].shape == (2, 4000, 3) and (got[2][got[3]][:, 7] == 1.0).all()
