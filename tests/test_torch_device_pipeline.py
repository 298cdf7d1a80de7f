"""seevcn_torch.see.device_pipeline against seevcn_tpu.see.device_pipeline
on the CPU. Canvases, masks and validity must be exactly equal, coordinates
within 1e-5 m. Inputs keep clear of the thresholds where the two
frameworks' f32 arithmetic could round to different sides: pixel edges,
DBSCAN's eps and the replacement radius."""
import jax.numpy as jnp
import numpy as np
import pytest

from seevcn_tpu.see import device_pipeline as JDP
from seevcn_torch.see import device_pipeline as TDP
from seevcn_torch.testing import assert_close, to_torch

H, W = 96, 128
PROJ = np.array([[60.0, 0, 64.0, 0], [0, 60.0, 48.0, 0], [0, 0, 1.0, 0]],
                np.float32)


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [to_torch(x) for x in xs]


def _detections(rng, d):
    x1 = rng.uniform(-10, W - 30, d)
    y1 = rng.uniform(-10, H - 25, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(15, 60, d),
                      y1 + rng.uniform(12, 50, d)], 1).astype(np.float32)
    masks = rng.rand(d, 28, 28).astype(np.float32)
    masks[:, 4:24, 4:24] = 0.5 + 0.5 * masks[:, 4:24, 4:24]  # solid cores
    scores = rng.uniform(0.2, 1.0, d).astype(np.float32)
    return boxes, masks, scores


def _points_off_pixel_edges(rng, n, depth=(2.0, 30.0)):
    """Camera-frame points whose projections sit 0.1-0.9 px inside a pixel,
    so floor(u), floor(v) cannot differ by a rounding of u, v."""
    u = rng.randint(-5, W + 5, n) + rng.uniform(0.1, 0.9, n)
    v = rng.randint(-5, H + 5, n) + rng.uniform(0.1, 0.9, n)
    z = rng.uniform(*depth, n)
    z[: n // 20] *= -1                                    # some behind
    x = (u - PROJ[0, 2]) * z / PROJ[0, 0]
    y = (v - PROJ[1, 2]) * z / PROJ[1, 1]
    return np.stack([x, y, z], 1).astype(np.float32)


def test_project_points():
    rng = np.random.RandomState(0)
    pts = _points_off_pixel_edges(rng, 500)
    got = TDP.project_points(*_t(pts, PROJ))
    ref = JDP.project_points(*_j(pts, PROJ))
    for g, r in zip(got, ref):
        assert_close(g, r, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("d,shrink", [(32, 0.0), (32, 3.0), (5, 20.0)])
def test_rasterize_masks_bit_equal(d, shrink):
    rng = np.random.RandomState(d)
    boxes, masks, scores = _detections(rng, d)
    if d == 32:                   # every instance covers the image centre
        boxes[:, :2] = np.minimum(boxes[:, :2], [50.0, 35.0])
        boxes[:, 2:] = np.maximum(boxes[:, 2:], [80.0, 60.0])
    args = dict(score_thresh=0.3, mask_thresh=0.5, shrink_pct=shrink)
    got = TDP.rasterize_masks(*_t(boxes, masks, scores), (H, W), **args)
    ref = JDP.rasterize_masks(*_j(boxes, masks, scores), (H, W), **args)
    assert got.dtype == np.int32 or str(got.dtype) == "torch.int32"
    assert_close(got, np.asarray(ref))
    if d == 32:
        assert (np.asarray(ref) < 0).any()               # bit 31 is set


@pytest.mark.parametrize("image_size", [(H, W), None])
def test_mask_membership(image_size):
    rng = np.random.RandomState(1)
    pts = _points_off_pixel_edges(rng, 3000)
    valid = rng.rand(3000) > 0.05
    boxes, masks, scores = _detections(rng, 6)
    kw = dict(score_thresh=0.3, mask_thresh=0.5, image_size=image_size,
              shrink_pct=3.0, core_shrink_pct=20.0)
    got = TDP.mask_membership(*_t(pts, valid, PROJ, boxes, masks, scores), **kw)
    ref = JDP.mask_membership(*_j(pts, valid, PROJ, boxes, masks, scores), **kw)
    assert_close(got[0], ref[0], name="member")
    assert_close(got[1], ref[1], name="core")
    assert 0 < int(got[0].sum())
    plain = TDP.mask_membership(*_t(pts, valid, PROJ, boxes, masks, scores),
                                score_thresh=0.3, image_size=image_size)
    assert_close(plain, JDP.mask_membership(
        *_j(pts, valid, PROJ, boxes, masks, scores), score_thresh=0.3,
        image_size=image_size))


def _lattice(rng, centre, w, h, s=0.18):
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    p = np.stack([gx.ravel() * s, np.zeros(gx.size), gy.ravel() * s], 1)
    return p + centre + rng.uniform(-0.003, 0.003, p.shape)


def _isolation_scene():
    """6000 points: two lattice objects and strays first in scan order, then
    sparse background. Instance 0's mask covers nearly all of the first 4500
    points, so the 4096-point candidate cap truncates, and instance 1 lies
    past it; instance 2 covers the second object plus strays."""
    rng = np.random.RandomState(2)
    obj_a = _lattice(rng, [7.0, 1.0, -0.5], 8, 6)           # 48 points
    obj_b = _lattice(rng, [6.0, -3.0, -0.2], 6, 5)          # 30 points
    strays = rng.uniform(-6, 6, (60, 3)) + [9.0, 0.0, 0.0]
    head = np.concatenate([obj_a, obj_b, strays])
    order = rng.permutation(len(head))
    head, kind = head[order], np.repeat([0, 1, 2], [48, 30, 60])[order]
    bg = rng.uniform(-40, 40, (6000 - len(head), 3))
    pts = np.concatenate([head, bg]).astype(np.float32)
    d = np.sqrt(((pts[:len(head), None].astype(np.float64)
                  - pts[None, :len(head)]) ** 2).sum(-1))
    assert not (np.abs(d - 0.3) < 1e-3).any()    # eps clips to 0.3 here
    member = np.zeros((3, 6000), bool)
    member[0, :4500] = rng.rand(4500) < 0.97
    member[1, 4400:4700] = True
    member[2, :len(head)] = (kind == 1) | ((kind == 2)
                                           & (rng.rand(len(head)) < 0.5))
    core = np.zeros_like(member)
    core[0, :len(head)] = kind == 0
    core[2, :len(head)] = kind == 1
    return pts, member, core


@pytest.mark.parametrize("use_core", [False, True])
def test_isolate_and_resample(use_core):
    pts, member, core = _isolation_scene()
    kw = dict(max_instance_pts=64, out_pts=32)
    got_out, got_ok = TDP.isolate_and_resample(
        *_t(pts, member), core_membership=to_torch(core) if use_core else None,
        **kw)
    ref_out, ref_ok = JDP.isolate_and_resample(
        *_j(pts, member), core_membership=jnp.asarray(core) if use_core
        else None, **kw)
    assert_close(got_ok, ref_ok, name="ok")
    assert_close(got_out, ref_out, atol=1e-5, name="isolated")
    assert np.asarray(ref_ok).tolist() == [True, False, True]


def test_nonzero_padded_truncates_in_scan_order():
    mask = np.random.RandomState(3).rand(1000) > 0.5
    for size in (10, int(mask.sum()), 900):
        (ref,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=-1)
        assert_close(TDP.nonzero_padded(to_torch(mask), size),
                     np.asarray(ref).astype(np.int64))


def test_completion_sanity_mask():
    rng = np.random.RandomState(1)
    obs = np.zeros((4, 64, 3), np.float32)
    obs[0] = rng.randn(64, 3) * 0.3 + [10, 0, 0]
    obs[1] = rng.randn(64, 3) * 0.3 + [20, 5, 0]
    obs[3, :20] = rng.randn(20, 3) * 0.3 + [15, -2, 0]    # partly padded
    comp = np.zeros((4, 128, 3), np.float32)
    comp[0] = rng.randn(128, 3) * 0.5 + [10, 0, 0]
    comp[1] = rng.randn(128, 3) * 0.5 + [49, 5, 0]
    comp[2] = rng.randn(128, 3) * 0.5 + [10, 0, 0]
    comp[3] = rng.randn(128, 3) * 0.5 + [15, -2, 0]
    for iv in (np.ones(4, bool), np.array([False, True, True, True])):
        got = TDP.completion_sanity_mask(*_t(obs, comp, iv), max_dist=2.0)
        ref = JDP.completion_sanity_mask(*_j(obs, comp, iv), max_dist=2.0)
        assert_close(got, ref)
    assert np.asarray(ref).tolist() == [False, False, False, True]


def assert_no_radius_ties(points, valid, flat, flat_valid, r, margin=1e-3):
    """No valid point's squared distance to the valid completed cloud lies
    within ``margin`` of r^2: the reference's CPU path is the uncentred Gram
    form, whose f32 error at tens of metres reaches a few 1e-4 in d^2."""
    d = ((points[:, None].astype(np.float64) - flat[flat_valid][None]) ** 2
         ).sum(-1).min(1) if flat_valid.any() else np.full(len(points), np.inf)
    assert not (valid & (np.abs(d - r * r) < margin)).any()


def _replace_scene(seed):
    # test_device_pipeline.py:129-145, plus points hugging the surfaces
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-20, 20, (4096, 3)).astype(np.float32)
    valid = rng.rand(4096) > 0.1
    centres = rng.uniform(-15, 15, (4, 3)).astype(np.float32)
    completed = (centres[:, None, :] +
                 rng.uniform(-1.5, 1.5, (4, 64, 3))).astype(np.float32)
    near = completed.reshape(-1, 3)[rng.randint(0, 256, 400)]
    # offsets of 3-8 cm (dropped) or 12.5-20 cm (kept unless nearer another)
    u = rng.randn(400, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    length = np.where(rng.rand(400) < 0.5, rng.uniform(0.03, 0.08, 400),
                      rng.uniform(0.125, 0.2, 400))
    pts[:400] = near + u * length[:, None]
    pts = pts[rng.permutation(4096)]
    iv = np.array([True, True, False, True])
    return pts, valid, completed, iv


@pytest.mark.parametrize("cand_cap", [4096, 512, 128])
def test_replace_with_completed(cand_cap):
    """cand_cap=4096 takes the full sweep; 512 and 128 the compacted branch
    (P > 4 * cand_cap), 128 with candidates past the cap kept."""
    pts, valid, completed, iv = _replace_scene(7)
    assert_no_radius_ties(pts, valid, completed.reshape(-1, 3),
                          np.repeat(iv, 64), 0.1)
    got = TDP.replace_with_completed(*_t(pts, valid, completed, iv),
                                     point_dist_thresh=0.1, cand_cap=cand_cap)
    ref = JDP.replace_with_completed(*_j(pts, valid, completed, iv),
                                     point_dist_thresh=0.1, cand_cap=cand_cap)
    assert_close(got[0], ref[0], atol=1e-5, name="new_pts")
    assert_close(got[1], ref[1], name="new_valid")
    dropped = valid.sum() - int(got[1][:4096].sum())
    assert dropped > 0
    if cand_cap == 128:           # overflow keeps points the full sweep drops
        full = JDP.replace_with_completed(*_j(pts, valid, completed, iv),
                                          cand_cap=4096)[1]
        assert int(np.asarray(full)[:4096].sum()) < int(got[1][:4096].sum())
