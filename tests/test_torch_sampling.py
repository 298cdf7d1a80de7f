"""seevcn_torch.ops.sampling / geom.transforms / ops.chamfer against the JAX
package on the CPU. Index-selecting ops (tile_to_n, knn_union_mask,
partial_mesh_batch, within_radius_mask) must agree exactly; float results
within 1e-4 (f32 products summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seevcn_tpu.geom import transforms as JT
from seevcn_tpu.ops import chamfer as JC
from seevcn_tpu.ops import sampling as JS
from seevcn_torch.geom import transforms as TT
from seevcn_torch.ops import chamfer as TC
from seevcn_torch.ops import sampling as TS
from seevcn_torch.testing import assert_close, to_numpy, to_torch


def test_pairwise_sqdist():
    rng = np.random.RandomState(0)
    a = rng.randn(2, 40, 3).astype(np.float32) * 5
    b = rng.randn(2, 70, 3).astype(np.float32) * 5
    assert_close(TS.pairwise_sqdist(to_torch(a), to_torch(b)),
                 JS.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)),
                 atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("valid_frac", [0.0, 0.3, 1.0])
def test_tile_to_n(valid_frac):
    rng = np.random.RandomState(1)
    pts = rng.randn(3, 50, 4).astype(np.float32)
    valid = rng.rand(3, 50) < valid_frac
    valid[1] = False                          # an all-invalid row
    out, ok = TS.tile_to_n(to_torch(pts), to_torch(valid), 128)
    for i in range(3):
        jo, jok = JS.tile_to_n(jnp.asarray(pts[i]), jnp.asarray(valid[i]), 128)
        assert_close(out[i], jo, name=f"out[{i}]")
        assert bool(ok[i]) == bool(jok)


def _untied_knn_inputs(seed, n, m, k):
    rng = np.random.RandomState(seed)
    p = rng.randn(n, 3).astype(np.float32) * 2
    c = rng.randn(m, 3).astype(np.float32) * 2
    d = np.sort(((p[:, None].astype(np.float64) - c[None]) ** 2).sum(-1), 1)
    # the k-th and (k+1)-th neighbours are far apart: no tie at the cut
    assert (d[:, k] - d[:, k - 1] > 1e-4).all()
    return p, c


def test_knn_union_mask():
    p, c = _untied_knn_inputs(2, 64, 200, 10)
    pv = np.random.RandomState(3).rand(64) > 0.3
    for valid in (None, pv):
        got = TS.knn_union_mask(to_torch(p), to_torch(c), 10,
                                None if valid is None else to_torch(valid))
        ref = JS.knn_union_mask(jnp.asarray(p), jnp.asarray(c), 10,
                                None if valid is None else jnp.asarray(valid))
        assert_close(got, ref)


def test_partial_mesh_batch():
    rng = np.random.RandomState(4)
    parts, comps = zip(*[_untied_knn_inputs(10 + i, 128, 128, 30)
                         for i in range(3)])
    part, comp = np.stack(parts), np.stack(comps)
    pv = rng.rand(3, 128) > 0.2
    got = TS.partial_mesh_batch(to_torch(part), to_torch(comp), k=30,
                                surface_pts=128, partial_valid=to_torch(pv))
    ref = JS.partial_mesh_batch(jnp.asarray(part), jnp.asarray(comp), k=30,
                                surface_pts=128, partial_valid=jnp.asarray(pv))
    assert_close(got, ref)


def test_within_radius_mask_cpu_matches_xla():
    rng = np.random.RandomState(5)
    a = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (700, 3)).astype(np.float32) + [5.0, -4.0, 0.0]
    a[:500] = b[rng.randint(0, 700, 500)] + rng.uniform(-0.1, 0.1, (500, 3))
    bv = rng.rand(700) > 0.25
    r = 0.1
    d = ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)
    d = np.where(bv[None], d, np.inf).min(1)
    assert not (np.abs(d - r * r) <= 1e-5 * r * r).any()   # no near-ties
    got = TS.within_radius_mask(to_torch(a), to_torch(b), r, to_torch(bv))
    ref = JS.within_radius_mask(jnp.asarray(a), jnp.asarray(b), r,
                                jnp.asarray(bv))
    assert_close(got, ref)
    assert 0 < int(got.sum()) < len(a)


def test_transforms():
    rng = np.random.RandomState(6)
    pts = rng.randn(4, 20, 5).astype(np.float32) * 10
    ang = rng.uniform(-np.pi, np.pi, 4).astype(np.float32)
    boxes = np.concatenate([rng.randn(4, 3) * 10, rng.uniform(1, 4, (4, 3)),
                            ang[:, None]], 1).astype(np.float32)
    o6 = rng.randn(4, 6).astype(np.float32)
    tp, ta, tb = to_torch(pts), to_torch(ang), to_torch(boxes)
    jp, ja, jb = jnp.asarray(pts), jnp.asarray(ang), jnp.asarray(boxes)
    assert_close(TT.rot_z(ta), JT.rot_z(ja), atol=1e-6)
    # row-vector convention: p @ rot_z(a) rotates p by +a
    e = TT.rotate_points_along_z(torch.tensor([[[1.0, 0, 0]]]),
                                 torch.tensor([np.pi / 2]))
    assert_close(e, [[[0.0, 1.0, 0.0]]], atol=1e-6)
    assert_close(TT.rotate_points_along_z(tp, ta),
                 JT.rotate_points_along_z(jp, ja), atol=1e-4)
    xyz, jxyz = tp[..., :3], jp[..., :3]
    assert_close(TT.vc_to_cn(xyz, tb), JT.vc_to_cn(jxyz, jb), atol=1e-4)
    assert_close(TT.cn_to_vc(xyz, tb), JT.cn_to_vc(jxyz, jb), atol=1e-4)
    assert_close(TT.normalize_scale(xyz, tb), JT.normalize_scale(jxyz, jb),
                 atol=1e-5)
    assert_close(TT.restore_scale(xyz, tb), JT.restore_scale(jxyz, jb),
                 atol=1e-4)
    assert_close(TT.rotation_matrix_from_ortho6d(to_torch(o6)),
                 JT.rotation_matrix_from_ortho6d(jnp.asarray(o6)), atol=1e-5)


def test_chamfer():
    rng = np.random.RandomState(7)
    x1 = rng.randn(3, 50, 3).astype(np.float32)
    x2 = rng.randn(3, 80, 3).astype(np.float32)
    v1 = rng.rand(3, 50) > 0.2
    v2 = rng.rand(3, 80) > 0.3
    for a1, a2 in ((None, None), (v1, None), (None, v2), (v1, v2)):
        t1 = None if a1 is None else to_torch(a1)
        t2 = None if a2 is None else to_torch(a2)
        j1 = None if a1 is None else jnp.asarray(a1)
        j2 = None if a2 is None else jnp.asarray(a2)
        got = TC.chamfer_sq(to_torch(x1), to_torch(x2), t1, t2)
        ref = JC.chamfer_sq(jnp.asarray(x1), jnp.asarray(x2), j1, j2)
        for g, r in zip(got, ref):
            assert_close(g, r, atol=1e-5, rtol=1e-5)
        assert_close(TC.chamfer_l2(to_torch(x1), to_torch(x2), t1, t2),
                     JC.chamfer_l2(jnp.asarray(x1), jnp.asarray(x2), j1, j2),
                     atol=1e-5, rtol=1e-5)
        assert_close(TC.chamfer_l1(to_torch(x1), to_torch(x2), t1, t2),
                     JC.chamfer_l1(jnp.asarray(x1), jnp.asarray(x2), j1, j2),
                     atol=1e-5, rtol=1e-5)
