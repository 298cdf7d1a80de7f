"""The detector's ops in the port against the JAX package on the CPU:
voxelisation, the rulebook sparse convs (both lookup routes and both
output-set routes, with truncation), height compression, box geometry,
rotated BEV IoU and NMS. Inputs are made with numpy from a seed.

Tolerances: integer and boolean outputs (coords, masks, indices, kept sets)
must be equal; float outputs of the same f32 formula agree to 1e-5
relative (only the order of sums differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seevcn_tpu.geom import boxes as JB
from seevcn_tpu.models.modules.map_to_bev import height_compression as jax_hc
from seevcn_tpu.ops import iou3d as JI
from seevcn_tpu.ops import nms as JN
from seevcn_tpu.ops import sparse as JS
from seevcn_tpu.ops import voxelize as JV
from seevcn_torch.geom import boxes as TB
from seevcn_torch.models.modules.map_to_bev import height_compression
from seevcn_torch.ops import iou3d as TI
from seevcn_torch.ops import nms as TN
from seevcn_torch.ops import sparse as TS
from seevcn_torch.ops import voxelize as TV
from seevcn_torch.testing import assert_close, to_torch
from seevcn_torch.utils.config import Cfg


def _np(x):
    return np.array(x)      # a writable copy of a JAX array


# --- voxelisation -----------------------------------------------------------

PCR, VS = [0.0, -4.0, -2.0, 8.0, 4.0, 2.0], [0.5, 0.5, 0.25]


def _cloud(seed, b=2, p=700):
    """Dense blobs (many points per voxel) + scattered points, some outside
    the range, some invalid."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-1, 9, (b, p)), rng.uniform(-5, 5, (b, p)),
                    rng.uniform(-2.5, 2.5, (b, p))], -1).astype(np.float32)
    pts[:, :200] = (rng.uniform(0, 1, (b, 200, 3)) * [0.4, 0.4, 0.2]
                    + [2.05, 0.05, 0.05]).astype(np.float32)   # one dense voxel
    valid = rng.rand(b, p) > 0.1
    return pts, valid


@pytest.mark.parametrize("max_voxels,cap", [(64, 5), (400, 5), (400, 0)])
def test_voxelize_batch_matches_jax(max_voxels, cap):
    pts, valid = _cloud(0)
    kw = dict(point_cloud_range=PCR, voxel_size=VS, max_voxels=max_voxels,
              max_points_per_voxel=cap)
    jf, jc, jm = JV.voxelize_batch(jnp.asarray(pts), jnp.asarray(valid), **kw)
    tf, tc, tm = TV.voxelize_batch(to_torch(pts), to_torch(valid), **kw)
    assert_close(tm, _np(jm), name="mask")
    assert_close(tc, _np(jc), name="coords")
    assert_close(tf, _np(jf), atol=1e-6, rtol=1e-6, name="features")
    # the cap and the lowest-key rule are exercised: more voxels than
    # capacity in each frame, and a voxel holding more than 5 points
    for i in range(2):
        full = TV.voxelize(to_torch(pts[i]), to_torch(valid[i]), **{
            **kw, "max_voxels": 10_000})
        assert int(full.mask.sum()) > 64
        assert int(full.num_points.max()) > 5
        jr = JV.voxelize(jnp.asarray(pts[i]), jnp.asarray(valid[i]), **kw)
        tr = TV.voxelize(to_torch(pts[i]), to_torch(valid[i]), **kw)
        for name in ("coords", "num_points", "mask", "point_voxel_id",
                     "point_order"):
            assert_close(getattr(tr, name), _np(getattr(jr, name)), name=name)


def test_voxel_mean_keeps_first_points_in_input_order():
    """A voxel averages its first 5 points in input order; num_points counts
    all of them; the kept voxels are those with the lowest keys."""
    pts = np.array([[0.1, 0.1, 0.1]] * 7 + [[3.1, 0.1, 0.1], [0.1, 0.1, 1.1]],
                   np.float32)
    pts[:7, 0] += np.arange(7, dtype=np.float32) * 0.01
    res = TV.voxelize(to_torch(pts), torch.ones(9, dtype=torch.bool),
                      point_cloud_range=[0, 0, 0, 4, 4, 4], voxel_size=[1, 1, 1],
                      max_voxels=2, max_points_per_voxel=5)
    assert res.num_points.tolist() == [7, 1]
    assert res.coords.tolist() == [[0, 0, 0], [0, 0, 3]]   # z=1 key is higher
    assert_close(res.features[0, 0], np.float32(0.1 + 0.02), atol=1e-6)


# --- sparse convs -----------------------------------------------------------

def _sparse(seed, shape, n_active, capacity, cin, b=2, clustered=False):
    """Random key-sorted sparse tensor with padding rows, in both packages."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = shape
    if clustered:        # a few blobs in a huge grid
        ctr = rng.randint([0, 0, 0, 0], [b, nz, ny - 8, nx - 8], (6, 4))
        c = ctr[rng.randint(0, 6, 4 * n_active)] + np.concatenate(
            [np.zeros((4 * n_active, 1), int),
             rng.randint(0, [nz, 8, 8], (4 * n_active, 3))], 1)
        c[:, 1] = np.minimum(c[:, 1], nz - 1)
    else:
        c = np.stack([rng.randint(0, b, 4 * n_active), rng.randint(0, nz, 4 * n_active),
                      rng.randint(0, ny, 4 * n_active), rng.randint(0, nx, 4 * n_active)], 1)
    key = ((c[:, 0] * nz + c[:, 1]) * ny + c[:, 2]) * nx + c[:, 3]
    _, first = np.unique(key, return_index=True)
    c = c[np.sort(first)][:n_active]
    key = ((c[:, 0] * nz + c[:, 1]) * ny + c[:, 2]) * nx + c[:, 3]
    c = c[np.argsort(key)]
    coords = np.zeros((capacity, 4), np.int32)
    coords[:len(c)] = c
    mask = np.arange(capacity) < len(c)
    feats = np.where(mask[:, None], rng.randn(capacity, cin), 0).astype(np.float32)
    j = JS.make_sparse_tensor(jnp.asarray(feats), jnp.asarray(coords),
                              jnp.asarray(mask), shape, b)
    t = TS.make_sparse_tensor(to_torch(feats), to_torch(coords), to_torch(mask),
                              shape, b)
    return j, t


def _weight(seed, k, cin, cout):
    # not symmetric in any axis: a flipped or transposed layout shows
    return np.random.RandomState(seed).randn(k, cin, cout).astype(np.float32)


def _assert_sparse_equal(t, j, name):
    assert t.spatial_shape == tuple(j.spatial_shape)
    assert_close(t.mask, _np(j.mask), name=f"{name} mask")
    m = _np(j.mask)
    assert_close(t.coords[m], _np(j.coords)[m], name=f"{name} coords")
    assert_close(t.features, _np(j.features), atol=1e-5, rtol=1e-5,
                 name=f"{name} features")


# (shape, active, capacity): a small grid (dense key map), and one whose key
# space exceeds 2^24 (binary search lookup)
SUBM_CASES = {"dense_map": ((9, 20, 24), 300, 400),
              "searchsorted": ((3, 2400, 2400), 300, 400)}


@pytest.mark.parametrize("case", sorted(SUBM_CASES))
def test_subm_conv3d_matches_jax(case):
    shape, n, cap = SUBM_CASES[case]
    j, t = _sparse(1, shape, n, cap, 5, clustered=case == "searchsorted")
    w = _weight(2, 27, 5, 7)
    jo = JS.subm_conv3d(j, jnp.asarray(w), kernel_size=3, padding=1)
    to = TS.subm_conv3d(t, to_torch(w), kernel_size=3, padding=1)
    _assert_sparse_equal(to, jo, "subm")
    # a neighbour that is not active contributes zero: an isolated voxel
    # sees only the centre tap
    iso = TS.subm_conv3d(t._replace(mask=torch.arange(cap) == 0), to_torch(w))
    assert_close(iso.features[0], t.features[0] @ to_torch(w)[13], atol=1e-5)


# (shape, kernel, stride, padding, active, capacity, out_capacity): output key
# spaces below 2^24 (occupancy plane) and above it (sort), each with and
# without truncation to the lowest keys (out_capacity None: the input's row
# count, the reference's default)
CONV_CASES = {
    "occupancy": ((9, 20, 24), 3, 2, 1, 300, 400, 1000),
    "occupancy_truncated": ((9, 20, 24), 3, 2, 1, 300, 400, None),
    "occupancy_z_unpadded": ((7, 12, 10), 3, 2, (0, 1, 1), 150, 200, 600),
    "conv_out_kernel": ((3, 12, 10), (3, 1, 1), (2, 1, 1), 0, 150, 200, 300),
    "sort": ((3, 2400, 2400), 3, 1, 1, 200, 300, 2000),
    "sort_truncated": ((3, 2400, 2400), 3, 1, 1, 200, 300, 700),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_sparse_conv3d_matches_jax(case):
    shape, ks, stride, pad, n, cap, out_cap = CONV_CASES[case]
    j, t = _sparse(3, shape, n, cap, 4, clustered=case.startswith("sort"))
    k = int(np.prod(TS._as3(ks)))
    w = _weight(4, k, 4, 6)
    out_space = 2 * int(np.prod(TS.conv_out_shape(shape, ks, stride, pad)))
    assert (out_space > TS._DENSE_MAP_MAX_SPACE) == case.startswith("sort")
    jo = JS.sparse_conv3d(j, jnp.asarray(w), kernel_size=ks, stride=stride,
                          padding=pad, out_capacity=out_cap)
    to = TS.sparse_conv3d(t, to_torch(w), kernel_size=ks, stride=stride,
                          padding=pad, out_capacity=out_cap)
    _assert_sparse_equal(to, jo, "conv")
    n_out = int(TS.sparse_conv3d(t, to_torch(w), ks, stride, pad,
                                 out_capacity=TS.ALL).mask.sum())
    if case.endswith("truncated"):
        assert n_out > int(to.mask.sum()) == (out_cap or cap)  # truncated
    else:
        assert n_out == int(to.mask.sum())


def test_height_compression_matches_jax():
    j, t = _sparse(5, (2, 6, 7), 50, 60, 3)
    assert_close(height_compression(t), _np(jax_hc(j)), name="bev")
    # channel c*D + d
    dense = TS.to_dense(t)
    assert_close(height_compression(t)[..., 2 * 2 + 1], dense[:, 1, :, :, 2],
                 name="channel order")
    assert_close(dense, _np(JS.to_dense(j)), name="to_dense")


# --- boxes, IoU, NMS --------------------------------------------------------

def _boxes(seed, n, spread=12.0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.uniform(-1, 1, (n, 1)), rng.uniform(1, 5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


def test_box_geometry_matches_jax():
    b = _boxes(6, 40)
    jb, tb = jnp.asarray(b), to_torch(b)
    assert_close(TB.boxes_to_corners_3d(tb), _np(JB.boxes_to_corners_3d(jb)),
                 atol=1e-5, name="corners 3d")
    assert_close(TB.corners_bev(tb), _np(JB.corners_bev(jb)), atol=1e-5,
                 name="corners bev")
    ja, ta = JB.boxes3d_to_aligned_bev(jb), TB.boxes3d_to_aligned_bev(tb)
    assert_close(ta, _np(ja), atol=1e-5, name="aligned bev")
    assert_close(TB.boxes_iou_normal(ta, ta), _np(JB.boxes_iou_normal(ja, ja)),
                 atol=1e-6, name="aligned iou")


@pytest.mark.parametrize("row_chunk", [None, 7])
def test_boxes_iou_bev_matches_jax(row_chunk):
    a, b = _boxes(7, 30, spread=6.0), _boxes(8, 25, spread=6.0)
    # identical boxes, a box inside another, far apart boxes, touching edges
    a[0], b[0] = [1, 1, 0, 4, 2, 1, 0.3], [1, 1, 0, 4, 2, 1, 0.3]
    a[1], b[1] = [0, 0, 0, 4, 4, 1, 0.0], [0, 0, 0, 1, 1, 1, 0.7]
    a[2], b[2] = [-50, -50, 0, 2, 2, 1, 0.1], [50, 50, 0, 2, 2, 1, 0.1]
    a[3], b[3] = [10, 0, 0, 2, 2, 1, 0.0], [12, 0, 0, 2, 2, 1, 0.0]
    ja = JI.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b), row_chunk=row_chunk)
    ta = TI.boxes_iou_bev(to_torch(a), to_torch(b), row_chunk=row_chunk)
    assert_close(ta, _np(ja), atol=1e-5, name="iou bev")
    t = ta.numpy()
    assert abs(t[0, 0] - 1) < 1e-5 and abs(t[1, 1] - 1 / 16) < 1e-5
    assert t[2, 2] == 0
    assert 0.05 < (t > 0).mean() < 0.9          # rotated overlaps and misses


@pytest.mark.parametrize("variant", ["plain", "ties", "thresholds", "aligned",
                                     "class_agnostic"])
def test_nms_bev_matches_jax(variant):
    rng = np.random.RandomState(9)
    b = _boxes(10, 120, spread=8.0)
    s = rng.rand(120).astype(np.float32)
    kw = dict(thresh=0.2, pre_maxsize=100, post_maxsize=100)
    valid = None
    if variant == "ties":            # equal scores, kept in index order
        s[::3] = 0.5
        s[5] = np.nan
    if variant == "thresholds":
        valid = rng.rand(120) > 0.3
        kw.update(score_thresh=0.4, post_maxsize=500)
    if variant == "aligned":
        kw.update(use_bev_aligned=True)
    if variant == "class_agnostic":          # the config-driven wrapper
        cfg = Cfg({"NMS_THRESH": 0.2, "NMS_PRE_MAXSIZE": 100,
                   "NMS_POST_MAXSIZE": 100, "NMS_TYPE": "nms_gpu"})
        jr = JN.class_agnostic_nms(jnp.asarray(s), jnp.asarray(b), cfg, 0.3)
        tr = TN.class_agnostic_nms(to_torch(s), to_torch(b), cfg, 0.3)
    else:
        jr = JN.nms_bev(jnp.asarray(b), jnp.asarray(s),
                        valid_mask=None if valid is None else jnp.asarray(valid),
                        **kw)
        tr = TN.nms_bev(to_torch(b), to_torch(s),
                        valid_mask=None if valid is None else to_torch(valid), **kw)
    for name, tv, jv in zip(("indices", "keep", "scores"), tr, jr):
        assert tv.shape == jv.shape
        assert_close(tv, _np(jv), name=name)
    keep = tr[1]
    assert 3 < int(keep.sum()) < keep.shape[0]       # some kept, some suppressed
