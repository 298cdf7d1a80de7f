"""The VCN training slice's ops, data path and metrics in the port against
the JAX package on the CPU: geodesic_distance, heading_from_rotm and the
_rt transforms; farthest point sampling; chamfer_l2_split;
get_bbox_from_keypoints; each numpy transform, VCDataset's batches and
generate_vc_dataset's files bit for bit from the same seeds; read_pcd /
write_pcd across the two packages; the metric battery; save_scene_html.

Tolerances are stated per test; every JAX function is jitted.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seevcn_tpu.geom import pcd_io as JPCD
from seevcn_tpu.geom import transforms as JT
from seevcn_tpu.models.vcn import dataset as JD
from seevcn_tpu.models.vcn import metrics as JM
from seevcn_tpu.models.vcn import transforms as JVT
from seevcn_tpu.models.vcn import vc_shapenet as JVS
from seevcn_tpu.models.vcn.nets import get_bbox_from_keypoints as jax_bbox
from seevcn_tpu.ops import chamfer as JC
from seevcn_tpu.ops import sampling as JS
from seevcn_tpu.utils import viz3d as JV
from seevcn_torch.geom import pcd_io as TPCD
from seevcn_torch.geom import transforms as TT
from seevcn_torch.models.vcn import dataset as TD
from seevcn_torch.models.vcn import metrics as TM
from seevcn_torch.models.vcn import transforms as TVT
from seevcn_torch.models.vcn import vc_shapenet as TVS
from seevcn_torch.models.vcn.nets import get_bbox_from_keypoints
from seevcn_torch.ops import chamfer as TC
from seevcn_torch.ops import sampling as TS
from seevcn_torch.testing import assert_close, to_torch
from seevcn_torch.utils import viz3d as TV


def _rotations(rng, b):
    return np.array(jax.jit(JT.rotation_matrix_from_ortho6d)(
        rng.randn(b, 6).astype(np.float32)))


def test_geodesic_heading_and_rt_transforms_match_jax():
    """geodesic_distance (including near-identical and opposite rotations,
    where the clip holds) and heading_from_rotm within 1e-6 rad;
    vc_to_cn_rt / cn_to_vc_rt within 1e-5 m (translation (B, 3) and
    (B, 1, 3)); rotate_points_along_z_np bit for bit."""
    rng = np.random.RandomState(0)
    r1, r2 = _rotations(rng, 16), _rotations(rng, 16)
    r2[:2] = r1[:2]
    r2[2] = r1[2] @ np.diag([-1, -1, 1]).astype(np.float32)     # pi about z
    assert_close(TT.geodesic_distance(to_torch(r1), to_torch(r2)),
                 np.asarray(jax.jit(JT.geodesic_distance)(r1, r2)), atol=1e-6,
                 name="geodesic")
    assert_close(TT.heading_from_rotm(to_torch(r1)),
                 np.asarray(jax.jit(JT.heading_from_rotm)(r1)), atol=1e-6,
                 name="heading")
    pts = (rng.randn(16, 50, 3) * 3 + [10, 2, 0]).astype(np.float32)
    for trans in (rng.randn(16, 3).astype(np.float32),
                  rng.randn(16, 1, 3).astype(np.float32)):
        for t_fn, j_fn in ((TT.vc_to_cn_rt, JT.vc_to_cn_rt),
                           (TT.cn_to_vc_rt, JT.cn_to_vc_rt)):
            assert_close(t_fn(to_torch(pts), to_torch(r1), to_torch(trans)),
                         np.asarray(jax.jit(j_fn)(pts, r1, trans)), atol=1e-5,
                         name=t_fn.__name__)
    ang = rng.uniform(-np.pi, np.pi, 16)
    assert np.array_equal(TT.rotate_points_along_z_np(pts, ang),
                          JT.rotate_points_along_z_np(pts, ang))


def _fps_case(case):
    rng = np.random.RandomState(1)
    p = (rng.randn(3, 300, 3) * [2, 0.8, 0.6] + [12, -3, 0]).astype(np.float32)
    valid = None
    if case == "valid":
        valid = rng.rand(3, 300) > 0.3
        valid[:, :5] = False                       # starts past a masked head
    elif case == "duplicates":                     # ResamplePoints tiles rows
        p = np.concatenate([p[:, :120]] * 3, 1)[:, rng.permutation(360)]
    elif case == "few_valid":                      # picks repeat among 40
        valid = np.zeros((3, 300), bool)
        valid[:, rng.choice(300, 40, replace=False)] = True
    return p, valid


@pytest.mark.parametrize("case", ["plain", "valid", "duplicates", "few_valid"])
def test_fps_indices_match_jax(case):
    """Indices equal, batched (one loop for the batch) and per sample; the
    gathered points equal; no invalid point picked."""
    p, valid = _fps_case(case)
    n = 100
    jfs = jax.jit(jax.vmap(lambda x, v: JS.farthest_point_sample(x, n, v)))
    v = np.ones(p.shape[:2], bool) if valid is None else valid
    ref = np.asarray(jfs(p, v))
    tv = None if valid is None else to_torch(valid)
    got = TS.farthest_point_sample(to_torch(p), n, tv)
    assert_close(got, ref.astype(np.int64), name="indices")
    assert_close(TS.farthest_point_sample(to_torch(p[1]), n,
                                          None if valid is None else tv[1]),
                 ref[1].astype(np.int64), name="unbatched")
    assert v[np.arange(3)[:, None], ref].all()
    assert_close(TS.fps(to_torch(p), n, tv), np.take_along_axis(p, ref[..., None], 1),
                 name="fps points")


def test_chamfer_l2_split_matches_jax():
    """Both directions within 1e-6 (absolute and relative), with and
    without validity masks; they sum to chamfer_l2."""
    rng = np.random.RandomState(2)
    a = (rng.randn(3, 200, 3) + [10, 0, 0]).astype(np.float32)
    b = (rng.randn(3, 150, 3) + [10, 0.2, 0]).astype(np.float32)
    va, vb = rng.rand(3, 200) > 0.2, rng.rand(3, 150) > 0.4
    for masks in ((None, None), (va, vb)):
        ref = jax.jit(JC.chamfer_l2_split)(a, b, *masks)
        got = TC.chamfer_l2_split(to_torch(a), to_torch(b),
                                  *[None if m is None else to_torch(m) for m in masks])
        for g, r in zip(got, ref):
            assert_close(g, np.asarray(r), atol=1e-6, rtol=1e-6, name="split")
        assert_close(sum(got), np.asarray(jax.jit(JC.chamfer_l2)(a, b, *masks)),
                     atol=1e-6, rtol=1e-6, name="sum")


def test_get_bbox_from_keypoints_matches_jax():
    """Values within 1e-5 m; the gradient of the extents through amax/amin
    within 1e-6, with tied extreme points (the rows are tiled twice), where
    both split it evenly."""
    rng = np.random.RandomState(3)
    pts = (rng.randn(4, 64, 3) * [2, 0.8, 0.6] + [10, 3, -1]).astype(np.float32)
    pts = np.concatenate([pts, pts], 1)
    gt = np.concatenate([rng.randn(4, 6), rng.uniform(-3, 3, (4, 1))], 1).astype(np.float32)
    ref = jax.jit(jax_bbox)(pts, gt)
    jgrad = jax.jit(jax.grad(lambda p: (jax_bbox(p, gt)[:, :6] ** 2).sum()))(pts)
    tp = to_torch(pts).requires_grad_(True)
    box = get_bbox_from_keypoints(tp, to_torch(gt))
    (box[:, :6] ** 2).sum().backward()
    assert_close(box.detach(), np.asarray(ref), atol=1e-5, name="box")
    assert_close(tp.grad, np.asarray(jgrad), atol=1e-6, name="grad")
    assert (np.asarray(jgrad)[:, :64] == np.asarray(jgrad)[:, 64:]).all()


# --------------------------------------------------------------------------- #
# the numpy data path
# --------------------------------------------------------------------------- #

def _ring_cloud(rng):
    el = np.repeat(np.linspace(-0.2, 0.2, 32), 64)
    az = np.tile(np.linspace(-0.3, 0.3, 64), 32)
    sph = np.stack([15 + rng.rand(2048) * 0.5, az, el], 1)
    return JVT.sph2cart(sph).astype(np.float32)


TRANSFORMS = [("LidarSimulation", None), ("Jitter", {"sigma": 0.02}),
              ("AddGNSpherical", None), ("ResamplePoints", {"n_points": 700}),
              ("RandomWorldFlip", None), ("GlobalRotation", None),
              ("RandomObjectScaling", {"scale_range": (0.8, 1.2)}),
              ("NormalizeObjectPose", None)]


@pytest.mark.parametrize("name,params", TRANSFORMS, ids=[t[0] for t in TRANSFORMS])
def test_numpy_transform_bit_equal_to_jax(name, params):
    """Ten calls from one seeded Generator each: outputs, the boxes and
    complete clouds they edit in place, and the generator's state after,
    all bit for bit."""
    pts = _ring_cloud(np.random.RandomState(4))
    outs = []
    for mod in (TVT, JVT):
        rng = np.random.default_rng(7)
        t = mod.TRANSFORMS[name](params, rng=rng)
        res = []
        for _ in range(10):
            box = np.array([15, 0.5, 0.2, 4.2, 1.8, 1.5, 0.3], np.float32)
            comp = pts[::3].copy()
            corners = np.array([[1, 1, 0], [1, -1, 0], [-1, -1, 0], [-1, 1, 0]] * 2,
                               np.float32) * [2.1, 0.9, 1] + [15, 0.5, 0]
            if name == "RandomObjectScaling":
                out = t(pts, gt_box=box, complete=comp)
            elif name == "NormalizeObjectPose":
                out = t(pts, bbox_pts=corners)
            elif getattr(t, "needs_kw", False):
                out = t(pts, gt_box=box)
            else:
                out = t(pts)
            res.append((out, box, comp))
        outs.append((res, rng.bit_generator.state))
    (got, got_state), (ref, ref_state) = outs
    assert got_state == ref_state
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    np.testing.assert_array_equal(TVT.sph2cart(TVT.cart2sph(pts)),
                                  JVT.sph2cart(JVT.cart2sph(pts)))


def test_compose_from_config_bit_equal_to_jax():
    cfg = [{"callback": "LidarSimulation"}, {"callback": "AddGNSpherical"},
           {"callback": "RandomWorldFlip"}, {"callback": "ResamplePoints",
                                             "parameters": {"n_points": 256}}]
    pts = _ring_cloud(np.random.RandomState(5))
    outs = []
    for mod in (TVT, JVT):
        t = mod.build_transforms(cfg, rng=np.random.default_rng(3))
        box = np.array([15, 0.5, 0.2, 4.2, 1.8, 1.5, 0.3], np.float32)
        outs.append([(t(pts, gt_box=box), box.copy()) for _ in range(5)])
    for (a, ba), (b, bb) in zip(*outs):
        assert np.array_equal(a, b) and np.array_equal(ba, bb)


def test_pcd_read_write_across_packages(tmp_path):
    """Binary and ascii files written by either package read back equal by
    the other, bit for bit."""
    pts = (np.random.RandomState(6).randn(333, 3) * 5).astype(np.float32)
    for binary in (True, False):
        for w, r in ((TPCD, JPCD), (JPCD, TPCD)):
            path = str(tmp_path / f"{w.__name__}_{binary}.pcd")
            w.write_pcd(path, pts, binary=binary)
            got = r.read_pcd(path)
            if binary:
                assert np.array_equal(got, pts)
            else:
                np.testing.assert_allclose(got, pts, atol=1e-8)   # "%.8f"
            assert np.array_equal(got, TPCD.read_pcd(path))
        assert (tmp_path / f"{TPCD.__name__}_{binary}.pcd").read_bytes() == \
            (tmp_path / f"{JPCD.__name__}_{binary}.pcd").read_bytes()


def _write_car_objs(mesh_dir, n, seed):
    """Procedural cars as .obj in ShapeNet's frame (y up, -z forward), as the
    training recipe writes them; one mesh list per package's generator."""
    os.makedirs(mesh_dir, exist_ok=True)
    paths = []
    rngs = (np.random.RandomState(seed), np.random.RandomState(seed))
    for i in range(n):
        v, f = TVS.procedural_car_mesh(rngs[0])
        jv, jf = JVS.procedural_car_mesh(rngs[1])
        assert np.array_equal(v, jv) and np.array_equal(f, jf)
        path = os.path.join(mesh_dir, f"car{i}.obj")
        with open(path, "w") as fh:
            for x, y, z in v:
                fh.write(f"v {y:.4f} {z:.4f} {-x:.4f}\n")
            for a, b, c in f:
                fh.write(f"f {a + 1} {b + 1} {c + 1}\n")
        paths.append(path)
    return paths


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            out[os.path.relpath(path, root)] = path
    return out


def _same_file(a, b):
    if a.endswith(".pkl"):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            la, lb = pickle.load(fa), pickle.load(fb)
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].keys() == lb[k].keys()
            for f in la[k]:
                assert np.array_equal(la[k][f], lb[k][f]), (a, k, f)
    else:
        assert np.array_equal(np.load(a), np.load(b)), a


def test_generate_vc_dataset_files_bit_equal_to_jax(tmp_path):
    """generate_vc_dataset and generate_vc_dataset_scenes (with the pole
    distractors of populate_scene) from the same meshes, poses and seeds:
    the same files, every array bit for bit."""
    meshes = _write_car_objs(str(tmp_path / "meshes"), 2, 0)
    rng = np.random.RandomState(1)
    poses = [np.array([d * np.cos(a), d * np.sin(a), 0.0, rng.uniform(3.8, 4.6), 0, 0,
                       rng.uniform(-np.pi, np.pi)])
             for d, a in zip(rng.uniform(6, 30, 3), rng.uniform(-0.5, 0.5, 3))]
    frames = [{"cars": np.array([[12, 3, -1.6, 4.2, 1.8, 1.5, 0.4],
                                 [9, -4, -1.6, 4.0, 1.7, 1.5, -1.0]]),
               "signs": np.array([[7, 6, -1, 0.5, 0.5, 2, 0]])}] * 3
    for mod, out in ((TVS, "port"), (JVS, "jax")):
        mod.generate_vc_dataset(meshes, poses, str(tmp_path / out / "single"),
                                n_complete=512, rng=np.random.default_rng(1),
                                logger=lambda s: None)
        mod.generate_vc_dataset_scenes(meshes, frames, str(tmp_path / out / "scenes"),
                                       nviews=2, n_complete=512, height_px=40,
                                       rng=np.random.default_rng(2), logger=lambda s: None)
    got, ref = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert got.keys() == ref.keys() and len(got) > 10
    for k in ref:
        _same_file(got[k], ref[k])


def _vc_dir(tmp_path):
    meshes = _write_car_objs(str(tmp_path / "meshes"), 2, 3)
    rng = np.random.RandomState(4)
    poses = [np.array([d, rng.uniform(-4, 4), 0.0, 4.2, 0, 0, rng.uniform(-3, 3)])
             for d in rng.uniform(8, 25, 5)]
    JVS.generate_vc_dataset(meshes, poses, str(tmp_path / "vc"), n_complete=600,
                            rng=np.random.default_rng(5), logger=lambda s: None)
    return str(tmp_path / "vc")


def test_vc_dataset_batches_bit_equal_to_jax(tmp_path):
    """VCDataset (transforms, then resampling, then the batch order from one
    Generator) and KittiObjectsDataset: every batch of two shuffled epochs,
    bit for bit."""
    root = _vc_dir(tmp_path)
    cfg = [{"callback": "LidarSimulation"}, {"callback": "RandomWorldFlip"}]
    runs = []
    for mod in (TD, JD):
        ds = mod.VCDataset(root, transforms_cfg=cfg, n_points=128, n_complete=256,
                           rng=np.random.default_rng(9))
        kitti = mod.KittiObjectsDataset(root, n_points=64)
        runs.append([b for _ in range(2) for b in ds.batches(3)]
                    + list(kitti.batches(4, shuffle=False, drop_last=False)))
    assert len(runs[0]) == len(runs[1]) == 2 * 3 + 3
    for got, ref in zip(*runs):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_metric_accumulator_matches_jax():
    """summary() within 1e-5 (absolute and relative) of JAX's, over two
    updates, with input point counts in all four levels and the pose and
    partial-mesh metrics on; each per-sample function too."""
    rng = np.random.RandomState(8)
    accs = (TM.MetricAccumulator(), JM.MetricAccumulator())
    for u in range(2):
        b, n = 4, 128
        gt = np.concatenate([rng.uniform(8, 15, (b, 1)), rng.uniform(-3, 3, (b, 1)),
                             rng.uniform(-1, 0, (b, 1)), rng.uniform(3.8, 4.4, (b, 1)),
                             rng.uniform(1.6, 1.9, (b, 1)), rng.uniform(1.4, 1.6, (b, 1)),
                             rng.uniform(-np.pi, np.pi, (b, 1))], 1).astype(np.float32)
        complete = (gt[:, None, :3] + rng.uniform(-1, 1, (b, 256, 3)) * gt[:, None, 3:6] / 2)
        pred = complete[:, :n] + rng.randn(b, n, 3) * [0.05, 0.05, 0.02]
        inp = complete[:, 128:128 + 64] + rng.randn(b, 64, 3) * 0.01
        rot = _rotations(rng, b)
        centre = gt[:, :3] + rng.randn(b, 3) * 0.2
        npts = np.array([250, 100, 50, 10]) + u
        arrs = [x.astype(np.float32) for x in (pred, complete, gt, rot, centre, inp)]
        accs[0].update(*[to_torch(x) for x in arrs[:3]], npts, to_torch(arrs[3]),
                       to_torch(arrs[4]), input_pts=to_torch(arrs[5]))
        accs[1].update(*[jnp.asarray(x) for x in arrs[:3]], npts, jnp.asarray(arrs[3]),
                       jnp.asarray(arrs[4]), input_pts=jnp.asarray(arrs[5]))
    got, ref = accs[0].summary(), accs[1].summary()
    assert list(got) == list(ref) and len(ref) == 14 * 5
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-5 + 1e-5 * abs(v), (k, got[k], v)
    assert all(ref[f"CDL1_{lvl}"] != -1.0 for lvl in TM.LEVELS)
    assert 0 < ref["F1_010"] < 1 and 0 < ref["IOU_3D"] < 1 and 0 < ref["OOB"] < 1
    empty = TM.MetricAccumulator()
    empty.update(to_torch(arrs[0]), to_torch(arrs[1]), to_torch(arrs[2]),
                 np.array([300, 300, 300, 300]))
    assert empty.summary()["CDL1_L4"] == -1.0


def test_save_scene_html_matches_jax(tmp_path):
    """The same page but for its title, boxes and points embedded alike."""
    rng = np.random.RandomState(9)
    pts = rng.randn(500, 3).astype(np.float32)
    boxes = np.array([[1, 2, 0, 4, 2, 1.5, 0.3]], np.float32)
    TV.save_scene_html(str(tmp_path / "t.html"), pts, gt_boxes=boxes, ref_boxes=boxes)
    JV.save_scene_html(str(tmp_path / "j.html"), pts, gt_boxes=boxes, ref_boxes=boxes)
    got = (tmp_path / "t.html").read_text().replace("seevcn scene", "")
    ref = (tmp_path / "j.html").read_text().replace("seevcn_tpu scene", "")
    assert got == ref
