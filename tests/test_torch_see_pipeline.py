"""The port's SEE host pipeline (seevcn_torch.see.pipeline.SEEVCN), its KITTI
adapter (seevcn_torch.data.kitti.see_adapter.KittiObjects) and VCN's list
form (seevcn_torch.models.vcn.inference.VCNInference.complete_list) against
the JAX package on the CPU.

Data: a synthetic KITTI tree from ``chip_smoke.write_kitti_split`` (two
frames of 6,000 points, four cars each) with a COCO mask file of each
car's projected box, written by ``detections_to_coco``; objects and
instances from numpy seeds. VCN_VC and VCN_CN at num_points 128 with flax's
initial weights (seeds 1 and 2), carried across; BATCH_SIZE_LIMIT 4, so six
objects take two forwards. JAX's SEEVCN runs the TPU's path: its
``within_radius_mask`` is the pruned Pallas kernel in interpret mode, as in
the SEE frame's test; its VCN is jitted once per net.

Tolerances: the same instances (isolated points equal); VCN's outputs and
the completed clouds to 1e-3 m, the clouds as sorted row sets (np.unique
orders rows lexicographically, so a last-bit difference can reorder two);
the kept scan points, the projections, infos and masks exactly. SEE-v1's
upsampling ranks neighbours by Gram-form f32 distances, which each
framework rounds its own way: its inputs lie within 2 m of the origin and
are tie-free there, and its outputs are held exactly.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import car_box_detections, write_kitti_split
from seevcn_tpu.data.kitti.see_adapter import KittiObjects as JKO
from seevcn_tpu.models.vcn.inference import VCNInference as JVCN
from seevcn_tpu.models.vcn.inference import resample_to_fixed as j_resample
from seevcn_tpu.models.vcn.nets import build_vcn as jax_build_vcn
from seevcn_tpu.ops.pallas.min_dist import min_sqdist as jax_min_sqdist
from seevcn_tpu.see import pipeline as JP
from seevcn_torch.cli.generate_masks import detections_to_coco
from seevcn_torch.data.kitti.see_adapter import KittiObjects as TKO
from seevcn_torch.models.vcn.inference import VCNInference as TVCN
from seevcn_torch.models.vcn.inference import resample_to_fixed as t_resample
from seevcn_torch.see import pipeline as TP
from seevcn_torch.utils.weights import vcn_state_dict_from_flax

OUT, BS = 128, 4
CFG = {"PC_ISOLATION": {"MIN_LIDAR_PTS": 30, "EPS_SCALING": 4.0, "MIN_EPS": 0.3,
                        "MAX_EPS": 1.0},
       "SURFACE_COMPLETION": {"VRES": 0.4}}


def _pallas_within_radius(a, b, radius, b_valid=None, chunk=8192):
    d = jax_min_sqdist(jnp.asarray(a, jnp.float32)[:, :3],
                       jnp.asarray(b, jnp.float32)[:, :3], b_valid=b_valid,
                       interpret=True, prune_radius=float(radius))
    return d <= radius * radius


@pytest.fixture(scope="module", autouse=True)
def pallas_route():
    mp = pytest.MonkeyPatch()
    mp.setattr(JP, "within_radius_mask", _pallas_within_radius)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def vcns():
    """{name: (JAX VCNInference, the port's)} for VCN_VC and VCN_CN."""
    out = {}
    for seed, (name, norm) in enumerate((("VCN_VC", False), ("VCN_CN", True)), start=1):
        model = jax_build_vcn(name, num_coarse=OUT)
        dummy = {"input": jnp.zeros((BS, OUT, 3))}
        if norm:
            dummy["gt_boxes"] = jnp.ones((BS, 7))
        variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), dummy))
        out[name] = (JVCN(name, variables, norm_with_gt=norm, batch_size=BS, num_points=OUT),
                     TVCN(name, vcn_state_dict_from_flax(variables, name), num_points=OUT,
                          norm_with_gt=norm, batch_size=BS, device="cpu"))
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("see_kitti")
    infos = write_kitti_split(str(root), 2, seed=5, n_points=6000, n_cars=4)
    detections_to_coco(car_box_detections(infos), str(root / "masks_image_2.json"))
    data_cfg = {"DATA_DIR": str(root), "INFO_PATHS": ["kitti_infos_val.pkl"],
                "MASK_PATHS": {"image_2": "masks_image_2.json"},
                "CAMERA_CHANNELS": ["image_2"], "TAG": "t", "CLASSES": ["Car"],
                "SHRINK_MASK_PERCENTAGE": 3.0}
    return root, infos, JKO(data_cfg), TKO(data_cfg)


@pytest.fixture(scope="module")
def sees(vcns, tree):
    _, _, jdo, tdo = tree
    j, t = JP.SEEVCN(CFG, data_obj=jdo), TP.SEEVCN(CFG, data_obj=tdo, device="cpu")
    j.vcn, t.vcn = vcns["VCN_VC"]
    return j, t


def _same_rows(got, ref, atol=1e-3):
    """The same row set within atol: equal counts, and every row of each
    within atol of a row of the other."""
    assert got.shape == ref.shape
    d = np.sqrt(((got[:, None, :] - ref[None, :, :]) ** 2).sum(-1))
    assert d.min(1).max() <= atol and d.min(0).max() <= atol, d.min(1).max()


def _same_completion(got, ref, atol=1e-3):
    for k in ("input", "coarse", "surface", "clustered"):
        if k in ref:
            assert got[k].shape == ref[k].shape, k
            for a, b in zip(got[k], ref[k]):
                _same_rows(a, b, atol)
    if ref["all_instances"] is None:
        assert got["all_instances"] is None
    else:
        _same_rows(got["all_instances"], ref["all_instances"], atol)


def _same_frame(got, ref, n_completed, atol=1e-3):
    """A replaced frame: the completed rows, then the kept scan points."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    _same_rows(got[:n_completed], ref[:n_completed], atol)
    np.testing.assert_array_equal(got[n_completed:], ref[n_completed:])


def _objects(seed, sizes):
    rng = np.random.RandomState(seed)
    objs, boxes = [], []
    for i, n in enumerate(sizes):
        c = np.array([8 + 3 * i, rng.uniform(-5, 5), -1.0])
        objs.append((c + rng.randn(n, 3) * [1.2, 0.5, 0.4]).astype(np.float32))
        boxes.append(np.array([*c, 4.2, 1.8, 1.5, rng.uniform(-1, 1)], np.float32))
    return objs, boxes


def test_resample_to_fixed_matches_jax():
    objs, _ = _objects(0, (1, 7, 128, 300))
    objs.append(np.zeros((0, 3), np.float32))
    np.testing.assert_array_equal(t_resample(objs, OUT), j_resample(objs, OUT))


@pytest.mark.parametrize("name", ["VCN_VC", "VCN_CN"])
def test_vcn_list_form_matches_jax(vcns, name):
    j, t = vcns[name]
    objs, boxes = _objects(1, (40, 150, 300, 90, 12, 500))          # 6 > BATCH_SIZE_LIMIT
    gt = boxes if name == "VCN_CN" else None
    got, ref = t.complete_list(objs, gt), j(objs, gtboxes=gt)
    assert sorted(got) == sorted(ref) == ["clustered", "coarse", "input", "surface"]
    for k in ref:
        assert got[k].shape == ref[k].shape == (6, OUT, 3)
    np.testing.assert_array_equal(got["input"], ref["input"])
    np.testing.assert_allclose(got["coarse"], ref["coarse"], atol=1e-3)
    for k in ("surface", "clustered"):
        for a, b in zip(got[k], ref[k]):
            _same_rows(a, b)
    if name == "VCN_CN":
        with pytest.raises(ValueError, match="boxes"):
            t.complete_list(objs)


def test_kitti_objects_match_jax(tree, tmp_path):
    _, infos, jdo, tdo = tree
    assert len(tdo) == len(jdo) == 2 and tdo.frames == jdo.frames
    for i in range(2):
        np.testing.assert_array_equal(tdo.get_pointcloud(i), jdo.get_pointcloud(i))
        np.testing.assert_array_equal(tdo.get_gt_boxes(i), jdo.get_gt_boxes(i))
        assert tdo.get_image_shape(i) == jdo.get_image_shape(i) == (375, 1242)
        got, ref = tdo.map_pointcloud_to_image(i), jdo.map_pointcloud_to_image(i)
        assert list(got) == list(ref) and got["img_shape"] == ref["img_shape"]
        for k in ("pc_lidar", "pc_cam", "pts_img", "fov_inds"):
            np.testing.assert_array_equal(got[k], ref[k])
        assert tdo.get_camera_instances(i) == jdo.get_camera_instances(i)
        assert len(tdo.get_camera_instances(i)) == 4
        assert tdo.get_save_fname(i) == jdo.get_save_fname(i)
    with open(tdo.update_infos(str(tmp_path / "t")), "rb") as f, \
            open(jdo.update_infos(str(tmp_path / "j")), "rb") as g:
        got, ref = pickle.load(f), pickle.load(g)
    assert [i["completed_lidar_path"] for i in got] == \
        [i["completed_lidar_path"] for i in ref] == ["vcn_t/000000.pcd", "vcn_t/000001.pcd"]
    assert pickle.dumps(got) == pickle.dumps(ref)


def test_gt_path_matches_jax(sees, tree):
    j, t = sees
    _, _, jdo, tdo = tree
    pts, boxes = tdo.get_pointcloud(0), tdo.get_gt_boxes(0)
    tp, tl = t.isolate_gt_pts(pts, boxes)
    jp, jl = j.isolate_gt_pts(pts, boxes)
    assert len(tp) == len(jp) == 4
    for a, b in zip(tp + tl, jp + jl):
        np.testing.assert_array_equal(a, b)
    assert t.isolate_gt_pts(pts, boxes[:0]) == ([], [])
    _same_completion(t.complete_gt_pts(tp, tl), j.complete_gt_pts(jp, jl))
    assert t.complete_gt_pts([], []) == {"all_instances": None}
    got, ref = t.process_gt_frame(pts, boxes), j.process_gt_frame(pts, boxes)
    n = len(j.complete_gt_pts(jp, jl)["all_instances"])
    _same_frame(got, ref, n)
    assert t.last_stats["isolated"] == t.last_stats["completed"] == 4
    assert t.last_stats["dropped"] == len(pts) - (len(got) - n) > 0


def test_det_path_matches_jax(sees, tree):
    j, t = sees
    for i in range(2):
        tproj, jproj = t.get_det_instances(i), j.get_det_instances(i)
        assert len(tproj) == len(jproj) == 1
        for k in ("img_uv", "cam_xyz", "lidar_xyz"):
            assert len(tproj[0][k]) == len(jproj[0][k]) == 4
            for a, b in zip(tproj[0][k], jproj[0][k]):
                np.testing.assert_array_equal(a, b)
        tinst, jinst = t.isolate_det_pts(tproj), j.isolate_det_pts(jproj)
        assert len(tinst) == len(jinst) > 0
        for a, b in zip(tinst, jinst):
            np.testing.assert_array_equal(a, b)
        comp = j.complete_det_pts(jinst)
        _same_completion(t.complete_det_pts(tinst), comp)
        got, ref = t.process_det_frame(i), j.process_det_frame(i)
        _same_frame(got, ref, len(comp["all_instances"]))
        n_scan = len(t.data_obj.get_pointcloud(i))
        assert t.last_stats["isolated"] == len(tinst) and t.last_stats["completed"] > 0
        assert t.last_stats["dropped"] == n_scan - (len(got) - len(comp["all_instances"]))


def test_isolation_subsamples_past_capacity(sees):
    """An instance of 3,000 points goes through RandomState(0).choice down
    to 2,048; one of 10 points or fewer is dropped before clustering."""
    j, t = sees
    rng = np.random.RandomState(4)
    big = (np.array([15.0, 2.0, -1.0]) + rng.randn(3000, 3) * [1.0, 0.5, 0.3]).astype(np.float32)
    far = (np.array([30.0, -6.0, -1.0]) + rng.randn(400, 3) * 0.4).astype(np.float32)
    tiny = rng.randn(10, 3).astype(np.float32)
    proj = [{"lidar_xyz": [big, tiny]}, {"lidar_xyz": [far]}]
    tinst, jinst = t.isolate_det_pts(proj), j.isolate_det_pts(proj)
    assert len(tinst) == len(jinst) == 2 and len(tinst[0]) <= 2048
    for a, b in zip(tinst, jinst):
        np.testing.assert_array_equal(a, b)
    assert t.isolate_det_pts([{"lidar_xyz": [tiny]}]) == j.isolate_det_pts(
        [{"lidar_xyz": [tiny]}]) == []


class _TwoCameras:
    camera_channels = ["image_2", "image_3"]


def test_multi_camera_merge_matches_jax(sees):
    """Two cameras' clusters of one car (sharing points) merge; a car seen
    by one camera and one farther than 3 m in range stay."""
    j, t = sees
    rng = np.random.RandomState(5)
    car = (np.array([12.0, 1.0, -1.0]) + rng.randn(400, 3) * [1.0, 0.4, 0.3]).astype(np.float32)
    other = (np.array([12.5, -6.0, -1.0]) + rng.randn(200, 3) * 0.4).astype(np.float32)
    far = (np.array([25.0, 1.0, -1.0]) + rng.randn(150, 3) * 0.4).astype(np.float32)
    inst = [car[:250], other, car[200:], far]
    got, ref = t.merge_multi_camera_detections(inst), j.merge_multi_camera_detections(inst)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    tdo, jdo = t.data_obj, j.data_obj
    t.data_obj = j.data_obj = _TwoCameras()
    try:
        _same_completion(t.complete_det_pts(inst), j.complete_det_pts(inst))
    finally:
        t.data_obj, j.data_obj = tdo, jdo


def test_replacement_matches_jax(sees):
    j, t = sees
    rng = np.random.RandomState(6)
    pts = rng.uniform(-5, 5, (5000, 4)).astype(np.float32)
    completed = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    got = t.replace_with_completed_pts(pts, completed)
    ref = j.replace_with_completed_pts(pts, completed)
    np.testing.assert_array_equal(got, ref)
    assert len(got) < len(pts) + 300 and t.last_stats["dropped"] == len(pts) + 300 - len(got)
    np.testing.assert_array_equal(t.replace_with_completed_pts(pts, None), pts[:, :3])


def test_seev1_matches_jax(sees):
    """SEE-v1's densification, its sampling rate from the box's range, and
    the GT path with USE_SEEV1."""
    j, t = sees
    rng = np.random.RandomState(7)
    pts = (rng.rand(60, 3) * [2.0, 1.0, 0.8]).astype(np.float32)
    for num_out, k in ((200, 4), (61, 2), (50, 4)):
        np.testing.assert_array_equal(TP.seev1_upsample(pts, num_out, k=k, seed=3),
                                      JP.seev1_upsample(pts, num_out, k=k, seed=3))
    box = np.array([14.0, 3.0, -1.0, 4.2, 1.8, 1.5, 0.3], np.float32)
    got = TP.seev1_sampling(pts, gt_box=box, seed=1)
    assert len(got) > len(pts)
    np.testing.assert_array_equal(got, JP.seev1_sampling(pts, gt_box=box, seed=1))
    np.testing.assert_array_equal(TP.seev1_sampling(pts), JP.seev1_sampling(pts))
    cfg = {**CFG, "SURFACE_COMPLETION": {"VRES": 0.4, "USE_SEEV1": True}}
    t1, j1 = TP.SEEVCN(cfg, device="cpu"), JP.SEEVCN(cfg)
    objs = [pts, (pts * 0.9 + 0.05).astype(np.float32)]
    boxes = [box, box + np.array([5, 0, 0, 0, 0, 0, 0], np.float32)]
    got, ref = t1.complete_gt_pts(objs, boxes), j1.complete_gt_pts(objs, boxes)
    for a, b in zip(got["clustered"], ref["clustered"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["all_instances"], ref["all_instances"])
