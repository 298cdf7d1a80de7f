"""The port's SEE frame (seevcn_torch.see.frame.complete_frame) against the
JAX chain that bench.py composes (see_stage -> vcn_stage -> replace_stage,
bench.py:172-212) at a small size: P = 4096, D = 4, a 96x128 image,
256-point instances resampled to 128, num_coarse = 128, cand_cap = 512 so
replacement takes its compacted branch. VCN weights are flax's, carried
across. The JAX replacement runs the TPU's path, the pruned Pallas kernel in
interpret mode; on the CPU it would take the Gram-form XLA sweep instead.

Also: the package imports nothing of JAX, and its entry points (the SEE
frame, the detector, the mask model and the fused frame) refuse to run on
the CPU unless asked to."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LIDAR_TO_CAM, make_scene
from seevcn_tpu.models.vcn.nets import build_vcn as jax_build_vcn
from seevcn_tpu.ops.clustering import largest_cluster_batch
from seevcn_tpu.ops.pallas.min_dist import min_sqdist as jax_min_sqdist
from seevcn_tpu.ops.sampling import partial_mesh_batch
from seevcn_tpu.see import device_pipeline as JDP
from seevcn_torch import resolve_device
from seevcn_torch.models.detectors.configs import tiny_detector_cfg
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.models.seg2d.backend import build_seg2d
from seevcn_torch.see.frame import (complete_frame, detect_stage, mask_stage,
                                    run_frame, see_and_detect)
from seevcn_torch.testing import assert_close, tiny_seg2d_cfg, to_numpy, to_torch
from seevcn_torch.utils.weights import vcn_state_dict_from_flax

P, D, IMG, M, OUT, CAP = 4096, 4, (96, 128), 256, 128, 512
# bench.py's KITTI-style camera scaled from 1280x384 to 128x96
PROJ = np.array([[72.0, 0, 64.0, 0], [0, 72.0, 47.5, 0], [0, 0, 1.0, 0]],
                np.float32)


def _pallas_within_radius(a, b, radius, b_valid=None, chunk=8192):
    d = jax_min_sqdist(jnp.asarray(a, jnp.float32)[:, :3],
                       jnp.asarray(b, jnp.float32)[:, :3], b_valid=b_valid,
                       interpret=True, prune_radius=float(radius))
    return d <= radius * radius


def jax_frame(scene, variables, model):
    """bench.py:172-212 with its arguments, at this test's sizes."""
    pts, v = jnp.asarray(scene["points"]), jnp.asarray(scene["valid"])
    cam_pts = pts @ jnp.asarray(LIDAR_TO_CAM).T
    member, core = JDP.mask_membership(
        cam_pts, v, jnp.asarray(PROJ), jnp.asarray(scene["det_boxes"]),
        jnp.asarray(scene["det_masks"]), jnp.asarray(scene["det_scores"]),
        score_thresh=0.0, mask_thresh=0.5, image_size=IMG, shrink_pct=3.0,
        core_shrink_pct=20.0)
    iso, ok = JDP.isolate_and_resample(pts, member, max_instance_pts=M,
                                       out_pts=OUT, core_membership=core)
    ret = model.apply(variables, {"input": iso})
    surface = partial_mesh_batch(iso, ret["coarse"], k=30, surface_pts=OUT)
    out = largest_cluster_batch(surface, eps=0.4, min_points=2, total_pts=OUT)
    sane = JDP.completion_sanity_mask(iso, out, jnp.ones(out.shape[0], bool))
    new_pts, new_valid = JDP.replace_with_completed(
        pts, v, out, ok & sane, point_dist_thresh=0.1, cand_cap=CAP)
    return new_pts, new_valid, {"ok": ok, "sane": sane, "completed": out}


def test_complete_frame_matches_jax_chain(monkeypatch):
    monkeypatch.setattr(JDP, "within_radius_mask", _pallas_within_radius)
    scene = make_scene(3, P, D, image_size=IMG, proj=PROJ, pts_per_car=300)
    model = jax_build_vcn("VCN_VC", num_coarse=OUT)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), {"input": jnp.zeros((D, OUT, 3))}))
    ref_pts, ref_valid, ref = jax_frame(scene, variables, model)

    vcn = VCNInference("VCN_VC", vcn_state_dict_from_flax(variables, "VCN_VC"),
                       num_points=OUT, device="cpu")
    t = {k: to_torch(v) for k, v in scene.items()}
    new_pts, new_valid, stats = complete_frame(
        t["points"], t["valid"], t["det_boxes"], t["det_masks"],
        t["det_scores"], vcn, to_torch(PROJ), to_torch(LIDAR_TO_CAM), IMG,
        max_instance_pts=M, out_pts=OUT, cand_cap=CAP, device="cpu")

    ref_iv = np.asarray(ref["ok"] & ref["sane"])
    assert_close(stats["inst_valid"], ref_iv, name="ok & sane")
    assert_close(stats["completed"], ref["completed"], atol=1e-3,
                 name="completed")
    # precondition: no scan point's distance to the completed cloud lies so
    # near 0.1 m that the completions' difference could move it across
    comp, rc = to_numpy(stats["completed"]), np.asarray(ref["completed"])
    shift = np.abs(comp - rc).max()
    flat = rc.reshape(-1, 3)[np.repeat(ref_iv, OUT)].astype(np.float64)
    dist = np.sqrt(((scene["points"][:, None] - flat[None]) ** 2).sum(-1)
                   ).min(1)
    assert not (np.abs(dist - 0.1) <= 2 * shift + 1e-6).any()

    assert_close(new_valid, np.asarray(ref_valid), name="new_valid")
    assert_close(new_pts, np.asarray(ref_pts), atol=1e-3, name="new_pts")
    assert ref_iv.any()                                  # real completions
    assert int((t["valid"] & ~new_valid[:P]).sum()) > 0  # and real drops


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import seevcn_torch\n"
        "for m in pkgutil.walk_packages(seevcn_torch.__path__, 'seevcn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'seevcn_tpu', 'cv2', 'PIL', 'matplotlib', "
        "'tensorflow')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('seevcn_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # ... and models.seg2d (the package, maskrcnn, backend), models.losses,
    # see.gt_completion, utils.ckpt, train (the package, optim, train), and
    # VCN training's cli (the package, train_vcn), geom.pcd_io,
    # models.vcn.{transforms,dataset,vc_shapenet,metrics,runner} and
    # utils.viz3d among them, and seg2d training's cli.train_seg2d,
    # models.seg2d.{synthetic,coco_eval} and ops.resize, and HTC's ops.dcn,
    # and PointPillar's models.modules.vfe, and CenterPoint's and Voxel
    # R-CNN's models.modules.center_head, models.detectors.{centerpoint,
    # voxelrcnn}, and the KITTI workflow's utils.native_io, see.{masks,
    # pipeline}, data.kitti.{see_adapter,bootstrap} and cli.{run_see,
    # generate_masks,create_infos,train_detector,test_detector}, and the other
    # domains' utils.shm_cache, data.{nuscenes,lyft,waymo}_{bootstrap,eval},
    # data.generic and data.see_adapters, and the demo's data.{jpeg,image,
    # demo_dataset,synth_da}, utils.{viz,profiling} and cli.demo, and the
    # experiments (the package, da_generate, train_vcn_da, train_vcn_synthetic,
    # da_experiment, da_table, measure_maskpath_impact); none of them reads
    # images or plots through cv2, PIL or matplotlib
    assert int(out.stdout.strip()) >= 127


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        VCNInference("VCN_VC", {}, num_points=OUT)
    z = torch.zeros((8, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        complete_frame(z, torch.ones(8, dtype=torch.bool), torch.zeros((1, 4)),
                       torch.zeros((1, 28, 28)), torch.ones(1), None,
                       to_torch(PROJ), to_torch(LIDAR_TO_CAM), IMG)
    cfg = tiny_detector_cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg)
    det, _ = build_detector(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_stage(det, cfg, z, torch.ones(8, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="CUDA"):
        see_and_detect(z, torch.ones(8, dtype=torch.bool), torch.zeros((1, 4)),
                       torch.zeros((1, 28, 28)), torch.ones(1), None,
                       to_torch(PROJ), to_torch(LIDAR_TO_CAM), det, cfg, IMG)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_seg2d(tiny_seg2d_cfg())
    seg = build_seg2d(tiny_seg2d_cfg(), device="cpu")
    image = torch.zeros((1, *IMG, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        mask_stage(seg, image)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_frame(image, z, torch.ones(8, dtype=torch.bool), seg, None, det, cfg,
                  to_torch(PROJ), to_torch(LIDAR_TO_CAM))
    assert resolve_device("cpu") == torch.device("cpu")
