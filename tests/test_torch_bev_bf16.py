"""BACKBONE_2D.DTYPE, the bf16 BEV backbone (seevcn_torch.models.modules.
backbone2d, detectors/second.py), against the JAX package on the CPU at
``_tiny_detector_cfg``.

As in JAX (flax's ``nn.Conv(dtype=bfloat16)``), the dtype is the convs'
compute dtype only: each conv's input and weight are cast to bf16 and its
output stays bf16; the batch norms run in f32 on f32 parameters and
statistics. Weights: a seeded state dict with random statistics carried
into flax by the JAX package's importer (as test_torch_detector.py).

Tolerances, bf16 (8 bits of mantissa; each conv's output is rounded to
bf16 in both frameworks, where their f32 sums may round apart): the BEV
backbone's eval output atol 2e-3, rtol 1e-3, where bf16 moves JAX's off
its f32 output by more than that (the f32 outputs agree to 1e-5); in the
detector, bf16 moves the boxes off the f32 run; the backbone's train step (batch-norm
statistics from the batch, a loss, its gradients, the running statistics'
update) on a BEV map of the tiny cfg's 256 channels, JAX run op by op:
outputs and running statistics 1e-2 of their tensor's largest; each
gradient's largest and median |difference| from JAX's bf16 gradient at
most 3/4 of JAX's bf16 gradient's own from its f32 gradient (bf16 alone
moves a gradient up to 0.56 of its largest off the f32 one, in both
frameworks; the port's sits at 0.0001-0.15 from JAX's). flax's batch
variance is E[x^2] - E[x]^2, the port's the mean squared deviation
(a pinned departure of the port).
CenterPoint ignores DTYPE as JAX's builder does: its outputs equal the f32
run's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_detector_cfg
from chip_smoke import blob_points, seeded_state_dict
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.modules.backbone2d import BaseBEVBackbone as JaxBEV
from seevcn_tpu.utils.ckpt_compat import detector_variables_from_torch
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.caddn import CaDDN
from seevcn_torch.models.detectors.centerpoint import CenterPoint
from seevcn_torch.models.detectors.pvrcnn import PVRCNN
from seevcn_torch.models.detectors.second import (PointPillar, SECONDNet, SECONDNetIoU,
                                                  build_detector)
from seevcn_torch.models.detectors.parta2 import PartA2
from seevcn_torch.models.detectors.voxelrcnn import VoxelRCNN
from seevcn_torch.testing import assert_close, to_torch
from seevcn_torch.utils.weights import detector_state_dict_from_flax

P = 600
BF16_ATOL, BF16_RTOL = 2e-3, 1e-3
# a bf16 backward is noise at the level of its own distance from the f32
# one; the port's must sit well inside that distance of JAX's
NOISE_SHARE = 0.75


@pytest.fixture(scope="module")
def weights():
    model, _ = build_detector(C.tiny_detector_cfg(), device="cpu")
    ref_sd = seeded_state_dict(0, model, random_stats=True)
    variables = jax.tree.map(np.asarray,
                             detector_variables_from_torch(ref_sd, "SECONDNetIoU"))
    frames = [blob_points(seed, P) for seed in (1, 2)]
    return variables, tuple(np.stack(x) for x in zip(*frames))


def _bf16(cfg):
    cfg.MODEL.BACKBONE_2D["DTYPE"] = "bfloat16"
    return cfg


def _jax_bev(dtype):
    b2 = _tiny_detector_cfg().MODEL.BACKBONE_2D
    return JaxBEV(tuple(b2.LAYER_NUMS), tuple(b2.LAYER_STRIDES), tuple(b2.NUM_FILTERS),
                  tuple(b2.UPSAMPLE_STRIDES), tuple(b2.NUM_UPSAMPLE_FILTERS), dtype=dtype)


def _bev_map(seed=7):
    """A BEV map of the tiny cfg's 256 channels, zero in most cells as a
    height-compressed sparse map is."""
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(2, 16, 16, 256).astype(np.float32), 0)
    x[rng.rand(2, 16, 16) < 0.7] = 0
    return x


def test_second_iou_bf16_bev_eval_matches_jax(weights):
    """SECOND-IoU's BEV backbone in eval with DTYPE bfloat16 against JAX's
    (op by op) on a BEV map; the port's whole detector with it moves its
    pre-NMS outputs off its f32 run (bf16 is on) and keeps them finite."""
    variables, (pts, valid) = weights
    sd = detector_state_dict_from_flax(variables)
    x = _bev_map()
    jv = {"params": variables["params"]["backbone_2d"],
          "batch_stats": variables["batch_stats"]["backbone_2d"]}
    ref = np.asarray(_jax_bev("bfloat16").apply(jv, jnp.asarray(x), train=False), np.float32)
    ref32 = np.asarray(_jax_bev(None).apply(jv, jnp.asarray(x), train=False), np.float32)
    outs = {}
    for name, c in (("bf16", _bf16(C.tiny_detector_cfg())), ("f32", C.tiny_detector_cfg())):
        det, _ = build_detector(c, sd, device="cpu")
        with torch.no_grad():
            outs[name] = (det.backbone_2d(torch.from_numpy(x)), det(to_torch(pts), to_torch(valid)))
    assert det.backbone_2d.compute_dtype is None
    got = outs["bf16"][0]
    assert got.dtype == torch.float32
    assert_close(got, ref, atol=BF16_ATOL, rtol=BF16_RTOL, name="bev2d")
    assert np.abs(ref - ref32).max() > BF16_ATOL          # JAX's bf16 is off its f32
    assert_close(outs["f32"][0], ref32, atol=1e-5, rtol=1e-5, name="bev2d f32")
    # the detector: bf16 is really on, and its outputs stay finite
    for k in ("spatial_features_2d", "batch_cls_preds", "batch_box_preds"):
        assert torch.isfinite(outs["bf16"][1][k]).all(), k
    gap = (outs["bf16"][1]["batch_box_preds"] - outs["f32"][1]["batch_box_preds"]).abs()
    assert gap.max() > 1e-4


def _rel(got, ref, frac, name):
    """|got - ref| at most ``frac`` of ref's largest element."""
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got.detach().numpy().astype(np.float32) - ref).max())
    assert err <= frac * scale, (name, err, scale)


def _within_bf16_noise(got, ref_bf16, ref_f32, name):
    """The port's bf16 gradient against JAX's: both its largest and its
    median |difference| at most NOISE_SHARE of the same statistic of JAX's
    bf16 gradient against its f32 one (plus 1e-6 of the tensor's largest)."""
    g = got.detach().numpy().astype(np.float32)
    rb, rf = np.asarray(ref_bf16, np.float32), np.asarray(ref_f32, np.float32)
    floor = 1e-6 * float(np.abs(rf).max())
    ours, noise = np.abs(g - rb), np.abs(rb - rf)
    for stat in (np.max, np.median):
        assert stat(ours) <= NOISE_SHARE * stat(noise) + floor, \
            (name, stat.__name__, float(stat(ours)), float(stat(noise)))


def test_bev_backbone_bf16_train_step_matches_jax(weights):
    """The tiny cfg's BEV backbone alone in training: a loss of its output,
    the gradients of its parameters and input, the running statistics."""
    variables, _ = weights
    jv = {"params": variables["params"]["backbone_2d"],
          "batch_stats": variables["batch_stats"]["backbone_2d"]}
    rng = np.random.RandomState(7)
    x = np.maximum(rng.randn(2, 16, 16, 256).astype(np.float32), 0)   # a sparse-ish BEV
    w = rng.randn(2, 16, 16, 64).astype(np.float32)
    ref = {}
    for dt in ("bfloat16", None):
        jmod = _jax_bev(dt)

        def loss_fn(params, xx, jmod=jmod):
            out, upd = jmod.apply({"params": params, "batch_stats": jv["batch_stats"]}, xx,
                                  train=True, mutable=["batch_stats"])
            return (out * w).sum(), (out, upd["batch_stats"])

        # op by op: under jit, XLA CPU may keep a bf16 conv's f32 result
        # (excess precision) where eager JAX and the port round it to bf16
        ref[dt] = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, jv["params"]), jnp.asarray(x))
    (jl, (jout, jstats)), (jgp, jgx) = ref["bfloat16"]
    (_, (_, fstats)), (fgp, fgx) = ref[None]
    det, _ = build_detector(_bf16(C.tiny_detector_cfg()), detector_state_dict_from_flax(variables),
                            device="cpu")
    bb = det.backbone_2d.train()
    assert bb.compute_dtype == torch.bfloat16
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bb(xt)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    assert out.dtype == torch.float32 and out.shape == jout.shape
    _rel(out, jout, 1e-2, "output")
    assert abs(loss.item() - float(jl)) <= 1e-2 * float(np.abs(np.asarray(jout) * w).sum())
    _within_bf16_noise(xt.grad, jgx, fgx, "input gradient")
    grads = {n: p.grad for n, p in bb.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all() for g in grads.values())
    # conv kernels: flax HWIO -> torch OIHW (deconv IOHW); BN scale / bias
    pairs = _flax_port_pairs(jgp, jstats, bb)
    f32 = _flax_port_pairs(fgp, fstats, bb)
    assert len(pairs) == len(grads) + 2 * sum(1 for n in dict(bb.named_buffers())
                                              if n.endswith("running_mean"))
    for (name, got, r_bf16), (_, _, r_f32) in zip(pairs, f32):
        if name.endswith(".grad"):
            _within_bf16_noise(got, r_bf16, r_f32, name)
        else:
            _rel(got, r_bf16, 1e-2, name)


def _flax_port_pairs(jgp, jstats, bb):
    """(name, the port's tensor, JAX's in the port's layout) for every
    parameter gradient and running statistic of the BEV backbone."""
    params, bufs = dict(bb.named_parameters()), dict(bb.named_buffers())
    out = []
    jgp = jax.tree.map(np.asarray, jgp)
    jstats = jax.tree.map(np.asarray, jstats)
    blocks = sorted(k for k in jgp if k.startswith("block"))
    levels = sorted({k.split("_")[0] for k in blocks})
    for li, lvl in enumerate(levels):
        names = [f"{lvl}_down"] + sorted((k for k in blocks if k.startswith(f"{lvl}_")
                                          and k != f"{lvl}_down"), key=lambda k: int(k.split("_")[1]))
        for ci, fname in enumerate(names):
            idx = 1 + 3 * ci                    # ZeroPad2d, then conv / bn / relu triples
            _pair(out, params, bufs, jgp[fname], jstats[fname], f"blocks.{li}.{idx}",
                  transpose=(3, 2, 0, 1))
        deconv = "deconv" in jgp[f"deblock{li}"]
        _pair(out, params, bufs, jgp[f"deblock{li}"], jstats[f"deblock{li}"],
              f"deblocks.{li}.0", transpose=(2, 3, 0, 1) if deconv else (3, 2, 0, 1))
    return out


def _pair(out, params, bufs, g, st, prefix, transpose):
    head, idx = prefix.rsplit(".", 1)
    bn = f"{head}.{int(idx) + 1}"
    if "deconv" in g:               # flax's ConvTranspose kernel, flipped (utils/weights.py)
        kernel = np.flip(g["deconv"]["kernel"], axis=(0, 1))
    else:
        kernel = g["conv"]["kernel"]
    out.append((f"{prefix}.weight.grad", params[f"{prefix}.weight"].grad,
                np.transpose(kernel, transpose)))
    out.append((f"{bn}.weight.grad", params[f"{bn}.weight"].grad, g["bn"]["scale"]))
    out.append((f"{bn}.bias.grad", params[f"{bn}.bias"].grad, g["bn"]["bias"]))
    out.append((f"{bn}.running_mean", bufs[f"{bn}.running_mean"], st["bn"]["mean"]))
    out.append((f"{bn}.running_var", bufs[f"{bn}.running_var"], st["bn"]["var"]))


def test_which_detectors_read_the_bev_dtype():
    """SECOND-IoU, SECONDNet and PointPillar pass DTYPE on, as their JAX
    builders do; PV-RCNN, Voxel R-CNN, Part-A2, CaDDN and CenterPoint ignore
    it, as theirs do. CenterPoint's outputs with DTYPE set equal its f32
    run's bit for bit."""
    assert SECONDNetIoU.BEV_DTYPE and SECONDNet.BEV_DTYPE and PointPillar.BEV_DTYPE
    assert not (PVRCNN.BEV_DTYPE or VoxelRCNN.BEV_DTYPE or PartA2.BEV_DTYPE
                or CaDDN.BEV_DTYPE or CenterPoint.BEV_DTYPE)
    pp, _ = build_detector(_bf16(C.tiny_pointpillar_cfg()), device="cpu")
    assert pp.backbone_2d.compute_dtype == torch.bfloat16
    pts, valid = blob_points(3)
    outs = []
    for c in (C.tiny_centerpoint_cfg(), _bf16(C.tiny_centerpoint_cfg())):
        det, _ = build_detector(c, device="cpu")
        assert det.backbone_2d.compute_dtype is None
        det.load_state_dict(seeded_state_dict(1, det, random_stats=True))
        with torch.no_grad():
            outs.append(det(to_torch(pts[None]), to_torch(valid[None])))
    for k in ("batch_cls_preds", "batch_box_preds"):
        assert torch.equal(outs[0][k], outs[1][k]), k
