"""Full SECOND-IoU train steps of the port (seevcn_torch.train.train) against
the JAX package's ``make_train_step`` (donate=False) on the CPU, at
``_tiny_detector_cfg`` with DP_RATIO 0, under BACKBONE_3D MODE ``sparse``
(the rulebook, which the port runs too) and ``zfold`` (a TPU lowering of
the same math), OPTIMIZATION as the config has it (adam_onecycle, lr 0.003,
weight decay 0.01, clip at 10).

Weights: chip_smoke.seeded_state_dict with random statistics, carried into
flax by the JAX importer. Inputs: two frames of point blobs
(chip_smoke.blob_points) with ground-truth cars on them. The RoI sampler's
priorities are JAX's own draws (``jax.random.uniform`` of the step's key),
passed to the port as ``roi_u``. The gradients of the JAX step come from
the same loss function under ``jax.value_and_grad``, mapped to the port's
keys by the flax exporter.

Tolerances, each stated at its assertion:
- loss terms: 1e-5 absolute and relative (f32 sums in another order);
- gradients: 5e-4 of the tensor's largest |gradient| (a deep backward in
  another summation order);
- the optimizer alone, the port's and optax's fed the same gradients (JAX's)
  for two steps: every updated parameter within 1e-7 + 2.5e-7 of its
  magnitude (two f32 ulps);
- the whole step: each updated parameter within 1e-5 of JAX's where its
  gradient is sure, at least 5% of its tensor's largest |gradient| and 1e-6
  after clipping in every step so far; elsewhere within 2 lr a step. Adam's
  first update is lr g / (|g| + 1e-8), so an element whose gradient is
  rounding noise (the same in both to 5e-4 of the largest, but of either
  sign) may step +lr in one and -lr in the other;
- running statistics: 1e-5 absolute and relative.
The second step starts from weights that differ by those noise steps, so
its loss terms are held to 1e-4, its gradients to 5e-3 of the largest and
its running statistics to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_detector_cfg
from chip_smoke import blob_points, seeded_state_dict
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.train.train import create_train_state as jax_train_state
from seevcn_tpu.train.train import make_train_step
from seevcn_tpu.utils.ckpt_compat import detector_variables_from_torch
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.testing import assert_close, to_numpy
from seevcn_torch.train.train import (apply_gradients, create_train_state,
                                      train_forward, train_step)
from seevcn_torch.utils.weights import detector_state_dict_from_flax

B, TOTAL, VOXELS = 2, 100, 512
TERMS = ("loss", "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss",
         "rcnn_loss_iou")


def _cfg(dp=0.0):
    cfg = C.tiny_detector_cfg()
    cfg.MODEL.ROI_HEAD.DP_RATIO = dp
    return cfg


def _inputs():
    frames = [blob_points(seed, 600) for seed in (1, 2)]
    gt = np.zeros((B, 4, 8), np.float32)
    gt[:, 0] = [8.0, 0.0, -0.5, 4.0, 1.8, 1.5, 0.3, 1.0]
    gt[0, 1] = [5.0, 3.0, -0.5, 4.0, 1.8, 1.5, 1.3, 1.0]
    gt[1, 1] = [11.0, -4.0, -0.3, 3.9, 1.7, 1.5, -0.4, 1.0]
    return (np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
            gt)


def _port_keys(sd):
    """A state dict in the exporter's key layout (a Dropout at index 3 of
    each FC stack) -> the DP_RATIO 0 model's, whose stacks have none."""
    keys = list(build_detector(_cfg(0.3), device="cpu")[0].state_dict())
    keys0 = list(build_detector(_cfg(), device="cpu")[0].state_dict())
    return {k0: sd[k] for k, k0 in zip(keys, keys0)}


def _flax_to_port(params, stats):
    return _port_keys(detector_state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": stats})))


@pytest.fixture(scope="module", params=["sparse", "zfold"])
def runs(request):
    """Two steps of each side from the same weights; for each step the
    losses, gradients (before clipping) and the state after it."""
    ref_sd = seeded_state_dict(0, build_detector(_cfg(), device="cpu")[0],
                               random_stats=True)
    variables = jax.tree.map(jnp.asarray,
                             detector_variables_from_torch(ref_sd, "SECONDNetIoU"))
    pts, valid, gt = _inputs()
    cfg = _tiny_detector_cfg()
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    cfg.MODEL.BACKBONE_3D["MODE"] = request.param
    jm, _ = jax_build(cfg, max_voxels=VOXELS)
    rng = jax.random.PRNGKey(7)
    n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)

    @jax.jit
    def grads_and_u(params, stats, step):
        # make_train_step's loss function, with the gradients returned
        sample_rng, dropout_rng = jax.random.split(jax.random.fold_in(rng, step))

        def loss_fn(params):
            out, _ = jm.apply({"params": params, "batch_stats": stats}, pts, valid,
                              gt_boxes=gt, train=True, rng=sample_rng,
                              rngs={"dropout": dropout_rng}, mutable=["batch_stats"])
            return jm.loss(out, gt)[0]

        u = jax.vmap(lambda r: jax.random.uniform(r, (n_rois,)))(
            jax.random.split(sample_rng, B))
        return jax.grad(loss_fn)(params), u

    jstep = make_train_step(jm, donate=False)
    jstate = jax_train_state(jm, variables, cfg.OPTIMIZATION, TOTAL)
    model, _ = build_detector(_cfg(), ref_sd, max_voxels=VOXELS, device="cpu")
    state = create_train_state(model, cfg.OPTIMIZATION, TOTAL)
    # the optimizers alone: optax's and the port's, fed the same gradients
    japply = jax.jit(lambda st, g: st.apply_gradients(g, st.batch_stats))
    jopt = jax_train_state(jm, variables, cfg.OPTIMIZATION, TOTAL)
    omodel, _ = build_detector(_cfg(), ref_sd, max_voxels=VOXELS, device="cpu")
    ostate = create_train_state(omodel, cfg.OPTIMIZATION, TOTAL)
    steps = []
    for k in range(2):
        jgrads, u = grads_and_u(jstate.params, jstate.batch_stats, k)
        jstate_next, jmetrics = jstep(jstate, pts, valid, gt, rng)
        jopt = japply(jopt, jgrads)
        port_jgrads = _flax_to_port(jgrads, jstate.batch_stats)
        for n, p in omodel.named_parameters():
            p.grad = port_jgrads[n].clone()
        ostate.optimizer.step(k)
        loss, tb, out = train_forward(state, torch.from_numpy(pts),
                                      torch.from_numpy(valid), torch.from_numpy(gt),
                                      roi_u=torch.from_numpy(np.array(u)))
        state.optimizer.zero_grad()
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        state.optimizer.step(state.step)
        state.step += 1
        steps.append({
            "jax_metrics": jax.tree.map(np.asarray, jmetrics),
            "metrics": {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}},
            "jax_grads": port_jgrads,
            "opt": {n: p.detach().clone() for n, p in omodel.named_parameters()},
            "jax_opt": _flax_to_port(jopt.params, jopt.batch_stats),
            "clip": 10 / float(torch.sqrt(sum((g ** 2).sum()
                                              for g in port_jgrads.values()))),
            "grads": grads,
            "jax_before": _flax_to_port(jstate.params, jstate.batch_stats),
            "jax_after": _flax_to_port(jstate_next.params, jstate_next.batch_stats),
            "after": {k: v.clone() for k, v in model.state_dict().items()},
            "samples": int(out["rcnn_targets"]["roi_sample_mask"].sum()),
            "lr": state.optimizer.lr_schedule(k)})
        jstate = jstate_next
    return steps


def _sure(steps, n):
    """Elements of parameter n whose gradient was sure in every step."""
    sure = True
    for s in steps:
        g = s["jax_grads"][n].abs()
        sure = sure & (g >= 0.05 * g.max()) & (g * min(s["clip"], 1.0) >= 1e-6)
    return sure


def _check_steps(steps, loss_tol, grad_tol, stat_tol):
    s = steps[-1]
    for k in TERMS:
        assert_close(s["metrics"][k], s["jax_metrics"][k], atol=loss_tol,
                     rtol=loss_tol, name=k)
    for n, g in s["grads"].items():
        ref = s["jax_grads"][n]
        assert_close(g, ref, atol=grad_tol * float(ref.abs().max()) + 1e-9,
                     name=f"grad {n}")
    lr = sum(x["lr"] for x in steps)
    for n, v in s["after"].items():
        ref = s["jax_after"][n]
        if n.endswith("num_batches_tracked"):
            continue
        if n not in s["grads"]:           # running statistics
            assert_close(v, ref, atol=stat_tol, rtol=stat_tol, name=n)
            continue
        sure = _sure(steps, n)
        assert_close(v[sure], ref[sure], atol=1e-5, name=f"updated {n}")
        assert_close(v, ref, atol=2 * lr, name=f"updated {n} (all)")
        assert not torch.equal(v, s["jax_before"][n])


def test_one_train_step_matches_jax(runs):
    s = runs[0]
    assert s["samples"] > 0
    assert float(s["metrics"]["rcnn_loss_iou"]) > 0
    _check_steps(runs[:1], 1e-5, 5e-4, 1e-5)


def test_two_train_steps_match_jax(runs):
    _check_steps(runs, 1e-4, 5e-3, 1e-4)


@pytest.mark.parametrize("step", [0, 1])
def test_optimizer_matches_optax_on_the_same_gradients(runs, step):
    """The update alone, two steps (moments, bias corrections, the b1 and lr
    schedules, weight decay and the clip): the port's optimizer and optax's,
    fed the same gradients, within 1e-7 and two f32 ulps."""
    s = runs[step]
    for n, v in s["opt"].items():
        assert_close(v, s["jax_opt"][n], atol=1e-7, rtol=2.5e-7, name=n)


def test_dropout_active_in_training_only():
    """DP_RATIO 0.3: the IoU head's dropout draws from the step's generator
    in training (two draws differ, one seed repeats) and is off in eval."""
    cfg = _cfg(0.3)
    model, _ = build_detector(cfg, max_voxels=VOXELS, device="cpu")
    head = model.roi_head
    pooled = torch.randn((B, 4, 7, 7, head.shared_fc_layer[0].in_channels // 49),
                         generator=torch.Generator().manual_seed(0))
    head.train()
    a = head(pooled, torch.Generator().manual_seed(1))
    b = head(pooled, torch.Generator().manual_seed(2))
    c = head(pooled, torch.Generator().manual_seed(1))
    assert not torch.equal(a, b) and torch.equal(a, c)
    head.eval()
    with torch.no_grad():
        assert torch.equal(head(pooled, torch.Generator().manual_seed(1)),
                           head(pooled, torch.Generator().manual_seed(2)))
    # and the whole step runs with it, its metrics finite
    state = create_train_state(model, cfg.OPTIMIZATION, TOTAL)
    pts, valid, gt = (torch.from_numpy(x) for x in _inputs())
    metrics = train_step(state, pts, valid, gt, torch.Generator().manual_seed(3))
    assert all(np.isfinite(to_numpy(v)) for v in metrics.values())
    assert state.step == 1 and model.training


def test_gradients_are_clipped_to_the_global_norm():
    """GRAD_NORM_CLIP 10: every gradient scaled by 10 / |g| (the global
    norm, no epsilon), within 1e-6 (relative)."""
    cfg = _cfg()
    model, _ = build_detector(cfg, max_voxels=VOXELS, device="cpu")
    state = create_train_state(model, cfg.OPTIMIZATION, TOTAL)
    pts, valid, gt = (torch.from_numpy(x) for x in _inputs())
    loss, _, _ = train_forward(state, pts, valid, gt, torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(loss, list(model.parameters()), retain_graph=True)
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    apply_gradients(state, loss)
    assert float(norm) > 10
    for g, p in zip(grads, model.parameters()):
        assert_close(p.grad, g * (10 / norm), atol=1e-9, rtol=1e-6, name="clipped")
