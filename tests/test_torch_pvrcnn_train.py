"""PV-RCNN's training in the port (seevcn_torch.models.modules.pvrcnn_head's
losses, PVRCNN.loss, seevcn_torch.train.train) against the JAX package on
the CPU, at ``tiny_pvrcnn_cfg`` with DP_RATIO 0.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init, carried into the port by ``pvrcnn_state_dict_from_flax``. Inputs:
chip_smoke.pvrcnn_train_inputs, the two blob frames of tiny_train_inputs
with ground-truth cars on them, two of them near training proposals so
that the RoI sample has foreground. The RoI sampler's priorities are JAX's own draws, passed to the
port as ``roi_u``; JAX's gradients come from its train step's loss function
under ``jax.value_and_grad``.

Tolerances, as tests/test_torch_train_step.py holds SECOND-IoU's step:
loss terms 1e-5 (absolute and relative); gradients 5e-4 of the tensor's
largest |gradient|; updated parameters within 1e-5 of JAX's where the
gradient is sure (at least 5% of its tensor's largest and 1e-6 after the
clip), elsewhere within 2 lr (Adam's first step is lr g / (|g| + 1e-8));
running statistics 1e-5 (absolute and relative); the second step starts
from JAX's first-step weights and is held to the same. The losses alone:
1e-5 (relative), their gradients 1e-5 of the largest. The port runs its
steps in f64 against JAX's f32 (JAX's sparse convs pin f32); its own f32
step is held against its f64 step at the f32 error stated there.
"""
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pvrcnn_train_inputs, tiny_train_inputs
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.modules import pfe as JPFE
from seevcn_tpu.models.modules import pvrcnn_head as JH
from seevcn_tpu.train.train import create_train_state as jax_train_state
from seevcn_tpu.train.train import make_train_step
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.models.modules import pvrcnn_head as H
from seevcn_torch.models.modules import roi_heads as RH
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy
from seevcn_torch.train.train import create_train_state, train_forward
from seevcn_torch.utils.config import Cfg
from seevcn_torch.utils.weights import pvrcnn_state_dict_from_flax

B, TOTAL = 2, 100
TERMS = ("loss", "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss",
         "point_loss_cls", "rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner",
         "rcnn_loss")
LOSS_CFG = Cfg({"CORNER_LOSS_REGULARIZATION": True,
                "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 2.0,
                                 "rcnn_corner_weight": 0.5,
                                 "code_weights": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5]}})


def _cfg(dp=0.0):
    cfg = C.tiny_pvrcnn_cfg()
    cfg.MODEL.ROI_HEAD.DP_RATIO = dp
    return cfg


# --- the losses alone --------------------------------------------------------


def _rois_and_gt(seed):
    rng = np.random.RandomState(seed)
    gt = np.concatenate([rng.uniform(-10, 10, (2, 6, 3)), rng.uniform(1, 4, (2, 6, 3)),
                         rng.uniform(-np.pi, np.pi, (2, 6, 1)), np.ones((2, 6, 1))], -1)
    jitter = rng.randn(2, 6, 7) * [0.3, 0.3, 0.1, 0.2, 0.1, 0.1, 0.4]
    rois = gt[..., :7] + jitter
    rois[..., 6] += rng.choice([0, np.pi, -2 * np.pi], (2, 6))   # opposite, wrapped
    rois[..., 3:6] = np.abs(rois[..., 3:6])
    return rois.astype(np.float32), gt.astype(np.float32)


def test_canonical_gt_of_rois_matches_jax():
    rois, gt = _rois_and_gt(0)
    got = H.canonical_gt_of_rois(torch.from_numpy(rois), torch.from_numpy(gt))
    ref = np.asarray(JH.canonical_gt_of_rois(jnp.asarray(rois), jnp.asarray(gt)))
    assert_close(got, ref, atol=1e-5, rtol=1e-5, name="canonical gt")
    assert (np.abs(ref[..., 6]) <= np.pi / 2 + 1e-6).all()


def test_point_head_loss_matches_jax():
    rng = np.random.RandomState(1)
    kp = rng.uniform(-6, 6, (2, 200, 3)).astype(np.float32)
    logits = rng.randn(2, 200).astype(np.float32)
    _, gt = _rois_and_gt(1)
    gt[..., :2] *= 0.4
    gt[1, 4:] = 0.0                                     # padding rows
    mask = np.abs(gt).sum(-1) > 0
    args = [logits, kp, gt, mask]
    ref, ref_g = jax.value_and_grad(lambda lg: JH.point_head_loss(
        lg, *(jnp.asarray(a) for a in args[1:]), (0.2, 0.2, 0.2)))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = H.point_head_loss(lg, *(torch.from_numpy(a) for a in args[1:]), (0.2, 0.2, 0.2))
    got.backward()
    assert_close(got, np.asarray(ref), rtol=1e-5, name="point loss")
    assert_close(lg.grad, np.asarray(ref_g), atol=1e-5 * float(np.abs(ref_g).max()),
                 name="its gradient")
    assert float(ref) > 0


def test_pvrcnn_rcnn_loss_matches_jax():
    """BCE on RoI-IoU labels (some ignored), canonical smooth-l1 over the
    foreground and the corner loss, at non-unit weights; the value and the
    gradients of both head outputs."""
    rois, gt = _rois_and_gt(2)
    rng = np.random.RandomState(3)
    targets = {"rois": rois, "gt_of_rois": gt,
               "rcnn_cls_labels": np.where(rng.rand(2, 6) < 0.2, -1.0,
                                           rng.rand(2, 6)).astype(np.float32),
               "reg_valid_mask": rng.rand(2, 6) < 0.6}
    cls = rng.randn(2, 6).astype(np.float32)
    reg = (0.2 * rng.randn(2, 6, 7)).astype(np.float32)

    def jax_loss(c, r):
        total, tb = JH.pvrcnn_rcnn_loss(c, r, {k: jnp.asarray(v) for k, v in targets.items()},
                                        LOSS_CFG)
        return total, tb

    (ref, ref_tb), (gc, gr) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                 has_aux=True)(jnp.asarray(cls),
                                                               jnp.asarray(reg))
    c = torch.from_numpy(cls).requires_grad_()
    r = torch.from_numpy(reg).requires_grad_()
    got, tb = H.pvrcnn_rcnn_loss(c, r, {k: torch.from_numpy(np.asarray(v))
                                        for k, v in targets.items()}, LOSS_CFG)
    got.backward()
    for k in ("rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner", "rcnn_loss"):
        assert_close(tb[k], np.asarray(ref_tb[k]), rtol=1e-5, name=k)
    assert_close(c.grad, np.asarray(gc), atol=1e-5 * float(np.abs(gc).max()), name="d cls")
    assert_close(r.grad, np.asarray(gr), atol=1e-5 * float(np.abs(gr).max()), name="d reg")
    assert float(ref_tb["rcnn_loss_corner"]) > 0


def test_dropout_only_between_the_shared_layers():
    """DP_RATIO 0.3 in training: both rcnn heads draw one dropout mask, in
    the shared stack, as the JAX package does (its SECONDHead and PVRCNNHead
    have none in their branches). Each head's output equals the stack run by
    hand with that one mask from the same generator; before the repair,
    SECONDHead drew a second mask in its IoU branch and read otherwise."""
    gen = lambda: torch.Generator().manual_seed(11)        # noqa: E731
    second, _ = build_detector(C.tiny_detector_cfg(), device="cpu")
    pv, _ = build_detector(_cfg(0.3), device="cpu")
    for head, branches in ((second.roi_head, ("iou_layers",)),
                           (pv.roi_head, ("cls_layers", "reg_layers"))):
        head.train()
        shared = head.shared_fc_layer
        cin = shared[0].in_channels
        if head is second.roi_head:
            x = torch.randn((2, 3, 7, 7, cin // 49), generator=torch.Generator().manual_seed(0))
            flat = x.permute(0, 1, 4, 2, 3).reshape(6, cin, 1)
        else:
            x = torch.randn((2, 3, 27, cin // 27), generator=torch.Generator().manual_seed(0))
            flat = x.permute(0, 1, 3, 2).reshape(6, cin, 1)
        with torch.no_grad():
            got = head(x, gen()) if head is second.roi_head else head.head(x, gen())
            g, y = gen(), flat
            for layer in shared:
                y = RH.dropout(y, layer.p, g) if isinstance(layer, torch.nn.Dropout) \
                    else layer(y)
            outs = [getattr(head, b)(y) for b in branches]
        want = outs[0].reshape(2, 3) if len(outs) == 1 else \
            (outs[0].reshape(2, 3), outs[1].reshape(2, 3, 7))
        if isinstance(got, tuple):
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        else:
            assert torch.equal(got, want)
        assert not any(isinstance(m, torch.nn.Dropout) for b in branches
                       for m in getattr(head, b))


# --- train steps against make_train_step ----------------------------------------


def _port_keys(sd):
    """The exporter's key layout (a slot at index 3 of each FC stack,
    DP_RATIO > 0) -> the DP_RATIO 0 model's, whose stacks have none."""
    keys = list(build_detector(_cfg(0.3), device="cpu")[0].state_dict())
    keys0 = list(build_detector(_cfg(), device="cpu")[0].state_dict())
    return {k0: sd[k] for k, k0 in zip(keys, keys0)}


def _flax_to_port(params, stats):
    return _port_keys(pvrcnn_state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": stats})))


@contextlib.contextmanager
def _argmax_routed_max_pool():
    """Within the block, JAX's VSA and RoI-grid pool max-pool through the
    argmax: the same values, the gradient sent to the first maximum.

    JAX's jitted gradient of ``masked_max_pool`` after a batch norm in
    training is wrong on XLA CPU: reduce_max's VJP routes the cotangent to
    the slots equal to the max, recomputed in another fusion, where the
    batch norm's rsqrt rounds differently, so some groups lose their
    gradient (jitted 1.18, eager and finite differences -1.84 on one
    element of the tiny SA MLP's input; ROADMAP §3). Eager JAX and the port
    agree; the argmax form needs no equality and is what the reference
    computes (ties apart, which only ReLU zeros reach, whose gradient is 0)."""
    plain = JPFE.masked_max_pool

    def routed(x, valid):
        neg = jnp.where(valid[..., None], x, -jnp.inf)
        i = jnp.argmax(neg, axis=1)
        out = jnp.take_along_axis(neg, i[:, None, :], axis=1)[:, 0]
        return jnp.where(jnp.isfinite(out), out, 0.0)

    JPFE.masked_max_pool = routed
    try:
        yield
    finally:
        JPFE.masked_max_pool = plain


def _port_step(state, pts, valid, gt, u, dtype):
    """One port step in ``dtype``: -> (metrics, gradients before the clip,
    the RoI sample's foreground and size)."""
    cast = lambda a: torch.from_numpy(np.array(a)).to(dtype)     # noqa: E731
    loss, tb, out = train_forward(state, cast(pts), torch.from_numpy(valid),
                                  cast(gt), roi_u=cast(u))
    state.optimizer.zero_grad()
    loss.backward()
    grads = {n: p.grad.double().clone() for n, p in state.model.named_parameters()}
    state.optimizer.step(state.step)
    state.step += 1
    tg = out["rcnn_targets"]
    return ({"loss": loss.detach().double(),
             **{k: v.detach().double() for k, v in tb.items()}}, grads,
            int((tg["roi_sample_mask"] & tg["reg_valid_mask"]).sum()),
            int(tg["roi_sample_mask"].sum()))


@pytest.fixture(scope="module")
def runs():
    """Two steps of JAX's ``make_train_step`` (jitted, BACKBONE_3D MODE
    sparse, the max-pool routed by its argmax) and of the port in f64 from
    the same weights, and the port's first step in f32; for each step the
    losses, gradients (before clipping) and the state after it."""
    cfg = jcfg = _cfg()
    jm, _ = jax_build(jcfg)
    p0, v0 = (to_numpy(t) for t in tiny_train_inputs("cpu")[:2])
    shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                 p, v, train=False),
                            jnp.asarray(p0), jnp.asarray(v0))
    variables = seeded_flax_variables(shapes, seed=3)
    sd = _flax_to_port(variables["params"], variables["batch_stats"])
    pts, valid, gt = pvrcnn_train_inputs(cfg, sd)
    rng = jax.random.PRNGKey(7)
    n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)

    scfg = _cfg()
    scfg.MODEL.BACKBONE_3D["MODE"] = "sparse"
    sm, _ = jax_build(scfg)

    def grads_and_u(model):
        @jax.jit
        def run(params, stats, step):
            # make_train_step's loss function, with the gradients returned
            sample_rng, dropout_rng = jax.random.split(jax.random.fold_in(rng, step))

            def loss_fn(params):
                out, _ = model.apply({"params": params, "batch_stats": stats}, pts,
                                     valid, gt_boxes=gt, train=True, rng=sample_rng,
                                     rngs={"dropout": dropout_rng},
                                     mutable=["batch_stats"])
                return model.loss(out, gt)[0]

            u = jax.vmap(lambda r: jax.random.uniform(r, (n_rois,)))(
                jax.random.split(sample_rng, B))
            return jax.grad(loss_fn)(params), u
        return run

    grads_default, grads_rulebook = grads_and_u(jm), grads_and_u(sm)

    jstep = make_train_step(jm, donate=False)
    jstate = jax_train_state(jm, jax.tree.map(jnp.asarray, variables),
                             jcfg.OPTIMIZATION, TOTAL)
    states = {}
    for dtype in (torch.float64, torch.float32):
        model, _ = build_detector(cfg, sd, device="cpu")
        states[dtype] = create_train_state(model.to(dtype), cfg.OPTIMIZATION, TOTAL)
    steps = []
    with _argmax_routed_max_pool():
        for k in range(2):
            jgrads, u = grads_default(jstate.params, jstate.batch_stats, k)
            jstate_next, jmetrics = jstep(jstate, pts, valid, gt, rng)
            port_jgrads = _flax_to_port(jgrads, jstate.batch_stats)
            rulebook = _flax_to_port(grads_rulebook(jstate.params, jstate.batch_stats,
                                                    k)[0], jstate.batch_stats)
            metrics, grads, fg, samples = _port_step(states[torch.float64], pts, valid,
                                                     gt, u, torch.float64)
            step = {
                "jax_metrics": jax.tree.map(np.asarray, jmetrics),
                "metrics": metrics, "grads": grads, "jax_grads": port_jgrads,
                "jax_grads_rulebook": rulebook,
                "clip": 10 / float(torch.sqrt(sum((g ** 2).sum()
                                                  for g in port_jgrads.values()))),
                "jax_before": _flax_to_port(jstate.params, jstate.batch_stats),
                "jax_after": _flax_to_port(jstate_next.params, jstate_next.batch_stats),
                "after": {k: v.clone() for k, v in
                          states[torch.float64].model.state_dict().items()},
                "fg": fg, "samples": samples, "lr": states[torch.float64].optimizer.lr_schedule(k)}
            if k == 0:
                step["f32"] = _port_step(states[torch.float32], pts, valid, gt, u,
                                         torch.float32)
                # the second step starts from JAX's weights and statistics (the
                # port's optimizer state kept), so that Adam's noise steps of
                # the first (2 lr on a gradient that is rounding noise) do not
                # move its forward
                states[torch.float64].model.load_state_dict(
                    {n: v.double() if v.is_floating_point() else v
                     for n, v in step["jax_after"].items()})
            steps.append(step)
            jstate = jstate_next
    return steps


def _sure(steps, n):
    """Elements of parameter n whose gradient was sure in every step."""
    sure = True
    for s in steps:
        g = s["jax_grads"][n].abs()
        sure = sure & (g >= 0.05 * g.max()) & (g * min(s["clip"], 1.0) >= 1e-6)
    return sure


def _check_steps(steps, loss_tol, grad_tol, stat_tol, sure_tol=1e-5):
    s = steps[-1]
    for k in TERMS:
        assert_close(s["metrics"][k], s["jax_metrics"][k], atol=loss_tol,
                     rtol=loss_tol, name=k)
    for n, g in s["grads"].items():
        # JAX's default (hybrid) lowering of the 3D backbone and its rulebook
        # one differ after a step: each tensor must meet one of the two
        errs = []
        for key in ("jax_grads", "jax_grads_rulebook"):
            ref = s[key][n]
            try:
                assert_close(g, ref, atol=grad_tol * float(ref.abs().max()) + 1e-9,
                             name=f"grad {n} ({key})")
                break
            except AssertionError as e:
                errs.append(str(e))
        else:
            raise AssertionError("; ".join(errs))
    lr = sum(x["lr"] for x in steps)
    for n, v in s["after"].items():
        ref = s["jax_after"][n]
        if n.endswith("num_batches_tracked"):
            continue
        if n not in s["grads"]:           # running statistics
            assert_close(v, ref, atol=stat_tol, rtol=stat_tol, name=n)
            continue
        if sure_tol is not None:
            sure = _sure(steps, n)
            assert_close(v[sure], ref[sure], atol=sure_tol, name=f"updated {n}")
        assert_close(v, ref, atol=2 * lr, name=f"updated {n} (all)")
        assert not torch.equal(v.float(), s["jax_before"][n])


def test_one_train_step_matches_jax(runs):
    """The port's step in f64 against JAX's in f32 (JAX's sparse convs pin
    f32, so it has no f64 step): JAX's f32 error is the whole difference."""
    s = runs[0]
    assert s["samples"] > 0 and s["fg"] > 0
    for k in ("point_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner"):
        assert float(s["metrics"][k]) > 0, k
    _check_steps(runs[:1], 1e-5, 5e-4, 1e-5)


def test_two_train_steps_match_jax(runs):
    """The second step, from JAX's first-step state with the port's own
    optimizer state: the first step's tolerances. At these weights JAX's
    two lowerings of the sparse backbone, its default (hybrid) and its
    rulebook, read gradients of the 3D backbone's first stages up to 0.6%
    apart (the port meets its rulebook lowering within 4e-6 there, and
    every other tensor of both); each gradient is held against either.
    Adam's moments carry each side's own first gradients, so the updated
    parameters are held within 2 lr (the first step's bound elsewhere)."""
    _check_steps(runs, 1e-5, 5e-4, 1e-5, sure_tol=None)
    assert all(math.isfinite(float(v)) for v in runs[-1]["metrics"].values())


def test_f32_train_step_matches_f64(runs):
    """The port's f32 step against its f64 step, the same sample: loss terms
    within 5e-5 (relative) and gradients within 1e-3 of the tensor's
    largest. An f32 training forward of this model strays so far from
    exact: the RPN's training-mode batch norms carry 1e-5 (relative) into
    the RoIs, whose grid points move by 2e-4 m; JAX's own f32 gradients
    stray up to 3.7e-4 of the largest from the port's f64 ones."""
    s = runs[0]
    metrics, grads, fg, samples = s["f32"]
    assert (fg, samples) == (s["fg"], s["samples"])
    for k in TERMS:
        assert_close(metrics[k], s["metrics"][k], atol=1e-6, rtol=5e-5, name=k)
    for n, g in grads.items():
        ref = s["grads"][n]
        assert_close(g, ref, atol=1e-3 * float(ref.abs().max()) + 1e-9, name=f"grad {n}")
