"""PV-RCNN++'s training in the port (PVRCNNPlusPlus in training mode, its
loss, seevcn_torch.train.train) against the JAX package on the CPU, at
``tiny_pvrcnn_plusplus_cfg`` (SPC + VectorPool, the full config's topology)
with DP_RATIO 0.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init, carried into the port by ``pvrcnn_state_dict_from_flax``. Inputs:
chip_smoke.pvrcnn_train_inputs, two blob frames with ground-truth cars, two
of them near training proposals so that the RoI sample has foreground. The
RoI sampler's priorities are JAX's own draws, passed to the port as
``roi_u``, so the sample, and with it the keypoints that SPC draws near it,
is JAX's.

Tolerances, as tests/test_torch_pvrcnn_train.py holds PV-RCNN's step: loss
terms 1e-5 (absolute and relative); gradients 5e-4 of the tensor's largest
|gradient|; updated parameters within 1e-5 of JAX's where the gradient is
sure, elsewhere within 2 lr; running statistics 1e-5. The port runs its step
in f64 against JAX's f32 (JAX's sparse convs pin f32), so JAX's f32 error is
the whole difference, and its size depends on the weights. Weights come from
seed 4. Over seeds 0-5 JAX's RPN and point terms stray at most 2e-6 from the
port's f64 step, its RCNN terms up to 3.4e-5 and its gradients up to 6.7e-4
of a tensor's largest: seeds 0 and 3 (PV-RCNN's train test's) exceed the
bounds. The port's own f32 step strays up to 2.2e-5 from its f64 one on the
same seeds, and JAX with x64 on (its backbone still f32) reads as its f32
does: this is the noise of the model's f32 training forward, amplified by
the RoI-grid pool's and the heads' training-mode batch norms (ROADMAP §3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PLUSPLUS_F32_GRAD, pvrcnn_train_inputs, tiny_train_inputs
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.train.train import create_train_state as jax_train_state
from seevcn_tpu.train.train import make_train_step
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy
from seevcn_torch.train.train import create_train_state
from seevcn_torch.utils.weights import pvrcnn_state_dict_from_flax
from test_torch_pvrcnn_train import TERMS, _argmax_routed_max_pool, _check_steps, _port_step

B, TOTAL = 2, 100


def _cfg(dp=0.0):
    cfg = C.tiny_pvrcnn_plusplus_cfg("SPC", True)
    cfg.MODEL.ROI_HEAD.DP_RATIO = dp
    return cfg


def _flax_to_port(params, stats):
    """The exporter's key layout (a Dropout slot in each FC stack, DP_RATIO
    > 0) -> the DP_RATIO 0 model's."""
    sd = pvrcnn_state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": stats}))
    keys = list(build_detector(_cfg(0.3), device="cpu")[0].state_dict())
    keys0 = list(build_detector(_cfg(), device="cpu")[0].state_dict())
    return {k0: sd[k] for k, k0 in zip(keys, keys0)}


@pytest.fixture(scope="module")
def step():
    """One step of JAX's ``make_train_step`` (jitted, its max-pool routed by
    its argmax, tests/test_torch_pvrcnn_train.py) and of the port in f64 from
    the same weights and RoI priorities; the keypoints of both."""
    cfg = _cfg()
    jm, _ = jax_build(cfg)
    p0, v0 = (to_numpy(t) for t in tiny_train_inputs("cpu")[:2])
    shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                 p, v, train=False),
                            jnp.asarray(p0), jnp.asarray(v0))
    variables = seeded_flax_variables(shapes, seed=4)
    sd = _flax_to_port(variables["params"], variables["batch_stats"])
    pts, valid, gt = pvrcnn_train_inputs(cfg, sd)
    rng = jax.random.PRNGKey(7)
    n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)

    @jax.jit
    def grads_and_u(params, stats):
        # make_train_step's loss function at step 0, with the gradients and
        # the keypoints returned
        sample_rng, dropout_rng = jax.random.split(jax.random.fold_in(rng, 0))

        def loss_fn(params):
            out, _ = jm.apply({"params": params, "batch_stats": stats}, pts, valid,
                              gt_boxes=gt, train=True, rng=sample_rng,
                              rngs={"dropout": dropout_rng}, mutable=["batch_stats"])
            return jm.loss(out, gt)[0], out["keypoints"]

        u = jax.vmap(lambda r: jax.random.uniform(r, (n_rois,)))(
            jax.random.split(sample_rng, B))
        grads, kp = jax.grad(loss_fn, has_aux=True)(params)
        return grads, kp, u

    jstate = jax_train_state(jm, jax.tree.map(jnp.asarray, variables), cfg.OPTIMIZATION,
                             TOTAL)
    model, _ = build_detector(cfg, sd, device="cpu")
    state = create_train_state(model.to(torch.float64), cfg.OPTIMIZATION, TOTAL)
    keypoints = {}
    hook = model.pfe.register_forward_hook(
        lambda m, i, o: keypoints.update(port=o["keypoints"].detach().clone()))
    with _argmax_routed_max_pool():
        jgrads, jkp, u = grads_and_u(jstate.params, jstate.batch_stats)
        jnext, jmetrics = make_train_step(jm, donate=False)(jstate, pts, valid, gt, rng)
        metrics, grads, fg, samples = _port_step(state, pts, valid, gt, u, torch.float64)
    hook.remove()
    model32, _ = build_detector(cfg, sd, device="cpu")
    f32 = _port_step(create_train_state(model32, cfg.OPTIMIZATION, TOTAL), pts, valid, gt,
                     u, torch.float32)
    port_jgrads = _flax_to_port(jgrads, jstate.batch_stats)
    return {"jax_metrics": jax.tree.map(np.asarray, jmetrics), "metrics": metrics,
            "grads": grads, "jax_grads": port_jgrads, "jax_grads_rulebook": port_jgrads,
            "clip": 10 / float(torch.sqrt(sum((g ** 2).sum() for g in port_jgrads.values()))),
            "jax_before": _flax_to_port(jstate.params, jstate.batch_stats),
            "jax_after": _flax_to_port(jnext.params, jnext.batch_stats),
            "after": {k: v.clone() for k, v in state.model.state_dict().items()},
            "fg": fg, "samples": samples, "lr": state.optimizer.lr_schedule(0),
            "keypoints": (keypoints["port"], np.asarray(jkp)), "f32": f32}


def test_train_step_keypoints_are_jax_s(step):
    """SPC in training samples near the RoI sample's valid rows
    (``roi_sample_mask``): with JAX's priorities the keypoints are JAX's,
    bit for bit (the port's f64 points are f32 values)."""
    port, ref = step["keypoints"]
    assert port.dtype == torch.float64
    assert np.array_equal(port.float().numpy(), ref)
    assert step["samples"] > 0 and step["fg"] > 0


def test_one_train_step_matches_jax(step):
    """The port's step in f64 against JAX's in f32: loss terms 1e-5,
    gradients 5e-4 of a tensor's largest, updated parameters and running
    statistics as tests/test_torch_pvrcnn_train.py holds them; the
    VectorPool layers' groups, reductions and MSG fusions all get
    gradient."""
    for k in ("point_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner"):
        assert float(step["metrics"][k]) > 0, k
    _check_steps([step], 1e-5, 5e-4, 1e-5)
    for name in ("pfe.SA_layers.0.layers.1.reduce.weight",
                 "pfe.SA_layers.1.msg_post_mlps.0.weight",
                 "pfe.SA_rawpoints.layers.0.post_mlps.0.weight"):
        assert float(step["grads"][name].abs().max()) > 0, name


def test_f32_train_step_matches_f64(step):
    """The port's f32 step against its f64 step, the same sample: loss
    terms within 5e-5 (relative), as PV-RCNN's, and gradients within 2e-3
    of the tensor's largest (chip_smoke.PLUSPLUS_F32_GRAD), twice PV-RCNN's
    bound: the VectorPool groups' and MSG fusions' training-mode batch norms
    carry the f32 error of their inputs further (at these weights the worst
    tensor reads 2.0e-4; at chip_smoke's tiny weights, seed 8 with
    random statistics, 1.66e-3)."""
    metrics, grads, fg, samples = step["f32"]
    assert (fg, samples) == (step["fg"], step["samples"])
    for k in TERMS:
        assert_close(metrics[k], step["metrics"][k], atol=1e-6, rtol=5e-5, name=k)
    for n, g in grads.items():
        ref = step["grads"][n]
        assert_close(g, ref, atol=PLUSPLUS_F32_GRAD * float(ref.abs().max()) + 1e-9,
                     name=f"grad {n}")
