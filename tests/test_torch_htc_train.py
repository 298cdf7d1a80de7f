"""HTC's training forward, loss and gradients in the port against the JAX
package on the CPU, at the tiny HTC config (``tiny_htc_cfg``) in two
variants: full HTC (the 3-stage cascade, the semantic branch, mask info
flow, deformable stages 1-3) and deformable stages alone.

Weights are ``seevcn_torch.testing.seeded_seg2d_weights`` (random biases
and batch-norm statistics, offset convs seeded non-zero). The batch is two
synthetic scenes with padding ground-truth rows; the RoI and anchor
priorities are JAX's own draws, as in tests/test_torch_seg2d_train.py. JAX
runs in f64 (flax's fast batch-norm variance strays in f32, ROADMAP §3).

The port runs in f64 as well. In f32 it strays from JAX's f64 by more than
the bounds at full HTC, through rounding, not through its logic: the RPN's
f32 deltas move the sampled proposals by about 2e-4 px, each cascade
refinement moves the next stage's boxes further (about 2e-3 px by stage
1), and the RoI features, the regression targets and ReLUs near zero move
with them; the loss terms read up to 4.2e-5 (``box_reg_s1``) and the
gradients up to 1.7e-2 (``mask_head_s2.res_conv.bias``), where the same
computation in f64 reads 7.3e-7 and 1.9e-6. With its ReLUs' signs pinned
to the f64 run's (``seg2d_relu_signs``, as chip_smoke.py pins the card's
to the CPU's) the f32 step reads 1.0e-4 in its gradients, and is held to
JAX's f64 at 1e-4 in its loss terms and 5e-4 in its gradients; ``pytest
-s`` prints the free f32 readings beside. The f32 runs are on one CPU
thread (``one_cpu_thread``: multi-threaded, the CPU build's oneDNN
convolution backward corrupts the heap now and then at these 8 channels;
ROADMAP §3).

Tolerances: the sample's and each cascade stage's classes, foreground and
matches equal; RoIs 1e-4 px; delta targets 1e-3; features and logits 1e-5
of their scale; loss terms 1e-5 absolute and relative; gradients 5e-4 of
each tensor's largest |gradient|. ``pytest -s`` prints the worst readings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seevcn_tpu.models.seg2d.backend import build_seg2d as jax_build_seg2d
from seevcn_torch.models.seg2d.backend import build_seg2d, seg2d_train_forward
from seevcn_torch.testing import (assert_close, one_cpu_thread, seeded_seg2d_weights,
                                  seg2d_relu_signs, to_torch)
from seevcn_torch.train.train import TrainState
from seevcn_torch.utils.weights import seg2d_flax_from_state_dict, seg2d_state_dict_from_flax
from test_torch_htc import htc_cfgs
from test_torch_seg2d_train import _batch, _f64, _step_draws

SAMPLE_KEYS = {"rois", "roi_cls_tgt", "roi_delta_tgt", "roi_fg", "roi_matched"}
STAGE_KEYS = {"cls_logits", "box_deltas", "cls_tgt", "delta_tgt", "fg", "rois", "matched",
              "mask_logits"}


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / max(np.abs(ref).max(),
                                                                        1e-30))


def _port_step(cfg, sd, batch, roi_u, rpn_u, dtype):
    port = build_seg2d(cfg, sd, device="cpu").train().to(dtype)
    floats = [to_torch(x) for x in batch]
    floats = [x.to(dtype) if x.is_floating_point() else x for x in floats]
    loss, tb, out = seg2d_train_forward(TrainState(port, None), *floats,
                                        roi_u=to_torch(roi_u).to(dtype),
                                        rpn_u=to_torch(rpn_u).to(dtype))
    loss.backward()
    return {"loss": loss.detach(), "terms": {k: v.detach() for k, v in tb.items()},
            "out": out, "grads": {n: p.grad for n, p in port.named_parameters()}}


@pytest.fixture(scope="module", params=["full_htc", "dcn"])
def htc_pair(request):
    """JAX's training forward, loss and gradients and the port's, both in
    f64, from the same weights, batch and draws."""
    variant = request.param
    jcfg, cfg = htc_cfgs(variant)
    model, logic = jax_build_seg2d(jcfg)
    sd = seeded_seg2d_weights(cfg, seed=3)
    variables = seg2d_flax_from_state_dict(sd)
    batch = _batch(0)
    with jax.enable_x64(True):
        imgs, gtb, gtl, gtv, gtm = (jnp.asarray(x) for x in _f64(batch))
        rng = jax.random.PRNGKey(11)

        @jax.jit
        def value_and_grad(params, stats):
            def loss_fn(p):
                out, _ = model.apply({"params": p, "batch_stats": stats}, imgs, gtb, gtl,
                                     gtv, gtm, train=True, rng=rng, mutable=["batch_stats"])
                loss, tb = model.loss(out, gtb, gtl, gtv, gtm, rng)
                return loss, (tb, out)
            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        v64 = _f64(variables)
        (loss, (tb, out)), grads = value_and_grad(v64["params"], v64["batch_stats"])
        ref = {"loss": np.asarray(loss), "terms": jax.tree.map(np.asarray, tb),
               "out": jax.tree.map(np.asarray, out),
               "grads": seg2d_state_dict_from_flax({"params": jax.tree.map(np.asarray, grads),
                                                    "batch_stats": v64["batch_stats"]})}
        roi_u, rpn_u = _step_draws(rng, jcfg, logic.anchors.shape[0])

    with seg2d_relu_signs() as signs:
        got = _port_step(cfg, sd, batch, roi_u, rpn_u, torch.float64)
    with one_cpu_thread():
        f32 = _port_step(cfg, sd, batch, roi_u, rpn_u, torch.float32)
        with seg2d_relu_signs(signs):
            got["f32_pinned"] = _port_step(cfg, sd, batch, roi_u, rpn_u, torch.float32)
    for label, run in (("free", f32), ("ReLU signs pinned to the f64 run's",
                                       got["f32_pinned"])):
        terms = {k: _rel(v, ref["terms"][k]) for k, v in run["terms"].items()}
        grads = {n: _rel(g, ref["grads"][n]) for n, g in run["grads"].items()}
        print(f"{variant}, the port in f32 ({label}) against JAX's f64: worst loss term "
              f"{max(terms.values()):.3g} ({max(terms, key=terms.get)}), worst gradient "
              f"{max(grads.values()):.3g} ({max(grads, key=grads.get)})")
    return variant, cfg, ref, got


def test_htc_train_forward_matches_jax(htc_pair):
    variant, cfg, ref, got = htc_pair
    r, g = ref["out"], got["out"]
    assert set(g) == set(r)
    stages = [(g, r, "")] + [(g[f"cascade_s{s}"], r[f"cascade_s{s}"], f"_s{s}")
                             for s in range(1, cfg.cascade_stages)]
    for gs, rs, tag in stages:
        if tag:
            assert set(gs) == set(rs) == STAGE_KEYS
        names = {k: k if not tag else {"roi_cls_tgt": "cls_tgt", "roi_fg": "fg",
                                       "roi_matched": "matched", "rois": "rois",
                                       "roi_delta_tgt": "delta_tgt"}[k] for k in SAMPLE_KEYS}
        for k in ("roi_cls_tgt", "roi_fg", "roi_matched"):
            assert_close(gs[names[k]], rs[names[k]], name=names[k] + tag)
        assert_close(gs[names["rois"]].detach(), rs[names["rois"]], atol=1e-4,
                     name="rois" + tag)
        assert_close(gs[names["roi_delta_tgt"]], rs[names["roi_delta_tgt"]], atol=1e-3,
                     name="delta_tgt" + tag)
        for k in ("cls_logits", "box_deltas", "mask_logits"):
            rr = np.asarray(rs[k])
            assert_close(gs[k].detach(), rr, atol=1e-5 * float(np.abs(rr).max()), rtol=1e-5,
                         name=k + tag)
        assert np.asarray(rs[names["roi_fg"]]).any()
    if cfg.semantic_branch:
        rr = r["semantic_logits"]
        assert_close(g["semantic_logits"].detach(), rr, atol=1e-5 * float(np.abs(rr).max()),
                     rtol=1e-5, name="semantic_logits")


def test_htc_loss_terms_match_jax(htc_pair):
    variant, cfg, ref, got = htc_pair
    assert set(got["terms"]) == set(ref["terms"])
    if variant == "full_htc":
        assert {"box_cls_s2", "box_reg_s1", "mask_s1", "mask_s2", "semantic"} <= set(
            got["terms"])
    worst = {k: _rel(got["terms"][k], ref["terms"][k]) for k in ref["terms"]}
    print(f"{variant}: loss {float(ref['loss']):.6f}, worst loss term "
          f"{max(worst.values()):.3g} relative ({max(worst, key=worst.get)})")
    assert_close(got["loss"], ref["loss"], atol=1e-5, rtol=1e-5, name="loss")
    for k in ref["terms"]:
        assert_close(got["terms"][k], ref["terms"][k], atol=1e-5, rtol=1e-5, name=k)
        assert float(ref["terms"][k]) > 0, k


def test_htc_gradients_match_jax(htc_pair):
    """Every parameter, the offset convs and every stage's heads among
    them, within 5e-4 of each tensor's largest |gradient|."""
    variant, cfg, ref, got = htc_pair
    assert set(got["grads"]) == {k for k in ref["grads"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    worst = {n: _rel(g, ref["grads"][n]) for n, g in got["grads"].items()}
    print(f"{variant}: worst gradient {max(worst.values()):.3g} of its tensor's largest "
          f"({max(worst, key=worst.get)})")
    offsets = [n for n in got["grads"] if "offset_conv" in n]
    assert len(offsets) == 6 and all(got["grads"][n].abs().max() > 0 for n in offsets)
    for n, g in got["grads"].items():
        r = ref["grads"][n]
        assert_close(g, r, atol=5e-4 * float(r.abs().max()) + 1e-12, name=f"grad {n}")


def test_htc_f32_step_matches_jax_with_relus_pinned(htc_pair):
    """The port's f32 step, each ReLU's sign taken from the port's f64 run,
    against JAX's f64: loss terms within 1e-4 (absolute and relative),
    gradients within 5e-4 of each tensor's largest |gradient|."""
    variant, cfg, ref, got = htc_pair
    run = got["f32_pinned"]
    assert set(run["terms"]) == set(ref["terms"])
    assert_close(run["loss"], ref["loss"], atol=1e-4, rtol=1e-4, name="loss")
    for k in ref["terms"]:
        assert_close(run["terms"][k], ref["terms"][k], atol=1e-4, rtol=1e-4, name=k)
    for n, g in run["grads"].items():
        r = ref["grads"][n]
        assert_close(g, r, atol=5e-4 * float(r.abs().max()) + 1e-12, name=f"f32 grad {n}")
