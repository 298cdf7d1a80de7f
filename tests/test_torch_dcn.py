"""Deformable convolution in the port (seevcn_torch/ops/dcn.py and
models/modules/common.py:DeformConv2d) against the JAX package on the CPU.

Inputs are numpy from a seed. ``modulated_deform_conv2d`` runs over the
parametrisation of tests/test_dcn.py (stride, padding, dilation, deform
groups, v1 and v2), with offsets that push taps past every edge of the map
and offsets that are whole numbers, where a tap lands on a pixel and the
bilinear weights are 0 and 1. Tolerances: the forward within 1e-5 of the
output's largest |value|; the gradients of x, offset, mask and weight
within 1e-4 of each tensor's largest |gradient| (the sums run in another
order, and the gathers' backward adds into the same pixel in another order).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seevcn_tpu.models.modules.common import DeformConv2d as JaxDeformConv2d
from seevcn_tpu.ops import dcn as JD
from seevcn_torch.models.modules.common import DeformConv2d
from seevcn_torch.ops import dcn as TD
from seevcn_torch.testing import assert_close, to_numpy, to_torch
from seevcn_torch.utils.weights import seg2d_state_dict_from_flax

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _case(seed, b, h, w, cin, cout, k, stride, padding, dilation, dg, modulated):
    """x, offset, mask (or None), weight, bias: about a quarter of the taps
    pushed 1-3 map sizes past an edge (above, below, left and right), about
    a quarter at whole-number offsets, the rest N(0, 2)."""
    rng = np.random.RandomState(seed)
    kk = k * k
    ho = JD.deform_conv2d_output_size(h, k, stride, padding, dilation)
    wo = JD.deform_conv2d_output_size(w, k, stride, padding, dilation)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    weight = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    off = (rng.randn(b, ho, wo, dg, kk, 2) * 2.0).astype(np.float32)
    pick = rng.rand(b, ho, wo, dg, kk)
    push = np.stack([h, w]) * rng.uniform(1, 3, (b, ho, wo, dg, kk, 2))
    sign = rng.choice([-1.0, 1.0], (b, ho, wo, dg, kk, 2))
    off = np.where((pick < 0.25)[..., None], sign * push, off)
    off = np.where(((pick >= 0.25) & (pick < 0.5))[..., None], np.round(off), off)
    off = off.astype(np.float32).reshape(b, ho, wo, dg * kk * 2)
    mask = rng.rand(b, ho, wo, dg * kk).astype(np.float32) if modulated else None
    return x, off, mask, weight, bias


CASES = {
    # tests/test_dcn.py:61
    "s1_p1_d1_dg1_v2": (1, 1, 1, 1, True),
    "s2_p1_d1_dg1_v2": (2, 1, 1, 1, True),
    "s1_p2_d2_dg1_v1": (1, 2, 2, 1, False),
    "s1_p1_d1_dg2_v2": (1, 1, 1, 2, True),
    # and v1 at the other strides and groups
    "s2_p0_d1_dg2_v1": (2, 0, 1, 2, False),
    "s1_p1_d1_dg4_v1": (1, 1, 1, 4, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_modulated_deform_conv2d_matches_jax(name):
    stride, padding, dilation, dg, modulated = CASES[name]
    x, off, mask, weight, bias = _case(len(name), 2, 9, 11, 4, 6, 3, stride, padding,
                                       dilation, dg, modulated)
    cot = np.random.RandomState(7).randn(*(2,) + (
        JD.deform_conv2d_output_size(9, 3, stride, padding, dilation),
        JD.deform_conv2d_output_size(11, 3, stride, padding, dilation), 6)).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation, deform_groups=dg)
    # the taps reach past every edge, and some sit on whole pixels
    o = off.reshape(2, *cot.shape[1:3], dg, 9, 2)
    assert (o[..., 0] < -9).any() and (o[..., 0] > 9).any()
    assert (o[..., 1] < -11).any() and (o[..., 1] > 11).any()
    assert ((o == np.round(o)) & (np.abs(o) < 9)).any()

    def jax_fn(x, off, mask, weight, bias):
        out = JD.modulated_deform_conv2d(x, off, mask, weight, bias, **kw)
        return (out * cot).sum(), out

    args = [x, off, mask, weight, bias]
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 3)
    (_, ref), ref_g = jax.jit(jax.value_and_grad(jax_fn, argnums=argnums, has_aux=True))(
        *args)
    t = [None if a is None else to_torch(a).requires_grad_() for a in args]
    got = TD.modulated_deform_conv2d(*t, **kw)
    (got * to_torch(cot)).sum().backward()
    ref = np.asarray(ref)
    assert_close(got, ref, atol=FWD_RTOL * float(np.abs(ref).max()), name="forward")
    for i, g in zip(argnums, ref_g):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        assert_close(t[i].grad, g, atol=GRAD_RTOL * float(np.abs(g).max()),
                     name=f"gradient {('x', 'offset', 'mask', 'weight')[i]}")


def test_deform_conv2d_is_v1():
    x, off, _, weight, _ = _case(3, 1, 7, 8, 4, 5, 3, 1, 1, 1, 1, False)
    ref = np.asarray(jax.jit(lambda *a: JD.deform_conv2d(*a, padding=1))(x, off, weight))
    got = TD.deform_conv2d(to_torch(x), to_torch(off), to_torch(weight), padding=1)
    assert_close(got, ref, atol=FWD_RTOL * float(np.abs(ref).max()), name="v1")


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_zero_offsets_equal_plain_conv(stride):
    """The layer at its init (offset conv at zero): the plain 3x3 conv
    with the same weight, padding 1 (tests/test_dcn.py:80)."""
    rng = np.random.RandomState(1)
    x = to_torch(rng.randn(2, 8, 12, 10).astype(np.float32))
    layer = DeformConv2d(8, 16, 3, stride=stride)
    with torch.no_grad():
        layer.weight.copy_(to_torch(rng.randn(16, 8, 3, 3).astype(np.float32) * 0.2))
        got = layer(x)
        want = torch.nn.functional.conv2d(x, layer.weight, stride=stride, padding=1)
    assert not layer.offset_conv.weight.any() and not layer.offset_conv.bias.any()
    assert_close(got, want, atol=1e-5 * float(want.abs().max()), name="zero offsets")


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv_layer_matches_flax(modulated):
    """The layer against the reference's flax DeformConv2d, carried over by
    seg2d_state_dict_from_flax, with the offset conv seeded non-zero (at
    its zero init the layer is a plain conv and would show nothing): the
    forward, and the gradients of the input and of every parameter."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 10, 9, 6).astype(np.float32)
    mod = JaxDeformConv2d(5, kernel_size=3, modulated=modulated, use_bias=True)
    params = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), x)["params"])
    params["offset_conv"] = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
                             for k, v in params["offset_conv"].items()}
    params["bias"] = rng.randn(5).astype(np.float32)
    cot = rng.randn(2, 10, 9, 5).astype(np.float32)

    def f(p, x):
        out = mod.apply({"params": p}, x)
        return (out * cot).sum(), out

    (_, ref), (g_p, g_x) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, x)
    sd = seg2d_state_dict_from_flax({"params": {"layer": params}, "batch_stats": {}})
    layer = DeformConv2d(6, 5, 3, modulated=modulated, use_bias=True)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    xt = to_torch(x).permute(0, 3, 1, 2).requires_grad_()
    got = layer(xt).permute(0, 2, 3, 1)
    (got * to_torch(cot)).sum().backward()
    ref = np.asarray(ref)
    assert_close(got, ref, atol=FWD_RTOL * float(np.abs(ref).max()), name="forward")
    g_sd = seg2d_state_dict_from_flax({"params": {"layer": jax.tree.map(np.asarray, g_p)},
                                       "batch_stats": {}})
    grads = {"x": (xt.grad.permute(0, 2, 3, 1), np.asarray(g_x)),
             **{n: (p.grad, g_sd[f"layer.{n}"]) for n, p in layer.named_parameters()}}
    assert set(grads) == {"x", "weight", "bias", "offset_conv.weight", "offset_conv.bias"}
    for n, (g, r) in grads.items():
        r = to_numpy(r)
        assert np.abs(r).max() > 0, n
        assert_close(g, r, atol=GRAD_RTOL * float(np.abs(r).max()), name=f"gradient {n}")
