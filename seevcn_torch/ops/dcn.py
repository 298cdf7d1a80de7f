"""Deformable convolution v1 and v2 (modulated) (port of
seevcn_tpu/ops/dcn.py).

    y(p) = sum_k w_k * m_k(p) * x(p0 + p_k + dp_k(p))

with bilinear sampling, zero outside the feature map, per-position offsets
dp_k and, for v2, modulation scalars m_k in [0, 1]. The reference's layout
holds at the boundary: NHWC ``x``, ``offset`` and ``mask``, an HWIO
``weight``, and mmcv's offset channel order ``[dy_0, dx_0, dy_1, dx_1,
...]`` for each deform group, the taps k = a * kw + b scanned row-major over
the kernel window.

The offset im2col tensor is built from four gathers, one a bilinear corner,
each an index into the input flattened to rows of (pixel, deform group),
each corner zeroed by its own in-bounds test; one f32 product of (B * Ho *
Wo, K * Cin) by (K * Cin, Cout) then finishes the sum. Autograd's backward
of the gathers is the scatter-add that JAX's VJP of ``take_along_axis`` is.
"""
from __future__ import annotations

import torch


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d_output_size(in_size: int, k: int, stride: int, padding: int,
                              dilation: int) -> int:
    return (in_size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, *, stride=1, padding=0,
                            dilation=1, deform_groups: int = 1) -> torch.Tensor:
    """Deformable conv v2 (v1 when ``mask`` is None), NHWC.

    x (B, H, W, Cin); offset (B, Ho, Wo, DG * K * 2); mask (B, Ho, Wo, DG *
    K), already through the sigmoid, or None; weight (kh, kw, Cin, Cout);
    bias (Cout,) or None; stride, padding and dilation an int or an (h, w)
    pair; the input channels split into ``deform_groups`` groups, each
    sampled with its own offsets. -> (B, Ho, Wo, Cout) in x's dtype."""
    b, h, w, cin = x.shape
    kh, kw, wcin, cout = weight.shape
    if wcin != cin:
        raise ValueError(f"weight Cin {wcin} != input Cin {cin}")
    k = kh * kw
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    dg = deform_groups
    if cin % dg:
        raise ValueError(f"Cin {cin} is not a multiple of deform_groups {dg}")
    cg = cin // dg
    ho = deform_conv2d_output_size(h, kh, sh, ph, dh)
    wo = deform_conv2d_output_size(w, kw, sw, pw, dw)
    if offset.shape != (b, ho, wo, dg * k * 2):
        raise ValueError(f"offset shape {tuple(offset.shape)}, expected "
                         f"{(b, ho, wo, dg * k * 2)}")
    if mask is not None and mask.shape != (b, ho, wo, dg * k):
        raise ValueError(f"mask shape {tuple(mask.shape)}, expected {(b, ho, wo, dg * k)}")

    f32 = torch.promote_types(x.dtype, torch.float32)
    dev = x.device
    off = offset.to(f32).reshape(b, ho, wo, dg, k, 2)
    # sampling positions: output origin + tap + learned offset, (B, Ho, Wo, DG, K)
    oy = (torch.arange(ho, device=dev, dtype=f32) * sh - ph)[:, None, None, None]
    ox = (torch.arange(wo, device=dev, dtype=f32) * sw - pw)[None, :, None, None]
    taps = torch.arange(k, device=dev)
    ky = (taps // kw).to(f32) * dh
    kx = (taps % kw).to(f32) * dw
    ys = oy + ky + off[..., 0]
    xs = ox + kx + off[..., 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0

    # rows of (pixel, deform group): row (b * H * W + pixel) * DG + g
    rows = x.reshape(b * h * w * dg, cg)
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None, None, None]
    group = torch.arange(dg, device=dev)[:, None]

    def corner(yc, xc, wgt):
        valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
        yi = yc.clamp(0, h - 1).long()
        xi = xc.clamp(0, w - 1).long()
        idx = (base + yi * w + xi) * dg + group              # (B, Ho, Wo, DG, K)
        got = rows.index_select(0, idx.reshape(-1)).reshape(*idx.shape, cg)
        return got.to(f32) * (wgt * valid.to(f32))[..., None]

    samples = (corner(y0, x0, (1 - wy) * (1 - wx)) +
               corner(y0, x0 + 1, (1 - wy) * wx) +
               corner(y0 + 1, x0, wy * (1 - wx)) +
               corner(y0 + 1, x0 + 1, wy * wx))              # (B, Ho, Wo, DG, K, Cg)
    if mask is not None:
        samples = samples * mask.to(f32).reshape(b, ho, wo, dg, k)[..., None]
    # group-major channels within each tap: the weight's Cin layout
    cols = samples.transpose(3, 4).reshape(b * ho * wo, k * cin)
    out = (cols @ weight.to(f32).reshape(k * cin, cout)).reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias.to(f32)
    return out.to(x.dtype)


def deform_conv2d(x, offset, weight, bias=None, *, stride=1, padding=0, dilation=1,
                  deform_groups: int = 1) -> torch.Tensor:
    """Deformable conv v1 (no modulation): mmcv's ``deform_conv2d``."""
    return modulated_deform_conv2d(x, offset, None, weight, bias, stride=stride,
                                   padding=padding, dilation=dilation,
                                   deform_groups=deform_groups)
