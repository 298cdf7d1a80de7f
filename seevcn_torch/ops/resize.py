"""Image resizes on the device with OpenCV's semantics (the reference resizes
on the host with cv2, which the card's machine does not have).

``resize_linear`` is ``cv2.resize(src, (out_w, out_h),
interpolation=cv2.INTER_LINEAR)`` on float32: each output pixel centre maps
to ``(d + 0.5) * in / out - 0.5`` in the source, the two neighbours on each
axis are mixed by the fraction, a coordinate before the first pixel or at
or past the last reads that edge pixel (edge replicate), and a shrink takes
no antialiasing. The columns are mixed first, then the rows, in f32, as
OpenCV's separable pass does.

On uint8 it is OpenCV's fixed-point route: each weight rounded (half to
even) to 11 fraction bits, the columns mixed exactly in int32, the rows
mixed as ``((b0 * (c0 >> 4)) >> 16) + ((b1 * (c1 >> 4)) >> 16) + 2 >> 2``.
There the row weights of an edge row stay those of its source coordinate
before the first row or past the last, both taps reading the edge row;
their two separate truncations can then lose one grey level, as cv2's do.
"""
from __future__ import annotations

import torch


def _taps(n_out: int, n_in: int, device):
    """Source index pairs and the second one's weight along one axis."""
    scale = n_in / n_out                       # OpenCV keeps it in double
    f = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * scale
         - 0.5).to(torch.float32)
    s = torch.floor(f)
    frac = f - s
    s = s.to(torch.int64)
    edge = (s < 0) | (s >= n_in - 1)
    frac = torch.where(edge, 0.0, frac)
    s = s.clamp(0, n_in - 1)
    return s, (s + 1).clamp_max(n_in - 1), frac


def _fixed(frac: torch.Tensor):
    """OpenCV's 11-bit fixed-point weights of the two taps (int32)."""
    return (torch.round((1.0 - frac) * 2048).to(torch.int32),
            torch.round(frac * 2048).to(torch.int32))


def resize_linear(src: torch.Tensor, size) -> torch.Tensor:
    """src (H, W) or (H, W, C) float32 or uint8 -> (out_h, out_w[, C]) of
    its dtype, ``size`` = (out_h, out_w), with cv2.INTER_LINEAR's
    semantics."""
    out_h, out_w = size
    h, w = src.shape[:2]
    x0, x1, fx = _taps(out_w, w, src.device)
    extra = (None,) * (src.dim() - 2)
    if src.dtype == torch.uint8:
        f = ((torch.arange(out_h, dtype=torch.float64, device=src.device) + 0.5)
             * (h / out_h) - 0.5).to(torch.float32)
        sy = torch.floor(f)
        b0, b1 = (b[(slice(None), None) + extra] for b in _fixed(f - sy))
        sy = sy.to(torch.int64)
        a0, a1 = (a[(slice(None),) + extra] for a in _fixed(fx))
        cols = src[:, x0].to(torch.int32) * a0 + src[:, x1].to(torch.int32) * a1
        c0, c1 = cols[sy.clamp(0, h - 1)] >> 4, cols[(sy + 1).clamp(0, h - 1)] >> 4
        return ((((b0 * c0) >> 16) + ((b1 * c1) >> 16) + 2) >> 2).to(torch.uint8)
    y0, y1, fy = _taps(out_h, h, src.device)
    fx = fx[(slice(None),) + extra]
    rows = src[:, x0] * (1.0 - fx) + src[:, x1] * fx           # (H, out_w[, C])
    fy = fy[(slice(None), None) + extra]
    return rows[y0] * (1.0 - fy) + rows[y1] * fy
