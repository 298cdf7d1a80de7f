"""Row-wise minimum squared distance: kernels K1, K2 and K3.

Port of ``seevcn_tpu/ops/pallas/min_dist.py``: ``min_sqdist`` keeps the
reference wrapper's contract (inputs cast to f32, invalid support rows
pushed to 1e9, output of length N) and its three forms:

- ``prune_radius=r`` (K1, ``_make_kernel_diff_pruned``): the difference
  form with AABB tile pruning. Values are exact where the true minimum is
  <= r^2 and never below the truth elsewhere (rows whose every support tile
  was pruned read 1e18; the plain version reads the true value, or inf
  where no b is valid), so a within-radius test gives the same set either
  way.
- ``form="diff"`` (K2, ``_kernel_diff``): the exact difference form over
  every support row.
- ``form="gram"`` (K3, ``_kernel_gram``): |a|^2 - 2a.b + |b|^2, clamped at
  0, after both sets are centred on the mean of the valid support rows.

On a CUDA tensor each form launches its hand-written kernel in
``seevcn_torch/csrc/min_dist.cu``; on a CPU tensor it runs the kernel's
plain version. Nothing falls back from a kernel to its plain version.

A support with no valid row: K2 and K3 read about 3e18 on both routes, as
the reference's kernels do (every row sits at 1e9); K1's plain route and
``min_sqdist_reference`` read inf.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, load_library

TQ = 128    # query rows per CUDA block (one thread each); keep in step with csrc
TS = 1024   # support rows per shared-memory tile; keep in step with csrc
FAR = 1e9   # where invalid support rows are pushed, as in the reference
CENTRE_CLIP = 1e4
PLAIN_CHUNK = 8192


def min_sqdist_plain(a: torch.Tensor, b: torch.Tensor,
                     b_valid: torch.Tensor | None = None,
                     chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain difference form: a (N, 3), b (M, 3) -> (N,) min over valid b of
    ((ax-bx)^2 + (ay-by)^2) + (az-bz)^2; inf where no b is valid.

    Chunked over N so a 32k x 32k call holds one (chunk, M) buffer. The
    plain version of K1 and K2; the kernels do the same f32 operations in
    the same order, so they agree with it bit for bit."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    n, m = a.shape[0], b.shape[0]
    if m == 0:
        return torch.full((n,), float("inf"), dtype=torch.float32,
                          device=a.device)
    outs = []
    for s in range(0, n, chunk):
        q = a[s:s + chunk]
        dx = q[:, None, 0] - b[None, :, 0]
        dy = q[:, None, 1] - b[None, :, 1]
        dz = q[:, None, 2] - b[None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        if b_valid is not None:
            d = torch.where(b_valid[None, :], d, float("inf"))
        outs.append(d.amin(dim=1))
    if not outs:
        return torch.empty((0,), dtype=torch.float32, device=a.device)
    return torch.cat(outs)


def push_invalid(b: torch.Tensor, b_valid: torch.Tensor | None) -> torch.Tensor:
    """Invalid support rows to FAR, as the reference wrapper does; an empty
    support becomes one FAR row, the reference's tile padding."""
    if b_valid is not None:
        b = torch.where(b_valid[:, None], b, FAR)
    if b.shape[0] == 0:
        b = b.new_full((1, 3), FAR)
    return b.contiguous()


def gram_inputs(a: torch.Tensor, b: torch.Tensor,
                b_valid: torch.Tensor | None = None):
    """K3's inputs as the reference wrapper builds them: a and b centred on
    the mean of the valid b rows (clipped to +-1e4; computed before the
    invalid rows are pushed away), then the invalid rows pushed to FAR."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if b_valid is None:
        centre = b.mean(0) if b.shape[0] else b.new_zeros(3)
    else:
        cnt = b_valid.sum().clamp_min(1).to(torch.float32)
        centre = torch.where(b_valid[:, None], b, 0.0).sum(0) / cnt
    centre = centre.clamp(-CENTRE_CLIP, CENTRE_CLIP)
    return (a - centre).contiguous(), push_invalid(b - centre, b_valid)


def min_sqdist_gram_plain(a: torch.Tensor, b: torch.Tensor,
                          b_valid: torch.Tensor | None = None,
                          chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain Gram form (the plain version of K3): centre and push as the
    reference wrapper does, then, chunked over N, the min over b of
    max((|a|^2 - 2 (ax bx + ay by + az bz)) + |b|^2, 0). The cross term is
    summed elementwise in the kernel's order, so the two agree bit for
    bit."""
    a, b = gram_inputs(a, b, b_valid)
    a2 = (a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]) + a[:, 2] * a[:, 2]
    b2 = (b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1]) + b[:, 2] * b[:, 2]
    outs = []
    for s in range(0, a.shape[0], chunk):
        q = a[s:s + chunk]
        ab = (q[:, None, 0] * b[None, :, 0] + q[:, None, 1] * b[None, :, 1]) \
            + q[:, None, 2] * b[None, :, 2]
        d = (a2[s:s + chunk, None] - 2.0 * ab) + b2[None, :]
        outs.append(d.clamp_min(0.0).amin(dim=1))
    if not outs:
        return torch.empty((0,), dtype=torch.float32, device=a.device)
    return torch.cat(outs)


def support_tile_boxes(b: torch.Tensor, b_valid: torch.Tensor | None = None,
                       tile: int = TS) -> torch.Tensor:
    """(M, 3) -> (ceil(M / tile), 6) [min xyz, max xyz] of each support tile
    over its valid rows; a tile without one gets an empty (+inf, -inf) box,
    which no query tile is near."""
    m = b.shape[0]
    pad = (-m) % tile
    lo = b if b_valid is None else torch.where(b_valid[:, None], b, float("inf"))
    hi = b if b_valid is None else torch.where(b_valid[:, None], b, float("-inf"))
    lo = torch.cat([lo, lo.new_full((pad, 3), float("inf"))])
    hi = torch.cat([hi, hi.new_full((pad, 3), float("-inf"))])
    return torch.cat([lo.view(-1, tile, 3).amin(1),
                      hi.view(-1, tile, 3).amax(1)], dim=1).contiguous()


def _check(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device != ts[0].device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("min_sqdist kernels take contiguous f32 tensors "
                             "on one device")


def _launch(name: str, a: torch.Tensor, *args) -> torch.Tensor:
    """Launch kernel ``name`` of min_dist.cu on a's stream with the pointers
    of the tensors in ``args`` (other args passed as they are), writing an
    (N,) output."""
    out = torch.empty((a.shape[0],), dtype=torch.float32, device=a.device)
    if a.shape[0] == 0:
        return out
    fn = getattr(load_library("min_dist"), name)
    conv = [ctypes.c_void_p(x.data_ptr()) if isinstance(x, torch.Tensor) else x
            for x in (a, *args)]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(*conv, ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _launch_pruned(a: torch.Tensor, b: torch.Tensor, bbox: torch.Tensor,
                   r2: float) -> torch.Tensor:
    _check(a, b, bbox)
    return _launch("min_sqdist_pruned", a, b, bbox, ctypes.c_int(a.shape[0]),
                   ctypes.c_int(b.shape[0]), ctypes.c_float(r2))


def _launch_dense(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    return _launch(name, a, b, ctypes.c_int(a.shape[0]),
                   ctypes.c_int(b.shape[0]))


def min_sqdist(a: torch.Tensor, b: torch.Tensor,
               b_valid: torch.Tensor | None = None, form: str = "diff",
               prune_radius: float | None = None) -> torch.Tensor:
    """a (N, 3), b (M, 3) -> (N,) min squared distance to any valid b.

    ``form="diff"`` with ``prune_radius`` is K1 (exact where <= r^2, never
    below the truth elsewhere), without it K2 (exact); ``form="gram"`` is K3
    (the radius is ignored, as in the reference)."""
    if form not in ("diff", "gram"):
        raise ValueError(f"unknown form {form!r}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"min_sqdist runs on CUDA or CPU, not {a.device}")
    cpu = a.device.type == "cpu"
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if form == "gram":
        if cpu:
            return min_sqdist_gram_plain(a, b, b_valid)
        return _launch_dense("min_sqdist_gram", *gram_inputs(a, b, b_valid))
    if prune_radius is None:
        b = push_invalid(b, b_valid)
        if cpu:
            return min_sqdist_plain(a, b)
        return _launch_dense("min_sqdist_diff", a.contiguous(), b)
    if cpu:
        return min_sqdist_plain(a, b, b_valid)
    if b_valid is not None:
        b = torch.where(b_valid[:, None], b, FAR)
    bbox = support_tile_boxes(b, b_valid)
    return _launch_pruned(a.contiguous(), b.contiguous(), bbox,
                          float(prune_radius) ** 2)
