"""Row-wise minimum squared distance with AABB tile pruning (K1).

Port of ``seevcn_tpu/ops/pallas/min_dist.py``: ``min_sqdist`` keeps the
reference wrapper's contract (inputs cast to f32, invalid support rows
pushed to 1e9, output of length N). Only the pruned difference form is
ported; on a CUDA tensor it launches the hand-written kernel in
``seevcn_torch/csrc/min_dist.cu``, on a CPU tensor it runs
``min_sqdist_plain``. Nothing falls back from the kernel to the plain
version.

The contract of the pruned form: values are exact where the true minimum is
<= prune_radius^2, never below the truth elsewhere (rows whose every
support tile was pruned read 1e18, the plain version reads the true value
or inf), so a within-radius test gives the same set either way.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, load_library

TQ = 128    # query rows per CUDA block (one thread each); keep in step with csrc
TS = 1024   # support rows per shared-memory tile; keep in step with csrc
FAR = 1e9   # where invalid support rows are pushed, as in the reference
PLAIN_CHUNK = 8192


def min_sqdist_plain(a: torch.Tensor, b: torch.Tensor,
                     b_valid: torch.Tensor | None = None,
                     chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain difference form: a (N, 3), b (M, 3) -> (N,) min over valid b of
    ((ax-bx)^2 + (ay-by)^2) + (az-bz)^2; inf where no b is valid.

    Chunked over N so a 32k x 32k call holds one (chunk, M) buffer. The
    counterpart of ``min_sqdist_reference``; the kernel does the same f32
    operations in the same order, so the two agree bit for bit."""
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


def _launch_pruned(a: torch.Tensor, b: torch.Tensor, bbox: torch.Tensor,
                   r2: float) -> torch.Tensor:
    for t in (a, b, bbox):
        if t.device != a.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("min_sqdist kernel takes contiguous f32 tensors "
                             "on one device")
    n, m = a.shape[0], b.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=a.device)
    if n == 0:
        return out
    lib = load_library("min_dist")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.min_sqdist_pruned(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(bbox.data_ptr()), ctypes.c_int(n), ctypes.c_int(m),
            ctypes.c_float(r2), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"min_sqdist_pruned launch failed: CUDA error {err}")
    LAUNCHES["min_sqdist_pruned"] += 1
    return out


def min_sqdist(a: torch.Tensor, b: torch.Tensor,
               b_valid: torch.Tensor | None = None, form: str = "diff",
               prune_radius: float | None = None) -> torch.Tensor:
    """a (N, 3), b (M, 3) -> (N,) min squared distance to any valid b, exact
    where <= prune_radius^2 and never below the truth elsewhere.

    Only the pruned difference form (the reference's K1,
    ``_make_kernel_diff_pruned``) is ported; the Gram form (K3,
    ``_kernel_gram``) and the unpruned sweep (K2, ``_kernel_diff``) are
    queued and raise."""
    if form == "gram":
        raise NotImplementedError("min_sqdist form='gram' (kernel K3, "
                                  "_kernel_gram) is not ported yet")
    if form != "diff":
        raise ValueError(f"unknown form {form!r}")
    if prune_radius is None:
        raise NotImplementedError("unpruned min_sqdist (kernel K2, "
                                  "_kernel_diff) is not ported yet")
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if a.device.type == "cpu":
        return min_sqdist_plain(a, b, b_valid)
    if a.device.type != "cuda":
        raise ValueError(f"min_sqdist runs on CUDA or CPU, not {a.device}")
    if b_valid is not None:
        b = torch.where(b_valid[:, None], b, FAR)
    bbox = support_tile_boxes(b, b_valid)
    return _launch_pruned(a.contiguous(), b.contiguous(), bbox,
                          float(prune_radius) ** 2)
