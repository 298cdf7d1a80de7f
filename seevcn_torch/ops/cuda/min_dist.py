"""Row-wise minimum squared distance: kernels K1, K2 and K3.

Port of ``seevcn_tpu/ops/pallas/min_dist.py``: ``min_sqdist`` keeps the
reference wrapper's contract (inputs cast to f32, invalid support rows
pushed to 1e9, output of length N) and its three forms:

- ``prune_radius=r`` (K1, ``_make_kernel_diff_pruned``): the difference
  form with box pruning. Values are exact where the true minimum is
  <= r^2 and never below the truth elsewhere (rows that no support box is
  near read 1e18; the plain version reads the true value, or inf where no b
  is valid), so a within-radius test gives the same set either way.
- ``form="diff"`` (K2, ``_kernel_diff``): the exact difference form over
  every support row.
- ``form="gram"`` (K3, ``_kernel_gram``): |a|^2 - 2a.b + |b|^2, clamped at
  0, after both sets are centred on the mean of the valid support rows.

On a CUDA tensor each form launches its hand-written kernels in
``seevcn_torch/csrc/min_dist.cu``; on a CPU tensor it runs the kernel's
plain version. Nothing falls back from a kernel to its plain version.

K1 is bound by the pairs it must look at, not by the card's rate: at the SEE
frame's replacement inputs (32,768 candidate rows in scan order, most far
from any car, against 32 completed cars of 1,024 points) a few million of
the 1.07 G pairs can matter. Its route therefore orders the query rows by
place before the sweep, all in one call from the host (``min_sqdist_pruned``:
a memset and five launches): it writes the support as float4 with invalid
rows at 1e9 and the box of every 32-row sub-tile and of every 1,024-row
tile; gives each row a key (the first tile near it, or "none"); orders the
rows stably by key with a counting sort; and gives each block of warps 32
ordered rows, which sweep only the sub-tiles that some row is near and
write each result back to its row's place. ``pruned_sweep_plain`` is the
plain version of that route, bit for bit, and counts the pairs it
sweeps.

K2 is bound by instruction issue: 8 FP32 instructions a pair that may not
be fused. Its call (``min_sqdist_diff``, two launches) writes the support
as float4 padded to whole K2_TILE-row tiles with copies of its last row,
then sweeps units of (K2_GROUP query rows, one tile), 8 rows a thread, in
one wave of blocks that each take an even share of the units; the min is
taken on the distances' bits (they are never negative), two pairs an
instruction, and the blocks' minima meet by atomicMin on those bits.

K3 is bound by FP32 issue slots: the kernel computes max(|a|^2 + min_j e_j,
0) with e_j = |b_j|^2 - 2 a.b_j, 3 FFMA and a min a pair, four query rows a
thread. ``min_sqdist_gram_plain`` computes the same e with separate
roundings, so the two agree to the reference's Gram tolerance.

A support with no valid row: K2 and K3 read about 3e18 on both routes, as
the reference's kernels do (every row sits at 1e9); K1 reads 1e18 on the
card, and its plain route and ``min_sqdist_reference`` read inf.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, load_library

TS = 1024   # K1's and K3's support rows per tile; keep in step with csrc
SUB = 32    # K1's support rows per sub-tile box; keep in step with csrc
WARP = 32   # K1's query rows per warp of the sweep
KEY_ROWS = 256  # K1's rows per block of its sort; keep in step with csrc
K2_GROUP = 1024  # K2's query rows of a unit of work; keep in step with csrc
K2_TILE = 512    # K2's support rows of a unit of work; keep in step with csrc
FAR = 1e9   # where invalid support rows are pushed, as in the reference
PRUNED_INIT = 1e18  # K1's value for a row that no support box is near
CENTRE_CLIP = 1e4
PLAIN_CHUNK = 8192


def min_sqdist_plain(a: torch.Tensor, b: torch.Tensor,
                     b_valid: torch.Tensor | None = None,
                     chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain difference form: a (N, 3), b (M, 3) -> (N,) min over valid b of
    ((ax-bx)^2 + (ay-by)^2) + (az-bz)^2; inf where no b is valid.

    Chunked over N so a 32k x 32k call holds one (chunk, M) buffer. The
    plain version of K2; K1 and K2 do the same f32 operations in the same
    order on every pair they look at, so they agree with it bit for bit."""
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
    reference wrapper does, then, chunked over N, max(|a|^2 + min_j e_j, 0)
    with e_j = ((|b_j|^2 + (-2ax) bx) + (-2ay) by) + (-2az) bz, each product
    and sum rounded on its own. The kernel fuses each product into its sum
    (FMA), so the two agree to the Gram tolerance, not bit for bit."""
    a, b = gram_inputs(a, b, b_valid)
    a2 = (a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]) + a[:, 2] * a[:, 2]
    b2 = (b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1]) + b[:, 2] * b[:, 2]
    na = -2.0 * a
    outs = []
    for s in range(0, a.shape[0], chunk):
        q = na[s:s + chunk]
        e = ((b2[None, :] + q[:, None, 0] * b[None, :, 0])
             + q[:, None, 1] * b[None, :, 1]) + q[:, None, 2] * b[None, :, 2]
        outs.append((a2[s:s + chunk] + e.amin(dim=1)).clamp_min(0.0))
    if not outs:
        return torch.empty((0,), dtype=torch.float32, device=a.device)
    return torch.cat(outs)


# --- K1's route, step by step ------------------------------------------------

def _r2_f32(r: float) -> float:
    """r^2 rounded to f32, as the kernel receives it."""
    return torch.tensor(float(r) ** 2, dtype=torch.float32).item()


def support_tile_boxes(b: torch.Tensor, b_valid: torch.Tensor | None = None,
                       tile: int = TS) -> torch.Tensor:
    """(M, 3) -> (ceil(M / tile), 6) [min xyz, max xyz] of each group of
    ``tile`` rows, taken in order from row 0, over its valid rows; a group
    without one gets an empty (+inf, -inf) box, which no point is near."""
    m = b.shape[0]
    pad = (-m) % tile
    lo = b if b_valid is None else torch.where(b_valid[:, None], b, float("inf"))
    hi = b if b_valid is None else torch.where(b_valid[:, None], b, float("-inf"))
    lo = torch.cat([lo, lo.new_full((pad, 3), float("inf"))])
    hi = torch.cat([hi, hi.new_full((pad, 3), float("-inf"))])
    return torch.cat([lo.view(-1, tile, 3).amin(1),
                      hi.view(-1, tile, 3).amax(1)], dim=1).contiguous()


def box_gap2(p: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """p (N, 3), box (G, 6) -> (N, G) squared gap from each point to each
    box, rounded as the kernels round it. It is never above the squared
    distance to any point inside the box, as the plain version computes
    that distance."""
    g = torch.maximum(box[None, :, :3] - p[:, None, :],
                      p[:, None, :] - box[None, :, 3:]).clamp_min(0.0)
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]


def query_keys(a: torch.Tensor, tile_box: torch.Tensor, r: float) -> torch.Tensor:
    """(N,) int32: the index of the first tile whose box lies within ``r``
    of each row of ``a``, or the tile count ("none") where no tile does. The
    plain version of K1's second launch."""
    t = tile_box.shape[0]
    if t == 0:
        return torch.zeros((a.shape[0],), dtype=torch.int32, device=a.device)
    near = box_gap2(a, tile_box) <= _r2_f32(r)
    return torch.where(near.any(1), near.int().argmax(1), t).to(torch.int32)


def pruned_order(keys: torch.Tensor) -> torch.Tensor:
    """(N,) int64 permutation that orders the rows stably by key: the rows
    near one tile come together, and the "none" rows come last."""
    return torch.argsort(keys, stable=True)


def pruned_sweep_plain(a: torch.Tensor, b: torch.Tensor,
                       b_valid: torch.Tensor | None, r: float,
                       chunk: int = 4096):
    """The plain version of K1's route: -> ((N,) values, pairs swept).

    The same keys, order, warps of WARP ordered rows, and sub-tiles swept
    as the kernel: a warp sweeps a SUB-row sub-tile when some row of it
    with a key is within ``r`` of the sub-tile's box. A row's value is the
    min, starting from 1e18, over the pairs its warp swept, with invalid
    and padding support rows at FAR; a row without a key reads 1e18. So it
    equals the kernel bit for bit. The pairs swept count each real row of a
    warp against every row of each sub-tile the warp swept."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    n, m = a.shape[0], b.shape[0]
    r2 = _r2_f32(r)
    tiles = support_tile_boxes(b, b_valid, TS)
    subs = support_tile_boxes(b, b_valid, SUB)
    keys = query_keys(a, tiles, r)
    perm = pruned_order(keys)
    live = (keys < tiles.shape[0])[perm]
    ap = a[perm]
    bp = b if b_valid is None else torch.where(b_valid[:, None], b, FAR)
    bp = torch.cat([bp, bp.new_full(((-m) % SUB, 3), FAR)])
    out = torch.full((n,), PRUNED_INIT, dtype=torch.float32, device=a.device)
    swept = 0
    chunk -= chunk % WARP
    for s in range(0, n, chunk):
        q, lv = ap[s:s + chunk], live[s:s + chunk]
        c = q.shape[0]
        near = (box_gap2(q, subs) <= r2) & lv[:, None]              # (c, G)
        pad = (-c) % WARP
        near = torch.cat([near, near.new_zeros((pad, near.shape[1]))])
        warp_near = near.view(-1, WARP, near.shape[1]).any(1)       # (w, G)
        rows = torch.full((warp_near.shape[0],), WARP, device=a.device)
        rows[-1] = WARP - pad
        swept += int((warp_near.sum(1) * rows).sum().item()) * SUB
        if not warp_near.any():
            continue
        sweep = warp_near.repeat_interleave(SUB, 1).repeat_interleave(WARP, 0)[:c]
        dx = q[:, None, 0] - bp[None, :, 0]
        dy = q[:, None, 1] - bp[None, :, 1]
        dz = q[:, None, 2] - bp[None, :, 2]
        d = torch.where(sweep, (dx * dx + dy * dy) + dz * dz, float("inf"))
        best = d.amin(1).clamp_max(PRUNED_INIT)
        out[s:s + c] = torch.where(lv, best, PRUNED_INIT)
    res = torch.empty_like(out)
    res[perm] = out
    return res, swept


def pairs_near_boxes(a: torch.Tensor, b: torch.Tensor,
                     b_valid: torch.Tensor | None, r: float, group: int,
                     chunk: int = 4096) -> int:
    """The pairs (i, j) where row i of ``a`` lies within ``r`` of the box of
    the ``group``-row support group that holds j: groups in order from row
    0, boxes over the valid rows, one test per row. It depends on the
    inputs and ``group`` alone, not on how a kernel tiles them."""
    a = a.to(torch.float32)
    m = b.shape[0]
    boxes = support_tile_boxes(b.to(torch.float32), b_valid, group)
    if boxes.shape[0] == 0:
        return 0
    rows = torch.full((boxes.shape[0],), group, device=a.device)
    rows[-1] = m - group * (boxes.shape[0] - 1)
    r2 = _r2_f32(r)
    total = 0
    for s in range(0, a.shape[0], chunk):
        near = box_gap2(a[s:s + chunk], boxes) <= r2
        total += int((near.sum(0) * rows).sum().item())
    return total


# --- launches ----------------------------------------------------------------

def _check(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device != ts[0].device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("min_sqdist kernels take contiguous f32 tensors "
                             "on one device")


def _call(name: str, device: torch.device, *args) -> None:
    """Call ``name`` of the min_dist library on the device's current stream,
    tensors passed by pointer (None as a null pointer), other args as they
    are; raise on the launch error it returns."""
    fn = getattr(load_library("min_dist"), name)
    conv = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*conv, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _pruned_layout(n: int, m: int):
    """K1's scratch, in int32 words, 16-byte aligned: {part: (offset, size)}
    and the total, in the order min_sqdist_pruned takes the pointers."""
    nsub, tiles = -(-m // SUB), -(-m // TS)
    sizes = (("b4", nsub * SUB * 4), ("sub_box", nsub * 6), ("tile_box", tiles * 6),
             ("keys", n), ("rank", n), ("hist", (tiles + 1) * -(-n // KEY_ROWS)),
             ("perm", n))
    offs, total = {}, 0
    for name, size in sizes:
        offs[name] = (total, size)
        total += -(-size // 4) * 4
    return offs, total


def _pruned_route(a: torch.Tensor, b: torch.Tensor,
                  b_valid: torch.Tensor | None, r: float):
    """K1's route on CUDA tensors, one call: -> (out, scratch, layout)."""
    a, b = a.contiguous(), b.contiguous()
    _check(a, b)
    n, m = a.shape[0], b.shape[0]
    offs, total = _pruned_layout(n, m)
    buf = torch.empty((total,), dtype=torch.int32, device=a.device)
    out = torch.empty((n,), dtype=torch.float32, device=a.device)
    base = buf.data_ptr()
    valid = None if b_valid is None else b_valid.to(torch.bool).contiguous()
    if valid is not None and (valid.device != a.device or valid.shape != (m,)):
        raise ValueError("b_valid must be (M,) on the device of a and b")
    _call("min_sqdist_pruned", a.device, a, b, valid, n, m, float(r) ** 2,
          *(base + 4 * off for off, _ in offs.values()), out)
    LAUNCHES["min_sqdist_pruned"] += 1
    return out, buf, offs


def _pruned_route_parts(a: torch.Tensor, b: torch.Tensor,
                        b_valid: torch.Tensor | None, r: float):
    """For the tests only: K1 on CUDA tensors, and what its steps left in
    the scratch, to hold each against its plain version: -> (out,
    {"sub_box", "tile_box", "keys", "perm"}); the plain versions are
    ``support_tile_boxes``, ``query_keys`` and ``pruned_order``."""
    out, buf, offs = _pruned_route(a, b, b_valid, r)

    def part(name, t):
        off, size = offs[name]
        return t[off:off + size]

    f = buf.view(torch.float32)
    return out, {"sub_box": part("sub_box", f).view(-1, 6),
                 "tile_box": part("tile_box", f).view(-1, 6),
                 "keys": part("keys", buf), "perm": part("perm", buf)}


def _launch_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2 on the wrapper's pushed inputs: two launches, the support as float4
    padded to whole K2_TILE-row tiles with copies of its last row into
    scratch, then the sweep."""
    _check(a, b)
    n, m = a.shape[0], b.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=a.device)
    b4 = torch.empty((-(-m // K2_TILE) * K2_TILE, 4), dtype=torch.float32,
                     device=a.device)
    _call("min_sqdist_diff", a.device, a, b, n, m, b4, out)
    LAUNCHES["min_sqdist_diff"] += 1
    return out


def _launch_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3 on gram_inputs' outputs: two launches, the support as float4 (x,
    y, z, |b|^2) padded to whole tiles into scratch, then the sweep."""
    _check(a, b)
    n, m = a.shape[0], b.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=a.device)
    b4 = torch.empty((-(-m // TS) * TS, 4), dtype=torch.float32, device=a.device)
    _call("min_sqdist_gram", a.device, a, b, n, m, b4, out)
    LAUNCHES["min_sqdist_gram"] += 1
    return out


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
        return _launch_gram(*gram_inputs(a, b, b_valid))
    if prune_radius is None:
        b = push_invalid(b, b_valid)
        if cpu:
            return min_sqdist_plain(a, b)
        return _launch_diff(a.contiguous(), b)
    if cpu:
        return min_sqdist_plain(a, b, b_valid)
    return _pruned_route(a, b, b_valid, prune_radius)[0]
