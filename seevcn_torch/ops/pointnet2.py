"""PointNet++ grouping ops in torch (port of seevcn_tpu/ops/pointnet2.py;
reference pcdet/ops/pointnet2/pointnet2_stack: ball_query, group_points).

The ball query keeps the reference CUDA kernel's contract: for each query
point, the FIRST ``nsample`` support points by index that lie within
``radius``; a query with none has an all-invalid group. The port computes
that selection exactly, as a chunked pass over (queries, supports): one
distance matrix a chunk, shared by every radius of a multi-scale layer,
then each row's in-radius supports ranked by a running count.

Two details follow the JAX package so that its results are met bit for
bit wherever it is exact. Both depend on the support width JAX's query
sees, its padded support row count, which the caller passes as ``width``
(the port hands over only a frame's valid rows):
- the squared distance is the Gram form |q|^2 + |s|^2 - 2 q.s (clamped at
  0) below ``GRID_BQ_MIN_SUPPORT``, where JAX runs its dense query, and
  the difference form (dx^2 + dy^2 + dz^2) from there on, where JAX runs
  its hash grid;
- a slot past a group's last member reads, on the dense side, the next
  supports that are not members, in index order (JAX's sort of the
  members' keys), and 0 on the grid side.

Deliberate departure: JAX's hash grid drops the highest-index members of a
bucket that overflows its capacity (pfe.py sizes the shared table at 128
for PV-RCNN's raw points), so it can miss members of a dense group. The
port has no table and never does.
"""
from __future__ import annotations

import torch

from .sampling import pairwise_sqdist

#: support count from which JAX's ball query runs on its hash grid
GRID_BQ_MIN_SUPPORT = 16384
#: (query, support) pairs of one chunk: bounds the chunk's buffers
PAIR_BUDGET = 1 << 24
_HASH_T = 1 << 16
_TABLE_ENTRY_BUDGET = 1 << 22


def table_size_for(n_support: int, capacity: int) -> int:
    """The hash-bucket count of JAX's grid table under its entry budget:
    the next power of 2 of min(2^16, max(4096, 2^22 / capacity)). The port
    builds no table; this sizes the JAX capacity that chip_smoke.py reports
    buckets against."""
    want = min(_HASH_T, max(4096, _TABLE_ENTRY_BUDGET // max(capacity, 1)))
    return 1 << (want - 1).bit_length()


def shared_table_capacity(radii, nsamples) -> int:
    """The bucket capacity of the grid table that JAX's SALayer shares
    between its radii (cell = the largest radius): 2 nsample times the
    ratio of the largest to the smallest radius squared, in [64, 512]."""
    ratio2 = (float(max(radii)) / max(float(min(radii)), 1e-3)) ** 2
    return int(min(max(2 * max(int(n) for n in nsamples) * max(ratio2, 1.0), 64),
                   512))


def _sqdist_chunk(q: torch.Tensor, s: torch.Tensor, grid: bool) -> torch.Tensor:
    if not grid:
        return pairwise_sqdist(q, s)
    d = (q[:, None, 0] - s[None, :, 0]).square_()
    d += (q[:, None, 1] - s[None, :, 1]).square_()
    d += (q[:, None, 2] - s[None, :, 2]).square_()
    return d


def _first_n(ok: torch.Tensor, nsample: int, grid: bool):
    """(C, N) membership -> (idx (C, nsample) int64, valid (C, nsample)):
    the first ``nsample`` members of each row by index; the slots after
    them as the module docstring says."""
    c, n = ok.shape
    rank = torch.cumsum(ok, 1, dtype=torch.int32)            # members up to j
    count = rank[:, -1:] if n else ok.new_zeros((c, 1), dtype=torch.int32)
    if grid:
        slot = torch.where(ok, rank - 1, nsample)
    else:
        # non-members after the members, each in index order
        cols = torch.arange(1, n + 1, dtype=torch.int32, device=ok.device)
        slot = torch.where(ok, rank - 1, count + (cols - rank) - 1)
    slot = torch.where(slot < nsample, slot, nsample).long()
    idx = torch.zeros((c, nsample + 1), dtype=torch.int64, device=ok.device)
    idx.scatter_(1, slot, torch.arange(n, device=ok.device).expand(c, n))
    valid = torch.arange(nsample, device=ok.device) < count
    return idx[:, :nsample], valid


def ball_query_multi(new_xyz: torch.Tensor, support_xyz: torch.Tensor, radii,
                     nsamples, support_valid: torch.Tensor | None = None,
                     width: int | None = None):
    """new_xyz (K, 3), support_xyz (N, 3) -> [(idx (K, ns) int64, valid
    (K, ns) bool) for each (radius, ns)]: ``ball_query`` at several radii
    over one distance pass. ``width``, the support width of JAX's query
    (default N), picks the distance form and the filling of the slots
    past a group's end."""
    k, n = new_xyz.shape[0], support_xyz.shape[0]
    grid = (n if width is None else int(width)) >= GRID_BQ_MIN_SUPPORT
    chunk = max(1, PAIR_BUDGET // max(n, 1))
    sup = support_xyz[:, :3]
    outs = [[] for _ in radii]
    for s in range(0, k, chunk):
        d = _sqdist_chunk(new_xyz[s:s + chunk, :3], sup, grid)
        for out, r, ns in zip(outs, radii, nsamples):
            ok = d <= float(r) * float(r)
            if support_valid is not None:
                ok &= support_valid[None, :]
            out.append(_first_n(ok, int(ns), grid))
    return [(torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]))
            for out in outs]


def ball_query(new_xyz: torch.Tensor, support_xyz: torch.Tensor, radius: float,
               nsample: int, support_valid: torch.Tensor | None = None,
               width: int | None = None):
    """new_xyz (K, 3), support_xyz (N, 3) -> (idx (K, nsample) int64, valid
    (K, nsample) bool): the first ``nsample`` valid supports by index within
    ``radius`` of each query (CUDA ball_query semantics), exactly; ``width``
    as in ``ball_query_multi``."""
    return ball_query_multi(new_xyz, support_xyz, (radius,), (nsample,),
                            support_valid, width)[0]


def group_features(idx: torch.Tensor, valid: torch.Tensor, new_xyz: torch.Tensor,
                   support_xyz: torch.Tensor,
                   support_features: torch.Tensor | None = None) -> torch.Tensor:
    """The reference QueryAndGroup: -> (K, nsample, 3[+C]) of each member's
    xyz relative to its query, then its features; empty slots zero."""
    safe = idx.clamp(0, support_xyz.shape[0] - 1)
    out = support_xyz[safe, :3] - new_xyz[:, None, :3]
    if support_features is not None:
        out = torch.cat([out, support_features[safe]], -1)
    return torch.where(valid[..., None], out, 0.0)


def masked_max_pool(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(K, nsample, C), (K, nsample) -> (K, C): the max over the valid
    slots, 0 for an empty group. Its gradient goes to the first maximal
    slot, as the reference's max_pool2d sends it (where slots tie exactly,
    as ReLU outputs may, JAX's reduce_max splits it among them)."""
    out = torch.where(valid[..., None], x, -torch.inf).max(1).values
    return torch.where(torch.isfinite(out), out, 0.0)
