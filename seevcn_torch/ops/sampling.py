"""Point-set sampling ops in torch (port of seevcn_tpu/ops/sampling.py):
pairwise distances, fixed-size tiling and resampling, farthest point
sampling, partial-mesh kNN selection, the within-radius test of the
replacement stage, the spatial hash and grid dedupe that bound PV-RCNN's
keypoint FPS, PV-RCNN++'s proposal-centric filter and sector FPS, and
PointNet++'s three-nearest-neighbour interpolation (PointRCNN's feature
propagation).

Fixed shapes and boolean validity masks, as in the reference; every
function takes an optional leading batch dimension where the reference
vmaps.
"""
from __future__ import annotations

import math

import torch

from .cuda.min_dist import min_sqdist


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances.

    Gram form |a|^2 + |b|^2 - 2 a.b, clamped at 0, as the reference computes
    it: DBSCAN's eps adjacency is defined on these values."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp_min(a2 + b2 - 2 * ab, 0.0)


def tile_to_n(points: torch.Tensor, valid: torch.Tensor, n: int):
    """Cyclically repeat the valid rows of (..., M, C) to exactly (..., n, C)
    (the reference's ``np.tile(sel, [n, 1])[:n]``). Valid rows keep their
    order (stable sort). Returns (out (..., n, C), ok (...,) bool)."""
    m = points.shape[-2]
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    cnt = valid.sum(-1).clamp_min(1).clamp_max(m)                 # (...,)
    pos = torch.arange(n, device=points.device) % cnt[..., None]  # (..., n)
    idx = torch.gather(order, -1, pos)
    out = torch.gather(points, -2,
                       idx[..., None].expand(*idx.shape, points.shape[-1]))
    return out, valid.any(-1)


def resample_points(points: torch.Tensor, valid: torch.Tensor, n: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Fixed-count resample (data_transforms.py:ResamplePoints): (M, C)
    points -> (n, C), the valid rows cycle-tiled (``tile_to_n``) after a
    random permutation of all rows drawn from ``generator`` where one is
    given (the reference's ``jax.random.permutation``; the draws differ
    between the two, the rule does not)."""
    if generator is not None:
        perm = torch.randperm(points.shape[0], generator=generator,
                              device=generator.device).to(points.device)
        points, valid = points[perm], valid[perm]
    return tile_to_n(points, valid, n)[0]


@torch.no_grad()
def farthest_point_sample(points: torch.Tensor, n_samples: int,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Iterative FPS: (..., N, 3) -> (..., n_samples) int64 indices.

    Starts at the first valid point with every distance at +inf; each step
    takes the argmax of the running min squared distance over the valid
    points (ties to the lower index; invalid points are never picked, and
    with fewer valid points than ``n_samples`` the picks repeat among them).
    One loop of ``n_samples`` steps serves the whole batch. The squared
    distance is summed x, y, z in that order, as the reference's reduction
    over the last axis does, and each step is elementwise, so every device
    picks the same points."""
    *lead, n, _ = points.shape
    p = points.reshape(-1, n, 3)
    b = p.shape[0]
    v = None if valid is None else valid.reshape(b, n)
    rows = torch.arange(b, device=p.device)
    min_d = torch.full((b, n), float("inf"), dtype=p.dtype, device=p.device)
    last = (torch.zeros(b, dtype=torch.long, device=p.device) if v is None
            else torch.argmax(v.to(torch.uint8), dim=1))
    picks = []
    for _ in range(n_samples):
        picks.append(last)
        diff = p - p[rows, last][:, None]
        dx, dy, dz = diff.unbind(-1)
        torch.minimum(min_d, dx * dx + dy * dy + dz * dz, out=min_d)
        last = torch.argmax(min_d if v is None else torch.where(v, min_d, -1.0),
                            dim=1)
    return torch.stack(picks, -1).reshape(*lead, n_samples)


def fps(points: torch.Tensor, n_samples: int,
        valid: torch.Tensor | None = None) -> torch.Tensor:
    """FPS gather: (..., N, 3) -> (..., n_samples, 3) (VCN misc.fps)."""
    idx = farthest_point_sample(points, n_samples, valid)
    return torch.gather(points, -2,
                        idx[..., None].expand(*idx.shape, points.shape[-1]))


def knn_union_mask(partial_pc: torch.Tensor, complete_pc: torch.Tensor, k: int,
                   partial_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Union of the k nearest ``complete`` points over every valid
    ``partial`` point: (..., N, 3), (..., M, 3) -> (..., M) bool.

    The reference's ``approx_max_k`` is exact off the TPU; ``topk`` is the
    exact selection it lowers to there. The selection carries no gradient,
    so the distances are taken from detached inputs."""
    d = pairwise_sqdist(partial_pc.detach(), complete_pc.detach())  # (..., N, M)
    m = complete_pc.shape[-2]
    _, idx = torch.topk(d, k, dim=-1, largest=False)               # (..., N, k)
    if partial_valid is not None:
        idx = torch.where(partial_valid[..., None], idx, m)        # drop rows
    mask = torch.zeros((*idx.shape[:-2], m + 1), dtype=torch.bool,
                       device=d.device)
    mask.scatter_(-1, idx.flatten(-2), True)
    return mask[..., :m]


def partial_mesh_batch(batch_partial: torch.Tensor, batch_complete: torch.Tensor,
                       k: int = 30, surface_pts: int = 1024,
                       partial_valid: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) observed, (B, M, 3) predicted -> (B, surface_pts, 3): the
    predicted points near observed ones, cyclically tiled to a fixed count."""
    sel = knn_union_mask(batch_partial, batch_complete, k, partial_valid)
    out, _ = tile_to_n(batch_complete, sel, surface_pts)
    return out


def within_radius_mask(a: torch.Tensor, b: torch.Tensor, radius: float,
                       b_valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) bool: does each point of ``a`` (N, 3) have a valid ``b`` (M, 3)
    point within ``radius``? On a CUDA tensor this always runs the pruned
    min-distance kernel; on a CPU tensor its plain version."""
    d = min_sqdist(a[:, :3], b[:, :3], b_valid=b_valid,
                   prune_radius=float(radius))
    return d <= radius * radius


_HASH_PRIMES = (73856093, 19349663, 83492791)


def cell_hash(c: torch.Tensor, t: int) -> torch.Tensor:
    """(..., 3) int32 cell coords -> bucket id in [0, t), the reference's
    spatial hash: each coordinate times its prime in int32 (wrapping), the
    three XORed, ``abs`` (which leaves INT_MIN negative), then the floor
    modulo, all in int32 so that every bucket is the reference's."""
    c = c.to(torch.int32)
    h = (c[..., 0] * _HASH_PRIMES[0]) ^ (c[..., 1] * _HASH_PRIMES[1]) \
        ^ (c[..., 2] * _HASH_PRIMES[2])
    return torch.remainder(torch.abs(h), t)


def grid_subsample(points: torch.Tensor, valid: torch.Tensor, cell: float,
                   max_out: int, table_size: int = 1 << 18):
    """Keep the lowest-index valid point of each occupied hash bucket of
    ``cell``-sized cells (origin at the valid points' minimum), the buckets
    in ascending order, truncated to ``max_out`` -> ((max_out,) int64
    indices, (max_out,) bool). Unused slots read index 0. Hash collisions
    merge distant cells, as in the reference; the kept set is the
    reference's bit for bit."""
    n = points.shape[0]
    dev = points.device
    xyz = points[:, :3]
    origin = torch.where(valid[:, None], xyz, torch.inf).amin(0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    # a divisor tensor, not a Python float: CUDA turns division by a scalar
    # into a product with its reciprocal, which may round a cell differently
    c = torch.floor((xyz - origin) / xyz.new_tensor(max(float(cell), 1e-3)))
    h = torch.where(valid, cell_hash(c.to(torch.int32), table_size), table_size)
    slot = torch.full((table_size + 1,), n, dtype=torch.int64, device=dev)
    slot.scatter_reduce_(0, h.long(), torch.arange(n, device=dev), "amin")
    occ = slot[:table_size] < n
    # the first max_out occupied buckets, in bucket order, without a sync
    pos = torch.cumsum(occ, 0) - 1
    sel = torch.full((max_out + 1,), -1, dtype=torch.int64, device=dev)
    sel.scatter_(0, torch.where(occ & (pos < max_out), pos, max_out),
                 torch.arange(table_size, device=dev))
    sel = sel[:max_out]
    ok = sel >= 0
    idx = slot[sel.clamp_min(0)]
    return torch.where(ok, idx, 0), ok


def sample_points_with_roi_mask(points: torch.Tensor, rois: torch.Tensor,
                                roi_mask: torch.Tensor, sample_radius_with_roi: float,
                                valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) bool: the points within their nearest RoI's half-diagonal plus
    ``sample_radius_with_roi`` of that RoI's centre, PV-RCNN++'s
    proposal-centric filter (reference voxel_set_abstraction.py:
    sample_points_with_roi). points (N, 3+), rois (M, 7+), roi_mask (M,).

    As the JAX package computes it: Gram-form distances to the centres
    (masked RoIs at +inf), the nearest by ``argmin`` (ties to the lower
    index), the half-diagonal's norm summed x, y, z; no point passes when
    no RoI is valid, and none that is not ``valid``."""
    d2 = pairwise_sqdist(points[:, :3], rois[:, :3])
    d2 = torch.where(roi_mask[None, :], d2, torch.inf)
    nearest = torch.argmin(d2, dim=1)
    min_dis = torch.sqrt(torch.gather(d2, 1, nearest[:, None])[:, 0])
    half = rois[nearest, 3:6] / 2
    roi_max_dim = torch.sqrt(half[:, 0] * half[:, 0] + half[:, 1] * half[:, 1]
                             + half[:, 2] * half[:, 2])
    mask = (min_dis < roi_max_dim + sample_radius_with_roi) & roi_mask.any()
    return mask if valid is None else mask & valid


def sector_ids(points: torch.Tensor, num_sectors: int) -> torch.Tensor:
    """(..., N, 3+) -> (..., N) int64 azimuthal sector in [0, S): floor((
    atan2(y, x) + pi) / (2 pi / S)) in f32, clamped, as the JAX package's
    ``sector_fps_sample`` computes it."""
    f32 = dict(dtype=torch.float32, device=points.device)
    # tensors, not Python scalars: CUDA divides by a scalar through its
    # reciprocal
    ang = torch.atan2(points[..., 1].float(), points[..., 0].float()) \
        + torch.tensor(math.pi, **f32)
    sec = torch.floor(ang / torch.tensor(2.0 * math.pi / num_sectors, **f32))
    return sec.to(torch.int32).clamp(0, num_sectors - 1).long()


def sector_quotas(sec: torch.Tensor, valid: torch.Tensor, num_sectors: int,
                  num_keypoints: int) -> torch.Tensor:
    """(b, N) sectors and validity -> (b, S) int64 quotas: min(count_s,
    ceil(count_s / total * k)), the share in f32 as the JAX package's
    ``sector_fps_sample`` takes it."""
    s = int(num_sectors)
    cnt = torch.zeros((sec.shape[0], s + 1), dtype=torch.int64, device=sec.device)
    cnt.scatter_add_(1, torch.where(valid, sec, s), torch.ones_like(sec))
    cnt = cnt[:, :s]
    total = cnt.sum(1, keepdim=True).clamp_min(1)
    return torch.minimum(cnt, torch.ceil(cnt.float() / total.float() * num_keypoints).long())


@torch.no_grad()
def sector_fps_sample(points: torch.Tensor, valid: torch.Tensor, num_keypoints: int,
                      num_sectors: int):
    """Azimuthal-sector quota FPS (reference voxel_set_abstraction.py:
    sector_fps; port of the JAX package's ``sector_fps_sample``): points
    (..., N, 3+), valid (..., N) -> ((..., k) int64 indices, (..., k) bool
    pick validity), k = ``num_keypoints``.

    Each point's sector is floor((atan2(y, x) + pi) / (2 pi / S)); sector s
    keeps quota_s = min(count_s, ceil(count_s / total * k)) picks (in f32),
    the FPS picks of its valid points in order; pick j of sector s scores
    (j + 0.5) / quota_s, and the k smallest scores win, ties to the lower
    (sector, pick) position, as ``jax.lax.top_k`` breaks them (a stable
    sort). Picks past a quota or in an empty sector never win; a slot no
    pick fills reads the first winner, with validity False.

    All sectors of all frames run as one batched ``farthest_point_sample``.
    It runs max(quota) steps, not JAX's k: FPS picks in order, so the first
    quota_s picks of a sector are the same however far the loop goes, and
    no later pick can win."""
    *lead, n, _ = points.shape
    s, k = int(num_sectors), int(num_keypoints)
    xyz = points[..., :3].reshape(-1, n, 3)
    v = valid.reshape(-1, n)
    b, dev = xyz.shape[0], xyz.device
    sec = sector_ids(xyz, s)                                           # (b, n)
    quota = sector_quotas(sec, v, s, k)                                # (b, s)
    per_k = min(k, n)
    steps = max(1, min(per_k, int(quota.max())))
    sectors = torch.arange(s, device=dev)
    in_sec = v[:, None, :] & (sec[:, None, :] == sectors[None, :, None])   # (b, s, n)
    idx = farthest_point_sample(xyz[:, None].expand(b, s, n, 3), steps, in_sec)
    j = torch.arange(steps, device=dev)
    score = torch.where(j < quota[..., None],
                        (j.float() + 0.5) / quota.clamp_min(1)[..., None].float(), torch.inf)
    picked = torch.gather(sec, 1, idx.reshape(b, -1)).reshape(b, s, steps) \
        == sectors[None, :, None]
    score = torch.where(picked, score, torch.inf).reshape(b, -1)
    idx = idx.reshape(b, -1)
    if score.shape[1] < k:                       # fewer candidates than k
        pad = k - score.shape[1]
        score = torch.cat([score, score.new_full((b, pad), torch.inf)], 1)
        idx = torch.cat([idx, idx.new_zeros((b, pad))], 1)
    order = torch.sort(score, dim=1, stable=True).indices[:, :k]
    out = torch.gather(idx, 1, order)
    ok = torch.isfinite(torch.gather(score, 1, order))
    out = torch.where(ok, out, out[:, :1])
    return out.reshape(*lead, k), ok.reshape(*lead, k)


#: (query, support) pairs of one chunk of ``three_nn``
THREE_NN_PAIRS = 1 << 25


def _sqnorm_fma(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...,) x0 x0 + x1 x1 + x2 x2 as a fused multiply-add
    chain, which is how XLA's CPU fusion of the reference's
    ``sum(a * a, -1)`` rounds it."""
    return torch.addcmul(torch.addcmul(x[..., 0] * x[..., 0], x[..., 1], x[..., 1]),
                         x[..., 2], x[..., 2])


def gram_sqdist_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``pairwise_sqdist`` with the squared norms of ``_sqnorm_fma``: (N, 3)
    x (M, 3) -> (N, M). On the CPU this is the reference's jitted
    ``pairwise_sqdist`` bit for bit, its Gram-form residue at coincident
    points included."""
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp_min(_sqnorm_fma(a)[:, None] + _sqnorm_fma(b)[None, :] - 2 * ab, 0.0)


@torch.no_grad()
def three_nn(query: torch.Tensor, support: torch.Tensor,
             support_valid: torch.Tensor | None = None):
    """The three nearest supports of each query: query (N, 3), support (M,
    3) -> (idx (N, 3) int64, d (N, 3) squared distances), as the reference
    selects them (``lax.top_k`` of the negated Gram-form distances): the
    Gram form clamped at 0 (``gram_sqdist_fma``: a query that is also a
    support keeps that form's rounding residue), invalid supports at +inf,
    nearest first, ties to the lower index. Three passes of ``argmin``
    (the first minimum), each pick masked before the next, give that order
    exactly; invalid supports rank at the largest finite f32, above every
    valid one and below a masked pick, so that fewer than three valid
    supports still give three distinct picks, as top_k's do. The queries
    run in chunks of ``THREE_NN_PAIRS`` pairs: the rows are independent,
    so chunking changes nothing."""
    n, m = query.shape[0], support.shape[0]
    chunk = max(1, THREE_NN_PAIRS // max(m, 1))
    big = torch.finfo(query.dtype).max
    idx_out, d_out = [], []
    for s in range(0, n, chunk):
        d = gram_sqdist_fma(query[s:s + chunk, :3], support[:, :3])
        if support_valid is not None:
            d = torch.where(support_valid[None, :], d, torch.inf)
        key = torch.where(torch.isinf(d), big, d)
        picks = []
        for _ in range(3):
            j = torch.argmin(key, dim=1)
            picks.append(j)
            key.scatter_(1, j[:, None], torch.inf)
        idx = torch.stack(picks, 1)
        idx_out.append(idx)
        d_out.append(torch.gather(d, 1, idx))
    return torch.cat(idx_out), torch.cat(d_out)


def three_nn_interpolate(query: torch.Tensor, support: torch.Tensor,
                         features: torch.Tensor,
                         support_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN feature interpolation (pointnet2
    three_nn + three_interpolate): query (N, 3), support (M, 3), features
    (M, C) -> (N, C). Weights 1 / max(d, 1e-8) over the ``three_nn``
    distances, normalised to sum 1; an invalid pick weighs 0. The selection
    carries no gradient; the features do."""
    idx, d = three_nn(query, support, support_valid)
    w = 1.0 / d.clamp_min(1e-8)
    w = w / w.sum(1, keepdim=True)
    return torch.einsum("nk,nkc->nc", w.to(features.dtype), features[idx])
