"""K1's least time (the within-radius test of the SEE replacement), counted
from its inputs: the bytes of each input read once and of the (N,) f32
output written once, and 9 operations (3 differences, 3 products, 2 sums,
1 comparison) for each (row, valid support row) pair within the radius,
the pairs counted here by hashing both sides into cells of the radius."""
from __future__ import annotations

import itertools

import torch


def pairs_within(a: torch.Tensor, b: torch.Tensor, radius: float, b_valid) -> int:
    """The (row of ``a``, valid row of ``b``) pairs at most ``radius``
    apart: each side binned into cubes of side ``radius``, each row of
    ``a`` tested against the rows of ``b`` in its cube and the 26 around."""
    b = b[:, :3].float() if b_valid is None else b[:, :3].float()[b_valid]
    if b.shape[0] == 0:
        return 0
    a = a[:, :3].float()
    lo, hi = b.amin(0) - radius, b.amax(0) + radius
    a = a[((a >= lo) & (a <= hi)).all(-1)]
    if a.shape[0] == 0:
        return 0
    r = torch.tensor(radius, dtype=torch.float32, device=b.device)
    cb = torch.floor((b - lo) / r).long()
    ca = torch.floor((a - lo) / r).long()
    dims = torch.maximum(cb.amax(0), ca.amax(0)) + 2

    def key(c):
        return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]

    kb, order = torch.sort(key(cb))
    bs = b[order]
    r2 = radius * radius
    n = 0
    for off in itertools.product((-1, 0, 1), repeat=3):
        q = ca + torch.tensor(off, device=ca.device)
        ok = (q >= 0).all(-1)
        kq = key(q[ok])
        first = torch.searchsorted(kb, kq)
        cnt = torch.searchsorted(kb, kq, right=True) - first
        total = int(cnt.sum())
        if total == 0:
            continue
        rows = torch.repeat_interleave(torch.arange(kq.numel(), device=kq.device), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        idx = first[rows] + torch.arange(total, device=kq.device) - start[rows]
        d2 = ((a[ok][rows] - bs[idx]) ** 2).sum(-1)
        n += int((d2 <= r2).sum())
    return n


def least_seconds(a, b, radius, b_valid, peaks: dict) -> float:
    nbytes = a[:, :3].numel() * 4 + b[:, :3].numel() * 4 + a.shape[0] * 4
    if b_valid is not None:
        nbytes += b_valid.numel()
    ops = 9 * pairs_within(a, b, radius, b_valid)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["flops_per_s"]["float32"])
