"""The ``mp`` axis of the mesh: the BEV map's W split between the ranks of a
dp row (port of JAX's ``constrain_bev``, seevcn_tpu/parallel/mesh.py:70-84,
which shards a (B, H, W, C) activation as P("dp", None, "mp", None) and
leaves the conv halo exchanges to XLA's partitioner; here they are made by
hand).

- ``scatter_w``: the full map -> this rank's slab of W / mp columns; its
  backward gathers the slabs' gradients, so what ran before it (replicated
  over mp) receives the whole map's gradient on every mp rank.
- ``gather_w``: the slabs -> the full map on every mp rank; its backward
  keeps this rank's slab of the incoming gradient (every mp rank computes
  the same replicated work after it).
- ``halo_w``: a slab with ``left`` / ``right`` columns from its neighbours
  (zeros at the map's true edges); its backward adds each halo's gradient
  back into the neighbour's edge columns.

Each is one all-reduce of a zero buffer on the dp row's group, as
``mesh.gather_rows`` is. Point-to-point (``send`` / ``recv``) and
``all_gather`` are not used: gloo documents them for CPU tensors only, and
gloo ranks that share one card (the only multi-rank group that a one-card
machine runs) hand the collectives CUDA tensors; gloo's and NCCL's
all-reduce take both. Without an active mesh of mp > 1 nothing here runs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import mesh as M


def w_sharded() -> bool:
    """Whether the active mesh splits the BEV map's W (mp > 1)."""
    m = M.active_mesh()
    return m is not None and m.mp > 1


def _exchange(m: M.Mesh, buf: torch.Tensor) -> torch.Tensor:
    """``buf`` summed over the dp row of mesh ``m``, in place."""
    if m.device is not None and buf.device != m.device:
        raise RuntimeError(f"a tensor on {buf.device} reached a collective of the mesh on "
                           f"{m.device}")
    dist.all_reduce(buf, group=m.mp_group)
    return buf


def _gather(m: M.Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every mp rank's slab along ``dim``, joined in mp order."""
    w = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = w * m.mp
    buf = x.new_zeros(shape)
    buf.narrow(dim, m.mp_rank * w, w).copy_(x)
    return _exchange(m, buf)


def _slab(m: M.Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This mp rank's slab of ``x`` along ``dim``."""
    full = x.shape[dim]
    if full % m.mp:
        raise ValueError(f"a BEV map of W {full} does not divide into {m.mp} slabs")
    w = full // m.mp
    return x.narrow(dim, m.mp_rank * w, w).contiguous()


class _ScatterW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.mesh, ctx.dim = M.active_mesh(), dim
        return _slab(ctx.mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.mesh, g.contiguous(), ctx.dim), None


class _GatherW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.mesh, ctx.dim = M.active_mesh(), dim
        return _gather(ctx.mesh, x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return _slab(ctx.mesh, g, ctx.dim), None


class _HaloW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, dim):
        m = ctx.mesh = M.active_mesh()
        r, w = m.mp_rank, x.shape[dim]
        if left > w or right > w:
            raise ValueError(f"a halo of {left} + {right} columns is wider than the "
                             f"slab's {w}")
        ctx.args = (left, right, dim, w)
        # this rank's edges: its first ``right`` columns (its left
        # neighbour's right halo), then its last ``left`` (its right one's)
        edges = torch.cat([x.narrow(dim, 0, right), x.narrow(dim, w - left, left)], dim)
        buf = x.new_zeros((m.mp, *edges.shape))
        buf[r] = edges
        _exchange(m, buf)
        zero = lambda n: x.new_zeros(                                  # noqa: E731
            [n if d == dim else s for d, s in enumerate(x.shape)])
        lh = buf[r - 1].narrow(dim, right, left) if r > 0 else zero(left)
        rh = buf[r + 1].narrow(dim, 0, right) if r < m.mp - 1 else zero(right)
        return torch.cat([lh, x, rh], dim)

    @staticmethod
    def backward(ctx, g):
        left, right, dim, w = ctx.args
        m = ctx.mesh
        r = m.mp_rank
        gx = g.narrow(dim, left, w).clone()
        halos = torch.cat([g.narrow(dim, 0, left), g.narrow(dim, left + w, right)], dim)
        buf = g.new_zeros((m.mp, *halos.shape))
        buf[r] = halos
        _exchange(m, buf)
        if r < m.mp - 1:     # the right neighbour's left halo: my last columns
            gx.narrow(dim, w - left, left).add_(buf[r + 1].narrow(dim, 0, left))
        if r > 0:            # the left neighbour's right halo: my first columns
            gx.narrow(dim, 0, right).add_(buf[r - 1].narrow(dim, left, right))
        return gx, None, None, None


def scatter_w(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's slab of a map ``x`` that every mp rank holds whole (W
    along ``dim``: 2 of (B, H, W, C)); ValueError where W does not divide by
    mp."""
    return _ScatterW.apply(x, dim)


def gather_w(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole map from every mp rank's slab ``x`` (W along ``dim``)."""
    return _GatherW.apply(x, dim)


def halo_w(x: torch.Tensor, left: int, right: int, dim: int = 2) -> torch.Tensor:
    """The slab ``x`` with ``left`` columns of its left neighbour before it
    and ``right`` of its right neighbour after it (W along ``dim``), zeros
    past the map's edges."""
    if left == 0 and right == 0:
        return x
    return _HaloW.apply(x, left, right, dim)
