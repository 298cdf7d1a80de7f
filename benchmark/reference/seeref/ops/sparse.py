"""Sparse 3D convolution as its definition: a dense convolution over the
scattered grid, read at the active sites.

A sparse tensor is its active rows (features, [b, z, y, x] coords, a
validity mask) on a (nz, ny, nx) grid. Each conv scatters the valid rows
into a dense (B, C, nz, ny, nx) grid with zeros elsewhere, runs
``F.conv3d`` over it (cuDNN's dense algorithm, nothing of a rulebook), and
reads the output back:

- a submanifold conv (SubMConv3d) at the input's active sites;
- a regular or strided conv (SparseConv3d) at every output site whose
  receptive field holds an active input (a max-pool of the occupancy with
  the conv's kernel, stride and padding), in ascending (b, z, y, x) order.

The backward is the same definition: the input's gradient is the dense
conv's (cuDNN's data gradient, read at the input's sites), and the weight's
is its sum, dW[k] = sum over output sites p of g(p) x(p*stride - pad +
off_k)^T, read from the dense grid (cuDNN's own weight gradient of a grid
this size takes seconds a call). The weight is the spconv 2.x layout's (K,
cin, cout) with K in z-major offset order, y(p) = sum_k W[k] x(p*stride -
pad + off_k): the cross-correlation of ``F.conv3d``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# out_capacity value meaning: keep every active output (no truncation)
ALL = -1


class SparseTensor(NamedTuple):
    features: torch.Tensor    # (N, C)
    coords: torch.Tensor      # (N, 4) int [b, z, y, x]
    mask: torch.Tensor        # (N,) bool
    spatial_shape: tuple      # (nz, ny, nx)
    batch_size: int


def _as3(v) -> tuple:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def make_sparse_tensor(features, coords, mask, spatial_shape, batch_size) -> SparseTensor:
    return SparseTensor(features, coords, mask, tuple(int(s) for s in spatial_shape),
                        int(batch_size))


def conv_out_shape(spatial_shape, kernel_size=3, stride=1, padding=0) -> tuple:
    ks, st, pd = _as3(kernel_size), _as3(stride), _as3(padding)
    return tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(spatial_shape, ks, st, pd))


def _scatter(rows, coords, mask, batch_size: int, shape) -> torch.Tensor:
    """(B, C, *shape): the valid rows at their sites, zeros elsewhere."""
    c = coords[mask].long()
    dense = rows.new_zeros((batch_size, *shape, rows.shape[1]))
    dense = dense.index_put((c[:, 0], c[:, 1], c[:, 2], c[:, 3]), rows[mask])
    return dense.permute(0, 4, 1, 2, 3).contiguous()


def to_dense(st: SparseTensor) -> torch.Tensor:
    """(B, C, nz, ny, nx): the valid rows at their sites, zeros elsewhere."""
    return _scatter(st.features, st.coords, st.mask, st.batch_size, st.spatial_shape)


def _read(dense: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rows of ``dense`` (B, C, ...) at ``coords``, zero where not ``mask``."""
    c = coords.long().clamp_min(0)
    rows = dense[c[:, 0], :, c[:, 1], c[:, 2], c[:, 3]]
    return torch.where(mask[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


class _GridConv(torch.autograd.Function):
    """rows (N, cin) at in_coords -> rows (M, cout) at out_coords: the dense
    conv with weight (cout, cin, kz, ky, kx), computed in the rows' dtype."""

    @staticmethod
    def forward(ctx, rows, weight, in_coords, in_mask, out_coords, out_mask, batch, in_shape,
                stride, pad):
        x = _scatter(rows, in_coords, in_mask, batch, in_shape)
        y = F.conv3d(x, weight.to(rows.dtype), stride=stride, padding=pad)
        ctx.save_for_backward(rows, weight, in_coords, in_mask, out_coords, out_mask)
        ctx.geometry = (batch, in_shape, tuple(y.shape[2:]), stride, pad)
        return _read(y, out_coords, out_mask)

    @staticmethod
    def backward(ctx, grad):
        rows, weight, in_coords, in_mask, out_coords, out_mask = ctx.saved_tensors
        batch, in_shape, out_shape, stride, pad = ctx.geometry
        d_rows = d_w = None
        if ctx.needs_input_grad[0]:
            gy = _scatter(grad, out_coords, out_mask, batch, out_shape)
            gx = torch.nn.grad.conv3d_input((batch, rows.shape[1], *in_shape),
                                            weight.to(grad.dtype), gy, stride, pad)
            d_rows = _read(gx, in_coords, in_mask)
        if ctx.needs_input_grad[1]:
            x = F.pad(_scatter(rows, in_coords, in_mask, batch, in_shape),
                      (pad[2], pad[2], pad[1], pad[1], pad[0], pad[0]))
            o = out_coords[out_mask].long()
            g = grad[out_mask].to(weight.dtype)
            d_w = torch.empty_like(weight)
            for kz in range(weight.shape[2]):
                for ky in range(weight.shape[3]):
                    for kx in range(weight.shape[4]):
                        xs = x[o[:, 0], :, o[:, 1] * stride[0] + kz, o[:, 2] * stride[1] + ky,
                               o[:, 3] * stride[2] + kx]
                        d_w[:, :, kz, ky, kx] = g.T @ xs.to(weight.dtype)
        return d_rows, d_w, None, None, None, None, None, None, None, None


def _dense_weight(weight: torch.Tensor, kernel_size) -> torch.Tensor:
    """(K, cin, cout) -> F.conv3d's (cout, cin, kz, ky, kx)."""
    k, cin, cout = weight.shape
    return weight.reshape(*kernel_size, cin, cout).permute(4, 3, 0, 1, 2)


def subm_conv3d(st: SparseTensor, weight: torch.Tensor, kernel_size=3,
                padding=1) -> SparseTensor:
    """SubMConv3d: the dense conv read at the input's active sites."""
    ks = _as3(kernel_size)
    rows = _GridConv.apply(st.features, _dense_weight(weight, ks), st.coords, st.mask,
                           st.coords, st.mask, st.batch_size, st.spatial_shape, (1, 1, 1),
                           _as3(padding))
    return st._replace(features=rows)


def sparse_conv3d(st: SparseTensor, weight: torch.Tensor, kernel_size=3,
                  stride=1, padding=0, out_capacity: int | None = None) -> SparseTensor:
    """SparseConv3d: the dense conv read at every output site that an active
    input reaches, in ascending (b, z, y, x) order; with ``out_capacity``
    (default the input's row count) the lowest that many, ``ALL`` every
    one."""
    ks, stride, pad = _as3(kernel_size), _as3(stride), _as3(padding)
    occ = torch.zeros((st.batch_size, 1, *st.spatial_shape), dtype=torch.float32,
                      device=st.features.device)
    c = st.coords[st.mask].long()
    occ[c[:, 0], 0, c[:, 1], c[:, 2], c[:, 3]] = 1.0
    out_occ = F.max_pool3d(F.pad(occ, (pad[2], pad[2], pad[1], pad[1], pad[0], pad[0])),
                           ks, stride)[:, 0] > 0
    out_coords = torch.nonzero(out_occ).to(torch.int32)          # row-major = key order
    if out_capacity is None:
        out_capacity = st.features.shape[0]
    if out_capacity != ALL:
        out_coords = out_coords[:out_capacity]
    mask = torch.ones(out_coords.shape[0], dtype=torch.bool, device=out_coords.device)
    rows = _GridConv.apply(st.features, _dense_weight(weight, ks), st.coords, st.mask,
                           out_coords, mask, st.batch_size, st.spatial_shape, stride, pad)
    return SparseTensor(rows, out_coords, mask, tuple(out_occ.shape[1:]), st.batch_size)
