"""Sparse 3D convolution as gather-GEMM, rulebook path (port of the rulebook
part of seevcn_tpu/ops/sparse.py).

Active voxels live in key-sorted buffers with a validity mask. Each conv
looks up, for every (output voxel, kernel offset), the input voxel it reads,
gathers those rows (a miss reads zeros) and does one matrix product; a
strided conv first finds its output active set from every (input, offset)
candidate. The reference's other lowerings of the same math (zfold, dense,
hybrid) are TPU layouts and are not ported: the port runs this one whatever
``BACKBONE_3D.MODE`` says.

The backward is the reference's (``_conv_core``'s custom VJP): the weight
gradient re-gathers the forward's rows, and the input gradient is the
transposed conv as a second gather-GEMM through the inverse queries, with
no scatter-add, so it is deterministic. ``gather_matmul_plain``, the same
forward with autograd's own backward of the gather (an index_put_
accumulate), is the plain version the tests hold it against.

Key invariant, as in the reference: rows are sorted ascending by the
linear key ((b*nz + z)*ny + y)*nx + x, invalid rows last (key = BIG).
Keys are int64 here (int32 in the reference; the values are the same).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_BIG = np.iinfo(np.int32).max
# a dense key -> row map (int32) is built for key spaces up to this size;
# larger spaces use a binary search (the reference's two lookup routes)
_DENSE_MAP_MAX_SPACE = 1 << 24
# out_capacity value meaning: keep every active output (no truncation)
ALL = -1
# output rows gathered per matrix product, to bound the gather buffer
GEMM_ROWS = 1 << 16


class SparseTensor(NamedTuple):
    features: torch.Tensor    # (N, C)
    coords: torch.Tensor      # (N, 4) int [b, z, y, x]
    mask: torch.Tensor        # (N,) bool
    spatial_shape: tuple      # (nz, ny, nx)
    batch_size: int


def _as3(v) -> tuple:
    if isinstance(v, (tuple, list)):
        if len(v) != 3:
            raise ValueError(f"expected 3 values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def linear_key(coords: torch.Tensor, spatial_shape, valid: torch.Tensor) -> torch.Tensor:
    nz, ny, nx = spatial_shape
    c = coords.long()
    key = ((c[:, 0] * nz + c[:, 1]) * ny + c[:, 2]) * nx + c[:, 3]
    return torch.where(valid, key, _BIG)


def make_sparse_tensor(features, coords, mask, spatial_shape, batch_size) -> SparseTensor:
    nz, ny, nx = (int(s) for s in spatial_shape)
    if batch_size * nz * ny * nx >= _BIG:
        raise ValueError("linear keys overflow int32; shrink batch or grid")
    return SparseTensor(features, coords, mask, (nz, ny, nx), int(batch_size))


def _offsets(kernel_size, device=None) -> torch.Tensor:
    """Kernel offsets in z-major order: row k of the (K, cin, cout) weight
    is offset (k // (ky*kx), k // kx % ky, k % kx)."""
    kz, ky, kx = kernel_size
    oz, oy, ox = np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx),
                             indexing="ij")
    return torch.as_tensor(np.stack([oz.ravel(), oy.ravel(), ox.ravel()], 1),
                           dtype=torch.int64, device=device)


def _key_space(spatial_shape, batch_size: int) -> int:
    nz, ny, nx = spatial_shape
    return int(batch_size) * int(nz) * int(ny) * int(nx)


def _lookup(keys_sorted: torch.Tensor, queries: torch.Tensor,
            key_space: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(M,) queries into (N,) ascending keys -> (row index, found). Key
    spaces up to 2^24 go through a dense key -> row map (one scatter, then
    one read per query), larger ones through a binary search; both give the
    same rows. BIG never counts as found."""
    n = keys_sorted.shape[0]
    if key_space is not None and key_space <= _DENSE_MAP_MAX_SPACE:
        kvalid = keys_sorted < _BIG
        safe = torch.where(kvalid, keys_sorted, key_space)
        rows = torch.arange(n, dtype=torch.int32, device=keys_sorted.device)
        dmap = torch.full((key_space + 1,), -1, dtype=torch.int32,
                          device=keys_sorted.device)
        # valid keys are unique; every invalid row writes -1 to the spare slot
        dmap.scatter_(0, safe, torch.where(kvalid, rows, -1))
        q = torch.where(queries == _BIG, key_space, queries.clamp(0, key_space))
        idx = dmap[q].long()
        found = (idx >= 0) & (queries != _BIG)
        return idx.clamp_min(0), found
    idx = torch.searchsorted(keys_sorted, queries).clamp(0, max(n - 1, 0))
    found = (keys_sorted[idx] == queries) & (queries != _BIG)
    return idx, found


def _conv_queries(coords, valid, offs, stride, pad, src_shape) -> torch.Tensor:
    """Query keys for y(p) = sum_k W[k] x(p*stride - pad + off_k): (V, K)
    keys into the source key space, BIG where out of range or invalid."""
    stride = torch.as_tensor(_as3(stride), device=coords.device)
    pad = torch.as_tensor(_as3(pad), device=coords.device)
    c = coords.long()
    t = c[:, None, 1:4] * stride - pad + offs[None]            # (V, K, 3)
    nz, ny, nx = src_shape
    dims = torch.as_tensor([nz, ny, nx], device=coords.device)
    inb = ((t >= 0) & (t < dims)).all(-1)
    q = ((c[:, 0:1] * nz + t[..., 0]) * ny + t[..., 1]) * nx + t[..., 2]
    return torch.where(inb & valid[:, None], q, _BIG)


def _invconv_queries(coords, valid, offs, stride, pad, out_shape) -> torch.Tensor:
    """Query keys for the transposed gather dx(j) = sum_k W[k]^T dy(p) with
    p = (j + pad - off_k) / stride where that divides: (N, K) keys into the
    output key space, BIG where out of range, not divisible or invalid."""
    stride = torch.as_tensor(_as3(stride), device=coords.device)
    pad = torch.as_tensor(_as3(pad), device=coords.device)
    c = coords.long()
    num = c[:, None, 1:4] + pad - offs[None]                   # (N, K, 3)
    divisible = (num % stride == 0).all(-1)
    t = torch.div(num, stride, rounding_mode="floor")
    nz, ny, nx = out_shape
    dims = torch.as_tensor([nz, ny, nx], device=coords.device)
    inb = ((t >= 0) & (t < dims)).all(-1) & divisible
    q = ((c[:, 0:1] * nz + t[..., 0]) * ny + t[..., 1]) * nx + t[..., 2]
    return torch.where(inb & valid[:, None], q, _BIG)


def _lookup_rows(keys, q, key_space) -> torch.Tensor:
    """(V, K) query keys -> (V, K) rows of ``keys``; a miss names the zero
    row appended after the last one (row keys.shape[0])."""
    idx, found = _lookup(keys, q.reshape(-1), key_space)
    return torch.where(found, idx, keys.shape[0]).view(q.shape)


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def _gather_product(x, w2, rows, block: int = GEMM_ROWS) -> torch.Tensor:
    """y[v] = concat_k x[rows[v, k]] @ w2 for (V, K) rows into x with its
    zero row appended; one matrix product per block of rows, in x's dtype
    with f32 accumulation."""
    padded = _with_zero_row(x)
    kc = rows.shape[1] * x.shape[1]
    y = x.new_empty((rows.shape[0], w2.shape[1]))
    for s in range(0, rows.shape[0], block):
        y[s:s + block] = padded[rows[s:s + block]].reshape(-1, kc) @ w2
    return y


def _zero_where_not(mask, y):
    return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype,
                                                     device=y.device))


class _BwdPlan(NamedTuple):
    """What the transposed gather needs: the input's coords and mask, the
    conv's geometry, the output's keys and key space."""
    in_coords: torch.Tensor
    in_mask: torch.Tensor
    offs: torch.Tensor
    stride: tuple
    pad: tuple
    out_shape: tuple
    out_keys: torch.Tensor
    out_space: int


class _RulebookConv(torch.autograd.Function):
    """The gather-GEMM with the reference's backward (seevcn_tpu/ops/
    sparse.py:_conv_core): dW = (re-gathered inputs)^T dy, the gathered
    matrix re-gathered from the forward's rows rather than kept; dx the
    transposed conv as a second gather-GEMM through the inverse queries, so
    no scatter-add and no atomics: deterministic."""

    @staticmethod
    def forward(ctx, features, weight, rows, out_mask, plan):
        k, cin, cout = weight.shape
        y = _gather_product(features, weight.reshape(k * cin, cout).to(features.dtype),
                            rows)
        ctx.save_for_backward(features, weight, rows, out_mask)
        ctx.plan = plan
        return _zero_where_not(out_mask, y)

    @staticmethod
    def backward(ctx, dy):
        features, weight, rows, out_mask = ctx.saved_tensors
        plan = ctx.plan
        k, cin, cout = weight.shape
        dy = _zero_where_not(out_mask, dy.to(features.dtype))
        dw = dx = None
        if ctx.needs_input_grad[1]:
            # f32 products and sums, as the reference's f32 matmul: a bf16
            # product is exact in f32, and no block's sum is rounded to bf16.
            # The rows are gathered from an f32 copy of the features, so the
            # gathered block needs no second pass to widen it.
            padded = _with_zero_row(features).float()
            dw = torch.zeros((k * cin, cout), dtype=torch.float32, device=dy.device)
            for s in range(0, rows.shape[0], GEMM_ROWS):
                g = padded[rows[s:s + GEMM_ROWS]].reshape(-1, k * cin)
                dw.addmm_(g.T, dy[s:s + GEMM_ROWS].float())
            dw = dw.view(k, cin, cout).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            q = _invconv_queries(plan.in_coords, plan.in_mask, plan.offs,
                                 plan.stride, plan.pad, plan.out_shape)
            rows_t = _lookup_rows(plan.out_keys, q, plan.out_space)
            wt = weight.permute(0, 2, 1).reshape(k * cout, cin).to(features.dtype)
            dx = _zero_where_not(plan.in_mask, _gather_product(dy, wt, rows_t))
        return dx, dw, None, None, None


def gather_matmul_plain(features, weight, rows, out_mask):
    """The plain version of ``_RulebookConv``: the same forward, with
    autograd's own backward (the gather's gradient an index_put_
    accumulate)."""
    k, cin, cout = weight.shape
    padded = _with_zero_row(features)
    y = padded[rows].reshape(-1, k * cin) @ weight.reshape(k * cin, cout).to(
        features.dtype)
    return _zero_where_not(out_mask, y)


def _gather_gemm(st: SparseTensor, out_coords, out_mask, weight, kernel_size,
                 stride, padding, in_keys, out_keys, out_shape) -> torch.Tensor:
    """y(p) = sum_k W[k] x(p*stride - pad + off_k) for the active outputs;
    weight (K, cin, cout) in any dtype, cast to the features' inside."""
    offs = _offsets(kernel_size, st.features.device)
    q = _conv_queries(out_coords, out_mask, offs, stride, padding,
                      st.spatial_shape)
    rows = _lookup_rows(in_keys, q, _key_space(st.spatial_shape, st.batch_size))
    w3 = weight.reshape(offs.shape[0], st.features.shape[1], -1)
    plan = _BwdPlan(st.coords, st.mask, offs, _as3(stride), _as3(padding),
                    tuple(out_shape), out_keys, _key_space(out_shape, st.batch_size))
    return _RulebookConv.apply(st.features, w3, rows, out_mask, plan)


def subm_conv3d(st: SparseTensor, weight: torch.Tensor, kernel_size=3,
                padding=1) -> SparseTensor:
    """Submanifold conv (SubMConv3d): the output active set is the input's.
    weight (K, cin, cout) with K in ``_offsets`` order."""
    ks = _as3(kernel_size)
    if weight.shape[0] != ks[0] * ks[1] * ks[2]:
        raise ValueError(f"weight {tuple(weight.shape)} for kernel {ks}")
    in_keys = linear_key(st.coords, st.spatial_shape, st.mask)
    feats = _gather_gemm(st, st.coords, st.mask, weight, ks, 1, padding, in_keys,
                         in_keys, st.spatial_shape)
    return st._replace(features=feats)


def conv_out_shape(spatial_shape, kernel_size=3, stride=1, padding=0) -> tuple:
    ks, st, pd = _as3(kernel_size), _as3(stride), _as3(padding)
    return tuple((n + 2 * p - k) // s + 1
                 for n, k, s, p in zip(spatial_shape, ks, st, pd))


def _active_outputs(st: SparseTensor, ks, stride, pad, out_shape,
                    out_capacity: int) -> torch.Tensor:
    """Ascending keys of the output positions that any active input touches,
    the lowest ``out_capacity`` of them (all where ALL), padded with BIG.
    Output key spaces up to 2^24 take the reference's occupancy-plane route,
    larger ones its sort route; both give the same keys."""
    dev = st.coords.device
    offs = _offsets(ks, dev)
    pz, py, px = pad
    c = st.coords.long()
    num = c[:, None, 1:4] + torch.as_tensor([pz, py, px], device=dev) - offs[None]
    strides = torch.as_tensor(stride, device=dev)
    divisible = (num % strides == 0).all(-1)
    out_zyx = torch.div(num, strides, rounding_mode="floor")
    odims = torch.as_tensor(out_shape, device=dev)
    inb = ((out_zyx >= 0) & (out_zyx < odims)).all(-1)
    cand_ok = divisible & inb & st.mask[:, None]
    oz, oy, ox = out_shape
    ckey = ((c[:, 0:1] * oz + out_zyx[..., 0]) * oy + out_zyx[..., 1]) * ox \
        + out_zyx[..., 2]
    ckey = torch.where(cand_ok, ckey, _BIG).reshape(-1)

    out_space = _key_space(out_shape, st.batch_size)
    if out_space <= _DENSE_MAP_MAX_SPACE:
        ok = ckey < _BIG
        occ = torch.zeros((out_space + 1,), dtype=torch.bool, device=dev)
        occ.scatter_(0, torch.where(ok, ckey, out_space), ok)
        keys = torch.nonzero(occ[:out_space]).view(-1)
    else:
        skey = torch.sort(ckey).values
        head = torch.ones_like(skey, dtype=torch.bool)
        head[1:] = skey[1:] != skey[:-1]
        keys = skey[head & (skey < _BIG)]
    if out_capacity == ALL:
        return keys
    keys = keys[:out_capacity]
    return torch.cat([keys, keys.new_full((out_capacity - keys.shape[0],), _BIG)])


def sparse_conv3d(st: SparseTensor, weight: torch.Tensor, kernel_size=3,
                  stride=1, padding=0, out_capacity: int | None = None) -> SparseTensor:
    """Strided / regular sparse conv (SparseConv3d): the output active set
    is every position that any active input touches, kept in ascending key
    order up to ``out_capacity`` rows (default: the input's row count, as in
    the reference; ``ALL`` keeps every one, with as many rows)."""
    ks, stride, pad = _as3(kernel_size), _as3(stride), _as3(padding)
    if weight.shape[0] != ks[0] * ks[1] * ks[2]:
        raise ValueError(f"weight {tuple(weight.shape)} for kernel {ks}")
    if out_capacity is None:
        out_capacity = st.features.shape[0]
    out_shape = conv_out_shape(st.spatial_shape, ks, stride, pad)
    out_keys = _active_outputs(st, ks, stride, pad, out_shape, int(out_capacity))
    out_mask = out_keys < _BIG
    oz, oy, ox = out_shape
    okey = torch.where(out_mask, out_keys, 0)
    out_coords = torch.stack([okey // (oz * oy * ox), okey // (oy * ox) % oz,
                              okey // ox % oy, okey % ox], 1).to(torch.int32)
    in_keys = linear_key(st.coords, st.spatial_shape, st.mask)
    feats = _gather_gemm(st, out_coords, out_mask, weight, ks, stride, pad,
                         in_keys, out_keys, out_shape)
    return SparseTensor(feats, out_coords, out_mask, out_shape, st.batch_size)


def to_dense(st: SparseTensor) -> torch.Tensor:
    """(B, nz, ny, nx, C) dense scatter (spconv SparseConvTensor.dense())."""
    nz, ny, nx = st.spatial_shape
    c = st.features.shape[-1]
    lin = torch.where(st.mask, linear_key(st.coords, st.spatial_shape, st.mask), 0)
    feats = torch.where(st.mask[:, None], st.features,
                        torch.zeros((), dtype=st.features.dtype,
                                    device=st.features.device))
    dense = st.features.new_zeros((st.batch_size * nz * ny * nx, c))
    dense.index_add_(0, lin, feats)      # valid keys are unique: add == set
    return dense.view(st.batch_size, nz, ny, nx, c)
