"""The benchmark's own count of a sparse 3D backbone's work: voxel
coordinates from the input points, then each sparse conv's active output
sites and its (input, output) pairs, by hashing the coordinates. Nothing of
the program is used, so a change to its rulebook cannot move the count."""
from __future__ import annotations

import itertools

import torch


def grid_shape(point_cloud_range, voxel_size) -> tuple:
    """(nx, ny, nz) voxels over the range, as OpenPCDet rounds it."""
    lo, hi = point_cloud_range[:3], point_cloud_range[3:]
    return tuple(int(round((h - l) / v)) for l, h, v in zip(lo, hi, voxel_size))


def voxel_sites(points: torch.Tensor, valid: torch.Tensor, point_cloud_range,
                voxel_size, cap: int) -> tuple[torch.Tensor, int]:
    """Points (P, 3) of one frame -> ((V, 3) int64 zyx of the occupied
    voxels, the lowest ``cap`` keys of them; the count before the cap)."""
    lo = torch.tensor(point_cloud_range[:3], device=points.device)
    vs = torch.tensor(voxel_size, device=points.device)
    nx, ny, nz = grid_shape(point_cloud_range, voxel_size)
    ijk = torch.floor((points[:, :3] - lo) / vs).long()
    dims = torch.tensor([nx, ny, nz], device=points.device)
    ok = valid & ((ijk >= 0) & (ijk < dims)).all(-1)
    ijk = ijk[ok]
    key = torch.unique((ijk[:, 2] * ny + ijk[:, 1]) * nx + ijk[:, 0])
    n = int(key.numel())
    key = key[:cap]
    z, rest = key // (ny * nx), key % (ny * nx)
    return torch.stack([z, rest // nx, rest % nx], -1), n


def _keys(c: torch.Tensor, shape) -> torch.Tensor:
    return (c[:, 0] * shape[1] + c[:, 1]) * shape[2] + c[:, 2]


def conv_sites(sites: torch.Tensor, shape, kernel, stride, pad, subm: bool):
    """One sparse conv over active ``sites`` (N, 3) zyx in a grid of
    ``shape`` -> (pairs, output sites, output shape). A submanifold conv
    keeps its sites and pairs each with the active sites of its kernel
    window; a strided conv's outputs are every site its inputs touch."""
    dev = sites.device
    offs = torch.tensor(list(itertools.product(*(range(k) for k in kernel))), device=dev)
    if subm:
        keys = torch.sort(_keys(sites, shape)).values
        nb = sites[:, None, :] + offs[None] - torch.tensor(pad, device=dev)
        inb = ((nb >= 0) & (nb < torch.tensor(shape, device=dev))).all(-1)
        q = _keys(nb.reshape(-1, 3), shape).view(nb.shape[:2])
        pos = torch.searchsorted(keys, q).clamp_max(keys.numel() - 1)
        pairs = int((inb & (keys[pos] == q)).sum())
        return pairs, sites, tuple(shape)
    out_shape = tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(shape, kernel, stride, pad))
    num = sites[:, None, :] + torch.tensor(pad, device=dev) - offs[None]
    st = torch.tensor(stride, device=dev)
    out = torch.div(num, st, rounding_mode="floor")
    ok = (num % st == 0).all(-1) & ((out >= 0) & (out < torch.tensor(out_shape, device=dev))).all(-1)
    outs = out[ok]
    keys = torch.unique(_keys(outs, out_shape))
    z, rest = keys // (out_shape[1] * out_shape[2]), keys % (out_shape[1] * out_shape[2])
    new = torch.stack([z, rest // out_shape[2], rest % out_shape[2]], -1)
    return int(ok.sum()), new, out_shape
