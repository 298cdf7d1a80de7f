"""Helpers for holding the port against its reference: numpy <-> torch
conversion, an ``assert_close`` that names the worst element, the cases at
the edges of kernel K2's tiling, the tiny Mask R-CNN config, a switch to
the sparse conv's plain backward, and the VCN gradient comparison with the
recorders of the VCN's discrete choices, which the tests and chip_smoke.py
all use."""
from __future__ import annotations

import contextlib
import re

import numpy as np
import torch

from seevcn_torch.geom import transforms as T
from seevcn_torch.models.seg2d.maskrcnn import Seg2DConfig
from seevcn_torch.models.vcn import nets as VN
from seevcn_torch.ops import sparse as SP
from seevcn_torch.ops.cuda.min_dist import FAR
from seevcn_torch.ops.sampling import (farthest_point_sample, knn_union_mask,
                                       pairwise_sqdist, tile_to_n)


def to_torch(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """numpy array (or anything np.asarray takes) -> torch tensor."""
    return torch.tensor(np.asarray(x), device=device)


def to_numpy(x) -> np.ndarray:
    """torch tensor (any device) or array-like -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(actual, expected, atol: float = 0.0, rtol: float = 0.0,
                 name: str = "value") -> None:
    """Raise AssertionError unless |actual - expected| <= atol + rtol*|expected|
    everywhere; the message names the worst element and its two values.
    Boolean and integer inputs are compared for exact equality."""
    a, e = to_numpy(actual), to_numpy(expected)
    if a.shape != e.shape:
        raise AssertionError(f"{name}: shape {a.shape} != {e.shape}")
    if a.size == 0:
        return
    if a.dtype == bool or e.dtype == bool or (
            np.issubdtype(a.dtype, np.integer)
            and np.issubdtype(e.dtype, np.integer)):
        bad = a != e
        if bad.any():
            idx = np.unravel_index(np.argmax(bad), a.shape)
            raise AssertionError(
                f"{name}: {int(bad.sum())} of {a.size} elements differ; "
                f"first at {idx}: {a[idx]} != {e[idx]}")
        return
    a64, e64 = a.astype(np.float64), e.astype(np.float64)
    err = np.abs(a64 - e64)
    err = np.where(np.isnan(a64) & np.isnan(e64), 0.0, err)
    err = np.where(np.isinf(e64) & (a64 == e64), 0.0, err)
    excess = err - (atol + rtol * np.abs(e64))
    excess = np.where(np.isnan(excess), np.inf, excess)
    if (excess > 0).any():
        idx = np.unravel_index(np.argmax(excess), a.shape)
        raise AssertionError(
            f"{name}: {int((excess > 0).sum())} of {a.size} elements exceed "
            f"atol={atol} rtol={rtol}; worst at {idx}: {a[idx]} vs {e[idx]} "
            f"(|diff| {err[idx]:.3g})")


# K2's tiling (ops/cuda/min_dist.py): units of K2_GROUP = 1,024 query rows
# (8 a thread) by K2_TILE = 512 support rows, cut into runs, one a block.
# N of 1, one below and one above a unit's rows, not a multiple of 8; M of
# 1, one below and one above one and two tiles; a support of rows all at
# the pushed value 1e9; query rows at 1e9, where a padding row at 1e9 would
# read 0; several blocks whose minima meet on each row; and, on the card,
# more units than the card holds blocks, so that runs cross from one row
# group into the next (the plain version of that case is too large for a
# CPU).
K2_EDGES = ("n1_m513", "n1023_m1", "n1025_m511_invalid", "n1030_m1025",
            "n1024_m1023", "n2049_m512", "all_rows_far", "queries_at_far",
            "n2100_m9000_invalid")
K2_CARD_EDGES = K2_EDGES + ("n20000_m40000",)


def k2_edge_case(name: str):
    """One of K2_CARD_EDGES as numpy (a (N, 3), b (M, 3), valid (M,) or
    None), made from a seed."""
    rng = np.random.RandomState(40 + K2_CARD_EDGES.index(name))

    def cloud(n):
        return rng.uniform(-30, 30, (n, 3)).astype(np.float32)

    far = np.float32(FAR)
    if name == "all_rows_far":
        return cloud(300), np.full((600, 3), far, np.float32), None
    if name == "queries_at_far":
        return (np.concatenate([cloud(5), np.full((4, 3), far, np.float32)]),
                cloud(700), None)
    n, m = (int(x) for x in re.match(r"n(\d+)_m(\d+)", name).groups())
    valid = rng.rand(m) > 0.3 if name.endswith("invalid") else None
    return cloud(n), cloud(m), valid


def tiny_seg2d_cfg() -> Seg2DConfig:
    """The reference's tiny Mask R-CNN test config (tests/test_seg2d.py's
    ``_tiny_cfg``): a 96x128 image, one block a stage at widths (16, 32, 64,
    64), FPN width 32, 128 pre-NMS proposals, 32 RoIs, 4 detections."""
    return Seg2DConfig(image_size=(96, 128), max_gt=4, pre_nms_topk=128,
                       num_proposals=32, roi_batch=16, rpn_batch=64,
                       max_detections=4, stage_sizes=(1, 1, 1, 1),
                       stage_channels=(16, 32, 64, 64), fpn_channels=32,
                       box_hidden=128, mask_channels=32, mask_convs=2)


@contextlib.contextmanager
def plain_sparse_backward():
    """Within the block, every sparse conv runs ``gather_matmul_plain`` (the
    same forward, autograd's own backward of the gather) in place of the
    rulebook conv's reference backward."""
    conv = SP._RulebookConv
    saved = conv.__dict__.get("apply")
    conv.apply = staticmethod(lambda features, weight, rows, out_mask, plan:
                              SP.gather_matmul_plain(features, weight, rows, out_mask))
    try:
        yield
    finally:
        if saved is None:
            del conv.apply
        else:
            conv.apply = saved


# VCN biases whose effect a batch norm in training takes out again: the
# Conv1d layers before a BatchNorm1d, and mlp_conv1's last, which shifts
# both halves of mlp_conv2's input (the points and their max) alike. Their
# gradient is 0 in exact arithmetic, so any two computations of it read
# rounding noise.
VCN_BIASES_BEFORE_BN = ("encoder.mlp_conv1.0.bias", "encoder.mlp_conv1.3.bias",
                        "encoder.mlp_conv2.0.bias")


def assert_vcn_grads_close(got: dict, ref: dict, tol: float = 5e-4) -> float:
    """VCN parameter gradients by name: within ``tol`` of each tensor's
    largest |ref|, except VCN_BIASES_BEFORE_BN, which must read under 1e-5
    of their layer's largest weight gradient on both sides. -> the worst
    |got - ref| over the compared tensors."""
    worst = 0.0
    for k, r in ref.items():
        r, g = to_numpy(r), to_numpy(got[k])
        if k in VCN_BIASES_BEFORE_BN:
            scale = np.abs(to_numpy(ref[k.replace("bias", "weight")])).max()
            if max(np.abs(r).max(), np.abs(g).max()) > 1e-5 * scale:
                raise AssertionError(f"{k}: gradient not at rounding level")
            continue
        assert_close(g, r, atol=tol * np.abs(r).max() + 1e-12, name=k)
        worst = max(worst, float(np.abs(g - r).max()))
    return worst


@contextlib.contextmanager
def vcn_pool_points(net):
    """Within the block, record which point each channel of the VCN's
    max-pools picks (the pose encoder's, where the net has one, then the
    feature encoder's two), into the list yielded ((B, C) int64 per pool and
    forward). Where two computations pick different points for a near-tie,
    their gradients differ by design."""
    picks = []

    def record(mod, inputs, out):
        with torch.no_grad():
            feat = VN._pointwise(mod, inputs[0]) \
                if mod is getattr(net, "pose_encoder", None) else out
            picks.append(feat.detach().argmax(1).cpu())

    mods = [getattr(net, "pose_encoder", None), net.encoder.mlp_conv1, net.encoder.mlp_conv2]
    hooks = [m.register_forward_hook(record) for m in mods if m is not None]
    try:
        yield picks
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def vcn_loss_selections(pinned: list | None = None):
    """Within the block, the VCN losses (models/vcn/nets.py) record each
    discrete choice they make, in call order, into the list yielded as
    (what, tensor on the CPU) pairs: FPS's indices, each partial mesh's
    top-k mask, each chamfer's nearest neighbours both ways (a mask of the
    entries at each row's minimum: squared distances in the Gram form
    round to a grid set by |a|^2 and tie exactly on it, and the gradient is
    shared by the tied entries), and the rotation loss's geodesic distances
    and where their cosine is clamped. Recording runs the losses' own
    functions. Given ``pinned``, such a list from another run, FPS, the
    partial meshes and the chamfers take its choices in place of their own,
    the chamfers as means over the pinned entries of the same distance
    matrix, so that two devices' gradients can be held to each other where
    a choice sits within rounding of its switch."""
    made, count = [], {}
    queue = None if pinned is None else [sel for w, sel in pinned
                                         if not w.startswith("geodesic")]

    def take(what, sel):
        count[what] = count.get(what, 0) + 1
        if queue is not None:
            sel = queue.pop(0).to(sel.device)
        made.append((f"{what} #{count[what]}", sel.cpu()))
        return sel

    def fps(points, n_samples):
        idx = take("fps indices", farthest_point_sample(points, n_samples))
        return torch.gather(points, -2, idx[..., None].expand(*idx.shape, 3))

    def partial_mesh_batch(partial, complete, k):
        sel = take("partial-mesh top-k mask", knn_union_mask(partial, complete, k))
        return tile_to_n(complete, sel, 1024)[0]

    def chamfer_l2(a, b):
        d = pairwise_sqdist(a, b)
        t12 = take("chamfer nearest 1->2", d.detach() == d.detach().amin(-1, keepdim=True))
        t21 = take("chamfer nearest 2->1", d.detach() == d.detach().amin(-2, keepdim=True))
        if queue is None:
            return real["chamfer_l2"](a, b)
        # amin's gradient: shared evenly by the entries tied at the minimum
        return ((d * t12).sum(-1) / t12.sum(-1)).mean() + \
            ((d * t21).sum(-2) / t21.sum(-2)).mean()

    def geodesic_distance(r1, r2, eps: float = 1e-7):
        m = (r1 @ r2.transpose(-1, -2)).detach()
        cos = (m.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
        made.append(("geodesic clamp", ((cos <= -1.0 + eps) | (cos >= 1.0 - eps)).cpu()))
        g = real["geodesic_distance"](r1, r2, eps)
        made.append(("geodesic distance", g.detach().cpu()))
        return g

    real = {"fps": VN.fps, "partial_mesh_batch": VN.partial_mesh_batch,
            "chamfer_l2": VN.chamfer_l2, "geodesic_distance": T.geodesic_distance}
    VN.fps, VN.partial_mesh_batch, VN.chamfer_l2 = fps, partial_mesh_batch, chamfer_l2
    T.geodesic_distance = geodesic_distance
    try:
        yield made
    finally:
        VN.fps, VN.partial_mesh_batch = real["fps"], real["partial_mesh_batch"]
        VN.chamfer_l2, T.geodesic_distance = real["chamfer_l2"], real["geodesic_distance"]
    if queue:
        raise AssertionError(f"{len(queue)} pinned VCN loss choices were not taken")


def vcn_selection_flips(got: list, ref: list) -> dict:
    """Where two records of vcn_loss_selections differ: {what: (elements
    that differ, elements)}, with the rotation loss's choice of target (the
    lesser of its two geodesic distances) in place of the distances."""
    def choices(rec):
        g = [s for w, s in rec if w == "geodesic distance"]
        return [(w, s) for w, s in rec if w != "geodesic distance"] + \
            ([("rotation target", g[0] <= g[1])] if g else [])

    got, ref = choices(got), choices(ref)
    if [w for w, _ in got] != [w for w, _ in ref]:
        raise AssertionError("the two runs made different sequences of choices")
    return {w: (int((a != b).sum()), a.numel()) for (w, a), (_, b) in zip(got, ref)}
