"""Helpers for holding the port against its reference: numpy <-> torch
conversion, an ``assert_close`` that names the worst element, the cases at
the edges of kernel K2's tiling, the tiny Mask R-CNN and HTC configs, a
single-thread switch for the CPU, a switch to the sparse conv's plain
backward, seeded Mask R-CNN weights with a recorder of its ReLUs' signs,
the VCN gradient comparison with the recorders of the VCN's discrete
choices, and W local ranks of a process group spawned on a free port with
the data- and model-parallel workers they run, which the tests and
chip_smoke.py all use."""
from __future__ import annotations

import contextlib
import os
import re
import socket
import tempfile
import time

import numpy as np
import torch

from seevcn_torch.geom import transforms as T
from seevcn_torch.models.seg2d import maskrcnn as SM
from seevcn_torch.models.seg2d.backend import init_seg2d
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


def tiny_htc_cfg(dcn: bool = False) -> Seg2DConfig:
    """The reference's tiny HTC test config (tests/test_seg2d_htc.py's
    ``_htc_cfg``): a 96x128 image, one block a stage at width 8, FPN width
    8, one mask conv, the 3-stage cascade, the semantic branch and mask info
    flow; with ``dcn`` also deformable convs in stages 1-3 (dconv_c3-c5),
    which makes it full HTC."""
    return Seg2DConfig(image_size=(96, 128), max_gt=4, num_proposals=32, roi_batch=16,
                       pre_nms_topk=64, max_detections=8, stage_sizes=(1, 1, 1, 1),
                       stage_channels=(8, 8, 8, 8), fpn_channels=8, box_hidden=32,
                       mask_channels=8, mask_convs=1, cascade_stages=3,
                       semantic_branch=True, mask_info_flow=True,
                       dcn_stages=(False, True, True, True) if dcn else
                       (False, False, False, False))


def seeded_seg2d_weights(cfg: Seg2DConfig, seed: int = 0) -> dict:
    """A Mask R-CNN state dict at ``cfg``: init_seg2d from ``seed``, then
    biases and running means N(0, 0.1), batch-norm scales and running
    variances U[0.5, 1.5), offset convs N(0, 0.15) (offsets of about a
    pixel), drawn from ``seed + 1``."""
    model = init_seg2d(SM.MaskRCNN(cfg), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    sd = {}
    for name, t in model.state_dict().items():
        t = t.clone()
        if "offset_conv" in name:
            t = 0.15 * torch.randn(t.shape, generator=gen)
        elif name.endswith(("bias", "running_mean")):
            t = 0.1 * torch.randn(t.shape, generator=gen)
        elif name.endswith("running_var") or (name.endswith("weight") and t.dim() == 1):
            t = 0.5 + torch.rand(t.shape, generator=gen)
        sd[name] = t
    return sd


class _PinnedReluF:
    """torch.nn.functional, but with ``relu`` replaced: maskrcnn.py calls
    ``F.relu`` for every ReLU of the Mask R-CNN."""

    def __init__(self, relu):
        self.relu = relu

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)


@contextlib.contextmanager
def seg2d_relu_signs(pinned: list | None = None):
    """Within the block, record where the input of each ReLU of the Mask
    R-CNN is positive, in call order, into the list yielded (bool, on the
    CPU). Given ``pinned``, such a list from another run, each ReLU takes
    its mask from there in place of its own input's sign."""
    signs, queue = [], None if pinned is None else list(pinned)

    def relu(x, inplace=False):
        signs.append((x > 0).cpu())
        if queue is None:
            return torch.nn.functional.relu(x)
        return torch.where(queue.pop(0).to(x.device), x, torch.zeros_like(x))

    plain = SM.F
    SM.F = _PinnedReluF(relu)
    try:
        yield signs
    finally:
        SM.F = plain


@contextlib.contextmanager
def one_cpu_thread():
    """Within the block, PyTorch's CPU ops on one thread. Multi-threaded, the
    CPU build's oneDNN convolution backward corrupts the heap now and then
    at 8 channels (tiny_htc_cfg's width): a crash, or garbage read later.
    On one thread it runs clean, and keeps oneDNN's f32 accuracy, which the
    native convolution (oneDNN off) does not: its f32 bias gradients stray
    by several percent there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


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


def seeded_flax_variables(shapes: dict, seed: int = 0) -> dict:
    """Random flax variables in the layout of ``shapes`` (nested dicts of
    anything with a ``.shape``, as ``jax.eval_shape`` of a model's init
    gives them), as f32 numpy from ``seed``: kernels normal with std
    1/sqrt(fan_in) (fan_in all dimensions but the last), batch-norm scales
    and running variances U[0.5, 1.5), biases and running means N(0, 0.1),
    so that no norm is an identity. Leaves are drawn in sorted key order."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k in sorted(tree):
            x = tree[k]
            if isinstance(x, dict):
                out[k] = fill(x)
                continue
            shape = tuple(x.shape)
            if k == "kernel":
                v = rng.randn(*shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
            elif k in ("scale", "var"):
                v = rng.rand(*shape) + 0.5
            else:
                v = 0.1 * rng.randn(*shape)
            out[k] = np.asarray(v, np.float32)
        return out

    return {col: fill(dict(tree)) for col, tree in shapes.items()}


# --------------------------------------------------------------------------- #
# local process groups: W spawned ranks and the data-parallel workers
# --------------------------------------------------------------------------- #

def free_port() -> int:
    """A TCP port of this host that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, port, out_dir, threads):
    torch.set_num_threads(threads)
    os.environ.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                      JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank))
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    torch.save(fn(rank, world, *args), os.path.join(out_dir, f"{rank}.pt"))


def spawn_ranks(fn, world: int, *args, threads: int = 1, timeout: float = 600.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes, each with
    ``threads`` CPU threads and JAX's launcher environment for a group on a
    free local port (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID; ``init_distributed("jax", device=...)`` reads it). ->
    each rank's return value, in rank order. A rank's exception is raised
    here; past ``timeout`` seconds every rank is ended and TimeoutError
    raised. The arguments reach the ranks through a file: handed to the
    processes directly, torch would move every tensor among them into
    shared memory in place, under any array that aliases its storage
    (a numpy view, or a JAX array made from one without a copy)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        torch.save(args, os.path.join(out_dir, "args.pt"))
        ctx = mp.start_processes(_rank_entry, args=(fn, world, free_port(), out_dir, threads),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def step_case(case: dict, world: int = 1) -> dict:
    """One train step of a detector case on ``case["device"]`` (the CPU by
    default): ``train_step`` at one rank, ``shard_train_step`` on this
    rank's rows of the global batch in a group of ``world``, over a mesh of
    ``case["mp"]`` (1 by default) ranks a dp row. ``case``: cfg,
    sd (its state dict), dtype, inputs
    (points or CaDDN's images, validity or P2, gt_boxes, RoI priorities or
    None: the global batch, numpy), extra (the loss inputs by name), seed
    (of the step's generator: the RoI sample and dropout draw from it where
    the priorities are None), build (``build_detector``'s keywords). -> the
    loss terms (the global batch's), the
    gradients before clipping (summed over the ranks), the parameters and
    buffers after the step, f64."""
    from .models.detectors.second import build_detector
    from .parallel.mesh import make_mesh, shard_batch
    from .train.train import create_train_state, shard_train_step, train_step

    dtype = case.get("dtype", torch.float64)
    dev = torch.device(case.get("device", "cpu"))
    model, _ = build_detector(case["cfg"], case["sd"], device=dev, **case.get("build", {}))
    model.to(dtype)
    state = create_train_state(model, case["cfg"].OPTIMIZATION, 100)
    grads = {}
    step = state.optimizer.step

    def recorded(count):
        grads.update({n: (torch.zeros_like(p) if p.grad is None else p.grad)
                      .to("cpu", torch.float64, copy=True)
                      for n, p in model.named_parameters()})
        step(count)

    state.optimizer.step = recorded
    cast = lambda a: None if a is None else (                     # noqa: E731
        lambda t: (t.to(dtype) if t.is_floating_point() else t).to(dev))(
        torch.from_numpy(np.asarray(a)))
    inputs = [cast(a) for a in case["inputs"]]
    extra = {k: cast(v) for k, v in case.get("extra", {}).items()}
    if world > 1:
        fn, mesh = shard_train_step(model, make_mesh(mp=case.get("mp", 1)))
        inputs, extra = shard_batch(mesh, (inputs, extra))
    else:
        fn = train_step
    pts, valid, gt, u = inputs
    gen = None if case.get("seed") is None else \
        torch.Generator(device=dev).manual_seed(case["seed"])
    terms = fn(state, pts, valid, gt, gen, roi_u=u, **extra)
    grab = lambda d: {k: v.detach().to("cpu", torch.float64, copy=True)   # noqa: E731
                      for k, v in d}
    return {"terms": grab(terms.items()), "grads": grads,
            "params": grab(model.named_parameters()), "buffers": grab(model.named_buffers())}


def dp_steps_worker(rank: int, world: int, cases: list, device: str = "cpu") -> list:
    """``step_case`` of every case on this rank of a gloo group of
    ``world`` (the ``jax`` launcher's environment) on ``device``: the CPU,
    or one card that every rank shares."""
    from .parallel import distributed as D

    D.init_distributed("jax", device=device, backend="gloo")
    try:
        return [step_case(c, world) for c in cases]
    finally:
        D.destroy_distributed()


def bn_case(case: dict, world: int = 1, rank: int = 0, mp: int = 1) -> dict:
    """A training batch norm (``kind`` BatchNorm2d or MaskedBatchNorm) on
    this rank's rows of ``x`` (the global batch, numpy; ``mask`` the masked
    one's rows), its parameters and running statistics from ``case``,
    under a mesh of ``world`` ranks, ``mp`` a dp row: -> the output, the input
    gradient of sum(output * ``g``), the parameter gradients (this rank's
    share) and the running statistics, f64."""
    from .models.modules.common import BatchNorm2d, MaskedBatchNorm
    from .parallel.mesh import make_mesh, set_active_mesh, shard_batch

    c = case["weight"].shape[0]
    bn = BatchNorm2d(c, eps=1e-3, momentum=0.01) if case["kind"] == "BatchNorm2d" \
        else MaskedBatchNorm(c)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(case[k]))
    bn.train()
    rows = {k: torch.from_numpy(case[k]) for k in ("x", "g", "mask") if k in case}
    mesh = make_mesh(mp=mp)
    if world > 1:
        rows = shard_batch(mesh, rows)
    x = rows["x"].clone().requires_grad_(True)
    prev = set_active_mesh(mesh)
    try:
        y = bn(x) if "mask" not in rows else bn(x, rows["mask"])
        (y * rows["g"]).sum().backward()
    finally:
        set_active_mesh(prev)
    return {"y": y.detach().double(), "x_grad": x.grad.double(),
            "weight_grad": bn.weight.grad.double(), "bias_grad": bn.bias.grad.double(),
            "running_mean": bn.running_mean.double().clone(),
            "running_var": bn.running_var.double().clone()}


def parallel_checks_worker(rank: int, world: int, auto_port: int, bn_cases: list,
                           mp_cases: dict) -> dict:
    """On each rank of a CPU group: the collectives at world 2 (the JAX
    package's tests/test_multihost.py cases), the mesh, ``bn_case`` of each
    case, ``mp_checks`` of ``mp_cases`` at mp 2, then a second group
    through torchrun's environment (``auto``) on ``auto_port``."""
    from .parallel import distributed as D
    from .parallel.collectives import (average_reduce_value, get_rank, get_world_size,
                                       merge_results_dist, reduce_dict)
    from .parallel.mesh import make_mesh, shard_batch

    out = {"jax": D.init_distributed("jax", device="cpu")}
    try:
        local = [{"frame": f"{rank}_{i}", "score": rank * 10 + i} for i in range(2 + rank)]
        out.update(
            rank=get_rank(), world=get_world_size(),
            merged=[m["frame"] for m in merge_results_dist(local)],
            average=average_reduce_value(float(rank + 1)),
            reduced=reduce_dict({"loss": rank * 2.0}),
            truncated=merge_results_dist([rank], total_size=1),
            mesh=(make_mesh().rank, make_mesh().world),
            rows=shard_batch(make_mesh(), {"a": np.arange(8).reshape(4, 2)})["a"].tolist(),
            bn=[bn_case(c, world, rank) for c in bn_cases],
            mp=mp_checks(world, 2, **mp_cases))
    finally:
        D.destroy_distributed()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(auto_port))
    out["auto"] = D.init_distributed("auto", device="cpu")
    try:
        t = torch.tensor([float(rank + 1)])
        torch.distributed.all_reduce(t)
        out["auto_sum"] = float(t)
    finally:
        D.destroy_distributed()
    return out


# --------------------------------------------------------------------------- #
# the mp axis: the BEV map's W over the ranks of a dp row
# --------------------------------------------------------------------------- #

def spatial_checks(x: np.ndarray, g: dict) -> dict:
    """``scatter_w``, ``gather_w`` and ``halo_w`` (1 and 1 columns, and the
    stride-2 conv's 1 and 0) on ``x`` (B, H, W, C), the whole map, under the
    active mesh, each with a backward of the upstream gradient ``g[name]``
    (numpy, per mp rank where a rank's output is its own, the output's
    shape): -> the outputs and the gradients each gives back, f64, and each
    error that a W or halo that does not fit raises."""
    from .parallel.mesh import active_mesh
    from .parallel.spatial import gather_w, halo_w, scatter_w

    r = active_mesh().mp_rank
    out, full = {}, torch.from_numpy(x)

    def run(name, fn, t):
        t = t.clone().requires_grad_(True)
        y = fn(t)
        gy = g[name][r] if g[name].ndim == y.dim() + 1 else g[name]
        (y * torch.from_numpy(gy)).sum().backward()
        out[name] = (y.detach(), t.grad)

    run("scatter", scatter_w, full)
    slab = out["scatter"][0]
    run("gather", gather_w, slab)
    run("halo", lambda t: halo_w(t, 1, 1), slab)
    run("halo_stride2", lambda t: halo_w(t, 1, 0), slab)
    for name, fn in (("odd_w", lambda: scatter_w(full[:, :, :-1])),
                     ("wide_halo", lambda: halo_w(slab, slab.shape[2] + 1, 0))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def bev_backbone_case(case: dict, world: int = 1, mp: int = 1) -> dict:
    """The ``BaseBEVBackbone`` of ``case`` (``kw``, its keywords; ``sd``, its
    state dict) in training, f64, on this rank's rows of ``x`` (the global
    batch (B, H, W, C), numpy) under a mesh of ``world`` ranks, ``mp`` a dp
    row: at mp > 1 the map scattered over W, the backbone on this rank's
    slab and the output gathered, as ``_AnchorRPN.bev_head`` runs it. ->
    the output (the whole map of this rank's rows), the input gradient of
    sum(output * ``g``), the parameter gradients (this rank's share), the
    running statistics and the slab's width; or, where ``case["w"]``
    narrows the map to a W that does not split, the error."""
    from .models.modules.backbone2d import BaseBEVBackbone
    from .parallel.mesh import make_mesh, set_active_mesh, shard_batch
    from .parallel.spatial import gather_w, scatter_w

    net = BaseBEVBackbone(**case["kw"]).double()
    net.load_state_dict(case["sd"])
    net.train()
    rows = {k: torch.from_numpy(case[k]) for k in ("x", "g")}
    mesh = make_mesh(mp=mp)
    if world > 1:
        rows = shard_batch(mesh, rows)
    x = rows["x"][:, :, :case.get("w")].clone().requires_grad_(True)
    widths = []
    net.register_forward_pre_hook(lambda m, a: widths.append(a[0].shape[2]))
    prev = set_active_mesh(mesh)
    try:
        y = gather_w(net(scatter_w(x), w_slabs=True)) if mp > 1 else net(x)
        (y * rows["g"][:, :, :y.shape[2]]).sum().backward()
    except ValueError as e:
        return {"error": str(e)}
    finally:
        set_active_mesh(prev)
    return {"y": y.detach(), "x_grad": x.grad,
            "grads": {n: p.grad.clone() for n, p in net.named_parameters()},
            "buffers": {n: b.clone() for n, b in net.named_buffers()},
            "slab_w": widths[0]}


def eval_case(case: dict, world: int = 1, mp: int = 1) -> dict:
    """The eval forward of a detector case (cfg, sd, points and valid of the
    global batch, numpy) in f64 on this rank's rows under a mesh of
    ``world`` ranks, ``mp`` a dp row: -> batch_cls_preds, batch_box_preds
    and the width of the map that its BEV backbone took."""
    from .models.detectors.second import build_detector
    from .parallel.mesh import make_mesh, set_active_mesh, shard_batch

    model, _ = build_detector(case["cfg"], case["sd"], device="cpu")
    model.double().eval()
    mesh = make_mesh(mp=mp)
    pts, valid = (torch.from_numpy(np.asarray(a)) for a in case["inputs"][:2])
    if world > 1:
        pts, valid = shard_batch(mesh, (pts, valid))
    widths = []
    model.backbone_2d.register_forward_pre_hook(lambda m, a: widths.append(a[0].shape[2]))
    prev = set_active_mesh(mesh)
    try:
        with torch.no_grad():
            out = model(pts.double(), valid)
    finally:
        set_active_mesh(prev)
    return {"batch_cls_preds": out["batch_cls_preds"], "batch_box_preds": out["batch_box_preds"],
            "bev_w": widths[0]}


def epoch_case(case: dict, world: int = 1, mp: int = 1) -> dict:
    """``eval_one_epoch`` of a detector case (cfg, sd; dataset: a class, its
    arguments and keywords; batch: frames a dp row) under an active mesh of
    ``world`` ranks, ``mp`` a dp row (no mesh at world 1): -> the AP dict,
    the recall counts and the log lines."""
    from .models.detectors.second import build_detector
    from .parallel.mesh import make_mesh, set_active_mesh
    from .train.eval import eval_one_epoch

    model, _ = build_detector(case["cfg"], case["sd"], device="cpu")
    cls, args, kwargs = case["dataset"]
    logs = []
    prev = set_active_mesh(make_mesh(mp=mp) if world > 1 else None)
    try:
        _, ap, recall = eval_one_epoch(model.eval(), case["cfg"], cls(*args, **kwargs),
                                       batch_size=case["batch"], logger=logs.append)
    finally:
        set_active_mesh(prev)
    return {"ap": ap, "recall": recall, "logs": logs}


def mp_checks(world: int, mp: int, spatial=None, bev=(), bn=(), evals=(), epochs=(),
              steps=()) -> dict:
    """Under this group's mesh of ``mp`` ranks a dp row: its layout (rank,
    dp, mp, dp index, mp index, and the rows that ``shard_batch`` gives of
    an 8-row batch), then ``spatial_checks`` of ``spatial`` (x, g) and each
    case of ``bev_backbone_case``, ``bn_case``, ``eval_case``,
    ``epoch_case`` and ``step_case`` (each step case at ``mp``)."""
    from .parallel.mesh import make_mesh, set_active_mesh, shard_batch

    mesh = make_mesh(mp=mp)
    out = {"layout": (mesh.rank, mesh.dp, mesh.mp, mesh.dp_rank, mesh.mp_rank),
           "rows": shard_batch(mesh, np.arange(8)).tolist()}
    if spatial is not None:
        prev = set_active_mesh(mesh)
        try:
            out["spatial"] = spatial_checks(*spatial)
        finally:
            set_active_mesh(prev)
    out["bev"] = [bev_backbone_case(c, world, mp) for c in bev]
    out["bn"] = [bn_case(c, world, mesh.rank, mp) for c in bn]
    out["eval"] = [eval_case(c, world, mp) for c in evals]
    out["epochs"] = [epoch_case(c, world, mp) for c in epochs]
    out["steps"] = [step_case({**c, "mp": mp}, world) for c in steps]
    return out


def mp_worker(rank: int, world: int, mp: int, cases: dict) -> dict:
    """``mp_checks`` of ``cases`` on this rank of a CPU gloo group of
    ``world`` (the ``jax`` launcher's environment), ``mp`` ranks a dp
    row."""
    from .parallel import distributed as D

    D.init_distributed("jax", device="cpu")
    try:
        return mp_checks(world, mp, **cases)
    finally:
        D.destroy_distributed()


def sharded_completion_worker(rank: int, world: int, vcn_sd: dict, frames: tuple,
                              out_pts: int, model_name: str = "VCN_VC") -> tuple:
    """``see.sharded.make_sharded_completion`` on this rank of a CPU group of
    ``world``: VCN ``model_name`` at ``vcn_sd`` completing ``out_pts``
    points, over ``frames`` (points, valid, gt_boxes, gt_mask of the global
    batch, numpy). -> this rank's (new_pts, new_valid, inst_ok)."""
    from .models.vcn.inference import VCNInference
    from .parallel import distributed as D
    from .parallel.mesh import make_mesh
    from .see.sharded import make_sharded_completion

    D.init_distributed("jax", device="cpu")
    try:
        vcn = VCNInference(model_name, vcn_sd, num_points=out_pts, device="cpu")
        fn = make_sharded_completion(make_mesh(), vcn, out_pts=out_pts)
        return fn(*(torch.from_numpy(np.asarray(a)) for a in frames))
    finally:
        D.destroy_distributed()


def eval_worker(rank: int, world: int, det_cfg, sd: dict, dataset: tuple,
                batch_size: int) -> tuple:
    """``train.eval.eval_one_epoch`` on this rank of a CPU group of
    ``world``: the detector at ``det_cfg`` and ``sd`` over ``dataset``
    (a class, its arguments and keywords), at ``batch_size``. -> (AP
    report, AP dict, recall counts, the log lines)."""
    from .models.detectors.second import build_detector
    from .parallel import distributed as D
    from .train.eval import eval_one_epoch

    D.init_distributed("jax", device="cpu")
    try:
        model, _ = build_detector(det_cfg, sd, device="cpu")
        cls, args, kwargs = dataset
        logs = []
        out = eval_one_epoch(model.eval(), det_cfg, cls(*args, **kwargs),
                             batch_size=batch_size, logger=logs.append)
        return (*out, logs)
    finally:
        D.destroy_distributed()


def cli_worker(rank: int, world: int, train_argv: list, test_argv: list,
               test_port: int) -> dict:
    """On this rank: ``cli.train_detector`` with ``train_argv`` and ``--launcher
    jax`` (its group on the spawned environment's port), then
    ``cli.test_detector`` with ``test_argv`` and ``--launcher jax`` on
    ``test_port``. -> {"train": the mean loss of each epoch, the run's
    checkpoints and the weights after it; "test": (AP report, AP dict,
    recall counts)}."""
    from .cli import test_detector as TD
    from .cli import train_detector as TR

    out = TR.main(train_argv + ["--launcher", "jax"])
    train = {"losses": out["losses"], "ckpts": out["ckpts"], "step": out["state"].step,
             "state_dict": {k: v.detach().clone()
                            for k, v in out["state"].model.state_dict().items()}}
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{test_port}"
    return {"train": train, "test": TD.main(test_argv + ["--launcher", "jax"])}
