"""The ``dp`` axis of the device mesh over the process group (port of
seevcn_tpu/parallel/mesh.py:23-67), and the cross-rank reductions that make
a data-parallel train step the step on the global batch.

JAX's sharded step is one program over the global batch: its batch-norm
statistics, its batch-wide loss normalizers and its random draws are the
global batch's. The port keeps that (not OpenPCDet's per-GPU DDP): while a
mesh of more than one rank is active (``set_active_mesh``), the batch norms
take their statistics over every rank's rows (``global_sum``), the losses
divide local sums by global counts (``global_count``, ``global_batch``), and
every draw is drawn at the global shape from the step's generator, each
rank keeping its own rows (``draw_rows``). Each rank's loss is then its
share of the global loss, and the summed gradients are the global loss's.
Without an active mesh, or at one rank, every helper is the identity and no
collective runs.

The ``mp`` axis (the BEV map's W sharded across cards, JAX's
``constrain_bev``) is not ported: ``make_mesh(mp > 1)`` raises.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import distributed as D
from .collectives import get_rank, get_world_size

MP_ITEM = "ROADMAP queue 1, item 6 (the mp axis)"


@dataclass(frozen=True)
class Mesh:
    """The default process group as JAX's ("dp", "mp") mesh with mp = 1:
    this process's rank, the world (the dp size) and its device."""
    rank: int
    world: int
    device: torch.device | None = None

    @property
    def dp(self) -> int:
        """The size of the dp axis: every rank."""
        return self.world


def make_mesh(n_devices: int | None = None, mp: int = 1, device=None) -> Mesh:
    """The dp mesh over every rank of the group (one rank without one);
    ``device`` defaults to the one ``init_distributed`` chose."""
    if mp != 1:
        raise NotImplementedError(f"make_mesh(mp={mp}): the BEV map sharded over an mp "
                                  f"axis is not ported yet ({MP_ITEM})")
    world = get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the group has {world} rank(s), one a device")
    dev = torch.device(device) if device is not None else D.DEVICE
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(get_rank(), world, dev)


def _rows(mesh: Mesh, x):
    b = x.shape[0]
    if b % mesh.world:
        raise ValueError(f"a batch of {b} rows does not divide over {mesh.world} ranks")
    n = b // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a global batch: rows [r B / W, (r + 1) B / W) of
    every array (tensor or numpy) of a dict / list / tuple tree, the block
    layout of JAX's P("dp"). Raises when B does not divide by W."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return _rows(mesh, tree)
    return tree


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` from rank ``src`` into every rank's ``t``, in place."""
    with torch.no_grad():
        dist.broadcast(t.data, src)
    return t


# --- the active mesh: the cross-rank reductions of a train step --------------
_ACTIVE_MESH: Mesh | None = None


def set_active_mesh(mesh: Mesh | None) -> Mesh | None:
    """Make ``mesh`` the one the reductions below use (returns the previous
    one)."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return prev


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH


def dp_world() -> int:
    """The number of ranks the active mesh spreads a batch over (1 without
    one)."""
    m = _ACTIVE_MESH
    return m.dp if m is not None else 1


def _on_mesh_device(t: torch.Tensor) -> torch.Tensor:
    """``t``, which a collective of the active mesh is about to take: it
    must lie on the mesh's device (NCCL takes no CPU tensor, and gloo would
    hide one that a card's run would pass it)."""
    dev = _ACTIVE_MESH.device
    if dev is not None and t.device != dev:
        raise RuntimeError(f"a tensor on {t.device} reached a collective of the mesh on {dev}")
    return t


def global_batch(b: int) -> int:
    """The global batch of a rank's ``b`` frames."""
    return b * dp_world()


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A count (or any value without a gradient) summed over the ranks."""
    if dp_world() == 1:
        return t
    t = _on_mesh_device(t).detach().clone()
    dist.all_reduce(t)
    return t


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of a batch-wide tensor (leading axis the frames) over every
    rank's elements: ``t.mean()`` at one rank."""
    if dp_world() == 1:
        return t.mean()
    return t.sum() / (t.numel() * dp_world())


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, its gradient summed back to each rank's
    ``t`` (a batch norm's statistics)."""
    if dp_world() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    # deprecated in favour of the traceable collective; this one carries the
    # gradient, which the batch norms need
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(_on_mesh_device(t))


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each), stacked in rank order (W,
    ...), without a gradient: one all-reduce of a zero buffer, which every
    backend runs on every device."""
    world = dp_world()
    if world == 1:
        return t[None]
    buf = _on_mesh_device(t).new_zeros((world, *t.shape))
    buf[_ACTIVE_MESH.rank] = t.detach()
    dist.all_reduce(buf)
    return buf


def global_top(score: torch.Tensor, k: int):
    """The top ``k`` rows of every rank's ``score`` (N_r,) concatenated in
    rank order, by a stable descending sort (ties to the lower global row),
    as the world-1 batch picks them; a rank's rows past its N_r (the ranks'
    row counts may differ) are padded with -inf and never picked before a
    real row. -> (each pick's row on its rank (k,), whether that rank is
    this one (k,))."""
    if dp_world() == 1:
        top = torch.sort(score, descending=True, stable=True).indices[:k]
        return top, torch.ones_like(top, dtype=torch.bool)
    n = score.shape[0]
    n_max = int(gather_rows(torch.tensor(n, device=score.device)).max())
    padded = torch.cat([score.detach(), score.new_full((n_max - n,), float("-inf"))])
    top = torch.sort(gather_rows(padded).reshape(-1), descending=True,
                     stable=True).indices[:k]
    mine = top // n_max == _ACTIVE_MESH.rank
    return torch.where(mine, top % n_max, 0), mine


def draw_rows(shape, draw):
    """``draw(shape)`` of a batch-major ``shape`` (leading axis this rank's
    rows) as the global batch draws it: ``draw`` at the global shape, this
    rank's block of rows kept, so the generator advances as it does at one
    rank."""
    world = dp_world()
    if world == 1:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * world, *shape[1:]))
    r = _ACTIVE_MESH.rank
    return full[r * n:(r + 1) * n]
