"""The (``dp``, ``mp``) device mesh over the process group (port of
seevcn_tpu/parallel/mesh.py:23-67), and the cross-rank reductions that make
a train step over it the step on the global batch.

JAX's sharded step is one program over the global batch: its batch-norm
statistics, its batch-wide loss normalizers and its random draws are the
global batch's. The port keeps that (not OpenPCDet's per-GPU DDP): while a
mesh of more than one rank is active (``set_active_mesh``), the batch norms
take their statistics over every rank's rows (``stats_sum``), the losses
divide local sums by global counts (``global_count``, ``global_batch``), and
every draw is drawn at the global shape from the step's generator, each
dp row keeping its own rows (``draw_rows``). Each dp row's loss is then its
share of the global loss, and the gradients summed over the dp rows are
the global loss's.
Without an active mesh, or at one rank, every helper is the identity and no
collective runs.

The ranks form JAX's grid of shape (world / mp, mp): rank r sits at dp
index r // mp and mp index r % mp. The ``mp`` ranks of a dp row hold the
same frames and split the BEV map's W between them (JAX's ``constrain_bev``;
the halo exchanges are in ``spatial.py``), so the batch helpers here act
over the dp axis: they key on the dp index and reduce over the ranks of
this rank's mp column. A batch norm's statistics (``stats_count``,
``stats_sum``) sum over every rank instead: on the W slabs each rank holds
its slab of its row's frames; elsewhere the mp ranks of a row hold the same
rows, which the sums and the count then both take mp times, so the mean,
the variance and their gradients are the dp rows', and every rank holds
the same bits, where the card's atomics make the mp replicas' activations
differ in their last bits.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import distributed as D
from .collectives import get_rank, get_world_size


@dataclass(frozen=True)
class Mesh:
    """The process group as JAX's ("dp", "mp") mesh: this process's rank,
    the world, its device, the mp size, and the two subgroups of this rank
    (None at mp 1, where the dp axis is every rank and the mp axis one)."""
    rank: int
    world: int
    device: torch.device | None = None
    mp: int = 1
    #: the ranks of this rank's mp column: one a dp row
    dp_group: object = None
    #: the ranks of this rank's dp row, in mp order
    mp_group: object = None

    @property
    def dp(self) -> int:
        """The size of the dp axis: the number of dp rows."""
        return self.world // self.mp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp


def make_mesh(n_devices: int | None = None, mp: int = 1, device=None) -> Mesh:
    """The (world / mp, mp) mesh over every rank of the group (one rank
    without one); ``device`` defaults to the one ``init_distributed`` chose.
    At mp > 1 every rank creates each dp column's and each dp row's group,
    in the same order, so every rank of the group must call it."""
    world = get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the group has {world} rank(s), one a device")
    if mp < 1 or world % mp:
        raise ValueError(f"make_mesh(mp={mp}): the group's {world} rank(s) do not divide "
                         f"into dp rows of {mp}")
    dev = torch.device(device) if device is not None else D.DEVICE
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = get_rank()
    dp_group = mp_group = None
    if mp > 1:
        dp = world // mp
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if rank % mp == m:
                dp_group = g
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if rank // mp == d:
                mp_group = g
    return Mesh(rank, world, dev, mp, dp_group, mp_group)


def _rows(mesh: Mesh, x):
    b = x.shape[0]
    if b % mesh.dp:
        raise ValueError(f"a batch of {b} rows does not divide over {mesh.dp} dp rows")
    n = b // mesh.dp
    return x[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a global batch: rows [d B / DP, (d + 1) B / DP)
    of every array (tensor or numpy) of a dict / list / tuple tree, d the
    dp index and DP the dp size (JAX's P("dp"); the mp ranks of a row take
    the same rows). Raises when B does not divide by DP."""
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
    """The number of dp rows the active mesh spreads a batch over (1
    without one)."""
    m = _ACTIVE_MESH
    return m.dp if m is not None else 1


def stats_world() -> int:
    """The number of ranks a batch norm's statistics span: every rank of
    the active mesh (1 without one)."""
    m = _ACTIVE_MESH
    return m.world if m is not None else 1


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


def _count(t: torch.Tensor, group) -> torch.Tensor:
    t = _on_mesh_device(t).detach().clone()
    dist.all_reduce(t, group=group)
    return t


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A count (or any value without a gradient) summed over the dp rows."""
    return t if dp_world() == 1 else _count(t, _ACTIVE_MESH.dp_group)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of a batch-wide tensor (leading axis the frames) over every
    dp row's elements: ``t.mean()`` at one rank."""
    if dp_world() == 1:
        return t.mean()
    return t.sum() / (t.numel() * dp_world())


def stats_count(t: torch.Tensor) -> torch.Tensor:
    """A batch norm's row count summed over every rank."""
    return t if stats_world() == 1 else _count(t, None)


def stats_sum(t: torch.Tensor) -> torch.Tensor:
    """A batch norm's sums over every rank, the gradient summed back to each
    rank's ``t``."""
    if stats_world() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    # deprecated in favour of the traceable collective; this one carries the
    # gradient, which the batch norms need
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(_on_mesh_device(t))


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every dp row's ``t`` (same shape on each), stacked in dp order (DP,
    ...), without a gradient: one all-reduce of a zero buffer over this
    rank's mp column, which every backend runs on every device."""
    world = dp_world()
    if world == 1:
        return t[None]
    buf = _on_mesh_device(t).new_zeros((world, *t.shape))
    buf[_ACTIVE_MESH.dp_rank] = t.detach()
    dist.all_reduce(buf, group=_ACTIVE_MESH.dp_group)
    return buf


def global_top(score: torch.Tensor, k: int):
    """The top ``k`` rows of every dp row's ``score`` (N_r,) concatenated in
    dp order, by a stable descending sort (ties to the lower global row),
    as the world-1 batch picks them; a dp row's rows past its N_r (the row
    counts may differ) are padded with -inf and never picked before a real
    row. -> (each pick's row on its dp row (k,), whether that dp row is
    this rank's (k,))."""
    if dp_world() == 1:
        top = torch.sort(score, descending=True, stable=True).indices[:k]
        return top, torch.ones_like(top, dtype=torch.bool)
    n = score.shape[0]
    n_max = int(gather_rows(torch.tensor(n, device=score.device)).max())
    padded = torch.cat([score.detach(), score.new_full((n_max - n,), float("-inf"))])
    top = torch.sort(gather_rows(padded).reshape(-1), descending=True,
                     stable=True).indices[:k]
    mine = top // n_max == _ACTIVE_MESH.dp_rank
    return torch.where(mine, top % n_max, 0), mine


def draw_rows(shape, draw):
    """``draw(shape)`` of a batch-major ``shape`` (leading axis this rank's
    rows) as the global batch draws it: ``draw`` at the global shape, this
    dp row's block of rows kept, so the generator advances as it does at
    one rank."""
    world = dp_world()
    if world == 1:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * world, *shape[1:]))
    r = _ACTIVE_MESH.dp_rank
    return full[r * n:(r + 1) * n]
