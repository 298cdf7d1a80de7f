"""Cross-process collectives for evaluation and metrics (port of
seevcn_tpu/parallel/collectives.py; reference pcdet/utils/commu_utils.py:
50-182 and common_utils.merge_results_dist:211-232) over ``torch.distributed``.

Without a group each one is the identity, as the JAX package's is at one
process. A group that a launcher started and that is gone raises: nothing
computes on one rank in its place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import distributed as D


def _initialized() -> bool:
    if dist.is_available() and dist.is_initialized():
        return True
    if D.LAUNCHER is not None:
        raise RuntimeError(f"the process group of --launcher {D.LAUNCHER} is not running")
    return False


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def comm_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL, the
    CPU under gloo."""
    if _initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def merge_results_dist(local_results: list, total_size: int | None = None) -> list:
    """Every rank's Python list, concatenated in rank order on every rank
    (the reference's tmpdir-pickle merge), cut to ``total_size``."""
    if get_world_size() > 1:
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, local_results)
        local_results = [x for part in parts for x in part]
    return local_results[:total_size] if total_size else local_results


def average_reduce_value(value: float) -> float:
    """The mean of a scalar over the ranks (commu_utils.average_reduce_value)."""
    world = get_world_size()
    if world == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=comm_device())
    dist.all_reduce(t)
    return float(t.item()) / world


def reduce_dict(d: dict) -> dict:
    """Each value's mean over the ranks."""
    return {k: average_reduce_value(float(v)) for k, v in d.items()}
