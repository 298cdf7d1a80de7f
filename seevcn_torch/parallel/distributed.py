"""Multi-process bring-up over ``torch.distributed`` (port of
seevcn_tpu/parallel/distributed.py; reference pcdet/utils/common_utils.py:
144-188, init_dist_pytorch and init_dist_slurm).

Launchers, the JAX package's four:
  * 'none'  -- one process; no group is started.
  * 'jax'   -- the coordinator from JAX_COORDINATOR_ADDRESS (host:port),
               JAX_NUM_PROCESSES and JAX_PROCESS_ID, or the arguments, as a
               ``tcp://`` rendezvous, so a JAX launch script carries over.
  * 'slurm' -- the rank from SLURM_PROCID, the world from SLURM_NTASKS, the
               coordinator the first host of SLURM_NODELIST (``scontrol show
               hostname``) at MASTER_PORT (29501 by default).
  * 'auto'  -- torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
               MASTER_PORT) through ``env://``: what the managed environment
               describes, as ``jax.distributed.initialize()`` reads its own.

The backend follows the device: NCCL for CUDA, gloo for the CPU; ``backend``
overrides it (two ranks sharing one card go over gloo). Each rank runs on
``cuda:<local rank>`` (LOCAL_RANK, else SLURM_LOCALID, else the rank), or on
the card that ``device`` names with an index. Nothing falls back: an absent
card or a failed init raises.
"""
from __future__ import annotations

import os
import subprocess

import torch
import torch.distributed as dist

#: the launcher of the group this process started (None: none started)
LAUNCHER: str | None = None
#: the device init_distributed resolved for this rank
DEVICE: torch.device | None = None


def local_rank(rank: int) -> int:
    """This process's index on its host: LOCAL_RANK (torchrun), else
    SLURM_LOCALID, else ``rank``."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in os.environ:
            return int(os.environ[key])
    return rank


def rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` runs on: ``device`` as given when it is the
    CPU or names a card's index, else ``cuda:<local rank>``; a CUDA device
    is made the current one. Raises when that card is absent."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", local_rank(rank))
    if not torch.cuda.is_available() or dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank}: {dev} is not available "
                           f"({torch.cuda.device_count()} CUDA device(s) visible)")
    torch.cuda.set_device(dev)
    return dev


def _rendezvous(launcher, coordinator_address, num_processes, process_id):
    """-> (init_method, world, rank) of a launcher."""
    if launcher == "slurm":
        rank = int(os.environ["SLURM_PROCID"])
        world = int(os.environ["SLURM_NTASKS"])
        node_list = os.environ["SLURM_NODELIST"]
        addr = subprocess.getoutput(f"scontrol show hostname {node_list} | head -n1")
        port = os.environ.get("MASTER_PORT", "29501")
        return f"tcp://{addr}:{port}", world, rank
    if launcher == "jax":
        addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
        if not addr:
            raise ValueError("--launcher jax needs JAX_COORDINATOR_ADDRESS (host:port) "
                             "or coordinator_address")
        world = num_processes if num_processes is not None else \
            int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        rank = process_id if process_id is not None else \
            int(os.environ.get("JAX_PROCESS_ID", "0"))
        return f"tcp://{addr}", world, rank
    if launcher == "auto":
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    raise NotImplementedError(launcher)


def init_distributed(launcher: str = "none", coordinator_address=None, num_processes=None,
                     process_id=None, backend: str | None = None,
                     device="cuda") -> tuple[int, int]:
    """Start this process's group; -> (rank, world size). 'none' starts
    nothing and returns (0, 1)."""
    global LAUNCHER, DEVICE
    if launcher in (None, "none"):
        return 0, 1
    init, world, rank = _rendezvous(launcher, coordinator_address, num_processes,
                                    process_id)
    dev = rank_device(device, rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kw)
    LAUNCHER, DEVICE = launcher, dev
    return dist.get_rank(), dist.get_world_size()


def destroy_distributed() -> None:
    """End this process's group, if it started one."""
    global LAUNCHER, DEVICE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    LAUNCHER, DEVICE = None, None
