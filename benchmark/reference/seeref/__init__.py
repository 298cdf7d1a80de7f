"""The benchmark's plain reference: what each cell's timed path computes,
written from its definition in plain PyTorch. Sparse convs are dense
convolutions over the scattered grid, the voxel mean a fixed-order sum,
NMS a greedy scan over polygon-clipped IoUs, the anchor targets and the RoI
sample their rules, SEE's isolation, partial mesh and replacement float64
neighbourhoods. The networks are the published architectures as plain
modules, under OpenPCDet's and SEE-VCN's state-dict keys. It imports torch
and numpy only, nothing of seevcn_torch, and takes nothing the program
made: a later change to the program cannot move it."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` names the
    CPU. Raises when CUDA is asked for (or by default) and is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("seevcn_torch runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev


def tf32_off():
    """Matrix products and cuDNN convolutions at full f32 precision: the
    reference runs f32 at Precision.HIGHEST, and PyTorch lets cuDNN use TF32
    by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
