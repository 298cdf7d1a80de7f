"""seevcn_torch: the PyTorch/CUDA port of seevcn_tpu for one NVIDIA H100.

Each module mirrors the path of its JAX counterpart under ``seevcn_tpu``.
The package imports torch and numpy only: never jax, flax or seevcn_tpu.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without CUDA they raise instead of falling back.
"""
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
