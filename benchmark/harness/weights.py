"""Seeded weights, made on the device in one call: frozen from
chip_smoke.py's ``seeded_state_dict`` and ``seeded_vcn_state_dict`` (the
scale of flax's default init: every conv and linear weight normal with std
1/sqrt(fan_in), biases zero, batch norm at identity statistics), drawn from
one generator on the device over the state dict's keys in sorted order, so
that the program and the reference, which share key names, get the same
tensors."""
from __future__ import annotations

import math

import torch

from ..traffic.raycast import device_generator

_TRANSPOSED = (torch.nn.ConvTranspose1d, torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)


def seeded_state_dict(model: torch.nn.Module, seed: int, stream: int, device) -> dict:
    """Weights for ``model``'s state dict on ``device``: random leaves by
    the rule above, every other entry (batch-norm statistics and affine,
    counters) as the model holds it."""
    sd = model.state_dict()
    transposed = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, _TRANSPOSED)}
    drawn = []
    out = {}
    for k in sorted(sd):
        v = sd[k]
        mod, leaf = k.rsplit(".", 1)
        if leaf == "num_batches_tracked" or f"{mod}.running_var" in sd:
            out[k] = v.clone().to(device)
        elif leaf == "bias":
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
        else:
            fan = v.shape[0] * math.prod(v.shape[2:]) if k in transposed \
                else math.prod(v.shape[1:])
            drawn.append((k, v, fan))
    flat = torch.randn(sum(v.numel() for _, v, _ in drawn),
                       generator=device_generator(seed, stream, device), device=device)
    off = 0
    for k, v, fan in drawn:
        out[k] = (flat[off:off + v.numel()].view(v.shape) / math.sqrt(max(fan, 1))).to(v.dtype)
        off += v.numel()
    return out
