"""Angles."""
from __future__ import annotations

import numpy as np
import torch


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = np.pi) -> torch.Tensor:
    """OpenPCDet's common_utils.limit_period: val - floor(val / period +
    offset) * period."""
    return val - torch.floor(val / period + offset) * period
