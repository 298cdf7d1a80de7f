"""Detection losses (port of seevcn_tpu/models/losses.py; reference
detector3d/pcdet/utils/loss_utils.py:9-385)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    """Elementwise, in the reference's stable form
    max(x, 0) - x t + log1p(exp(-|x|))."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """SigmoidFocalClassificationLoss per element: logits / targets (..., A,
    C), anchor weights (..., A) broadcast over C."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1 - p) + (1 - targets) * p
    loss = alpha_w * torch.pow(pt, gamma) * binary_cross_entropy_with_logits(logits, targets)
    return loss * weights[..., None]


def weighted_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                       weights: torch.Tensor, beta: float = 1.0 / 9.0,
                       code_weights=None) -> torch.Tensor:
    """WeightedSmoothL1Loss: per-code weights, then per-anchor weights."""
    diff = pred - target
    if code_weights is not None:
        diff = diff * diff.new_tensor(code_weights)
    ad = diff.abs()
    loss = torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)
    return loss * weights[..., None]


def weighted_cross_entropy(logits: torch.Tensor, one_hot: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """WeightedCrossEntropyLoss, the direction classifier's."""
    return -(one_hot * F.log_softmax(logits, dim=-1)).sum(-1) * weights
