"""VCN_CN (SEE-VCN's see/surface_completion/models/vcn/models/VCN_CN.py):
the object's points in its GT box's frame, scaled by the box length, through
PCN's two-stage encoder to a global feature and a fully connected decoder to
``num_coarse`` points, which go back to the sensor frame. Pointwise layers
are Conv1d(k=1) on (B, C, N) as the published model's; the state-dict keys
are its (``encoder.mlp_conv1.0.weight``)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..modules.common import BatchNorm1d


def _mlp(in_ch: int, features: Sequence[int]) -> nn.Sequential:
    layers = []
    for i, f in enumerate(features):
        layers.append(nn.Conv1d(in_ch, f, 1))
        if i != len(features) - 1:
            layers += [BatchNorm1d(f), nn.ReLU()]
        in_ch = f
    return nn.Sequential(*layers)


class FeatureEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp_conv1 = _mlp(3, [128, 256])
        self.mlp_conv2 = _mlp(512, [512, 1024])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, N) -> (B, 1024)."""
        feat = self.mlp_conv1(x)
        glob = feat.amax(2, keepdim=True).expand_as(feat)
        return self.mlp_conv2(torch.cat([glob, feat], 1)).amax(2)


def _fc(in_ch: int, features: Sequence[int]) -> nn.Sequential:
    layers = []
    for i, f in enumerate(features):
        layers.append(nn.Linear(in_ch, f))
        if i != len(features) - 1:
            layers.append(nn.ReLU())
        in_ch = f
    return nn.Sequential(*layers)


def _rotate_z(p: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) turned by (B,) angles about z."""
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    x, y = p[..., 0], p[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y, p[..., 2]], -1)


class VCNCN(nn.Module):
    def __init__(self, num_coarse: int = 1024):
        super().__init__()
        self.num_coarse = num_coarse
        self.encoder = FeatureEncoder()
        self.shape_fc = _fc(1024, [1024, 1024, 3 * num_coarse])

    def forward(self, in_dict: dict) -> dict:
        pc, box = in_dict["input"], in_dict["gt_boxes"]
        length = box[:, 3, None, None]
        canon = _rotate_z(pc - box[:, None, :3], -box[:, 6]) / length
        coarse = self.shape_fc(self.encoder(canon.transpose(1, 2)))
        coarse = coarse.reshape(-1, self.num_coarse, 3) * length
        return {"coarse": _rotate_z(coarse, box[:, 6]) + box[:, None, :3]}


MODELS = {"VCN_CN": VCNCN}


def build_vcn(name: str, **kw) -> nn.Module:
    return MODELS[name](**kw)
