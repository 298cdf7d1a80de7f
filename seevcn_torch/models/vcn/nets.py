"""VCN completion networks in torch, inference only (port of
seevcn_tpu/models/vcn/nets.py).

Module and parameter names follow the reference torch models
(see/surface_completion/models/vcn/models/VCN_{CN,VC}.py): the pointwise
MLPs are ``Conv1d(k=1)`` stacks, so a reference state dict
(``encoder.mlp_conv1.0.weight`` ...) loads with ``strict=True``. The forward
keeps the JAX package's channel-last layout and runs each pointwise layer as
one (B*N, C) x (C, C') product. BatchNorm always uses its running statistics
(eps 1e-5); the pose encoder's leaky slope is 0.01.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...geom import transforms as T


def _pointwise(layers: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Run a Conv1d(k=1)/BatchNorm1d/activation stack on channel-last
    (..., C) input as (B*N, C) products; BatchNorm in eval form."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    for layer in layers:
        if isinstance(layer, nn.Conv1d):
            x = F.linear(x, layer.weight[:, :, 0], layer.bias)
        elif isinstance(layer, nn.BatchNorm1d):
            x = F.batch_norm(x, layer.running_mean, layer.running_var,
                             layer.weight, layer.bias, training=False,
                             eps=layer.eps)
        else:
            x = layer(x)
    return x.reshape(*shape[:-1], x.shape[-1])


class PointMLP(nn.Sequential):
    """Pointwise Conv1d(k=1) + BN + ReLU stack; the last layer is linear.
    Takes channel-last (..., C) input."""

    def __init__(self, in_ch: int, features: Sequence[int]):
        layers = []
        for i, f in enumerate(features):
            layers.append(nn.Conv1d(in_ch, f, 1))
            if i != len(features) - 1:
                layers += [nn.BatchNorm1d(f), nn.ReLU()]
            in_ch = f
        super().__init__(*layers)

    def forward(self, x):
        return _pointwise(self, x)


class FeatureEncoder(nn.Module):
    """PCN-style two-stage encoder: (B, N, 3) -> (B, dims[-1])."""

    def __init__(self, dims: Sequence[int] = (3, 128, 256, 512, 512, 1024)):
        super().__init__()
        d = dims
        self.mlp_conv1 = PointMLP(d[0], [d[1], d[2]])
        self.mlp_conv2 = PointMLP(d[3], [d[4], d[5]])

    def forward(self, x):
        feat = self.mlp_conv1(x)                                   # (B, N, d2)
        glob = feat.amax(dim=1, keepdim=True)
        feat = torch.cat([glob.expand_as(feat), feat], dim=-1)     # (B, N, 2*d2)
        return self.mlp_conv2(feat).amax(dim=1)                    # (B, d5)


class FCDecoder(nn.Sequential):
    """Linear + ReLU pairs, the last Linear without activation."""

    def __init__(self, in_ch: int, features: Sequence[int]):
        layers = []
        for i, f in enumerate(features):
            layers.append(nn.Linear(in_ch, f))
            if i != len(features) - 1:
                layers.append(nn.ReLU())
            in_ch = f
        super().__init__(*layers)


class PoseEncoder(nn.Sequential):
    """Conv1d(3->64->128->1024) + LeakyReLU(0.01) + global max:
    (B, N, 3) -> (B, 1024)."""

    def __init__(self):
        super().__init__(nn.Conv1d(3, 64, 1), nn.LeakyReLU(0.01),
                         nn.Conv1d(64, 128, 1), nn.LeakyReLU(0.01),
                         nn.Conv1d(128, 1024, 1))

    def forward(self, x):
        return _pointwise(self, x).amax(dim=1)


class VCNCN(nn.Module):
    """GT-box-canonicalised surface completion (source-domain model)."""

    def __init__(self, num_coarse: int = 1024):
        super().__init__()
        self.num_coarse = num_coarse
        self.encoder = FeatureEncoder()
        self.shape_fc = FCDecoder(1024, [1024, 1024, 3 * num_coarse])

    def forward(self, in_dict):
        pc, gt = in_dict["input"], in_dict["gt_boxes"]
        pc_cn = T.normalize_scale(T.vc_to_cn(pc, gt), gt)
        coarse = self.shape_fc(self.encoder(pc_cn))
        coarse = coarse.reshape(-1, self.num_coarse, 3)
        return {"coarse": T.cn_to_vc(T.restore_scale(coarse, gt), gt)}


class VCNVC(nn.Module):
    """Viewer-centred completion with self-regressed pose (target-domain)."""

    def __init__(self, num_coarse: int = 1024):
        super().__init__()
        self.num_coarse = num_coarse
        self.pose_encoder = PoseEncoder()
        self.pose_fc = FCDecoder(1024, [512, 9])
        self.encoder = FeatureEncoder()
        self.shape_fc = FCDecoder(1024, [1024, 1024, 3 * num_coarse])

    def forward(self, in_dict):
        pc = in_dict["input"]                                      # (B, N, 3)
        # frustum view: rotate the object onto the +x axis
        frustum_angle = torch.atan2(pc[:, :, 1].mean(1), pc[:, :, 0].mean(1))
        pc_fview = T.rotate_points_along_z(pc, -frustum_angle)
        pts_mean = pc_fview.mean(1, keepdim=True)

        # pose regression: translation residual + ortho-6D rotation
        rel_pose = self.pose_fc(self.pose_encoder(pc_fview - pts_mean))
        centre = pts_mean + rel_pose[:, None, :3]
        rot_mat = T.rotation_matrix_from_ortho6d(rel_pose[:, 3:9])

        pc_cn = torch.matmul(pc_fview - centre, rot_mat.transpose(-1, -2))
        coarse = self.shape_fc(self.encoder(pc_cn))
        coarse = coarse.reshape(-1, self.num_coarse, 3)
        coarse_vc = torch.matmul(coarse, rot_mat) + centre
        return {
            "coarse": T.rotate_points_along_z(coarse_vc, frustum_angle),
            "reg_rot": torch.matmul(rot_mat, T.rot_z(frustum_angle)),
            "reg_centre": T.rotate_points_along_z(centre, frustum_angle)[:, 0],
        }


MODELS = {"VCN_CN": VCNCN, "VCN_VC": VCNVC, "PartialSC_CN": VCNCN,
          "PartialSC_VC": VCNVC}


def build_vcn(name: str, **kw) -> nn.Module:
    return MODELS[name](**kw)
