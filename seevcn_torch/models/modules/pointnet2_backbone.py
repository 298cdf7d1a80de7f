"""PointNet++ MSG backbone with feature propagation, and the point-wise box
coder of PointRCNN (port of seevcn_tpu/models/modules/pointnet2_backbone.py;
reference pcdet/models/backbones_3d/pointnet2_backbone.py:9-206 and
pcdet/utils/box_coder_utils.py:144-221).

Encoder: at each SA level, FPS over the padded level with its validity,
then an ``SALayer`` (multi-scale ball query, shared MLP, max pool) around
the sampled points. Each frame's supports are the level's valid rows, in
row order, and the ball query takes the level's padded row count as
``width`` (the support width of the reference's query): N at level 0,
NPOINTS[l - 1] after. Decoder: from the deepest level up, each level's
rows (padding included) get the three-NN interpolation of the level below
them, concatenated after the level's own features (skip first, as the
reference writes it), through Linear (no bias) + BN + ReLU. Every batch
norm takes its statistics over all of its rows, padding included, as the
reference's flax BatchNorm does.

Key names are OpenPCDet's: ``SA_modules.{l}.mlps`` and
``FP_modules.{l}.mlp`` (1x1 Conv2d + BN + ReLU triples).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...ops.sampling import farthest_point_sample, three_nn_interpolate
from .pfe import SALayer, _run_mlp, _shared_mlp


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) rows of ``idx`` (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class PointnetFPModule(nn.Module):
    """One feature-propagation level: ``mlp``, the shared MLP over the
    concatenation of a level's own features and the interpolated ones."""

    def __init__(self, cin: int, widths: Sequence[int]):
        super().__init__()
        self.mlp = _shared_mlp(cin, widths)


class PointNet2MSG(nn.Module):
    """(B, N, 3 + C) points and (B, N) validity -> (B, N, FP_MLPS[0][-1])
    per-point features."""

    def __init__(self, sa_cfg, fp_mlps, input_channels: int = 0):
        super().__init__()
        self.npoints = [int(n) for n in sa_cfg["NPOINTS"]]
        self.SA_modules = nn.ModuleList()
        skip = [int(input_channels)]
        c = int(input_channels)
        for li in range(len(self.npoints)):
            layer = SALayer(c, sa_cfg["RADIUS"][li], sa_cfg["NSAMPLE"][li], sa_cfg["MLPS"][li])
            self.SA_modules.append(layer)
            c = layer.out_channels
            skip.append(c)
        self.FP_modules = nn.ModuleList()
        for li, widths in enumerate(fp_mlps):
            below = int(fp_mlps[li + 1][-1]) if li + 1 < len(fp_mlps) else skip[-1]
            self.FP_modules.append(PointnetFPModule(skip[li] + below, widths))

    def sample(self, li: int, xyz: torch.Tensor, valid: torch.Tensor):
        """SA level ``li``'s FPS over the padded level (B, N, 3) with its
        validity -> (the sampled points (B, K, 3), their validity)."""
        idx = farthest_point_sample(xyz, self.npoints[li], valid)
        return _gather_rows(xyz, idx), _gather_rows(valid, idx)

    def abstract(self, li: int, new_xyz, xyz, feats, valid) -> torch.Tensor:
        """SA level ``li`` around new_xyz (B, K, 3) over each frame's valid
        rows of the level below (xyz (B, N, 3), feats (B, N, C) or None),
        the ball query at that level's padded width N -> (B, K, C')."""
        frames = [(q, sup[v], None if feats is None else f[v])
                  for q, sup, v, f in zip(new_xyz, xyz, valid,
                                          [None] * len(valid) if feats is None else feats)]
        return self.SA_modules[li](frames, width=xyz.shape[1])

    def propagate(self, li: int, xyz, up_xyz, up_feats, up_valid, skip) -> torch.Tensor:
        """FP level ``li``: every row of the level (xyz (B, N, 3), padding
        included) gets the three-NN interpolation of the level above it,
        concatenated after its own features ``skip`` (or alone where None),
        through the level's MLP -> (B, N, C)."""
        interp = torch.stack([three_nn_interpolate(q, s, f, v) for q, s, f, v in zip(
            xyz, up_xyz, up_feats, up_valid)])
        cat = interp if skip is None else torch.cat([skip, interp], -1)
        b, n, c = cat.shape
        return _run_mlp(self.FP_modules[li].mlp, cat.reshape(b * n, c)).reshape(b, n, -1)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor) -> torch.Tensor:
        xyz = [points[..., :3]]
        feats = [points[..., 3:] if points.shape[-1] > 3 else None]
        valid = [points_valid]
        for li in range(len(self.SA_modules)):
            nx, nv = self.sample(li, xyz[-1], valid[-1])
            feats.append(self.abstract(li, nx, xyz[-1], feats[-1], valid[-1]))
            xyz.append(nx)
            valid.append(nv)
        up = feats[-1]
        for li in range(len(self.SA_modules) - 1, -1, -1):
            up = self.propagate(li, xyz[li], xyz[li + 1], up, valid[li + 1], feats[li])
        return up


class PointResidualCoder:
    """Per-point box residuals against per-class mean sizes, with the
    heading as (cos, sin) (box_coder_utils.py:144-221): 8 codes."""

    def __init__(self, code_size: int = 8, use_mean_size: bool = True, mean_size=None):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        self.mean_size = None if mean_size is None else np.asarray(mean_size, np.float32)

    def _anchor(self, classes: torch.Tensor, like: torch.Tensor):
        anchor = like.new_tensor(self.mean_size)[
            (classes.long() - 1).clamp(0, len(self.mean_size) - 1)]
        return anchor[..., 0], anchor[..., 1], anchor[..., 2]

    def encode(self, gt_boxes: torch.Tensor, points: torch.Tensor,
               gt_classes: torch.Tensor | None = None) -> torch.Tensor:
        """gt_boxes (..., 7), points (..., 3), gt_classes (...) 1-based ->
        (..., 8)."""
        g = gt_boxes
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        xg, yg, zg = g[..., 0], g[..., 1], g[..., 2]
        dxg, dyg, dzg = (g[..., i].clamp_min(1e-5) for i in (3, 4, 5))
        if self.use_mean_size:
            dxa, dya, dza = self._anchor(gt_classes, g)
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            out = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                   torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            out = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg), torch.log(dzg)]
        out += [torch.cos(g[..., 6]), torch.sin(g[..., 6])]
        return torch.stack(out, -1)

    def decode(self, encodings: torch.Tensor, points: torch.Tensor,
               pred_classes: torch.Tensor | None = None) -> torch.Tensor:
        """encodings (..., 8), points (..., 3), pred_classes (...) 1-based ->
        boxes (..., 7)."""
        xt, yt, zt, dxt, dyt, dzt, cost, sint = encodings.unbind(-1)
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._anchor(pred_classes, encodings)
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            box = [xt * diag + xa, yt * diag + ya, zt * dza + za,
                   torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        else:
            box = [xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)]
        return torch.stack(box + [torch.atan2(sint, cost)], -1)
