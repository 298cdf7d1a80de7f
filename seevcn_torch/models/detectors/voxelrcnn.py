"""Voxel R-CNN: forward and training loss (port of VoxelRCNNHead and
VoxelRCNN of seevcn_tpu/models/detectors/voxelrcnn.py; reference
voxel_rcnn.py, roi_heads/voxel_rcnn_head.py and
tools/cfgs/kitti_models/voxel_rcnn_car.yaml).

SECOND's trunk (``AnchorDetector``: MeanVFE -> the 3D backbone ->
HeightCompression -> BaseBEVBackbone -> AnchorHeadSingle -> the proposal
NMS, in training the RoI sample), then an RoI head that pools the sparse
voxel features of each FEATURES_SOURCE stage around each RoI's G^3 grid
points. For each stage: the centres of its active voxels at the stage's
stride, optionally PRE_MLP (Linear without bias, BN, ReLU), then a
StackSA layer (``pfe.SALayer``: ball query, shared MLP, max pool) over the
grid points. The reference's voxel query becomes the ball query over the
voxel centres, as in the JAX package. The stages' pooled features are
concatenated at each grid point and flattened grid-major (G^3, C), as the
JAX package flattens them, then the shared, class and box FC stacks
(Linear without bias, BN, ReLU; dropout only between the shared layers).
In eval the refined boxes become ``rois`` and ``rcnn_iou`` is the class
logit, which ``post_processing``'s RCNN branch reads. In training the
backbone's stage features reach the head detached (no RCNN gradient into
the backbone), and ``loss`` adds the RPN's losses to the RCNN's.

Each frame's supports are its stage's valid voxel rows in row order, and
the ball query's distance form follows the row count of the stage tensor
the JAX package's head reads (``pvrcnn.jax_stage_width``). In training
PRE_MLP's batch norm takes its statistics over that many rows, the rows
past the frame's active voxels zeros, as the JAX package's does over its
padded stage tensor.

State-dict keys: OpenPCDet's for the RPN (``backbone_3d``, ``backbone_2d``,
``dense_head.conv_*``); the JAX package's module names for the RoI head:
``roi_head.pre_{stage}`` and ``pre_bn_{stage}``, ``pool_{stage}`` (the
SALayer's ``mlps``), ``{shared,cls,reg}_fc{i}`` and ``_bn{i}``,
``cls_out``, ``reg_out``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import sparse as SP
from ...parallel.mesh import dp_world, global_batch, stats_count, stats_sum, stats_world
from ..modules.common import BatchNorm1d, MaskedBatchNorm, _update_running
from ..modules.pfe import STAGE_STRIDES, SALayer, voxel_centres
from ..modules.pvrcnn_head import decode_rcnn_boxes, pvrcnn_rcnn_loss, roi_grid_points
from ..modules.roi_heads import dropout
from .pvrcnn import jax_stage_width
from .second import AnchorDetector, DetectorConfig


def stage_channels(backbone: nn.Module) -> dict:
    """The output width of each stage (``x_conv1``-``x_conv4``) of a 3D
    backbone: its last batch norm's."""
    return {f"x_conv{i}": [m for m in getattr(backbone, f"conv{i}").modules()
                           if isinstance(m, MaskedBatchNorm)][-1].num_features
            for i in range(1, 5)}


def padded_batch_norm(bn: BatchNorm1d, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``bn`` over x (N, C); in training its statistics (and the running
    update) over ``rows`` >= N rows, the ones past x zeros. Under a mesh
    ``rows`` is the global batch's and the sums and N are every rank's, as
    a batch norm's (``parallel.mesh.stats_sum``: each of the mp ranks of a
    dp row adds the row's rows, so ``rows`` is taken mp times too)."""
    if not bn.training:
        return bn(x)
    if stats_world() > 1:
        n = stats_count(x.new_tensor(x.shape[0]))
        rows = torch.clamp_min(n, int(rows) * (stats_world() // dp_world()))
        mean = stats_sum(x.sum(0)) / rows
        var = (stats_sum(((x - mean) ** 2).sum(0)) + (rows - n) * mean ** 2) / rows
    else:
        rows = max(int(rows), x.shape[0])
        mean = x.sum(0) / rows
        var = (((x - mean) ** 2).sum(0) + (rows - x.shape[0]) * mean ** 2) / rows
    _update_running(bn, mean, var)
    return (x - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias


class VoxelRCNNHead(nn.Module):
    def __init__(self, roi_cfg, point_cloud_range, voxel_size, channels: dict,
                 code_size: int = 7):
        super().__init__()
        pool = roi_cfg.ROI_GRID_POOL
        self.grid_size = int(pool.GRID_SIZE)
        self.sources = list(pool.FEATURES_SOURCE)
        self.pre_mlp = bool(pool.get("PRE_MLP", False))
        self.point_cloud_range = [float(v) for v in point_cloud_range]
        self.voxel_size = [float(v) for v in voxel_size]
        self.dp_ratio = float(roi_cfg.DP_RATIO)
        c_pooled = 0
        for name in self.sources:
            c, lc = channels[name], pool.POOL_LAYERS[name]
            if self.pre_mlp:
                self.add_module(f"pre_{name}", nn.Linear(c, c, bias=False))
                self.add_module(f"pre_bn_{name}", BatchNorm1d(c, eps=1e-3, momentum=0.01))
            layer = SALayer(c, lc.POOL_RADIUS, lc.NSAMPLE, lc.MLPS)
            self.add_module(f"pool_{name}", layer)
            c_pooled += layer.out_channels
        self.branches = {}
        for branch, widths, cin in (("shared", roi_cfg.SHARED_FC, c_pooled * self.grid_size ** 3),
                                    ("cls", roi_cfg.CLS_FC, int(roi_cfg.SHARED_FC[-1])),
                                    ("reg", roi_cfg.REG_FC, int(roi_cfg.SHARED_FC[-1]))):
            self.branches[branch] = len(widths)
            for i, f in enumerate(widths):
                self.add_module(f"{branch}_fc{i}", nn.Linear(cin, int(f), bias=False))
                self.add_module(f"{branch}_bn{i}", BatchNorm1d(int(f), eps=1e-3, momentum=0.01))
                cin = int(f)
        self.cls_out = nn.Linear(int(roi_cfg.CLS_FC[-1]), 1)
        self.reg_out = nn.Linear(int(roi_cfg.REG_FC[-1]), code_size)
        self.relu = nn.ReLU()

    def centres(self, name: str, st: SP.SparseTensor, dtype) -> torch.Tensor:
        """(N, 3) metric centres of a stage's voxels at the stage's stride."""
        return voxel_centres(st.coords, float(STAGE_STRIDES[name]), self.voxel_size,
                             self.point_cloud_range, dtype)

    def pool_source(self, name: str, rois: torch.Tensor, st: SP.SparseTensor,
                    width: int) -> torch.Tensor:
        """rois (B, R, 7), stage ``name``'s tensor and ``width``, the JAX
        head's stage row count -> (B, R, G^3, C): the stage's SA pool at
        every grid point of every RoI."""
        b, r = rois.shape[:2]
        rows = st.mask
        centres = self.centres(name, st, rois.dtype)[rows]
        feats = st.features[rows].to(rois.dtype)
        if self.pre_mlp:
            feats = self.relu(padded_batch_norm(getattr(self, f"pre_bn_{name}"),
                                                getattr(self, f"pre_{name}")(feats), width))
        frame = st.coords[rows, 0]
        frames = [(roi_grid_points(rois[i], self.grid_size).reshape(-1, 3),
                   centres[frame == i], feats[frame == i]) for i in range(b)]
        out = getattr(self, f"pool_{name}")(frames, width=width)
        return out.reshape(b, r, self.grid_size ** 3, -1)

    def pool(self, rois: torch.Tensor, multi_scale_3d: dict, width: int) -> torch.Tensor:
        """``pool_source`` of every source (name -> SparseTensor in
        ``multi_scale_3d``), concatenated at each grid point."""
        return torch.cat([self.pool_source(n, rois, multi_scale_3d[n], width)
                          for n in self.sources], -1)

    def _stack(self, branch: str, x: torch.Tensor, generator=None) -> torch.Tensor:
        n = self.branches[branch]
        for i in range(n):
            x = self.relu(getattr(self, f"{branch}_bn{i}")(getattr(self, f"{branch}_fc{i}")(x)))
            if branch == "shared" and self.training and i != n - 1 and self.dp_ratio > 0:
                x = dropout(x, self.dp_ratio, generator)
        return x

    def head(self, pooled: torch.Tensor, generator=None):
        """(B, R, G^3, C) -> (rcnn_cls (B, R), rcnn_reg (B, R, 7)), the
        input flattened grid-major; in training, dropout between the shared
        layers draws from ``generator``."""
        b, r = pooled.shape[:2]
        x = self._stack("shared", pooled.reshape(b * r, -1), generator)
        return (self.cls_out(self._stack("cls", x)).reshape(b, r),
                self.reg_out(self._stack("reg", x)).reshape(b, r, -1))

    def forward(self, rois, multi_scale_3d: dict, width: int, generator=None):
        return self.head(self.pool(rois, multi_scale_3d, width), generator)


class VoxelRCNN(AnchorDetector):
    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg)
        self.roi_head = VoxelRCNNHead(cfg.model_cfg.ROI_HEAD, cfg.point_cloud_range,
                                      cfg.voxel_size, stage_channels(self.backbone_3d))

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """points (B, P, 3+C), points_valid (B, P) -> head_out,
        batch_cls_preds (B, A, ncls), batch_box_preds (B, A, 7),
        spatial_features_2d, roi_mask (B, R) of the proposals, rcnn_cls (B,
        R), rcnn_reg (B, R, 7) and ``active_voxels`` as SECONDNetIoU gives
        them. In eval also roi_scores, roi_labels, rois (the refined boxes)
        and rcnn_iou (= rcnn_cls). In training, ``gt_boxes`` (B, M, 8) is
        required and the output holds ``rcnn_targets``; the sample's
        priorities are ``roi_u`` (B, R) where given, else drawn from
        ``generator``, which also draws the dropout masks."""
        out = self.rpn(points, points_valid)
        bb, props = out.pop("bb"), out.pop("props")
        ms3d = bb["multi_scale_3d_features"]
        if self.training:
            targets = self.sample_rois(props, gt_boxes, generator, roi_u)
            out["rcnn_targets"] = targets
            rois = targets["rois"]
            ms3d = {k: v._replace(features=v.features.detach()) for k, v in ms3d.items()}
        else:
            out.update(props)
            rois = props["rois"]
        rcnn_cls, rcnn_reg = self.roi_head(rois[..., :7], ms3d,
                                           jax_stage_width(self.cfg,
                                                           global_batch(points.shape[0])),
                                           generator)
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
        if not self.training:
            out.update(rois=decode_rcnn_boxes(rois[..., :7], rcnn_reg), rcnn_iou=rcnn_cls)
        return out

    def loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """-> (total, the terms: rpn_loss_cls, rpn_loss_loc, rpn_loss_dir,
        rpn_loss, rcnn_loss_cls, rcnn_loss_reg, rcnn_loss_corner,
        rcnn_loss)."""
        rpn_loss, tb = self.rpn_loss(out, gt_boxes)
        rcnn_loss, rtb = pvrcnn_rcnn_loss(out["rcnn_cls"], out["rcnn_reg"],
                                          out["rcnn_targets"],
                                          self.cfg.model_cfg.ROI_HEAD.LOSS_CONFIG)
        tb.update(rtb)
        return rpn_loss + rcnn_loss, tb
