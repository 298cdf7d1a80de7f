"""Detector training on one device (port of seevcn_tpu/train/train.py;
reference detector3d/tools/train_utils/train_utils.py:11-135).

``train_step`` is the reference's step: the training forward with the
ground truth, the loss, the backward, then the scheduled update with the
gradients clipped, for every ported detector (SECONDNetIoU, PVRCNN,
PVRCNNPlusPlus and VoxelRCNN, which draw their RoI sample and dropout from
the step's generator, PointRCNN and PartA2, which draw their RoI sample
from it and no dropout, and SECONDNet, PointPillar, CenterPoint and CaDDN
(on images), which draw nothing: each model's ``loss`` gives its terms).
It is single-device; the reference's sharded step (``shard_train_step``)
maps to DDP, which the port has not taken up yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .optim import Optimizer, build_optimizer


@dataclass
class TrainState:
    """The model (in training mode), its optimizer with the schedules, and
    the number of steps taken."""
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(model, opt_cfg, total_steps: int) -> TrainState:
    """``model`` (any detector of ``build_detector``, on its device) into
    training mode, with the OPTIMIZATION config's optimizer
    over ``total_steps``."""
    model.train()
    return TrainState(model, build_optimizer(opt_cfg, total_steps, model.parameters()))


def train_forward(state: TrainState, points, valid, gt_boxes, generator=None,
                  roi_u=None, **loss_inputs):
    """The training forward and loss: -> (loss, loss terms, forward output).
    ``generator``, a generator of the points' device, draws the RoI sample's
    priorities (unless ``roi_u`` (B, R) gives them) and the dropout masks;
    a detector without an RoI head draws nothing. CaDDN takes its images
    (B, H, W, 3) and their P2 (B, 3, 4) in place of ``points`` and
    ``valid``, and its loss the ``loss_inputs`` depth_maps (B, H, W) and
    gt_boxes2d (B, M, 4)."""
    out = state.model(points, valid, gt_boxes=gt_boxes, generator=generator,
                      roi_u=roi_u)
    loss, tb = state.model.loss(out, gt_boxes, **loss_inputs)
    return loss, tb, out


def apply_gradients(state: TrainState, loss: torch.Tensor) -> None:
    """Backward of ``loss`` and the update for step ``state.step``, which
    then advances."""
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step(state.step)
    state.step += 1


def train_step(state: TrainState, points, valid, gt_boxes, generator=None, *,
               roi_u=None, **loss_inputs) -> dict:
    """One step on points (B, P, 3), valid (B, P), gt_boxes (B, M, 8) (zero
    rows padding). -> metrics, detached: loss and the model's loss terms
    (rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss, then SECOND-IoU's
    rcnn_loss_iou, or PV-RCNN's (and PV-RCNN++'s) point_loss_cls, rcnn_loss_cls,
    rcnn_loss_reg, rcnn_loss_corner, rcnn_loss, or Voxel R-CNN's rcnn_loss_cls,
    rcnn_loss_reg, rcnn_loss_corner, rcnn_loss, or the focal SECONDNet's
    loss_box_of_pts; CenterPoint's are hm_loss, loc_loss and rpn_loss, their
    weighted sum; PointRCNN's point_loss_cls, point_loss_box and the RCNN's
    four, no RPN's; Part-A2's the RPN's, seg_loss, part_loss and the RCNN's
    four); CaDDN's the RPN's and ddn_loss (with DDNLoss and 2D boxes also
    fg_loss and bg_loss). ``loss_inputs`` as ``train_forward``'s."""
    loss, tb, _ = train_forward(state, points, valid, gt_boxes, generator, roi_u,
                                **loss_inputs)
    apply_gradients(state, loss)
    return {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}
