"""Detector training on one device (port of seevcn_tpu/train/train.py;
reference detector3d/tools/train_utils/train_utils.py:11-135).

``train_step`` is the reference's step: the training forward with the
ground truth, the loss, the backward, then the scheduled update with the
gradients clipped, for every ported detector (SECONDNetIoU, PVRCNN,
PVRCNNPlusPlus and VoxelRCNN, which draw their RoI sample and dropout from
the step's generator, PointRCNN and PartA2, which draw their RoI sample
from it and no dropout, and SECONDNet, PointPillar, CenterPoint and CaDDN
(on images), which draw nothing: each model's ``loss`` gives its terms).

``shard_train_step`` is the step over a (dp, mp) mesh of a process group
(the JAX package's ``shard_train_step``, the batch over its mesh's dp axis
and, in SECOND-IoU and SECONDNet, the BEV map's W over its mp axis): each
rank takes its dp row's rows of the global batch, and the step equals the
one-process step on the global batch, as JAX's one program over the global
batch does (batch-norm statistics, loss normalizers and draws of the global
batch; ``parallel/mesh.py``). It is not OpenPCDet's DDP step, which keeps
each GPU's own statistics and normalizers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..parallel.mesh import broadcast_, make_mesh, set_active_mesh
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


def all_reduce_grads(params, mp: int = 1, sharded=frozenset()) -> None:
    """Sum every parameter's gradient over the ranks (a missing one taken
    as zero), one all-reduce a dtype and kind. Over an mp axis of ``mp``
    ranks, the parameters whose ids are in ``sharded`` (a BEV backbone run
    on W slabs: each rank's gradient is its slab's share) are summed over
    every rank, and every other one is summed over every rank and divided by
    ``mp``: the mp ranks of a dp row compute the same replicated work, so
    this is the sum over the dp rows, and, reduced over every rank, the
    same on every rank even where the replicated work differs in its last
    bits between them."""
    buckets = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        buckets.setdefault((id(p) in sharded, p.grad.dtype), []).append(p.grad)
    for (own_slab, _), grads in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        if mp > 1 and not own_slab:
            flat /= mp
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def shard_train_step(model, mesh=None):
    """The train step of ``model`` over the (dp, mp) mesh of the process
    group (``make_mesh()``'s, dp only, by default) -> (step_fn, mesh). Rank
    0's weights and statistics are broadcast to every rank once, here.
    ``step_fn(state, points, valid, gt_boxes, generator, *, roi_u=None,
    **loss_inputs)`` takes this rank's dp row's rows of the global batch
    (``mesh.shard_batch``; ``roi_u`` its rows of the priorities, and CaDDN
    its image rows and their loss inputs) and ``generator`` the same on
    every rank. Under the active mesh it runs ``train_forward``, whose loss
    is its dp row's share of the global batch's (SECOND-IoU and SECONDNet
    run their BEV backbone on this rank's W slab); the gradients are then
    summed over the dp rows (``all_reduce_grads``), clipped by their global
    norm and stepped, so the weights stay the same on every rank. -> the
    metrics of the global batch (the dp rows' shares summed), the same on
    every rank."""
    mesh = mesh or make_mesh()
    if mesh.world > 1:
        for t in [*model.parameters(), *model.buffers()]:
            broadcast_(t)
    sharded = frozenset(id(p) for p in model.backbone_2d.parameters()) \
        if mesh.mp > 1 and getattr(model, "SHARD_BEV", False) else frozenset()

    def step_fn(state: TrainState, points, valid, gt_boxes, generator=None, *,
                roi_u=None, **loss_inputs) -> dict:
        prev = set_active_mesh(mesh)
        try:
            loss, tb, _ = train_forward(state, points, valid, gt_boxes, generator, roi_u,
                                        **loss_inputs)
            state.optimizer.zero_grad()
            loss.backward()
        finally:
            set_active_mesh(prev)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}
        if mesh.world > 1:
            all_reduce_grads(state.optimizer.params, mesh.mp, sharded)
        if mesh.dp > 1:
            vals = torch.stack([v.to(loss.dtype) for v in metrics.values()])
            dist.all_reduce(vals, group=mesh.dp_group)
            metrics = dict(zip(metrics, vals.unbind()))
        state.optimizer.step(state.step)
        state.step += 1
        return metrics

    return step_fn, mesh
