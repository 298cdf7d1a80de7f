"""Detector training on one device (OpenPCDet's train_utils.py): the
training forward with the ground truth, the loss, the backward, then the
scheduled update with the gradients clipped."""
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
    ``generator`` draws the RoI sample's priorities (unless ``roi_u`` (B, R)
    gives them) and the dropout masks."""
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
    rows padding). -> metrics, detached: loss and the model's loss terms."""
    loss, tb, _ = train_forward(state, points, valid, gt_boxes, generator, roi_u,
                                **loss_inputs)
    apply_gradients(state, loss)
    return {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}
