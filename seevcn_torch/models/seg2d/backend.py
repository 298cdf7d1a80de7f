"""Build, initialise, train and checkpoint the port's Mask R-CNN (port of
seevcn_tpu/models/seg2d/backend.py).

``build_seg2d`` makes the model on a device and loads a state dict in the
port's key names (``seevcn_torch.utils.weights.seg2d_state_dict_from_flax``
carries a flax tree over); ``init_seg2d`` draws fresh weights at flax's
default initializers. ``make_seg2d_train_step`` is the reference's train
step on its wire format, and the checkpoint pair reads and writes the JAX
package's pickle (flax-layout numpy trees and the config) without importing
JAX. ``paste_mask`` puts a 28x28 mask back into the image as the
reference's ``cv2.resize(m, (bw, bh)) >= 0.5`` does, and ``MaskRCNNBackend``
is the reference's image backend of the mask CLI (``JaxMaskRCNNBackend``):
a BGR camera image in, each detection's full-image mask out.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch
from torch import nn

from ... import resolve_device, tf32_off
from ...ops.resize import resize_linear
from ...train.train import TrainState, apply_gradients
from ...utils.weights import seg2d_flax_from_state_dict, seg2d_state_dict_from_flax
from ..modules.common import DeformConv2d, lecun_normal
from .maskrcnn import MaskRCNN, Seg2DConfig

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# the plain model's loss terms (HTC adds its own)
LOSS_TERMS = ("rpn_cls", "rpn_reg", "box_cls", "box_reg", "mask")


def build_seg2d(cfg: Seg2DConfig | None = None, state_dict: dict | None = None, *,
                device="cuda") -> MaskRCNN:
    """-> the model in eval mode on ``device`` (CUDA unless the caller asks
    for the CPU). A given state dict is loaded with strict=True."""
    dev = resolve_device(device)
    model = MaskRCNN(cfg or Seg2DConfig())
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


@torch.no_grad()
def init_seg2d(model: MaskRCNN, generator: torch.Generator) -> MaskRCNN:
    """Fresh weights at flax's default initializers, drawn on the CPU from
    ``generator`` (so a seed gives the same weights on every device): every
    conv, transposed conv, deformable conv and dense kernel lecun normal
    (variance 1 / fan_in, fan_in the kernel's input channels times its
    taps), biases zero, a deformable conv's offset conv zero (weight and
    bias: the layer starts as a plain conv), batch norm at scale 1, offset
    0, running mean 0 and variance 1. -> the model."""
    offset_convs = [m.offset_conv for m in model.modules() if isinstance(m, DeformConv2d)]
    for m in model.modules():
        if any(m is c for c in offset_convs):
            m.weight.zero_()
            m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, DeformConv2d)):
            w = m.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) \
                else w[0].numel()
            w.copy_(lecun_normal(w.shape, fan_in, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
            m.reset_parameters()
    return model


def decode_wire(images: torch.Tensor, gt_masks: torch.Tensor,
                packed_masks: bool | None = None):
    """The train step's wire format on the device: images of any float type
    -> f32; masks bit-packed along the width (uint8, ``np.packbits(...,
    axis=-1, bitorder="little")``) -> unpacked, then f32. ``packed_masks``
    says which; None keeps the reference's guess, uint8 masks whose packed
    width times 8 is the image's width."""
    images = images.to(torch.float32)
    unpack = packed_masks if packed_masks is not None else (
        gt_masks.dtype == torch.uint8 and gt_masks.shape[-1] * 8 == images.shape[-2])
    if unpack:
        shifts = torch.arange(8, dtype=torch.uint8, device=gt_masks.device)
        bits = (gt_masks[..., None] >> shifts) & 1
        gt_masks = bits.reshape(*gt_masks.shape[:-1], gt_masks.shape[-1] * 8)
    return images, gt_masks.to(torch.float32)


def step_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of train step ``it`` of a run seeded ``seed``, on
    ``device``: the step counter feeds the draws, as the reference folds it
    into the step's key."""
    return torch.Generator(device=device).manual_seed(seed * 2**32 + it)


def seg2d_train_forward(state: TrainState, images, gt_boxes, gt_labels, gt_valid,
                        gt_masks, generator: torch.Generator | None = None, *,
                        roi_u=None, rpn_u=None):
    """The training forward and loss on decoded inputs -> (loss, {term:
    value}, forward output). ``roi_u`` / ``rpn_u`` override the draws of the
    RoI and anchor samples (else drawn from ``generator``, the RoIs' first)."""
    out = state.model(images, gt_boxes, gt_labels, gt_valid, gt_masks, train=True,
                      generator=generator, roi_u=roi_u)
    loss, tb = state.model.loss(out, gt_boxes, gt_labels, gt_valid, gt_masks,
                                generator, rpn_u=rpn_u)
    return loss, tb, out


def make_seg2d_train_step(packed_masks: bool | None = None):
    """-> step(state, images, gt_boxes, gt_labels, gt_valid, gt_masks, seed=0,
    *, roi_u=None, rpn_u=None) -> metrics {loss, and every term of
    ``MaskRCNN.loss``: rpn_cls, rpn_reg, box_cls, box_reg, mask, and HTC's
    where the config has them}, detached. One step decodes the wire format
    (``decode_wire``), runs the training forward and loss with the draws of
    ``step_generator(seed, state.step)``, the backward and the scheduled
    update; ``state.step`` then advances. TF32 is switched off for the step,
    as the serving stages do (``tf32_off``)."""

    def step(state: TrainState, images, gt_boxes, gt_labels, gt_valid, gt_masks,
             seed: int = 0, *, roi_u=None, rpn_u=None) -> dict:
        tf32_off()
        images, gt_masks = decode_wire(images, gt_masks, packed_masks)
        gen = step_generator(seed, state.step, images.device)
        loss, tb, _ = seg2d_train_forward(state, images, gt_boxes, gt_labels, gt_valid,
                                          gt_masks, gen, roi_u=roi_u, rpn_u=rpn_u)
        apply_gradients(state, loss)
        return {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}

    return step


class _CheckpointUnpickler(pickle.Unpickler):
    """Reads the JAX package's seg2d pickle with no JAX at hand: its config
    class becomes the port's copy; any other class of seevcn_tpu, JAX, flax
    or optax is refused."""

    def find_class(self, module, name):
        if (module, name) == ("seevcn_tpu.models.seg2d.maskrcnn", "Seg2DConfig"):
            return Seg2DConfig
        if module.split(".")[0] in ("seevcn_tpu", "jax", "jaxlib", "flax", "optax"):
            raise pickle.UnpicklingError(f"refusing {module}.{name} in a seg2d "
                                         f"checkpoint")
        return super().find_class(module, name)


def save_seg2d_checkpoint(path: str, model: MaskRCNN, cfg: Seg2DConfig) -> None:
    """The reference's pickle, {"params", "batch_stats"} as flax-layout
    numpy trees and "cfg", written atomically (a temporary file, then
    os.replace): a run killed mid-write leaves the previous file whole."""
    tree = seg2d_flax_from_state_dict(model.state_dict())
    with open(path + ".tmp", "wb") as f:
        pickle.dump({"params": tree["params"], "batch_stats": tree["batch_stats"],
                     "cfg": cfg}, f)
    os.replace(path + ".tmp", path)


def load_seg2d_checkpoint(path: str):
    """A seg2d pickle of either package -> (Seg2DConfig, state dict in the
    port's key names). A config pickled before a field existed takes that
    field's default."""
    with open(path, "rb") as f:
        saved = _CheckpointUnpickler(f).load()
    cfg = saved.get("cfg") or Seg2DConfig()
    names = {f.name for f in dataclasses.fields(Seg2DConfig)}
    cfg = Seg2DConfig(**{k: v for k, v in vars(cfg).items() if k in names})
    sd = seg2d_state_dict_from_flax({"params": saved["params"],
                                     "batch_stats": saved.get("batch_stats", {})})
    return cfg, sd


def paste_mask(mask: torch.Tensor, box, image_size) -> torch.Tensor:
    """One detection's mask probabilities (28, 28) into an image of
    ``image_size`` (H, W) -> bool (H, W), as the reference pastes it: the
    box rounded to whole pixels (bw, bh at least 1), the mask resized to
    (bh, bw) with cv2's INTER_LINEAR semantics (``resize_linear``),
    thresholded at 0.5, cut at the image's edges. ``box`` is host numbers
    (x1, y1, x2, y2), taken in their own precision as the reference takes
    them (numpy float32 from a detection's row)."""
    h, w = image_size
    x1, y1, x2, y2 = box
    bw, bh = max(int(round(x2 - x1)), 1), max(int(round(y2 - y1)), 1)
    patch = resize_linear(mask, (bh, bw)) >= 0.5
    xi, yi = max(int(round(x1)), 0), max(int(round(y1)), 0)
    xe, ye = min(xi + bw, w), min(yi + bh, h)
    full = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    full[yi:ye, xi:xe] = patch[:max(ye - yi, 0), :max(xe - xi, 0)]
    return full


class MaskRCNNBackend:
    """The mask CLI's image backend (the reference's ``JaxMaskRCNNBackend``):
    ``backend(image_bgr)`` with a uint8 (H0, W0, 3) BGR numpy image -> a
    list of {mask (H0, W0) bool numpy, bbox [x, y, w, h], score,
    category_id}, one a detection scoring at least ``score_thresh``, in the
    model's slot order.

    The model comes from a seg2d checkpoint of either package (its config
    with it), else is ``cfg`` (default ``Seg2DConfig()``) at
    ``init_seg2d``'s random weights drawn from ``generator`` (default: a
    CPU generator seeded 0). On ``device`` (CUDA unless the caller asks for
    the CPU), a call flips BGR to RGB, resizes to ``cfg.image_size`` with
    cv2's uint8 INTER_LINEAR (``resize_linear``), normalises by ImageNet's
    mean and deviation, runs the eval forward, and pastes each kept
    detection's mask at its box scaled back to the camera image
    (``paste_mask``)."""

    def __init__(self, ckpt: str | None = None, cfg: Seg2DConfig | None = None,
                 score_thresh: float = 0.5, device="cuda",
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        if ckpt:
            cfg, sd = load_seg2d_checkpoint(ckpt)
            self.model = build_seg2d(cfg, sd, device=dev)
        else:
            cfg = cfg or Seg2DConfig()
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            self.model = init_seg2d(MaskRCNN(cfg), gen).to(dev).eval()
        self.cfg, self.score_thresh, self.device = cfg, score_thresh, dev
        self.mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
        self.std = torch.from_numpy(IMAGENET_STD).to(dev)

    @torch.no_grad()
    def __call__(self, image_bgr: np.ndarray) -> list[dict]:
        tf32_off()
        h0, w0 = image_bgr.shape[:2]
        ih, iw = self.cfg.image_size
        rgb = torch.from_numpy(np.ascontiguousarray(image_bgr[..., ::-1])).to(self.device)
        img = resize_linear(rgb, (ih, iw)).to(torch.float32)
        img = (img / 255.0 - self.mean) / self.std
        out = self.model(img[None])
        boxes, scores, cls = (out[k][0].cpu().numpy()
                              for k in ("det_boxes", "det_scores", "det_cls"))
        sx, sy = w0 / iw, h0 / ih
        dets = []
        for d in np.nonzero(scores >= self.score_thresh)[0]:
            b = boxes[d]
            x1, y1, x2, y2 = b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy
            full = paste_mask(out["det_masks"][0, d], (x1, y1, x2, y2), (h0, w0))
            dets.append({"mask": full.cpu().numpy(),
                         "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                         "score": float(scores[d]),
                         "category_id": int(self.cfg.class_ids[int(cls[d])])})
        return dets
