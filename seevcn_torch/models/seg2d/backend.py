"""Build the port's Mask R-CNN (port of the inference side of
seevcn_tpu/models/seg2d/backend.py).

``build_seg2d`` makes the model on a device and loads a state dict in the
port's key names (``seevcn_torch.utils.weights.seg2d_state_dict_from_flax``
carries a flax tree over). The reference's image backend for the mask CLI
(``JaxMaskRCNNBackend``, which resizes with cv2) waits for the CLIs, ROADMAP
queue 1 item 12; training waits for item 9.
"""
from __future__ import annotations

import numpy as np

from ... import resolve_device
from .maskrcnn import MaskRCNN, Seg2DConfig

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def build_seg2d(cfg: Seg2DConfig | None = None, state_dict: dict | None = None, *,
                device="cuda") -> MaskRCNN:
    """-> the model in eval mode on ``device`` (CUDA unless the caller asks
    for the CPU). A given state dict is loaded with strict=True."""
    dev = resolve_device(device)
    model = MaskRCNN(cfg or Seg2DConfig())
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()
