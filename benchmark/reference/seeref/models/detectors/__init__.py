"""The reference's detectors, one file each, found by the config's
MODEL.NAME in lower case (``secondnetiou.py`` for SECONDNetIoU); each file
names its class ``Detector``. A detector that a later cell adds is a file
of its own."""
from __future__ import annotations

import importlib

from ... import resolve_device
from .anchor_rpn import DetectorConfig


def build_detector(cfg, state_dict: dict | None = None, *, max_voxels=None, device="cuda"):
    """cfg: a full pcdet config (MODEL, DATA_CONFIG, CLASS_NAMES) -> (the
    model in eval mode on ``device``, DetectorConfig); ``max_voxels``
    overrides the voxel cap."""
    mod = importlib.import_module(f"{__name__}.{cfg.MODEL.NAME.lower()}")
    dcfg = DetectorConfig(cfg.MODEL, cfg.DATA_CONFIG, cfg.CLASS_NAMES, max_voxels=max_voxels)
    model = mod.Detector(dcfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device)).eval(), dcfg
