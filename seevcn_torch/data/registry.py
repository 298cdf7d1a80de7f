"""The dataset registry (port of seevcn_tpu/data/registry.py; reference
pcdet/datasets/__init__.py and SEE_VCN.py's __DATASETS__): KITTI, nuScenes,
Lyft, Waymo and Custom (Baraja), each with its SEE-completed variant, and
the demo's SEE adapter, which the JAX registry also imports."""
from __future__ import annotations

from .demo_dataset import DemoObjects  # noqa: F401
from .generic import (CustomDataset, LyftDataset, NuScenesDataset, SCCustomDataset,
                      SCLyftDataset, SCNuScenesDataset, SCWaymoDataset, WaymoDataset)
from .kitti.dataset import KittiDataset, SCKittiDataset

DATASETS = {
    "KittiDataset": KittiDataset,
    "SCKittiDataset": SCKittiDataset,
    "LyftDataset": LyftDataset,
    "SCLyftDataset": SCLyftDataset,
    "NuScenesDataset": NuScenesDataset,
    "SCNuScenesDataset": SCNuScenesDataset,
    "WaymoDataset": WaymoDataset,
    "SCWaymoDataset": SCWaymoDataset,
    "CustomDataset": CustomDataset,
    "SCCustomDataset": SCCustomDataset,
}


def build_dataset(dataset_cfg, class_names, training: bool, root_path=None, **kw):
    return DATASETS[dataset_cfg.DATASET](dataset_cfg, class_names, training,
                                         root_path, **kw)
