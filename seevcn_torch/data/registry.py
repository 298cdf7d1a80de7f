"""The dataset registry (port of seevcn_tpu/data/registry.py; reference
pcdet/datasets/__init__.py and SEE_VCN.py's __DATASETS__): the datasets the
port has, KITTI and its SEE-completed variant."""
from __future__ import annotations

from .kitti.dataset import KittiDataset, SCKittiDataset

DATASETS = {"KittiDataset": KittiDataset, "SCKittiDataset": SCKittiDataset}

#: the JAX package's other datasets, not ported yet
NOT_PORTED = ("LyftDataset", "SCLyftDataset", "NuScenesDataset", "SCNuScenesDataset",
              "WaymoDataset", "SCWaymoDataset", "CustomDataset", "SCCustomDataset")


def build_dataset(dataset_cfg, class_names, training: bool, root_path=None, **kw):
    """DATA_CONFIG.DATASET's dataset. A name the JAX package has and the
    port not yet raises a KeyError that names those."""
    name = dataset_cfg.DATASET
    if name not in DATASETS:
        raise KeyError(f"dataset {name}: the port has {', '.join(DATASETS)}; not ported "
                       f"yet: {', '.join(NOT_PORTED)}")
    return DATASETS[name](dataset_cfg, class_names, training, root_path, **kw)
