"""SECOND-IoU detector configurations (copies of the ones in
__graft_entry__.py, which the port does not import: ``_mini_detector_cfg``,
``_flagship_detector_cfg`` and ``_tiny_detector_cfg``)."""
from __future__ import annotations

from ...utils.config import Cfg


def mini_detector_cfg():
    """KITTI-scale SECOND-IoU config (reference source-waymo/second_iou.yaml
    MODEL block over a KITTI-sized grid to keep single-chip compile fast)."""
    return Cfg({
        "CLASS_NAMES": ["Car"],
        "DATA_CONFIG": {
            "POINT_CLOUD_RANGE": [0, -40, -3, 70.4, 40, 1],
            "POINT_FEATURE_ENCODING": {"used_feature_list": ["x", "y", "z"]},
            "DATA_PROCESSOR": [
                {"NAME": "transform_points_to_voxels",
                 # z-voxel matches the sc_kitti eval grid (0.15 -> z=27)
                 "VOXEL_SIZE": [0.1, 0.1, 0.15],
                 "MAX_POINTS_PER_VOXEL": 5,
                 "MAX_NUMBER_OF_VOXELS": {"train": 16000, "test": 16000}},
            ],
        },
        "MODEL": {
            "NAME": "SECONDNetIoU",
            "VFE": {"NAME": "MeanVFE"},
            "BACKBONE_3D": {"NAME": "VoxelBackBone8x"},
            "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
            "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [5, 5],
                            "LAYER_STRIDES": [1, 2], "NUM_FILTERS": [128, 256],
                            "UPSAMPLE_STRIDES": [1, 2],
                            "NUM_UPSAMPLE_FILTERS": [256, 256]},
            "DENSE_HEAD": {
                "NAME": "AnchorHeadSingle", "CLASS_AGNOSTIC": False,
                "USE_DIRECTION_CLASSIFIER": True, "DIR_OFFSET": 0.78539,
                "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
                "ANCHOR_GENERATOR_CONFIG": [{
                    "class_name": "Car", "anchor_sizes": [[4.2, 2.0, 1.6]],
                    "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [0],
                    "align_center": False, "feature_map_stride": 8,
                    "matched_threshold": 0.55, "unmatched_threshold": 0.4}],
                "TARGET_ASSIGNER_CONFIG": {
                    "NAME": "AxisAlignedTargetAssigner", "POS_FRACTION": -1.0,
                    "SAMPLE_SIZE": 512, "NORM_BY_NUM_EXAMPLES": False,
                    "MATCH_HEIGHT": False, "BOX_CODER": "ResidualCoder"},
                "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                    "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
                    "code_weights": [1.0] * 7}},
            },
            "ROI_HEAD": {
                "NAME": "SECONDHead", "CLASS_AGNOSTIC": True,
                "SHARED_FC": [256, 256], "IOU_FC": [256, 256], "DP_RATIO": 0.3,
                "NMS_CONFIG": {
                    "TRAIN": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                              "NMS_PRE_MAXSIZE": 1024, "NMS_POST_MAXSIZE": 128,
                              "NMS_THRESH": 0.8},
                    "TEST": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                             "NMS_PRE_MAXSIZE": 1024, "NMS_POST_MAXSIZE": 100,
                             "NMS_THRESH": 0.7}},
                "ROI_GRID_POOL": {"GRID_SIZE": 7, "IN_CHANNEL": 512,
                                  "DOWNSAMPLE_RATIO": 8},
                "TARGET_CONFIG": {
                    "BOX_CODER": "ResidualCoder", "ROI_PER_IMAGE": 128,
                    "FG_RATIO": 0.5, "SAMPLE_ROI_BY_EACH_CLASS": True,
                    "CLS_SCORE_TYPE": "raw_roi_iou", "CLS_FG_THRESH": 0.75,
                    "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
                    "HARD_BG_RATIO": 0.8, "REG_FG_THRESH": 0.55},
                "LOSS_CONFIG": {"IOU_LOSS": "BinaryCrossEntropy",
                                "LOSS_WEIGHTS": {"rcnn_iou_weight": 1.0,
                                                 "code_weights": [1.0] * 7}},
            },
            "POST_PROCESSING": {
                "RECALL_THRESH_LIST": [0.3, 0.5, 0.7], "SCORE_THRESH": 0.1,
                "OUTPUT_RAW_SCORE": False, "EVAL_METRIC": "kitti",
                "NMS_CONFIG": {"MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                               "NMS_THRESH": 0.01, "NMS_PRE_MAXSIZE": 1024,
                               "NMS_POST_MAXSIZE": 500}},
        },
        "OPTIMIZATION": {"OPTIMIZER": "adam_onecycle", "BATCH_SIZE_PER_GPU": 4,
                         "NUM_EPOCHS": 1, "LR": 0.003, "WEIGHT_DECAY": 0.01,
                         "MOMENTUM": 0.9, "MOMS": [0.95, 0.85], "PCT_START": 0.4,
                         "DIV_FACTOR": 10, "GRAD_NORM_CLIP": 10},
    })


def flagship_detector_cfg():
    """Reference-capacity SECOND-IoU: the sc_kitti eval budget
    (sc_kitti_dataset.yaml:31-37 — voxel [0.1, 0.1, 0.15], 90k test voxels)
    under the source-waymo/second_iou.yaml MODEL block. This is the config
    bench.py measures and the port's SEE + detector frame runs."""
    cfg = mini_detector_cfg()
    cfg.DATA_CONFIG.DATA_PROCESSOR[0].VOXEL_SIZE = [0.1, 0.1, 0.15]
    cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS = {
        "train": 80000, "test": 90000}
    # bf16 backbone activations between layers (convs accumulate f32);
    # MODE names a TPU lowering of the same math and does not change the
    # port's result
    cfg.MODEL.BACKBONE_3D["MODE"] = "zfold"
    cfg.MODEL.BACKBONE_3D["DTYPE"] = "bfloat16"
    return cfg


def tiny_detector_cfg():
    """Shrunken grid (16 x 16 x 4 m at 0.5 x 0.5 x 0.1 m) and 2D widths for
    small runs and the parity tests."""
    cfg = mini_detector_cfg()
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -8, -2, 16, 8, 2]
    cfg.DATA_CONFIG.DATA_PROCESSOR[0].VOXEL_SIZE = [0.5, 0.5, 0.1]
    cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS = {"train": 512, "test": 512}
    cfg.MODEL.BACKBONE_2D.LAYER_NUMS = [2, 2]
    cfg.MODEL.BACKBONE_2D.NUM_FILTERS = [32, 64]
    cfg.MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [32, 32]
    cfg.MODEL.ROI_HEAD.SHARED_FC = [64, 64]
    cfg.MODEL.ROI_HEAD.IOU_FC = [64, 64]
    cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 128
    cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 32
    cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16
    return cfg
