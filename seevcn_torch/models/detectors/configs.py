"""Detector configurations: SECOND-IoU's (copies of the ones in
__graft_entry__.py, which the port does not import: ``_mini_detector_cfg``,
``_flagship_detector_cfg`` and ``_tiny_detector_cfg``), PV-RCNN's
(``pvrcnn_detector_cfg`` at OpenPCDet's pv_rcnn.yaml widths on the
flagship's grid, ``tiny_pvrcnn_cfg`` for small runs and the tests) and
PV-RCNN++'s (``pvrcnn_plusplus_detector_cfg``, pv_rcnn_plusplus.yaml's PFE
on PV-RCNN's config, and ``tiny_pvrcnn_plusplus_cfg``)."""
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


def _pvrcnn_heads(sa_layers: dict, sources, num_keypoints: int, num_features: int,
                  point_fc, roi: dict):
    """PV-RCNN's PFE, POINT_HEAD and ROI_HEAD blocks, with pv_rcnn.yaml's
    fixed settings; ``roi`` holds the widths and sizes that vary."""
    pfe = Cfg({"NAME": "VoxelSetAbstraction", "POINT_SOURCE": "raw_points",
               "NUM_KEYPOINTS": num_keypoints, "NUM_OUTPUT_FEATURES": num_features,
               "SAMPLE_METHOD": "FPS", "FEATURES_SOURCE": list(sources),
               "SA_LAYER": sa_layers})
    point_head = Cfg({
        "NAME": "PointHeadSimple", "CLS_FC": list(point_fc), "CLASS_AGNOSTIC": True,
        "USE_POINT_FEATURES_BEFORE_FUSION": True,
        "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2]},
        "LOSS_CONFIG": {"LOSS_REG": "smooth-l1",
                        "LOSS_WEIGHTS": {"point_cls_weight": 1.0}}})
    nms = {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False}
    roi_head = Cfg({
        "NAME": "PVRCNNHead", "CLASS_AGNOSTIC": True,
        "SHARED_FC": list(roi["fc"]), "CLS_FC": list(roi["fc"]),
        "REG_FC": list(roi["fc"]),
        "DP_RATIO": 0.3,
        "NMS_CONFIG": {"TRAIN": {**nms, **roi["nms_train"]},
                       "TEST": {**nms, **roi["nms_test"]}},
        "ROI_GRID_POOL": {**roi["grid_pool"], "POOL_METHOD": "max_pool"},
        "TARGET_CONFIG": {"BOX_CODER": "ResidualCoder",
                          "ROI_PER_IMAGE": roi["per_image"], "FG_RATIO": 0.5,
                          "SAMPLE_ROI_BY_EACH_CLASS": True,
                          "CLS_SCORE_TYPE": "roi_iou", "CLS_FG_THRESH": 0.75,
                          "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
                          "HARD_BG_RATIO": 0.8, "REG_FG_THRESH": 0.55},
        "LOSS_CONFIG": {"CLS_LOSS": "BinaryCrossEntropy", "REG_LOSS": "smooth-l1",
                        "CORNER_LOSS_REGULARIZATION": True,
                        "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0,
                                         "rcnn_reg_weight": 1.0,
                                         "rcnn_corner_weight": 1.0,
                                         "code_weights": [1.0] * 7}}})
    return pfe, point_head, roi_head


def _nms(pre: int, post: int, thresh: float) -> dict:
    return {"NMS_PRE_MAXSIZE": pre, "NMS_POST_MAXSIZE": post, "NMS_THRESH": thresh}


def pvrcnn_detector_cfg():
    """PV-RCNN at the widths of OpenPCDet's tools/cfgs/kitti_models/
    pv_rcnn.yaml (PFE, POINT_HEAD, ROI_HEAD, POST_PROCESSING, batch 2) on
    the flagship's CLASS_NAMES, DATA_CONFIG (voxel [0.1, 0.1, 0.15], 90,000
    test and 80,000 train voxels), VFE, MAP_TO_BEV, BACKBONE_2D and Car
    DENSE_HEAD, with its OPTIMIZATION (adam_onecycle). The 3D backbone runs
    in f32 (pv_rcnn.yaml sets no dtype). The fused BEV is 512 channels, so
    the keypoint features concatenate 512 + 32 + 32 + 64 + 128 + 128 = 896
    channels before the fusion layer."""
    cfg = flagship_detector_cfg()
    m = cfg.MODEL
    m.NAME = "PVRCNN"
    m.BACKBONE_3D = Cfg({"NAME": "VoxelBackBone8x"})

    def sa(ds, width, radii, nsample):
        out = {"MLPS": [[width, width], [width, width]], "POOL_RADIUS": radii,
               "NSAMPLE": nsample}
        return out if ds is None else {"DOWNSAMPLE_FACTOR": ds, **out}

    m.PFE, m.POINT_HEAD, m.ROI_HEAD = _pvrcnn_heads(
        {"raw_points": sa(None, 16, [0.4, 0.8], [16, 16]),
         "x_conv1": sa(1, 16, [0.4, 0.8], [16, 16]),
         "x_conv2": sa(2, 32, [0.8, 1.2], [16, 32]),
         "x_conv3": sa(4, 64, [1.2, 2.4], [16, 32]),
         "x_conv4": sa(8, 64, [2.4, 4.8], [16, 32])},
        ["bev", "x_conv1", "x_conv2", "x_conv3", "x_conv4", "raw_points"],
        2048, 128, [256, 256],
        {"fc": [256, 256], "nms_train": _nms(9000, 512, 0.8),
         "nms_test": _nms(1024, 100, 0.7), "per_image": 128,
         "grid_pool": {"GRID_SIZE": 6, "MLPS": [[64, 64], [64, 64]],
                       "POOL_RADIUS": [0.8, 1.6], "NSAMPLE": [16, 16]}})
    post = m.POST_PROCESSING
    post.SCORE_THRESH = 0.1
    post.NMS_CONFIG.NMS_THRESH = 0.1
    post.NMS_CONFIG.NMS_PRE_MAXSIZE = 4096
    post.NMS_CONFIG.NMS_POST_MAXSIZE = 500
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    return cfg


def _graft_tiny_pvrcnn_cfg():
    """A copy of __graft_entry__._tiny_pvrcnn_cfg: the tiny grid with
    single-radius SA layers over bev, x_conv4 and the raw points."""
    cfg = tiny_detector_cfg()
    cfg.MODEL.NAME = "PVRCNN"
    cfg.MODEL.PFE, cfg.MODEL.POINT_HEAD, cfg.MODEL.ROI_HEAD = _pvrcnn_heads(
        {"raw_points": {"MLPS": [[8, 8]], "POOL_RADIUS": [0.8], "NSAMPLE": [8]},
         "x_conv4": {"DOWNSAMPLE_FACTOR": 8, "MLPS": [[8, 8]],
                     "POOL_RADIUS": [4.8], "NSAMPLE": [8]}},
        ["bev", "x_conv4", "raw_points"], 64, 16, [16],
        {"fc": [16], "nms_train": _nms(64, 8, 0.8), "nms_test": _nms(64, 8, 0.85),
         "per_image": 8,
         "grid_pool": {"GRID_SIZE": 3, "MLPS": [[8, 8]], "POOL_RADIUS": [1.6],
                       "NSAMPLE": [8]}})
    return cfg


def tiny_pvrcnn_cfg():
    """``_graft_tiny_pvrcnn_cfg`` with what the parity tests need from the
    JAX package's tests/test_pvrcnn.py:_pvrcnn_cfg: two radii in every SA
    layer and in the RoI-grid pool (the shared distance pass, two nsample
    values), two layers in every MLP and FC stack (the dropout slot), and
    every source of the full config, x_conv1-x_conv4 included."""
    cfg = _graft_tiny_pvrcnn_cfg()
    pfe, roi = cfg.MODEL.PFE, cfg.MODEL.ROI_HEAD
    pfe.FEATURES_SOURCE = ["bev", "x_conv1", "x_conv2", "x_conv3", "x_conv4",
                           "raw_points"]
    radii = {"raw_points": [0.4, 0.8], "x_conv1": [0.4, 0.8], "x_conv2": [0.8, 1.2],
             "x_conv3": [1.2, 2.4], "x_conv4": [2.4, 4.8]}
    for name, r in radii.items():
        width = 16 if name in ("x_conv3", "x_conv4") else 8
        pfe.SA_LAYER[name] = Cfg({"MLPS": [[width, width], [width, width]],
                                  "POOL_RADIUS": r, "NSAMPLE": [8, 16]})
        if name != "raw_points":
            pfe.SA_LAYER[name]["DOWNSAMPLE_FACTOR"] = 2 ** (int(name[-1]) - 1)
    cfg.MODEL.POINT_HEAD.CLS_FC = [16, 16]
    roi.SHARED_FC, roi.CLS_FC, roi.REG_FC = [16, 16], [16, 16], [16, 16]
    roi.ROI_GRID_POOL.MLPS = [[8, 8], [8, 8]]
    roi.ROI_GRID_POOL.POOL_RADIUS = [0.8, 1.6]
    roi.ROI_GRID_POOL.NSAMPLE = [8, 16]
    return cfg


def _vector_pool(reduced: int, msg_post, groups, ds=None) -> Cfg:
    """A VectorPoolAggregationModuleMSG SA layer; ``groups``: (NUM_LOCAL_VOXEL,
    MAX_NEIGHBOR_DISTANCE, NEIGHBOR_NSAMPLE, POST_MLPS) for each group."""
    out = {"NAME": "VectorPoolAggregationModuleMSG", "NUM_GROUPS": len(groups),
           "NUM_REDUCED_CHANNELS": reduced, "MSG_POST_MLPS": list(msg_post)}
    for i, (nv, dist, ns, post) in enumerate(groups):
        out[f"GROUP_CFG_{i}"] = {"NUM_LOCAL_VOXEL": list(nv), "MAX_NEIGHBOR_DISTANCE": dist,
                                 "NEIGHBOR_NSAMPLE": ns, "POST_MLPS": list(post)}
    if ds is not None:
        out["DOWNSAMPLE_FACTOR"] = ds
    return Cfg(out)


def pvrcnn_plusplus_detector_cfg():
    """PV-RCNN++: ``pvrcnn_detector_cfg`` with MODEL.NAME PVRCNNPlusPlus and
    the PFE of OpenPCDet's tools/cfgs/waymo_models/pv_rcnn_plusplus.yaml:
    4,096 keypoints by sectorized proposal-centric sampling (SPC: 6
    sectors, 1.6 m around the proposals), features from bev, x_conv3,
    x_conv4 and the raw points, each SA layer a
    VectorPoolAggregationModuleMSG of two groups, fused to 90 channels
    (512 + 32 + 128 + 128 = 800 before the fusion).

    Left out of the yaml's PFE: the keys the JAX package does not read
    (LOCAL_AGGREGATION_TYPE, NUM_CHANNELS_OF_LOCAL_AGGREGATION,
    FILTER_NEIGHBOR_WITH_ROI, RADIUS_OF_NEIGHBOR_WITH_ROI); its VectorPool
    layers take the per-bin mean (``voxel_avg_pool``). The 3D backbone,
    AnchorHeadSingle, POINT_HEAD, ROI_HEAD (the StackSA RoI-grid pool),
    POST_PROCESSING and OPTIMIZATION stay pv_rcnn.yaml's: the JAX
    package's PVRCNNPlusPlus builds AnchorHeadSingle whatever the config
    says, and its PVRCNNHead pools with the StackSA layer only, so the
    yaml's CenterHead and VectorPool RoI-grid pool have no counterpart
    there."""
    cfg = pvrcnn_detector_cfg()
    m = cfg.MODEL
    m.NAME = "PVRCNNPlusPlus"
    m.PFE.NUM_KEYPOINTS = 4096
    m.PFE.NUM_OUTPUT_FEATURES = 90
    m.PFE.SAMPLE_METHOD = "SPC"
    m.PFE["SPC_SAMPLING"] = Cfg({"NUM_SECTORS": 6, "SAMPLE_RADIUS_WITH_ROI": 1.6})
    m.PFE.FEATURES_SOURCE = ["bev", "x_conv3", "x_conv4", "raw_points"]
    m.PFE.SA_LAYER = Cfg({
        "raw_points": _vector_pool(2, [32], [([2, 2, 2], 0.2, -1, [32, 32]),
                                             ([3, 3, 3], 0.4, -1, [32, 32])]),
        "x_conv3": _vector_pool(32, [128], [([3, 3, 3], 1.2, -1, [64, 64]),
                                            ([3, 3, 3], 2.4, -1, [64, 64])], ds=4),
        "x_conv4": _vector_pool(32, [128], [([3, 3, 3], 2.4, -1, [64, 64]),
                                            ([3, 3, 3], 4.8, -1, [64, 64])], ds=8)})
    return cfg


def tiny_pvrcnn_plusplus_cfg(sample_method: str = "SPC", vector_pool: bool = True):
    """PV-RCNN++ on ``tiny_pvrcnn_cfg``'s grid, heads and widths, with the
    full config's sources (bev, x_conv3, x_conv4, raw points), for the
    tests. ``sample_method`` FPS (with ROI_NEIGHBOR_RADIUS 2.4) or SPC (6
    sectors, 1.6 m); ``vector_pool`` False keeps tiny_pvrcnn_cfg's StackSA
    layers, True makes each a two-group VectorPool MSG layer at tiny widths
    (one group with NEIGHBOR_NSAMPLE -1, one with 16). FPS + StackSA, FPS +
    VectorPool and SPC + StackSA are the JAX package's three PV-RCNN++ test
    topologies (tests/test_pvrcnn.py:173, :246, :297); SPC + VectorPool is
    the full config's."""
    cfg = tiny_pvrcnn_cfg()
    cfg.MODEL.NAME = "PVRCNNPlusPlus"
    pfe = cfg.MODEL.PFE
    pfe.FEATURES_SOURCE = ["bev", "x_conv3", "x_conv4", "raw_points"]
    pfe.SA_LAYER = Cfg({k: pfe.SA_LAYER[k] for k in ("raw_points", "x_conv3", "x_conv4")})
    if sample_method == "SPC":
        pfe.SAMPLE_METHOD = "SPC"
        pfe["SPC_SAMPLING"] = Cfg({"NUM_SECTORS": 6, "SAMPLE_RADIUS_WITH_ROI": 1.6})
    else:
        pfe["ROI_NEIGHBOR_RADIUS"] = 2.4
    if vector_pool:
        pfe.SA_LAYER = Cfg({
            "raw_points": _vector_pool(2, [8], [([2, 2, 2], 0.8, -1, [8, 8]),
                                                ([3, 3, 3], 1.6, 16, [8, 8])]),
            "x_conv3": _vector_pool(4, [16], [([3, 3, 3], 2.4, -1, [8, 8]),
                                              ([3, 3, 3], 4.8, 16, [8, 8])], ds=4),
            "x_conv4": _vector_pool(4, [16], [([2, 2, 2], 4.8, -1, [8, 8]),
                                              ([3, 3, 3], 9.6, 16, [8, 8])], ds=8)})
    return cfg


# --- single-stage anchor detectors: PointPillar and SECONDNet ---------------

def _kitti_anchor(name: str, size, bottom: float, stride: int, matched: float,
                  unmatched: float) -> dict:
    """One class of OpenPCDet's KITTI ANCHOR_GENERATOR_CONFIG (rotations 0 and
    1.57, not centre-aligned)."""
    return {"class_name": name, "anchor_sizes": [list(size)],
            "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [bottom],
            "align_center": False, "feature_map_stride": stride,
            "matched_threshold": matched, "unmatched_threshold": unmatched}


def _kitti_three_class_head(stride: int, name: str = "AnchorHeadSingle") -> Cfg:
    """The Car / Pedestrian / Cyclist anchor head of OpenPCDet's KITTI
    models (pointpillar.yaml, second.yaml): anchors at ``stride``, the
    axis-aligned assigner with the residual coder, loss weights cls 1.0,
    loc 2.0, dir 0.2."""
    return Cfg({
        "NAME": name, "CLASS_AGNOSTIC": False, "USE_DIRECTION_CLASSIFIER": True,
        "DIR_OFFSET": 0.78539, "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
        "ANCHOR_GENERATOR_CONFIG": [
            _kitti_anchor("Car", (3.9, 1.6, 1.56), -1.78, stride, 0.6, 0.45),
            _kitti_anchor("Pedestrian", (0.8, 0.6, 1.73), -0.6, stride, 0.5, 0.35),
            _kitti_anchor("Cyclist", (1.76, 0.6, 1.73), -0.6, stride, 0.5, 0.35)],
        "TARGET_ASSIGNER_CONFIG": {
            "NAME": "AxisAlignedTargetAssigner", "POS_FRACTION": -1.0,
            "SAMPLE_SIZE": 512, "NORM_BY_NUM_EXAMPLES": False,
            "MATCH_HEIGHT": False, "BOX_CODER": "ResidualCoder"},
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {
            "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
            "code_weights": [1.0] * 7}}})


def _single_stage_post(thresh: float, pre: int, post: int, multi: bool) -> Cfg:
    return Cfg({"RECALL_THRESH_LIST": [0.3, 0.5, 0.7], "SCORE_THRESH": 0.1,
                "OUTPUT_RAW_SCORE": False, "EVAL_METRIC": "kitti",
                "NMS_CONFIG": {"MULTI_CLASSES_NMS": multi, "NMS_TYPE": "nms_gpu",
                               "NMS_THRESH": thresh, "NMS_PRE_MAXSIZE": pre,
                               "NMS_POST_MAXSIZE": post}})


def _kitti_optimization() -> Cfg:
    """OpenPCDet's KITTI OPTIMIZATION block: adam_onecycle, LR 0.003, batch 4."""
    return Cfg({"OPTIMIZER": "adam_onecycle", "BATCH_SIZE_PER_GPU": 4,
                "NUM_EPOCHS": 80, "LR": 0.003, "WEIGHT_DECAY": 0.01,
                "MOMENTUM": 0.9, "MOMS": [0.95, 0.85], "PCT_START": 0.4,
                "DIV_FACTOR": 10, "DECAY_STEP_LIST": [35, 45], "LR_DECAY": 0.1,
                "LR_CLIP": 0.0000001, "LR_WARMUP": False, "WARMUP_EPOCH": 1,
                "GRAD_NORM_CLIP": 10})


def pointpillar_detector_cfg():
    """PointPillar at OpenPCDet's tools/cfgs/kitti_models/pointpillar.yaml:
    0.16 x 0.16 x 4 m pillars over [0, -39.68, -3, 69.12, 39.68, 1] (a 432 x
    496 grid), PillarVFE (absolute xyz, no distance, 64 filters), the
    64-channel scatter, BACKBONE_2D [3, 5, 5] x [64, 128, 256] at strides 2
    up by [1, 2, 4] to 3 x 128, AnchorHeadSingle with the three KITTI
    classes at stride 2, NMS 0.01 over 4,096 -> 500, adam_onecycle at batch
    4. One change: ``used_feature_list`` is [x, y, z], as the flagship's,
    because the SEE frame's completed points carry no intensity; the VFE
    reads 3 + 3 + 3 = 9 features. The JAX package's PointPillar averages
    every point of a pillar (MAX_POINTS_PER_VOXEL is not read)."""
    return Cfg({
        "CLASS_NAMES": ["Car", "Pedestrian", "Cyclist"],
        "DATA_CONFIG": {
            "POINT_CLOUD_RANGE": [0, -39.68, -3, 69.12, 39.68, 1],
            "POINT_FEATURE_ENCODING": {"used_feature_list": ["x", "y", "z"]},
            "DATA_PROCESSOR": [
                {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": [0.16, 0.16, 4],
                 "MAX_POINTS_PER_VOXEL": 32,
                 "MAX_NUMBER_OF_VOXELS": {"train": 16000, "test": 40000}}]},
        "MODEL": {
            "NAME": "PointPillar",
            "VFE": {"NAME": "PillarVFE", "WITH_DISTANCE": False,
                    "USE_ABSLOTE_XYZ": True, "USE_NORM": True, "NUM_FILTERS": [64]},
            "MAP_TO_BEV": {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 64},
            "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [3, 5, 5],
                            "LAYER_STRIDES": [2, 2, 2], "NUM_FILTERS": [64, 128, 256],
                            "UPSAMPLE_STRIDES": [1, 2, 4],
                            "NUM_UPSAMPLE_FILTERS": [128, 128, 128]},
            "DENSE_HEAD": _kitti_three_class_head(2),
            "POST_PROCESSING": _single_stage_post(0.01, 4096, 500, False)},
        "OPTIMIZATION": _kitti_optimization()})


def second_multihead_detector_cfg():
    """SECONDNet with the structure of OpenPCDet's tools/cfgs/nuscenes_models/
    cbgs_second_multihead.yaml (VoxelResBackBone8x, AnchorHeadMulti with a
    64-channel shared conv and one group a class, per-class NMS 0.2 over
    1,000 -> 83) on the KITTI data and widths of kitti_models/second.yaml:
    0.05 x 0.05 x 0.1 m voxels over [0, -40, -3, 70.4, 40, 1] (1408 x 1600
    x 40), 5 points a voxel, 16,000 / 40,000 voxels, HeightCompression 256,
    BACKBONE_2D [5, 5] x [128, 256] up to 2 x 256, the three KITTI classes
    at stride 8, batch 4, points [x, y, z]. No published multi-head yaml
    runs unchanged here: the JAX package's grouped head has no
    SEPARATE_REG_CONFIG and no velocity code, which the nuScenes heads
    need."""
    return Cfg({
        "CLASS_NAMES": ["Car", "Pedestrian", "Cyclist"],
        "DATA_CONFIG": {
            "POINT_CLOUD_RANGE": [0, -40, -3, 70.4, 40, 1],
            "POINT_FEATURE_ENCODING": {"used_feature_list": ["x", "y", "z"]},
            "DATA_PROCESSOR": [
                {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": [0.05, 0.05, 0.1],
                 "MAX_POINTS_PER_VOXEL": 5,
                 "MAX_NUMBER_OF_VOXELS": {"train": 16000, "test": 40000}}]},
        "MODEL": {
            "NAME": "SECONDNet",
            "VFE": {"NAME": "MeanVFE"},
            "BACKBONE_3D": {"NAME": "VoxelResBackBone8x"},
            "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
            "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [5, 5],
                            "LAYER_STRIDES": [1, 2], "NUM_FILTERS": [128, 256],
                            "UPSAMPLE_STRIDES": [1, 2],
                            "NUM_UPSAMPLE_FILTERS": [256, 256]},
            "DENSE_HEAD": _multihead(_kitti_three_class_head(8, "AnchorHeadMulti"), 64,
                                     [["Car"], ["Pedestrian"], ["Cyclist"]]),
            "POST_PROCESSING": _single_stage_post(0.2, 1000, 83, True)},
        "OPTIMIZATION": _kitti_optimization()})


def _multihead(head: Cfg, shared: int, groups) -> Cfg:
    head["SHARED_CONV_NUM_FILTER"] = shared
    head["USE_MULTIHEAD"] = True
    head["SEPARATE_MULTIHEAD"] = True
    head["CLASS_NAMES_EACH_HEAD"] = [list(g) for g in groups]
    return head


def second_focal_detector_cfg():
    """``second_multihead_detector_cfg`` with the focal 3D backbone
    (VoxelBackBone8xFocal: the JAX package's TOPK 128 and THRESHOLD 0.5,
    which its model fixes) and AnchorHeadSingle, second.yaml's head, with
    second.yaml's NMS (0.01 over 4,096 -> 500)."""
    cfg = second_multihead_detector_cfg()
    cfg.MODEL.BACKBONE_3D = Cfg({"NAME": "VoxelBackBone8xFocal"})
    cfg.MODEL.DENSE_HEAD = _kitti_three_class_head(8)
    cfg.MODEL.POST_PROCESSING = _single_stage_post(0.01, 4096, 500, False)
    return cfg


def _tiny_single_stage(cfg, voxel_size, stride: int):
    """A full single-stage config cut to the tiny grid ([0, -8, -2, 16, 8,
    2]) with narrow 2D widths and small NMS, for the tests."""
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -8, -2, 16, 8, 2]
    vox = cfg.DATA_CONFIG.DATA_PROCESSOR[0]
    vox.VOXEL_SIZE = list(voxel_size)
    vox.MAX_NUMBER_OF_VOXELS = {"train": 512, "test": 512}
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS, b2.NUM_FILTERS, b2.NUM_UPSAMPLE_FILTERS = [1, 1], [16, 32], [16, 16]
    b2.LAYER_STRIDES = [1, 2] if stride == 8 else [2, 2]
    b2.UPSAMPLE_STRIDES = [1, 2]
    for a in cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG:
        a["feature_map_stride"] = stride
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 16
    return cfg


def tiny_pointpillar_cfg():
    """PointPillar on the tiny grid: 0.5 m pillars (32 x 32), a 16-filter
    VFE, BACKBONE_2D [1, 1] x [16, 32] at strides 2, 2 up by [1, 2],
    anchors at stride 2."""
    cfg = _tiny_single_stage(pointpillar_detector_cfg(), (0.5, 0.5, 4), 2)
    cfg.MODEL.VFE.NUM_FILTERS = [16]
    cfg.MODEL.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    return cfg


def tiny_second_multihead_cfg():
    """The multi-head SECONDNet on the tiny grid (0.5 x 0.5 x 0.1 m, 32 x 32
    x 40): VoxelResBackBone8x, BACKBONE_2D [1, 1] x [16, 32] at strides 1,
    2, a 16-channel shared conv and the groups [Car], [Pedestrian,
    Cyclist] (one group of two classes), anchors at stride 8."""
    cfg = _tiny_single_stage(second_multihead_detector_cfg(), (0.5, 0.5, 0.1), 8)
    _multihead(cfg.MODEL.DENSE_HEAD, 16, [["Car"], ["Pedestrian", "Cyclist"]])
    return cfg


def tiny_second_focal_cfg():
    """The focal SECONDNet on ``tiny_second_multihead_cfg``'s grid and
    widths, with AnchorHeadSingle, and 2,048 voxel rows a frame: the focal
    layers' new voxels take the strided convs' outputs past the 512 rows of
    the other tiny configs, where the JAX package's rulebook mode would
    truncate them (ROADMAP §3)."""
    cfg = _tiny_single_stage(second_focal_detector_cfg(), (0.5, 0.5, 0.1), 8)
    cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS = {"train": 2048, "test": 2048}
    return cfg
