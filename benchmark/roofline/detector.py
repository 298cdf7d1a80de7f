"""The operations of a voxel detector's forward pass, counted from its
configuration (``configs/<name>.json``'s ``detector``) and the frame's
points: the sparse 3D backbone from the benchmark's own sparse-conv pairs
(``sparse_pairs.py``, layer lists in ``backbones.json``), the BEV backbone,
the dense head and the RoI head from their shapes. An FMA counts as two
operations; batch norm, activations, pooling and NMS are left out. Each
part is counted in the dtype the configuration runs it in."""
from __future__ import annotations

import json
from pathlib import Path

from . import sparse_pairs as SPP

LAYERS = json.loads((Path(__file__).with_name("backbones.json")).read_text())


def voxel_cfg(det: dict) -> dict:
    vox = next(p for p in det["DATA_CONFIG"]["DATA_PROCESSOR"]
               if p["NAME"] == "transform_points_to_voxels")
    return vox


def backbone3d(points, valid, det: dict, train: bool) -> dict:
    """-> flops, the active sites of each layer (input first) and the
    voxels before the cap, for one frame."""
    vox = voxel_cfg(det)
    cap = int(vox["MAX_NUMBER_OF_VOXELS"]["train" if train else "test"])
    pcr = det["DATA_CONFIG"]["POINT_CLOUD_RANGE"]
    sites, before = SPP.voxel_sites(points, valid, pcr, vox["VOXEL_SIZE"], cap)
    nx, ny, nz = SPP.grid_shape(pcr, vox["VOXEL_SIZE"])
    shape = (nz + 1, ny, nx)
    cin0 = len(det["DATA_CONFIG"]["POINT_FEATURE_ENCODING"]["used_feature_list"])
    flops, active = 0, [int(sites.shape[0])]
    for kind, cin, cout, *pad in LAYERS[det["MODEL"]["BACKBONE_3D"]["NAME"]]:
        cin = cin0 if cin == "in" else cin
        if kind == "subm":
            pairs, sites, shape = SPP.conv_sites(sites, shape, (3, 3, 3), (1, 1, 1), (1, 1, 1), True)
        elif kind == "down":
            pairs, sites, shape = SPP.conv_sites(sites, shape, (3, 3, 3), (2, 2, 2), tuple(pad[0]), False)
        else:
            pairs, sites, shape = SPP.conv_sites(sites, shape, (3, 1, 1), (2, 1, 1), (0, 0, 0), False)
        flops += 2 * pairs * cin * cout
        active.append(int(sites.shape[0]))
    return {"flops": flops, "active": active, "voxels": before, "cap": cap,
            "bev": (cout * shape[0], shape[1], shape[2])}


def bev_and_heads(det: dict, bev, train: bool) -> int:
    """The BEV backbone, the dense head and (SECOND-IoU) the RoI head."""
    c, h, w = bev
    b2 = det["MODEL"]["BACKBONE_2D"]
    flops, outs = 0, []
    for i, (n, s, f) in enumerate(zip(b2["LAYER_NUMS"], b2["LAYER_STRIDES"], b2["NUM_FILTERS"])):
        h, w = (h + 2 - 3) // s + 1, (w + 2 - 3) // s + 1
        flops += 2 * 9 * c * f * h * w + n * 2 * 9 * f * f * h * w
        c = f
        u, uf = int(b2["UPSAMPLE_STRIDES"][i]), b2["NUM_UPSAMPLE_FILTERS"][i]
        flops += 2 * c * uf * u * u * h * w
        outs.append((uf, h * u, w * u))
    c, h, w = sum(o[0] for o in outs), outs[0][1], outs[0][2]
    head = det["MODEL"]["DENSE_HEAD"]
    if head["NAME"] == "CenterHead":
        sh = head["SHARED_CONV_CHANNEL"]
        flops += 2 * 9 * c * sh * h * w
        chans = [len(det["CLASS_NAMES"])] + [v["out_channels"] for v in
                                              head["SEPARATE_HEAD_CFG"]["HEAD_DICT"].values()]
        flops += sum(2 * 9 * sh * sh * h * w + 2 * 9 * sh * ch * h * w for ch in chans)
    else:
        ag = head["ANCHOR_GENERATOR_CONFIG"]
        a = sum(len(g["anchor_rotations"]) * len(g["anchor_sizes"]) for g in ag)
        per = a * len(det["CLASS_NAMES"]) + a * 7 + a * int(head.get("NUM_DIR_BINS", 0))
        flops += 2 * c * per * h * w
    roi = det["MODEL"].get("ROI_HEAD")
    if roi is not None:
        g = roi["ROI_GRID_POOL"]["GRID_SIZE"]
        dims = [roi["ROI_GRID_POOL"]["IN_CHANNEL"] * g * g, *roi["SHARED_FC"]]
        fc = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        iou = [dims[-1], *roi["IOU_FC"], 1]
        fc += sum(a * b for a, b in zip(iou[:-1], iou[1:]))
        rois = roi["TARGET_CONFIG"]["ROI_PER_IMAGE"] if train else \
            roi["NMS_CONFIG"]["TEST"]["NMS_POST_MAXSIZE"]
        flops += 2 * fc * rois
    return flops


def forward_flops(points, valid, det: dict, train: bool) -> dict:
    """One frame's forward: {dtype: operations} and the counts of the 3D
    backbone (active sites a layer, voxels before the cap, the cap)."""
    bb = backbone3d(points, valid, det, train)
    dt = det["MODEL"]["BACKBONE_3D"].get("DTYPE", "float32")
    out = {"bfloat16": 0, "float32": 0}
    out[dt] += bb["flops"]
    out["float32"] += bev_and_heads(det, bb["bev"], train)
    return {"flops": out, "active": bb["active"], "voxels": bb["voxels"], "cap": bb["cap"]}
