"""2D instance-mask generation CLI (port of seevcn_tpu/cli/generate_masks.py;
reference see/detector2d/generate_masks.py:67-141).

Runs a 2D instance-segmentation model on every image of a directory and
writes the masks as the reference's COCO JSON, one file a camera, which
the SEE stage reads (``see/masks.CocoMasks``). The model is pluggable:

  * ``--backend jax[:ckpt]``: the port's Mask R-CNN / HTC
    (``models/seg2d/backend.MaskRCNNBackend``) from a seg2d checkpoint of
    either package (``--weights`` when no path follows the colon; with
    neither, seeded random weights); the default. The name is kept so
    that the JAX package's command lines run unchanged.
  * ``--backend import:pkg.mod:fn``: any callable(image_bgr) -> list of
    {mask (H, W) bool, bbox xywh, score, category_id}.
  * ``--backend torchvision`` (the JAX package's default) raises:
    torchvision is not installed where the port runs, and the JAX
    package's branch downloads its weights.

Images are PNGs or JPEGs read by ``data/image.read_image_bgr`` (BGR, as
cv2 reads them; the JPEG decoder is libjpeg's arithmetic in the port's own
C++). ``mask_to_polygons`` is ``cv2.findContours``'s
external border following (``see/masks.external_contours``), so the JSON
is the JAX package's byte for byte on the same detections.

Usage:
  python -m seevcn_torch.cli.generate_masks --image_dir <dir> --out masks.json \\
      --backend jax:seg2d.ckpt [--score_thresh 0.5] [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import importlib
import json
import os
import time

import numpy as np

from ..data.image import read_image_bgr
from ..see.masks import external_contours

CAR_CATEGORY_ID = 3  # COCO 'car' (generate_masks.py keeps COCO ids)


def mask_to_polygons(mask: np.ndarray):
    """Binary mask -> COCO polygon list (mask_utils.mask2polygon): the
    external contours of ``cv2.findContours(RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)`` with at least 3 vertices, as float lists."""
    polys = []
    for c in external_contours(np.asarray(mask).astype(np.uint8)):
        if len(c) >= 3:
            polys.append(c.reshape(-1).astype(float).tolist())
    return polys


def detections_to_coco(per_image, out_path: str, score_thresh: float = 0.5):
    """per_image: list of (file_name, (H, W), detections) -> the COCO JSON
    at ``out_path``."""
    images, annotations = [], []
    ann_id = 1
    for img_id, (fname, (h, w), dets) in enumerate(per_image, start=1):
        images.append({"id": img_id, "file_name": fname,
                       "height": int(h), "width": int(w)})
        for d in dets:
            if d.get("score", 1.0) < score_thresh:
                continue
            segm = d.get("segmentation") or mask_to_polygons(d["mask"])
            if not segm:
                continue
            annotations.append({
                "id": ann_id, "image_id": img_id,
                "category_id": int(d.get("category_id", CAR_CATEGORY_ID)),
                "segmentation": segm,
                "bbox": [float(x) for x in d["bbox"]],
                "score": float(d.get("score", 1.0)), "iscrowd": 0})
            ann_id += 1
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": CAR_CATEGORY_ID, "name": "car"}]}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(coco, f)
    return out_path


def _import_backend(spec: str):
    mod_name, fn_name = spec.split(":", 1)
    return getattr(importlib.import_module(mod_name), fn_name)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out", required=True, help="output COCO json path")
    p.add_argument("--backend", default="jax")
    p.add_argument("--weights", default=None)
    p.add_argument("--score_thresh", type=float, default=0.5)
    p.add_argument("--ext", default="png,jpg")
    p.add_argument("--device", default="cuda",
                   help="the device of the jax backend's model (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """-> {"out": the JSON's path, "images": n, "detections": n a image,
    "s": seconds over the images (read, model, polygons)}."""
    args = parse_args(argv)
    if args.backend == "torchvision":
        raise SystemExit("generate_masks --backend torchvision: torchvision is not "
                         "installed where the port runs, and without --weights the "
                         "reference's branch downloads its weights; use --backend "
                         "jax:<seg2d checkpoint> or import:pkg.mod:fn")
    if args.backend == "jax" or args.backend.startswith("jax:"):
        from ..models.seg2d.backend import MaskRCNNBackend

        ckpt = args.backend[4:] if args.backend.startswith("jax:") else args.weights
        run = MaskRCNNBackend(ckpt, score_thresh=args.score_thresh, device=args.device)
    elif args.backend.startswith("import:"):
        run = _import_backend(args.backend[len("import:"):])
    else:
        raise SystemExit(f"unknown backend {args.backend}")

    paths = []
    for ext in args.ext.split(","):
        paths += glob.glob(os.path.join(args.image_dir, f"*.{ext}"))
    per_image, counts = [], []
    t0 = time.time()
    for path in sorted(paths):
        img = read_image_bgr(path)
        dets = run(img)
        per_image.append((os.path.basename(path), img.shape[:2], dets))
        counts.append(len(dets))
        print(f"{os.path.basename(path)}: {len(dets)} cars")
    detections_to_coco(per_image, args.out, args.score_thresh)
    seconds = time.time() - t0
    print(f"wrote {args.out}")
    return {"out": args.out, "images": len(per_image), "detections": counts, "s": seconds}


if __name__ == "__main__":
    main()
