"""Train the port's Mask R-CNN from scratch (port of
seevcn_tpu/cli/train_seg2d.py).

No pretrained HTC can be fetched, so the recipe trains from scratch on
procedural synthetic driving scenes (models/seg2d/synthetic.py), or on a
COCO-format directory (``--coco_dir``: annotations.json and its PNGs, e.g.
what generate_masks writes): AdamW
with a warm-up and cosine decay, gradients clipped at a global norm of 10,
f16 images and bit-packed masks on the wire, held-out mask and box AP every
``eval_every`` steps with a checkpoint at each eval point and at the end.
The checkpoint is the JAX package's pickle, so either package loads it.

Usage:
  python -m seevcn_torch.cli.train_seg2d --steps 2000 --out seg2d.ckpt
  python -m seevcn_torch.cli.train_seg2d --device cpu --size tiny --image_size 96 128
"""
from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="seg2d.ckpt")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=200)
    p.add_argument("--image_size", type=int, nargs=2, default=(384, 512))
    p.add_argument("--size", choices=["tiny", "small", "base"], default="base",
                   help="backbone scale")
    p.add_argument("--coco_dir", default=None,
                   help="COCO-format dataset root with annotations.json and PNG "
                        "images (default: synthetic scenes)")
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--eval_scenes", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--cascade", type=int, default=1, choices=[1, 3],
                   help="cascade box-head stages (3 = HTC's cascade at IoU "
                        "0.5/0.6/0.7)")
    p.add_argument("--semantic", action="store_true",
                   help="HTC's fused semantic branch (stride-8 segmentation "
                        "loss and RoI feature fusion)")
    p.add_argument("--mask_info_flow", action="store_true",
                   help="HTC's per-stage mask heads chained by their "
                        "features (needs --cascade 3)")
    p.add_argument("--hard", action="store_true",
                   help="far-instance/occlusion scene regime (train and eval); "
                        "eval always reports far/near AP buckets")
    p.add_argument("--device", default="cuda",
                   help="the device to train on (cuda, or cpu)")
    return p.parse_args(argv)


SIZES = {
    "tiny": dict(stage_sizes=(1, 1, 1, 1), stage_channels=(16, 32, 64, 64),
                 fpn_channels=32, box_hidden=128, mask_channels=32,
                 mask_convs=2),
    "small": dict(stage_sizes=(2, 2, 2, 2), stage_channels=(32, 64, 128, 128),
                  fpn_channels=64, box_hidden=256, mask_channels=64,
                  mask_convs=2),
    "base": dict(),  # Seg2DConfig defaults (ResNet-18-class)
}


def build_cfg(args):
    from ..models.seg2d.maskrcnn import Seg2DConfig

    return Seg2DConfig(image_size=tuple(args.image_size),
                       cascade_stages=getattr(args, "cascade", 1),
                       semantic_branch=getattr(args, "semantic", False),
                       mask_info_flow=getattr(args, "mask_info_flow", False),
                       **SIZES[args.size])


def synthetic_stream(cfg, batch, seed, hard=False):
    """Endless batches of synthetic scenes from RandomState(seed)."""
    import numpy as np

    from ..models.seg2d.synthetic import synth_batch

    rng = np.random.RandomState(seed)
    while True:
        yield synth_batch(rng, cfg.image_size, batch, max_gt=cfg.max_gt, hard=hard)


def coco_stream(cfg, batch, root, seed):
    """Endless batches from a COCO-format directory: <root>/annotations.json
    with images [{file_name, id}] and annotations [{image_id, bbox xywh,
    category_id, polygon segmentation}], the images with annotations drawn
    by RandomState(seed). Each image (a PNG or a JPEG,
``data/image.read_image_bgr``, flipped to RGB as the JAX package's cv2
read is) is resized to
    cfg.image_size with cv2's uint8 INTER_LINEAR (``ops/resize``) and
    normalised; each mask is rasterized at the image's size
    (``see/masks.polygons_to_mask``), resized in f32 and thresholded at 0.5;
    boxes scale with the image. -> (images, boxes x1y1x2y2, labels, valid,
    masks) numpy, as ``synthetic_stream``'s."""
    import numpy as np
    import torch

    from ..data.image import read_image_bgr
    from ..models.seg2d.backend import IMAGENET_MEAN, IMAGENET_STD
    from ..ops.resize import resize_linear
    from ..see.masks import polygons_to_mask

    with open(os.path.join(root, "annotations.json")) as f:
        coco = json.load(f)
    by_img = {}
    for a in coco["annotations"]:
        by_img.setdefault(a["image_id"], []).append(a)
    images = [im for im in coco["images"] if by_img.get(im["id"])]
    cat_ids = sorted({a["category_id"] for a in coco["annotations"]})
    cat_to_label = {c: i for i, c in enumerate(cat_ids)}
    h, w = cfg.image_size
    rng = np.random.RandomState(seed)
    while True:
        idxs = rng.randint(0, len(images), batch)
        imgs = np.zeros((batch, h, w, 3), np.float32)
        gtb = np.zeros((batch, cfg.max_gt, 4), np.float32)
        gtl = np.zeros((batch, cfg.max_gt), np.int32)
        gtv = np.zeros((batch, cfg.max_gt), bool)
        gtm = np.zeros((batch, cfg.max_gt, h, w), np.float32)
        for bi, ii in enumerate(idxs):
            im = images[ii]
            raw = read_image_bgr(os.path.join(root, im["file_name"]))[..., ::-1]
            h0, w0 = raw.shape[:2]
            small = resize_linear(torch.from_numpy(np.ascontiguousarray(raw)), (h, w)).numpy()
            imgs[bi] = (small.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            sx, sy = w / w0, h / h0
            for k, a in enumerate(by_img[im["id"]][:cfg.max_gt]):
                x, y, bw, bh = a["bbox"]
                gtb[bi, k] = [x * sx, y * sy, (x + bw) * sx, (y + bh) * sy]
                gtl[bi, k] = cat_to_label[a["category_id"]]
                gtv[bi, k] = True
                m = polygons_to_mask(a["segmentation"], h0, w0).astype(np.float32)
                gtm[bi, k] = resize_linear(torch.from_numpy(m), (h, w)).numpy() >= 0.5
        yield imgs, gtb, gtl, gtv, gtm


def pack(batch):
    """A host batch -> its wire format: f16 images, and the masks
    bit-packed along the width (np.packbits, little bit order) where the
    width is a multiple of 8."""
    import numpy as np

    imgs, boxes, labels, valid, masks = batch
    if masks.shape[-1] % 8 == 0:
        masks = np.packbits(masks >= 0.5, axis=-1, bitorder="little")
    return imgs.astype(np.float16), boxes, labels, valid, masks


def evaluate(model, cfg, n_scenes, seed, hard=False):
    """Held-out synthetic mask and box AP (RandomState(seed + 77777)'s
    scenes), plus far / near buckets of the mask AP50 by ground-truth box
    height (far: under h / 8, COCO's ignore semantics). Each detection
    scoring above 0.05 is pasted into the image at its box (``paste_mask``).
    The model runs in eval mode, with TF32 off, and goes back to the mode it
    was in."""
    import numpy as np
    import torch

    from .. import tf32_off
    from ..models.seg2d.backend import paste_mask
    from ..models.seg2d.coco_eval import evaluate_instances
    from ..models.seg2d.synthetic import synth_scene

    tf32_off()
    dev = model.anchors.device
    was_training = model.training
    model.eval()
    rng = np.random.RandomState(seed + 77777)
    h, w = cfg.image_size
    preds, gts = [], []
    with torch.no_grad():
        for _ in range(n_scenes):
            img, boxes, labels, valid, masks = synth_scene(h, w, rng, max_gt=cfg.max_gt,
                                                           hard=hard)
            out = model(torch.from_numpy(img[None]).to(dev))
            db, ds, dc = (out[k][0].cpu().numpy()
                          for k in ("det_boxes", "det_scores", "det_cls"))
            keep = ds > 0.05
            full = [paste_mask(out["det_masks"][0, i], db[i], (h, w))
                    for i in np.nonzero(keep)[0]]
            full = torch.stack(full).cpu().numpy() if full else np.zeros((0, h, w), bool)
            preds.append({"masks": full, "boxes": db[keep], "scores": ds[keep],
                          "labels": dc[keep]})
            gts.append({"masks": masks[valid] >= 0.5, "boxes": boxes[valid],
                        "labels": labels[valid]})
    model.train(was_training)
    mask_ap = evaluate_instances(preds, gts, kind="mask")
    box_ap = evaluate_instances(preds, gts, kind="box")
    far_h = h / 8.0
    mask_far = evaluate_instances(preds, gts, kind="mask", height_range=(0.0, far_h))
    mask_near = evaluate_instances(preds, gts, kind="mask",
                                   height_range=(far_h, float("inf")))
    return {"mask_AP50": mask_ap["AP50"], "mask_AP": mask_ap["AP"],
            "box_AP50": box_ap["AP50"], "box_AP": box_ap["AP"],
            "mask_AP50_far": mask_far["AP50"],
            "mask_AP50_near": mask_near["AP50"]}


def train(args=None, cfg=None, stream=None, quiet=False):
    """The recipe: -> (TrainState, model, cfg). Weights start at flax's
    default initializers from seed 0, as the reference's do; the data and
    the samples' draws follow ``args.seed``."""
    import torch

    from .. import resolve_device
    from ..train.optim import build_seg2d_optimizer
    from ..train.train import TrainState
    from ..models.seg2d.backend import (init_seg2d, make_seg2d_train_step,
                                        save_seg2d_checkpoint)
    from ..models.seg2d.maskrcnn import MaskRCNN

    args = args or parse_args([])
    cfg = cfg or build_cfg(args)
    dev = resolve_device(args.device)
    model = init_seg2d(MaskRCNN(cfg), torch.Generator().manual_seed(0)).to(dev).train()
    opt = build_seg2d_optimizer(model.parameters(), args.lr, args.weight_decay,
                                args.warmup_steps, max(args.steps, args.warmup_steps + 1))
    state = TrainState(model, opt)
    step_fn = make_seg2d_train_step(packed_masks=cfg.image_size[1] % 8 == 0)
    if stream is None and args.coco_dir:
        stream = coco_stream(cfg, args.batch_size, args.coco_dir, args.seed)
    elif stream is None:
        stream = synthetic_stream(cfg, args.batch_size, args.seed,
                                  hard=getattr(args, "hard", False))

    t0 = time.time()
    for it in range(args.steps):
        batch = [torch.from_numpy(x).to(dev) for x in pack(next(stream))]
        metrics = step_fn(state, *batch, args.seed)
        if not quiet and (it % args.log_every == 0 or it == args.steps - 1):
            print(f"step {it:5d} loss {float(metrics['loss']):.4f} "
                  f"({(it + 1) / (time.time() - t0):.2f} it/s)", flush=True)
        if args.eval_every and it > 0 and (it + 1) % args.eval_every == 0:
            ev = evaluate(model, cfg, args.eval_scenes, args.seed,
                          hard=getattr(args, "hard", False))
            if not quiet:
                print(f"step {it:5d} " + " ".join(f"{k}={v:.3f}" for k, v in ev.items()),
                      flush=True)
            if args.out:
                # a checkpoint at every eval point: a run killed mid-flight
                # still leaves a usable file
                save_seg2d_checkpoint(args.out, model, cfg)
                if not quiet:
                    print(f"saved {args.out} (step {it + 1})", flush=True)
    if args.out:
        save_seg2d_checkpoint(args.out, model, cfg)
        if not quiet:
            print(f"saved {args.out}")
    return state, model, cfg


def main(argv=None):
    args = parse_args(argv)
    _, model, cfg = train(args)
    ev = evaluate(model, cfg, args.eval_scenes, args.seed,
                  hard=getattr(args, "hard", False))
    print(json.dumps(ev))
    return ev


if __name__ == "__main__":
    main()
