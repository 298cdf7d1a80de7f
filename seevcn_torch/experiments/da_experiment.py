"""The DA demonstration: does SEE completion transfer detection across a
scan-pattern shift? (port of scripts/da_experiment.py)

Protocol (the reference's source -> target recipe at synthetic scale):
  raw detector:  train SECOND-IoU on raw 64-beam source frames, eval KITTI
                 Car 3D AP@0.7 on raw 16-beam target frames.
  see detector:  complete every frame through the GT-path SEE
                 (``see/gt_completion.complete_gt_frames``: the points in
                 each ground-lifted GT box, isolation, VCN, partial mesh,
                 largest cluster, the 2 m guard, the replacement, whose
                 within-radius test is the pruned min-distance kernel K1 on
                 the card), train on the completed source, eval on the
                 completed target. The source is completed by VCN_CN with
                 the GT boxes, as the reference does (SEE_VCN.py:46-82).
  claim:         AP(see on target) > AP(raw on target), while both are
                 comparable on the source val.

Subcommands:
  complete --set runs/da/src_train.npz --vcn runs/vcn_da/ckpt-best.pth
  train    --train runs/da/src_train[.completed].npz --out runs/da/det_raw
  eval     --ckpt runs/da/det_raw/ckpt.pth --set runs/da/tgt_val[.completed].npz

Runs on the card unless ``--cpu`` asks for the CPU. The port's checkpoints
are the reference's ``.pth``: VCN's (``utils/ckpt.load_vcn_checkpoint``) and
OpenPCDet's for the detector (``ckpt.pth``: model_state, optimizer_state,
it, total_steps, cfg_mode).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from .. import resolve_device, tf32_off
from ..data.kitti.eval import get_official_eval_result
from ..models.detectors.configs import mini_detector_cfg
from ..models.detectors.second import build_detector, post_processing
from ..models.vcn.inference import VCNInference
from ..models.vcn.nets import build_vcn
from ..models.vcn.runner import init_vcn_weights
from ..models.vcn.vc_shapenet import points_in_box7
from ..see.gt_completion import complete_gt_frames
from ..train.train import create_train_state, train_step
from ..utils.ckpt import (detector_state_dict_from_torch, load_torch_checkpoint,
                          load_vcn_checkpoint, save_detector_checkpoint)

#: frames completed in one call of ``complete_gt_frames`` (the VCN runs once
#: on all their instances)
COMPLETE_BATCH = 8
#: the world y-flip of a training batch: points and boxes (y, and the yaw)
FLIP_P = (1.0, -1.0, 1.0)
FLIP_G = (1.0, -1.0, 1.0, 1.0, 1.0, 1.0, -1.0, 1.0)


def _device(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else "cuda")


def da_detector_cfg(max_pts: int, mode: str = "zfold"):
    """SECOND-IoU over the DA frame envelope (x <= 48, |y| <= 19.2): grid
    240 x 192 x 40 at voxel [0.2, 0.2, 0.1], the model block of
    ``mini_detector_cfg`` (the z depth of 40 keeps z/8 >= 3 for the three
    stride-2 stages and the final (3, 1, 1) conv). ``mode`` is recorded as
    BACKBONE_3D.MODE; the port's backbone runs the rulebook in every mode."""
    cfg = mini_detector_cfg()
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -19.2, -3, 48.0, 19.2, 1]
    proc = cfg.DATA_CONFIG.DATA_PROCESSOR[0]
    proc.VOXEL_SIZE = [0.2, 0.2, 0.1]
    proc.MAX_NUMBER_OF_VOXELS = {"train": 16000, "test": 20000}
    head = cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]
    head["anchor_sizes"] = [[4.2, 1.9, 2.0]]
    head["anchor_bottom_heights"] = [-1.75]
    head["matched_threshold"] = 0.6
    head["unmatched_threshold"] = 0.45
    cfg.MODEL.BACKBONE_3D["MODE"] = mode
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.1
    return cfg


def load_set(path):
    d = np.load(path)
    return (d["points"].astype(np.float32), d["valid"],
            d["gt_boxes"].astype(np.float32), d["gt_mask"])


# --------------------------------------------------------------------------- #
# completion (GT-path SEE)
# --------------------------------------------------------------------------- #

def seeded_vcn(model_name: str, device) -> VCNInference:
    """``model_name`` at flax's default init drawn from a generator seeded
    with 0 (the script's ``PRNGKey(0)`` weights when no checkpoint is
    given)."""
    net = build_vcn(model_name)
    init_vcn_weights(net, torch.Generator().manual_seed(0))
    return VCNInference(model_name, net.state_dict(), device=device)


def added_in_box(completed: np.ndarray, ok: np.ndarray, gt_boxes: np.ndarray):
    """The diagnostic of the completion: the fraction of the added points
    (``completed`` (D, K, 3) where ``ok``) inside a true GT box grown by
    0.4 m; None when nothing was added."""
    added = completed[ok].reshape(-1, 3)
    if not len(added):
        return None
    hit = np.zeros(len(added), bool)
    for b in gt_boxes:
        bb = b[:7].copy()
        bb[3:6] += 0.4
        hit |= points_in_box7(added, bb)
    return float(hit.mean())


def cmd_complete(args):
    """GT-path SEE of every frame of ``--set`` -> ``--out`` (default
    <set>.completed.npz): points (N, P + D*1024, 3), valid, and the set's
    gt_boxes and gt_mask. -> {"out", "frames", "in_box", "s"}."""
    dev = _device(args)
    model_name = args.model
    if args.vcn:
        vcn = VCNInference(model_name, load_vcn_checkpoint(args.vcn, model_name),
                           device=dev)
    else:
        vcn = seeded_vcn(model_name, dev)

    pts, val, gtb, gtm = load_set(args.set)
    n, p, _ = pts.shape
    d_inst, k = gtb.shape[1], vcn.num_points
    out_pts = np.zeros((n, p + d_inst * k, 3), np.float32)
    out_val = np.zeros((n, p + d_inst * k), bool)
    inbox_fracs = []
    t0 = time.time()
    for c0 in range(0, n, COMPLETE_BATCH):
        sl = slice(c0, min(c0 + COMPLETE_BATCH, n))
        new_pts, new_valid, stats = complete_gt_frames(
            vcn, *(torch.from_numpy(x[sl]) for x in (pts, val, gtb, gtm)), device=dev,
            vcn_boxes=model_name == "VCN_CN")
        out_pts[sl], out_val[sl] = new_pts.cpu().numpy(), new_valid.cpu().numpy()
        comp = stats["completed"].cpu().numpy()
        ok = stats["inst_valid"].cpu().numpy()
        for j, i in enumerate(range(sl.start, sl.stop)):
            frac = added_in_box(comp[j], ok[j] & gtm[i], gtb[i][gtm[i]])
            if frac is not None:
                inbox_fracs.append(frac)
            if (i + 1) % 16 == 0:
                print(f"  complete {i+1}/{n} ({time.time()-t0:.0f}s)", flush=True)
    s = time.time() - t0
    out = args.out or args.set.replace(".npz", ".completed.npz")
    np.savez_compressed(out, points=out_pts, valid=out_val, gt_boxes=gtb, gt_mask=gtm)
    ib = float(np.mean(inbox_fracs)) if inbox_fracs else float("nan")
    print(f"wrote {out}; in-box fraction of added points: {ib:.3f}", flush=True)
    return {"out": out, "frames": n, "in_box": ib, "s": s}


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #

def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The draws of step ``step``: a generator on ``device`` seeded from
    (seed, step), so a resumed run continues the interrupted run's stream."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def draw_batch(gen: torch.Generator, n: int, batch: int):
    """-> (idx (batch,) frame indices in [0, n), flip () bool), drawn from
    ``gen`` on its device."""
    idx = torch.randint(0, n, (batch,), generator=gen, device=gen.device)
    flip = torch.rand((), generator=gen, device=gen.device) < 0.5
    return idx, flip


def assemble_batch(points, valid, gt_boxes, idx, flip):
    """The frames ``idx`` of the set on the device, y-flipped (points' y,
    boxes' y and yaw) where ``flip``: -> (points, valid, gt_boxes)."""
    fp, fg = (points.new_tensor(f) for f in (FLIP_P, FLIP_G))
    one = points.new_ones(())
    return (points[idx] * torch.where(flip, fp, one), valid[idx],
            gt_boxes[idx] * torch.where(flip, fg, one))


def seeded_detector(cfg, device):
    """SECOND-IoU of ``cfg`` at its modules' default initialisers drawn
    from the CPU generator seeded with 0, on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model, dcfg = build_detector(cfg, device="cpu")
    return model.to(device), dcfg


def cmd_train(args):
    """``--steps`` SECOND-IoU steps at ``da_detector_cfg`` on ``--train``,
    the set uploaded once and each batch drawn on the device; ``ckpt.pth``
    under ``--out`` every ``--ckpt_every`` steps and at the end. -> {"state",
    "losses", "start", "step_s"}."""
    dev = _device(args)
    pts, val, gtb, gtm = load_set(args.train)
    n, p, _ = pts.shape
    print(f"train set {args.train}: {n} frames x {p} pts", flush=True)
    cfg = da_detector_cfg(p, mode=args.mode)
    if args.bf16:
        cfg.MODEL.BACKBONE_3D["DTYPE"] = "bfloat16"
    model, _ = seeded_detector(cfg, dev)
    state = create_train_state(model, cfg.OPTIMIZATION, total_steps=args.steps)
    tf32_off()

    d_pts = torch.from_numpy(pts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_gt = torch.from_numpy(np.ascontiguousarray(gtb[..., :8])).to(dev)

    os.makedirs(args.out, exist_ok=True)
    ck_path = os.path.join(args.out, "ckpt.pth")
    start = 0
    if args.resume and os.path.exists(ck_path):
        # the checkpoint carries the optimizer state and the step, and the
        # draws are seeded from the step: the resumed run continues the
        # interrupted one's stream. An unreadable file (a kill mid-write of
        # an older writer) means a fresh start.
        try:
            ck = load_torch_checkpoint(ck_path)
        except (OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
            print(f"resume skipped: {ck_path} unreadable ({e}); starting fresh",
                  flush=True)
            ck = {}
        if ck.get("optimizer_state") and ck.get("total_steps") == args.steps:
            model.load_state_dict(ck["model_state"], strict=True)
            state.optimizer.inner.load_state_dict(ck["optimizer_state"])
            state.step = start = int(ck["it"])
            print(f"resumed {ck_path} at step {start}", flush=True)

    t0 = time.time()
    losses, step_s = [], []
    for it in range(start, args.steps):
        t_step = time.perf_counter()
        gen = step_generator(args.seed, state.step, dev)
        idx, flip = draw_batch(gen, n, args.batch)
        metrics = train_step(state, *assemble_batch(d_pts, d_val, d_gt, idx, flip), gen)
        if (it + 1) % args.log_every == 0:
            loss = float(metrics["loss"])              # waits for the step
            losses.append(loss)
            print(f"step {it+1}/{args.steps} loss {loss:.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        step_s.append(time.perf_counter() - t_step)
        if (it + 1) % args.ckpt_every == 0 or it + 1 == args.steps:
            save_detector_checkpoint(ck_path, model, it=state.step,
                                     optimizer_state=state.optimizer.inner.state_dict(),
                                     total_steps=args.steps, cfg_mode=args.mode)
    print(f"done: final losses {losses[-3:]}", flush=True)
    return {"state": state, "losses": losses, "start": start, "step_s": step_s}


# --------------------------------------------------------------------------- #
# evaluation (KITTI Car 3D AP)
# --------------------------------------------------------------------------- #

def lidar_boxes_to_annos(boxes, scores=None):
    """lidar (x, y, z, L, W, H, yaw) -> KITTI camera-format anno dict
    (inverse of data/kitti/eval.py _camera_to_lidar_like; bbox faked tall
    so no difficulty bucket ignores it)."""
    n = len(boxes)
    if n == 0:
        anno = {k: np.zeros((0,)) for k in
                ("truncated", "occluded", "alpha", "rotation_y", "score")}
        anno["name"] = np.zeros((0,), "<U10")
        anno["bbox"] = np.zeros((0, 4))
        anno["dimensions"] = np.zeros((0, 3))
        anno["location"] = np.zeros((0, 3))
        return anno
    x, y, z = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    L, W, H = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    yaw = boxes[:, 6]
    loc = np.stack([-y, H / 2 - z, x], 1)
    dims = np.stack([L, H, W], 1)
    ry = -yaw - np.pi / 2
    anno = {"name": np.array(["Car"] * n),
            "truncated": np.zeros(n), "occluded": np.zeros(n, np.int32),
            "alpha": np.full(n, -10.0), "rotation_y": ry,
            "bbox": np.tile([0.0, 0.0, 300.0, 150.0], (n, 1)),
            "dimensions": dims, "location": loc}
    anno["score"] = scores if scores is not None else np.ones(n)
    return anno


def cmd_eval(args):
    """The detector of ``--ckpt`` on every frame of ``--set``, ``--eval_batch``
    frames a forward (the tail padded by its first frame, the padding
    discarded), its detections above ``--score_thresh`` against the set's GT
    boxes: KITTI Car 3D / BEV AP@0.7 (R40). -> the summary dict, printed as
    JSON and written to ``--out_json``."""
    dev = _device(args)
    pts, val, gtb, gtm = load_set(args.set)
    n, p, _ = pts.shape
    ck = load_torch_checkpoint(args.ckpt)
    cfg = da_detector_cfg(p, mode=ck.get("cfg_mode", args.mode))
    model, _ = build_detector(cfg, detector_state_dict_from_torch(ck.get("model_state", ck)),
                              device=dev)
    tf32_off()
    B = max(1, args.eval_batch)

    gt_annos, dt_annos = [], []
    t0 = time.time()
    for c0 in range(0, n, B):
        idx = np.arange(c0, min(c0 + B, n))
        # pad the tail chunk by repeating its first frame (discarded below)
        pad = np.concatenate([idx, np.full(B - len(idx), idx[0])])
        with torch.no_grad():
            out = model(torch.from_numpy(pts[pad]).to(dev), torch.from_numpy(val[pad]).to(dev))
            pp = post_processing(out, cfg.MODEL.POST_PROCESSING, 1, has_roi_head=True)
            packed = torch.cat([pp["pred_boxes"], pp["pred_scores"][..., None],
                                pp["pred_labels"].float()[..., None],
                                pp["pred_mask"].float()[..., None]], 2).cpu().numpy()
        for j, i in enumerate(idx):
            fr = packed[j]
            m = fr[:, 9] > 0.5
            boxes, scores = fr[m, :7], fr[m, 7]
            keep = scores > args.score_thresh
            dt_annos.append(lidar_boxes_to_annos(boxes[keep], scores[keep]))
            gt_annos.append(lidar_boxes_to_annos(gtb[i][gtm[i]][:, :7]))
        done = idx[-1] + 1
        if done % 32 < B:
            print(f"  eval {done}/{n} ({time.time()-t0:.0f}s)", flush=True)

    report, result = get_official_eval_result(gt_annos, dt_annos, ("Car",), device=dev)
    print(report)
    summary = {"set": args.set, "ckpt": args.ckpt,
               "ap_3d_07_r40": result["Car"]["3d"][0],
               "ap_bev_07_r40": result["Car"]["bev"][0],
               "n_frames": n,
               "n_dets": int(sum(len(a["score"]) for a in dt_annos))}
    print(json.dumps(summary))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description="The DA experiment: complete, train, eval.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("complete")
    c.add_argument("--set", required=True)
    c.add_argument("--vcn", default=None, help="a VCN .pth (reference layout)")
    c.add_argument("--model", default="VCN_VC", choices=["VCN_VC", "VCN_CN"],
                   help="VCN_CN = reference source-domain (GT-canonical) "
                        "completion; VCN_VC = self-regressed pose")
    c.add_argument("--out", default=None,
                   help="output npz (default: <set>.completed.npz)")
    c.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    c.set_defaults(fn=cmd_complete)

    t = sub.add_parser("train")
    t.add_argument("--train", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--steps", type=int, default=3000)
    t.add_argument("--batch", type=int, default=4)
    t.add_argument("--mode", default="zfold",
                   help="BACKBONE_3D.MODE, recorded in the checkpoint; the "
                        "port runs the rulebook in every mode")
    t.add_argument("--remat", default="layer", choices=["layer", "dots", "none"],
                   help="accepted so that the JAX runbooks' command lines "
                        "parse; no effect in the port")
    t.add_argument("--bf16", action="store_true", help="the 3D backbone in bfloat16")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log_every", type=int, default=50)
    t.add_argument("--ckpt_every", type=int, default=500)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    e.add_argument("--ckpt", required=True)
    e.add_argument("--set", required=True)
    e.add_argument("--mode", default="zfold")
    e.add_argument("--score_thresh", type=float, default=0.3)
    e.add_argument("--eval_batch", type=int, default=8, help="frames a forward")
    e.add_argument("--out_json", default=None)
    e.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    e.set_defaults(fn=cmd_eval)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
