"""The Mask R-CNN recipe's data, evaluation, checkpoints and CLI in the port
(seevcn_torch.models.seg2d.{synthetic,coco_eval,backend}, ops/resize.py,
cli/train_seg2d.py) against the JAX package and cv2 on the CPU.

- The scene generators make the same arrays as JAX's from the same
  ``RandomState`` seeds: equal.
- ``evaluate_instances`` gives JAX's numbers on random predictions: equal.
- ``resize_linear`` against ``cv2.resize(..., INTER_LINEAR)``: with
  OpenCV's own arithmetic (IPP off) the values agree to 1e-6 and the masks
  thresholded at 0.5 are equal except where cv2's value lies within 1e-6 of
  0.5 (5.96e-8 read); the build's default route through Intel IPP rounds
  differently, by up to 1.49e-6 on these cases, so there the bound is 2e-6
  on both (``pytest -s`` prints the worst of each).
- Checkpoints: a pickle JAX's ``save_seg2d_checkpoint`` wrote loads into
  the port in a process that imports no JAX, and gives JAX's eval forward
  (scores 1e-6, boxes 1e-4 px, masks 1e-5, classes equal on scores that lie
  apart); the port's own pickle round-trips bit for bit and JAX's model on
  its trees gives the port's forward.
"""
import json
import os
import pickle
import subprocess
import sys
from dataclasses import asdict

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seevcn_tpu.cli import train_seg2d as JCLI
from seevcn_tpu.models.seg2d import coco_eval as JE
from seevcn_tpu.models.seg2d import synthetic as JS
from seevcn_tpu.models.seg2d.backend import build_seg2d as jax_build_seg2d
from seevcn_tpu.models.seg2d.backend import init_seg2d as jax_init_seg2d
from seevcn_tpu.models.seg2d.backend import save_seg2d_checkpoint as jax_save
from seevcn_torch.cli import train_seg2d as CLI
from seevcn_torch.models.seg2d import coco_eval as TE
from seevcn_torch.models.seg2d import synthetic as TS
from seevcn_torch.models.seg2d.backend import (build_seg2d, init_seg2d,
                                               load_seg2d_checkpoint, paste_mask,
                                               save_seg2d_checkpoint, seg2d_train_forward)
from seevcn_torch.models.seg2d.maskrcnn import MaskRCNN
from seevcn_torch.ops.resize import resize_linear
from seevcn_torch.testing import assert_close, tiny_seg2d_cfg, to_torch
from test_seg2d import _tiny_cfg
from test_torch_seg2d import _randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# scene generators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hard", [False, True])
def test_synth_batch_equals_jax(hard):
    ref = JS.synth_batch(np.random.RandomState(7), (96, 128), 3, max_gt=6, hard=hard)
    got = TS.synth_batch(np.random.RandomState(7), (96, 128), 3, max_gt=6, hard=hard)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype
        np.testing.assert_array_equal(g, r)
    assert ref[3].any() and not ref[3].all()    # cars and padding rows


def test_synth_scene_and_bgr_equal_jax():
    rs_j, rs_t = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        ref = JS.synth_scene(72, 120, rs_j, max_gt=4)
        got = TS.synth_scene(72, 120, rs_t, max_gt=4)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(TS.scene_to_bgr(got[0]), JS.scene_to_bgr(ref[0]))


def test_synth_frame3d_equals_jax():
    ref = JS.synth_frame3d(96, 128, np.random.RandomState(5), n_cars=2, n_bg=600,
                           car_pts=80)
    got = TS.synth_frame3d(96, 128, np.random.RandomState(5), n_cars=2, n_bg=600,
                           car_pts=80)
    for r, g in zip(ref, got):
        if isinstance(r, dict):
            assert r.keys() == g.keys()
            for k in r:
                np.testing.assert_array_equal(g[k], r[k])
        else:
            np.testing.assert_array_equal(g, r)
    assert len(ref[1]) > 600                    # car points were cast


# ---------------------------------------------------------------------------
# COCO-style evaluation
# ---------------------------------------------------------------------------
def _random_instances(seed, n_img=4, h=48, w=64):
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_img):
        n_g, n_p = rng.randint(1, 5), rng.randint(0, 7)

        def inst(n):
            xy = rng.randint(0, [w - 8, h - 6], (n, 2))
            wh = rng.randint(3, 30, (n, 2))
            boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1).astype(np.float32)
            masks = np.zeros((n, h, w), bool)
            for k, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
                masks[k, y1:y2, x1:x2] = rng.rand(y2 - y1, x2 - x1) > 0.2
            return boxes, masks, rng.randint(0, 2, n)

        gb, gm, gl = inst(n_g)
        pb, pm, pl = inst(n_p)
        # some predictions copy a ground truth, jittered
        for k in range(min(n_p, n_g)):
            if rng.rand() < 0.6:
                pb[k], pm[k], pl[k] = gb[k] + rng.uniform(-1, 1, 4), gm[k], gl[k]
        preds.append({"masks": pm, "boxes": pb, "scores": rng.rand(n_p), "labels": pl})
        gts.append({"masks": gm, "boxes": gb, "labels": gl})
    return preds, gts


@pytest.mark.parametrize("kind", ["mask", "box"])
@pytest.mark.parametrize("height_range", [None, (0.0, 12.0), (12.0, float("inf"))])
def test_evaluate_instances_equals_jax(kind, height_range):
    preds, gts = _random_instances(8)
    ref = JE.evaluate_instances(preds, gts, kind=kind, height_range=height_range)
    got = TE.evaluate_instances(preds, gts, kind=kind, height_range=height_range)
    assert got == ref
    assert 0 < ref["AP50"] < 1


# ---------------------------------------------------------------------------
# the paste-back resize
# ---------------------------------------------------------------------------
SIZES = [(14, 14), (1, 1), (1, 40), (40, 1), (100, 37), (28, 28), (56, 56), (3, 250),
         (300, 5), (17, 9), (200, 300), (14, 29), (2, 3)]


@pytest.mark.parametrize("ipp", [False, True])
def test_resize_linear_matches_cv2(ipp):
    """28x28 mask probabilities to shrinks, stretches and 1-pixel sizes.
    ``ipp`` False: OpenCV's own INTER_LINEAR arithmetic, 1e-6; True: the
    build's default route through Intel IPP, 2e-6. The thresholded masks
    are equal except within that bound of 0.5."""
    tol = 2e-6 if ipp else 1e-6
    rng = np.random.RandomState(0)
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    worst = 0.0
    try:
        for oh, ow in SIZES + [tuple(rng.randint(1, 400, 2)) for _ in range(40)]:
            m = rng.rand(28, 28).astype(np.float32)
            m[rng.rand(28, 28) < 0.1] = 0.5      # values on the threshold
            ref = cv2.resize(m, (int(ow), int(oh)), interpolation=cv2.INTER_LINEAR)
            got = resize_linear(to_torch(m), (int(oh), int(ow))).numpy()
            assert got.shape == ref.shape
            assert_close(got, ref, atol=tol, name=f"{oh}x{ow}")
            worst = max(worst, float(np.abs(got - ref).max()))
            near = np.abs(ref - 0.5) <= tol
            assert ((got >= 0.5) == (ref >= 0.5))[~near].all()
    finally:
        cv2.ipp.setUseIPP(saved)
    print(f"resize_linear against cv2 (IPP {'on' if ipp else 'off'}): max |diff| {worst:.3g}")


def _cv2_paste(prob, box, h, w):
    """The reference's paste (seevcn_tpu/cli/train_seg2d.py:evaluate)."""
    x1, y1, x2, y2 = box
    bw = max(int(round(x2 - x1)), 1)
    bh = max(int(round(y2 - y1)), 1)
    patch = cv2.resize(prob, (bw, bh)) >= 0.5
    xi, yi = max(int(round(x1)), 0), max(int(round(y1)), 0)
    xe, ye = min(xi + bw, w), min(yi + bh, h)
    full = np.zeros((h, w), bool)
    full[yi:ye, xi:xe] = patch[:ye - yi, :xe - xi]
    return full


def test_paste_mask_matches_the_reference():
    """Boxes inside, on the edge, 1 pixel and sub-pixel wide, against the
    reference's cv2 paste (IPP off): equal except at pixels whose cv2 value
    lies within 1e-6 of 0.5."""
    h, w = 96, 128
    rng = np.random.RandomState(1)
    boxes = [(10.2, 20.7, 60.4, 50.1), (0.0, 0.0, 127.0, 95.0), (100.3, 80.2, 127.0, 95.0),
             (40.0, 40.0, 40.4, 70.0), (5.5, 6.5, 6.49, 7.51), (30.0, 12.0, 31.0, 13.0)]
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for box in boxes:
            prob = rng.rand(28, 28).astype(np.float32)
            box = np.asarray(box, np.float32)
            ref = _cv2_paste(prob, box, h, w)
            got = paste_mask(to_torch(prob), box, (h, w)).numpy()
            bw = max(int(round(box[2] - box[0])), 1)
            bh = max(int(round(box[3] - box[1])), 1)
            vals = cv2.resize(prob, (bw, bh))
            near = np.zeros((h, w), bool)
            xi, yi = max(int(round(box[0])), 0), max(int(round(box[1])), 0)
            near[yi:yi + bh, xi:xi + bw] = (np.abs(vals - 0.5) <= 1e-6)[:h - yi, :w - xi]
            assert (got == ref)[~near].all()
            assert ref.any()
    finally:
        cv2.ipp.setUseIPP(saved)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_seg():
    """(JAX cfg, model, random-ish numpy variables, jitted eval forward)."""
    cfg = _tiny_cfg()
    model, _ = jax_build_seg2d(cfg)
    variables = _randomize(jax.tree.map(np.asarray, jax_init_seg2d(model)))
    forward = jax.jit(lambda v, x: model.apply(v, x, train=False))
    return cfg, model, variables, forward


def _image():
    return np.random.RandomState(9).rand(1, 96, 128, 3).astype(np.float32)


def _check_eval(got, ref):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    kept = np.sort(ref["det_scores"][ref["det_scores"] > 0])
    assert len(kept) > 1 and np.diff(kept).min() > 1e-5   # scores lie apart
    assert_close(got["det_cls"], ref["det_cls"], name="det_cls")
    assert_close(got["det_scores"], ref["det_scores"], atol=1e-6, name="det_scores")
    assert_close(got["det_boxes"], ref["det_boxes"], atol=1e-4, name="det_boxes")
    assert_close(got["det_masks"], ref["det_masks"], atol=1e-5, name="det_masks")


LOAD_IN_A_CLEAN_PROCESS = """
import sys
import numpy as np
import torch
from seevcn_torch.models.seg2d.backend import build_seg2d, load_seg2d_checkpoint
cfg, sd = load_seg2d_checkpoint(sys.argv[1])
model = build_seg2d(cfg, sd, device="cpu")
with torch.no_grad():
    out = model(torch.from_numpy(np.load(sys.argv[2])))
np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()},
         image_size=np.asarray(cfg.image_size), cfg_type=type(cfg).__module__)
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "optax", "seevcn_tpu")]
assert not bad, bad
"""


def test_jax_checkpoint_loads_without_jax(jax_seg, tmp_path):
    cfg, _, variables, forward = jax_seg
    path = str(tmp_path / "jax.ckpt")
    jax_save(path, {"params": variables["params"],
                    "batch_stats": variables["batch_stats"]}, cfg)
    np.save(tmp_path / "image.npy", _image())
    run = subprocess.run([sys.executable, "-c", LOAD_IN_A_CLEAN_PROCESS, path,
                          str(tmp_path / "image.npy"), str(tmp_path / "out.npz")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr
    got = dict(np.load(tmp_path / "out.npz"))
    assert tuple(got["image_size"]) == cfg.image_size
    assert str(got["cfg_type"]).startswith("seevcn_torch")
    _check_eval(got, forward(variables, _image()))


def test_checkpoint_refuses_jax_classes(tmp_path):
    """Any class of JAX, flax or seevcn_tpu but the config is refused."""
    path = str(tmp_path / "bad.ckpt")

    class Fake:
        def __reduce__(self):
            return (jnp.asarray, ([1.0],))

    with open(path, "wb") as f:
        pickle.dump({"params": {}, "batch_stats": {}, "cfg": Fake()}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing jax"):
        load_seg2d_checkpoint(path)


def test_port_checkpoint_round_trips(jax_seg, tmp_path):
    """save -> load bit for bit, an older config without the HTC fields
    takes their defaults, and JAX's model on the saved trees gives the
    port's eval forward."""
    cfg, model, _, forward = jax_seg
    tcfg = tiny_seg2d_cfg()
    port = init_seg2d(MaskRCNN(tcfg), torch.Generator().manual_seed(3))
    # random biases and statistics, so that no norm is an identity
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in port.state_dict().items():
            if name.endswith(("bias", "running_mean")):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var") or (
                    name.endswith("weight") and t.dim() == 1):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
    path = str(tmp_path / "port.ckpt")
    save_seg2d_checkpoint(path, port, tcfg)
    assert not os.path.exists(path + ".tmp")
    loaded_cfg, sd = load_seg2d_checkpoint(path)
    assert asdict(loaded_cfg) == asdict(tcfg)
    ref_sd = {k: v for k, v in port.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(port.state_dict())
    for k, v in ref_sd.items():
        assert torch.equal(sd[k], v), k

    with open(path, "rb") as f:
        saved = pickle.load(f)
    variables = {"params": saved["params"], "batch_stats": saved["batch_stats"]}
    reloaded = build_seg2d(loaded_cfg, sd, device="cpu")
    with torch.no_grad():
        got = reloaded(to_torch(_image()))
    _check_eval(got, forward(variables, _image()))

    # a config pickled before the HTC fields existed
    old = dict(vars(tcfg))
    for k in ("cascade_stages", "cascade_ious", "cascade_weights", "semantic_branch",
              "semantic_convs", "semantic_loss_weight", "mask_info_flow"):
        del old[k]
    stale = object.__new__(type(tcfg))
    stale.__dict__.update(old)
    with open(path, "wb") as f:
        pickle.dump({**saved, "cfg": stale}, f)
    assert asdict(load_seg2d_checkpoint(path)[0]) == asdict(tcfg)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_trains_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "seg2d.ckpt")
    ev = CLI.main(["--device", "cpu", "--size", "tiny", "--image_size", "96", "128",
                   "--steps", "3", "--batch_size", "2", "--eval_scenes", "2",
                   "--out", out, "--log_every", "1"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == ev
    assert set(ev) == {"mask_AP50", "mask_AP", "box_AP50", "box_AP", "mask_AP50_far",
                       "mask_AP50_near"}
    assert all(0.0 <= v <= 1.0 for v in ev.values())
    assert sum(line.startswith("step") for line in printed) == 3
    cfg, sd = load_seg2d_checkpoint(out)
    assert cfg.image_size == (96, 128) and cfg.fpn_channels == 32
    assert set(sd) == set(MaskRCNN(cfg).state_dict())


def test_cli_defaults_are_the_references():
    args = CLI.parse_args([])
    assert (args.size, tuple(args.image_size), args.batch_size, args.steps, args.lr,
            args.weight_decay, args.warmup_steps, args.eval_every, args.device) == \
        ("base", (384, 512), 8, 2000, 1e-3, 1e-4, 200, 500, "cuda")
    cfg = CLI.build_cfg(args)
    assert (cfg.stage_channels, cfg.fpn_channels, cfg.box_hidden, cfg.mask_channels,
            cfg.mask_convs, cfg.cascade_stages) == ((64, 128, 256, 512), 256, 1024, 256,
                                                    4, 1)


def _coco_dir(root, ext="png"):
    """A COCO-format directory as generate_masks writes it: three PNGs of
    70 x 90 (the port's writer; or JPEGs, cv2's) and annotations.json from
    detections_to_coco, the masks discs and a box, categories 3 and 1."""
    from seevcn_torch.cli.generate_masks import detections_to_coco
    from seevcn_torch.data.png import write_png

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:70, :90]
    per_image = []
    for i in range(3):
        pixels = rng.randint(0, 256, (70, 90, 3)).astype(np.uint8)
        if ext == "png":
            write_png(os.path.join(root, f"{i:06d}.png"), pixels)
        else:
            cv2.imwrite(os.path.join(root, f"{i:06d}.jpg"), pixels)
        dets = []
        for k in range(1 + i):
            cy, cx, r = rng.randint(10, 60), rng.randint(10, 80), rng.randint(4, 14)
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            dets.append({"mask": mask, "bbox": [cx - r, cy - r, 2 * r, 2 * r],
                         "score": 0.9, "category_id": 3 if k % 2 == 0 else 1})
        box = np.zeros((70, 90), bool)
        box[5:20, 60:85] = True
        dets.append({"mask": box, "bbox": [60.0, 5.0, 25.0, 15.0], "score": 0.8})
        per_image.append((f"{i:06d}.{ext}", (70, 90), dets))
    detections_to_coco(per_image, os.path.join(root, "annotations.json"))


def test_cli_coco_dir_matches_jax(tmp_path):
    """--coco_dir: the port's coco_stream batches equal JAX's on a directory
    that generate_masks' detections_to_coco wrote (images through the PNG
    reader and cv2's uint8 INTER_LINEAR, masks through the rasterizer and
    the f32 resize), then the recipe trains one tiny step on them."""
    root = str(tmp_path)
    _coco_dir(root)
    args = CLI.parse_args(["--device", "cpu", "--size", "tiny", "--image_size", "96", "128",
                           "--steps", "1", "--batch_size", "2", "--eval_every", "0",
                           "--out", "", "--coco_dir", root])
    cfg = CLI.build_cfg(args)
    got, ref = CLI.coco_stream(cfg, 2, root, 3), JCLI.coco_stream(cfg, 2, root, 3)
    for _ in range(3):
        for a, b in zip(next(got), next(ref)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    state, model, _ = CLI.train(args, quiet=True)
    assert state.step == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_cli_coco_dir_of_jpegs_matches_jax(tmp_path):
    """--coco_dir over JPEGs (cv2 wrote them; the port decodes them itself,
    JAX with cv2): the same batches."""
    root = str(tmp_path)
    _coco_dir(root, ext="jpg")
    args = CLI.parse_args(["--device", "cpu", "--size", "tiny", "--image_size", "96", "128",
                           "--coco_dir", root])
    cfg = CLI.build_cfg(args)
    got, ref = CLI.coco_stream(cfg, 2, root, 5), JCLI.coco_stream(cfg, 2, root, 5)
    for _ in range(3):
        for a, b in zip(next(got), next(ref)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags", [["--cascade", "3"], ["--semantic"], ["--mask_info_flow"]],
                         ids=["cascade", "semantic", "mask_info_flow"])
def test_cli_htc_flag_trains(flags):
    """Each HTC flag: the config equals JAX's ``build_cfg`` of the same
    flags, and the recipe trains one tiny step on the CPU, whose training
    forward then gives the flag's loss terms, finite."""
    common = ["--size", "tiny", "--image_size", "96", "128", "--steps", "1",
              "--batch_size", "2", "--eval_every", "0", "--out", ""]
    args = CLI.parse_args(["--device", "cpu"] + common + flags)
    assert asdict(CLI.build_cfg(args)) == asdict(JCLI.build_cfg(JCLI.parse_args(common + flags)))
    state, model, cfg = CLI.train(args, quiet=True)
    assert state.step == 1
    batch = [to_torch(x) for x in TS.synth_batch(np.random.RandomState(1), (96, 128), 2,
                                                 max_gt=cfg.max_gt)]
    loss, tb, _ = seg2d_train_forward(state, *batch, torch.Generator().manual_seed(0))
    extra = {"--cascade": {f"box_{k}_s{s}" for k in ("cls", "reg") for s in (1, 2)},
             "--semantic": {"semantic"},
             "--mask_info_flow": set()}[flags[0]]
    assert set(tb) == {"rpn_cls", "rpn_reg", "box_cls", "box_reg", "mask"} | extra
    assert torch.isfinite(loss) and all(torch.isfinite(v) for v in tb.values())
