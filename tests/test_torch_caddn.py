"""CaDDN in the port (seevcn_torch.models.modules.ddn,
seevcn_torch.models.detectors.caddn, the CaDDN export and the torchvision
DeepLabV3 loader) against the JAX package on the CPU.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init (``jax.eval_shape``, no init compile), carried into the port by
``caddn_state_dict_from_flax``. Inputs: numpy from a seed, two 96 x 320
images (their bottom rows zero, as the dataset's pad) with two P2s. JAX
models are built once per module and every JAX model call is jitted.

Tolerances: the LID bins exact; DDNDeepLabV3's features and logits, and
CaDDN's outputs, within 1e-5 of a tensor's largest |value|; the focal loss
1e-6 relative, its gradient 1e-5 of the largest; the train step's loss
terms 1e-5 (relative) and gradients 5e-4 of a tensor's largest, running
statistics 1e-5, JAX and the port both in f64 (flax's f32 training
variance and the tiny DeepLabV3's conditioning: the test's docstring).
The frustum cells (row, column, bin) are compared with JAX's first, the
count of cells that differ printed and asserted; the forwards then run
with JAX's cells pinned, as the card checks pin f32 choices.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import caddn_tiny_inputs
from seevcn_tpu.models.detectors import caddn as JCD
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.modules import ddn as JD
from seevcn_tpu.utils.ckpt_compat import deeplabv3_variables_from_torch
from seevcn_torch.models.detectors import caddn as TCD
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.models.modules import ddn as TD
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy, to_torch
from seevcn_torch.train.train import create_train_state, train_forward
from seevcn_torch.utils.ckpt import deeplabv3_state_dict_from_torch, load_ddn_weights
from seevcn_torch.utils.weights import caddn_state_dict_from_flax, ddn_state_dict_from_flax

BACKBONES = ("image", "resnet_tiny")
H, W = 96, 320


def _rel(got, ref, name, tol=1e-5):
    ref = to_numpy(ref)
    assert_close(got, ref, atol=tol * float(np.abs(ref).max()) + 1e-12, name=name)


_BUILT = {}


def _built(backbone):
    """(cfg, JAX model, seeded flax variables, the port's f32 model), once
    a backbone."""
    if backbone not in _BUILT:
        cfg = C.tiny_caddn_cfg(backbone)
        jm, _ = jax_build(cfg)
        images, p2 = caddn_tiny_inputs()[:2]
        shapes = jax.eval_shape(lambda a, b: jm.init({"params": jax.random.PRNGKey(0)}, a, b,
                                                     train=False),
                                jnp.asarray(images), jnp.asarray(p2))
        variables = seeded_flax_variables(shapes, seed=3)
        model, _ = build_detector(cfg, caddn_state_dict_from_flax(variables), device="cpu")
        _BUILT[backbone] = {"cfg": cfg, "jm": jm, "variables": variables, "model": model}
    return _BUILT[backbone]


def _jax_cells(cfg, p2, feat_hw, stride):
    """The frustum cells of JAX's CaDDN (caddn.py:126-147), its expression
    in a jitted function: -> numpy (vi, ui, db, ok), each (B, V)."""
    disc = cfg.MODEL.VFE.FFN.DISCRETIZE
    nb, d_min, d_max = int(disc["num_bins"]), float(disc["depth_min"]), float(disc["depth_max"])
    pcr = jnp.asarray([float(v) for v in cfg.DATA_CONFIG.POINT_CLOUD_RANGE])
    vs = jnp.asarray([float(v) for v in cfg.DATA_CONFIG.DATA_PROCESSOR[0].VOXEL_SIZE])
    grid = np.round((np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE[3:])
                     - np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE[:3]))
                    / np.asarray(cfg.DATA_CONFIG.DATA_PROCESSOR[0].VOXEL_SIZE)).astype(int)
    h, w = feat_hw

    @jax.jit
    def cells(P2s):
        xs = (jnp.arange(grid[0]) + 0.5) * vs[0] + pcr[0]
        ys = (jnp.arange(grid[1]) + 0.5) * vs[1] + pcr[1]
        zs = (jnp.arange(grid[2]) + 0.5) * vs[2] + pcr[2]
        X, Y, Z = jnp.meshgrid(xs, ys, zs, indexing="ij")
        rect = jnp.stack([-Y, -Z, X], axis=-1).reshape(-1, 3)

        def one(P2):
            hom = jnp.concatenate([rect, jnp.ones((rect.shape[0], 1))], axis=1)
            uvw = hom @ P2.T
            depth = uvw[:, 2]
            u = uvw[:, 0] / jnp.maximum(depth, 1e-3) / stride
            v = uvw[:, 1] / jnp.maximum(depth, 1e-3) / stride
            dbin = JCD.depth_to_lid_bin(depth, d_min, d_max, nb)
            ok = (depth > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h) & (dbin < nb)
            return (jnp.clip(v.astype(jnp.int32), 0, h - 1),
                    jnp.clip(u.astype(jnp.int32), 0, w - 1), jnp.clip(dbin, 0, nb - 1), ok)

        return jax.vmap(one)(P2s)

    return tuple(np.asarray(a) for a in cells(jnp.asarray(p2)))


@contextlib.contextmanager
def _pinned_cells(cells):
    """Within the block, the port's CaDDN takes ``cells`` (numpy, JAX's) as
    its frustum cells."""
    plain = TCD.frustum_indices

    def pinned(calib_p2, *args, **kw):
        dev = calib_p2.device
        return tuple(torch.tensor(c, device=dev) for c in cells)

    TCD.frustum_indices = pinned
    try:
        yield
    finally:
        TCD.frustum_indices = plain


def test_lid_bins_match_jax():
    """The edges, and the bins of depths on each edge (its f32 value and the
    f32 neighbours on each side), of bin centres, below the minimum (0
    too), at and beyond the maximum, -inf, inf and NaN: exact, against
    JAX's jitted function (the model's rounding: eager JAX divides by delta
    where jitted XLA multiplies by its reciprocal, and a few edges land
    apart, asserted)."""
    for d_min, d_max, nb in ((2.0, 46.8, 80), (2.0, 30.0, 20)):
        edges = TCD.lid_bin_edges(d_min, d_max, nb)
        np.testing.assert_array_equal(edges, JCD.lid_bin_edges(d_min, d_max, nb))
        e32 = edges.astype(np.float32)
        depth = np.concatenate([
            e32, np.nextafter(e32, np.float32(-np.inf)), np.nextafter(e32, np.float32(np.inf)),
            ((edges[:-1] + edges[1:]) / 2).astype(np.float32),
            np.float32([0.0, -1.0, 1.999, d_max, d_max + 1, 1e6, -np.inf, np.inf, np.nan])])
        got = to_numpy(TCD.depth_to_lid_bin(to_torch(depth), d_min, d_max, nb))
        ref = np.asarray(JCD.depth_to_lid_bin(jnp.asarray(depth), d_min, d_max, nb))
        ref_jit = np.asarray(jax.jit(lambda d: JCD.depth_to_lid_bin(d, d_min, d_max, nb))(
            jnp.asarray(depth)))
        np.testing.assert_array_equal(got, ref_jit)
        assert 0 < (ref != ref_jit).sum() <= 8
        assert (got[-9:] == [nb, nb, nb, nb, nb, nb, nb, nb, nb]).all()
        np.testing.assert_array_equal(got[len(edges) * 3:len(edges) * 3 + nb], np.arange(nb))


@pytest.fixture(scope="module")
def ddn_pair():
    """JAX's DDNDeepLabV3 (ResNetTiny, width 8, 21 classes), seeded variables,
    and the port's module with them."""
    jm = JD.DDNDeepLabV3(num_classes=21, backbone_name="ResNetTiny", width=8)
    images = caddn_tiny_inputs()[0]
    shapes = jax.eval_shape(lambda a: jm.init({"params": jax.random.PRNGKey(0)}, a),
                            jnp.asarray(images))
    variables = seeded_flax_variables(shapes, seed=1)
    tm = TD.DDNDeepLabV3(21, "ResNetTiny", 8)
    tm.load_state_dict(ddn_state_dict_from_flax(variables["params"], variables["batch_stats"]),
                       strict=True)
    return jm, variables, tm, images


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_ddn_deeplabv3_matches_jax(ddn_pair, mode):
    """DDNDeepLabV3 alone, the port in f32: stride-4 features and the
    upsampled logits; in training also the updated running statistics,
    there against JAX in f64 (flax's f32 training variance, E[x^2] -
    E[x]^2, strays 2e-5 from its f64 value at these inputs: ROADMAP §3)."""
    jm, variables, tm, images = ddn_pair
    if mode == "eval":
        ref = jax.jit(lambda v_, x: jm.apply(v_, x))(jax.tree.map(jnp.asarray, variables),
                                                     jnp.asarray(images))
        tm.eval()
        with torch.no_grad():
            got = tm(to_torch(images))
    else:
        with jax.enable_x64(True):
            ref, new = jax.jit(lambda v_, x: jm.apply(v_, x, train=True, mutable=[
                "batch_stats"]))(_f64(variables), jnp.asarray(images, jnp.float64))
            ref = [np.asarray(a) for a in ref]
            new = jax.tree.map(np.asarray, new)
        state = {k: t.clone() for k, t in tm.state_dict().items()}
        tm.train()
        with torch.no_grad():
            got = tm(to_torch(images))
        after = ddn_state_dict_from_flax(variables["params"], new["batch_stats"])
        for k, t in tm.state_dict().items():
            if k.endswith("running_mean") or k.endswith("running_var"):
                assert_close(t, after[k], atol=1e-5, rtol=1e-5, name=k)
        tm.load_state_dict(state)
        tm.eval()
    assert got[0].shape == (2, H // 4, W // 4, 32) and got[1].shape == (2, H // 4, W // 4, 21)
    _rel(got[0], ref[0], f"{mode} features")
    _rel(got[1], ref[1], f"{mode} logits")


def test_fg_mask_and_focal_loss_match_jax():
    """fg_mask_from_boxes2d at stride 4 (fractional boxes, a zero row) and
    ddn_focal_loss with and without boxes: values and d loss / d logits."""
    images, _, _, depth, boxes2d = caddn_tiny_inputs()
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 24, 80, 21).astype(np.float32) * 2
    tgt = rng.randint(0, 21, (2, 24, 80))
    ref_fg = np.asarray(JD.fg_mask_from_boxes2d(jnp.asarray(boxes2d), (2, 24, 80), 4))
    got_fg = to_numpy(TD.fg_mask_from_boxes2d(to_torch(boxes2d), (2, 24, 80), 4))
    np.testing.assert_array_equal(got_fg, ref_fg)
    assert 0 < got_fg.sum() < got_fg.size
    for boxes in (boxes2d, None):
        def jf(x):
            return JD.ddn_focal_loss(x, jnp.asarray(tgt), None if boxes is None
                                     else jnp.asarray(boxes), downsample_factor=4)

        (ref, ref_tb), ref_g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
        x = to_torch(logits).requires_grad_()
        got, tb = TD.ddn_focal_loss(x, to_torch(tgt), None if boxes is None
                                    else to_torch(boxes), downsample_factor=4)
        got.backward()
        assert set(tb) == set(ref_tb)
        for k in tb:
            assert_close(tb[k].detach(), np.asarray(ref_tb[k]), rtol=1e-6, name=k)
        _rel(x.grad, ref_g, "d focal / d logits")


def _cells_compared(backbone):
    """The port's frustum cells against JAX's at the tiny config: -> (JAX's
    cells, the number of ok voxels whose cell differs, ok voxels)."""
    b = _built(backbone)
    cfg, model = b["cfg"], b["model"]
    _, p2 = caddn_tiny_inputs()[:2]
    ref = _jax_cells(cfg, p2, (H // 4, W // 4), 4)
    hom = model.voxel_hom(torch.device("cpu"))
    got = [to_numpy(t) for t in TCD.frustum_indices(
        to_torch(p2), hom, (H // 4, W // 4), 4, model.depth_min, model.depth_max,
        model.num_bins)]
    np.testing.assert_array_equal(got[3], ref[3])
    ok = ref[3]
    flips = int(sum(((g != r) & ok).sum() for g, r in zip(got[:3], ref[:3])))
    return ref, flips, int(ok.sum())


def test_frustum_cells_match_jax():
    """Row, column and bin of every voxel's frustum cell at the tiny grid
    (16,384 voxels a frame), both P2s: the validity equal, and the number of
    valid voxels whose cell differs from JAX's (an f32 projection rounding
    across a pixel edge) printed; none at these inputs."""
    _, flips, n_ok = _cells_compared("image")
    print(f"frustum cells: {flips} of {n_ok} valid voxels differ from JAX's")
    assert n_ok > 1000
    assert flips == 0


def test_frustum_sample_matches_outer_product():
    """``frustum_to_voxels`` (gather, then multiply) against JAX's order
    (the whole outer product, then the gather) on the same cells: bit for
    bit."""
    rng = np.random.RandomState(4)
    feat = rng.randn(2, 6, 9, 5).astype(np.float32)
    ddist = rng.rand(2, 6, 9, 7).astype(np.float32)
    vi, ui, db = rng.randint(0, 6, (2, 50)), rng.randint(0, 9, (2, 50)), rng.randint(0, 7, (2, 50))
    ok = rng.rand(2, 50) < 0.7
    frustum = ddist[..., :, None] * feat[..., None, :]
    ref = np.stack([np.where(ok[b][:, None], frustum[b][vi[b], ui[b], db[b]], 0.0)
                    for b in range(2)])
    got = TCD.frustum_to_voxels(to_torch(feat), to_torch(ddist), to_torch(vi), to_torch(ui),
                                to_torch(db), to_torch(ok))
    np.testing.assert_array_equal(to_numpy(got), ref)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_caddn_eval_matches_jax(backbone):
    """The tiny CaDDN's eval forward, JAX's frustum cells pinned: depth
    logits, the head's maps and the decoded boxes."""
    b = _built(backbone)
    images, p2 = caddn_tiny_inputs()[:2]
    ref = jax.jit(lambda v, x, p: b["jm"].apply(v, x, p, train=False))(
        jax.tree.map(jnp.asarray, b["variables"]), jnp.asarray(images), jnp.asarray(p2))
    cells = _cells_compared(backbone)[0]
    with _pinned_cells(cells), torch.no_grad():
        out = b["model"](to_torch(images), to_torch(p2))
    for k in ("depth_logits", "batch_cls_preds", "batch_box_preds"):
        _rel(out[k], ref[k], k)
    for k, v in ref["head_out"].items():
        _rel(out["head_out"][k], v, k)
    assert out["batch_box_preds"].shape == (2, 32 * 32 * 2, 7)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_caddn_train_step_matches_jax(backbone):
    """One training forward and loss of the tiny CaDDN (batch norms in
    training) with depth maps, and for DDNLoss 2D boxes: JAX's loss terms
    and ``jax.value_and_grad`` gradients against the port's train step,
    both in f64 with JAX's f64 frustum cells pinned, and the running
    statistics it leaves. In f32 the tiny DeepLabV3's gradients are ill
    conditioned: two ReLU inputs of 18 layers cross 0 between f32 and f64
    and move gradients 1.3% (JAX's f32 step strays 8% from its f64 one),
    so f32 is held only with its ReLU signs pinned (chip_smoke.py)."""
    b = _built(backbone)
    cfg, jm = b["cfg"], b["jm"]
    images, p2, gt, depth, boxes2d = caddn_tiny_inputs(1)
    with jax.enable_x64(True):
        variables = _f64(b["variables"])
        params, stats = variables["params"], variables["batch_stats"]
        box_arg = jnp.asarray(boxes2d, jnp.float64) if backbone == "resnet_tiny" else None

        def loss_fn(prm):
            out, new = jm.apply({"params": prm, "batch_stats": stats},
                                jnp.asarray(images, jnp.float64), jnp.asarray(p2, jnp.float64),
                                train=True, mutable=["batch_stats"])
            total, tb = jm.loss(out, jnp.asarray(gt, jnp.float64),
                                depth_maps=jnp.asarray(depth, jnp.float64), gt_boxes2d=box_arg)
            return total, (tb, new["batch_stats"])

        (loss, (tb, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params)
        grads, new_stats = jax.tree.map(np.asarray, (grads, new_stats))
        ref = {"loss": float(loss), **{k: float(v) for k, v in tb.items()}}
        cells = _jax_cells(cfg, p2.astype(np.float64), (H // 4, W // 4), 4)
    export = lambda p, s: caddn_state_dict_from_flax(            # noqa: E731
        jax.tree.map(np.asarray, {"params": p, "batch_stats": s}))
    v32 = b["variables"]
    jax_grads = export(grads, v32["batch_stats"])
    jax_after = export(v32["params"], new_stats)
    model, _ = build_detector(cfg, export(v32["params"], v32["batch_stats"]), device="cpu")
    state = create_train_state(model.double(), cfg.OPTIMIZATION, 100)
    dbl = lambda a: torch.from_numpy(np.asarray(a, np.float64))   # noqa: E731
    with _pinned_cells(cells):
        ploss, ptb, _ = train_forward(
            state, dbl(images), dbl(p2), dbl(gt), depth_maps=dbl(depth),
            gt_boxes2d=None if box_arg is None else dbl(boxes2d))
    state.optimizer.zero_grad()
    ploss.backward()
    terms = {"loss": ploss.item(), **{k: v.item() for k, v in ptb.items()}}
    extra = {"fg_loss", "bg_loss"} if backbone == "resnet_tiny" else set()
    assert set(terms) == set(ref) == {"loss", "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                                      "rpn_loss", "ddn_loss"} | extra
    for k, v in ref.items():
        assert_close(np.float64(terms[k]), np.float64(v), atol=1e-5, rtol=1e-5, name=k)
        assert terms[k] > 0, k
    for n, p in model.named_parameters():
        r = jax_grads[n].double()
        assert_close(p.grad, r, atol=5e-4 * float(r.abs().max()) + 1e-12, name=f"grad {n}")
        assert p.grad.abs().max() > 0, n
    for n, buf in model.named_buffers():
        if n.endswith("running_mean") or n.endswith("running_var"):
            assert_close(buf, jax_after[n], atol=1e-5, rtol=1e-5, name=n)


@pytest.mark.parametrize("num_classes", [21, 81], ids=["same_classes", "other_classes"])
def test_deeplabv3_state_dict_loads_both_ways(ddn_pair, num_classes):
    """The port's DDNDeepLabV3 state dict, in torchvision's names with an
    aux_classifier added, read by JAX's ``deeplabv3_variables_from_torch``
    and by the port's ``deeplabv3_state_dict_from_torch``: with the class
    count of the file, JAX's model and the port's give the same features
    and logits; with another, both drop ``classifier.4``, which keeps its
    init, and the features still agree."""
    jm, variables, tm, images = ddn_pair
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    sd["aux_classifier.0.weight"] = torch.zeros(4, 4, 3, 3)
    jm2 = JD.DDNDeepLabV3(num_classes=num_classes, backbone_name="ResNetTiny", width=8)
    jvars = deeplabv3_variables_from_torch({k: v.numpy() for k, v in sd.items()}, num_classes)
    port_sd = deeplabv3_state_dict_from_torch(sd, num_classes)
    assert not any(k.startswith("aux_classifier") for k in port_sd)
    tm2 = TD.DDNDeepLabV3(num_classes, "ResNetTiny", 8).eval()
    kept = load_ddn_weights(tm2, port_sd)
    if num_classes == 21:
        assert kept == [] and "classifier" in jvars["params"]
    else:
        assert kept == ["classifier.4.bias", "classifier.4.weight"]
        assert "classifier" not in jvars["params"]
        init = jax.eval_shape(lambda a: jm2.init({"params": jax.random.PRNGKey(0)}, a),
                              jnp.asarray(images))
        cls = seeded_flax_variables({"params": {"c": init["params"]["classifier"]}})
        jvars["params"]["classifier"] = cls["params"]["c"]
        with torch.no_grad():
            tm2.classifier[4].weight.copy_(torch.from_numpy(
                np.transpose(cls["params"]["c"]["kernel"], (3, 2, 0, 1)).copy()))
            tm2.classifier[4].bias.copy_(torch.from_numpy(cls["params"]["c"]["bias"]))
    ref = jax.jit(lambda v, x: jm2.apply(v, x))(jax.tree.map(jnp.asarray, jvars),
                                               jnp.asarray(images))
    with torch.no_grad():
        got = tm2(to_torch(images))
    _rel(got[0], ref[0], "features")
    _rel(got[1], ref[1], "logits")


def test_caddn_full_config_builds():
    """``build_detector`` at ``caddn_detector_cfg`` (no forward): DeepLabV3
    on ResNet101 with 81 depth classes, the 64-channel reduce, the collapse
    of 25 z levels, the BEV backbone and a head of 6 anchors a cell over a
    188 x 140 map; the grid 280 x 376 x 25."""
    model, dcfg = build_detector(C.caddn_detector_cfg(), device="cpu")
    assert [int(g) for g in dcfg.grid_size] == [280, 376, 25]
    sd = model.state_dict()
    assert sum(1 for k in sd if k.startswith("ddn.backbone.layer3.")
               and k.endswith("conv1.weight")) == 23
    assert sd["ddn.classifier.4.weight"].shape == (81, 256, 1, 1)
    assert sd["channel_reduce.0.weight"].shape == (64, 256, 1, 1)
    assert sd["collapse.0.weight"].shape == (64, 64 * 25, 1, 1)
    assert sd["dense_head.conv_cls.weight"].shape == (18, 384, 1, 1)
    assert dcfg.head_logic.anchors_flat.shape[0] == 188 * 140 * 6
    assert sum(p.numel() for p in model.ddn.parameters()) > 40e6
