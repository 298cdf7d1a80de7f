"""PV-RCNN in the port (seevcn_torch.models.detectors.pvrcnn and its ops and
modules) against the JAX package on the CPU.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init (``jax.eval_shape``, no init compile), carried into the port by
``pvrcnn_state_dict_from_flax``. Inputs: numpy from a seed
(chip_smoke.blob_points for the tiny config: 600 points a frame, 220
valid). Every JAX call is jitted.

Tolerances:
- ``cell_hash``, ``grid_subsample``, the ball query (indices, including the
  slots past a group's end, and validity) and the keypoints: bit for bit;
- f32 features, logits and boxes as tests/test_torch_detector.py holds
  SECOND-IoU: 1e-5 absolute and relative (box centres and sizes atol
  1e-4); only the order of sums differs. Kept sets, labels and masks after
  both NMS passes are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_pvrcnn_cfg
from chip_smoke import LIDAR_TO_CAM, blob_points, make_scene, seeded_vcn_state_dict
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.models.modules import pfe as JPFE
from seevcn_tpu.models.modules import pvrcnn_head as JH
from seevcn_tpu.ops import pointnet2 as JP
from seevcn_tpu.ops import sampling as JS
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector, post_processing
from seevcn_torch.models.modules import pfe as PFE
from seevcn_torch.models.modules import pvrcnn_head as H
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.ops import pointnet2 as P
from seevcn_torch.ops import sampling as S
from seevcn_torch.see.frame import see_and_detect
from seevcn_torch.testing import (assert_close, seeded_flax_variables, to_numpy,
                                  to_torch)
from seevcn_torch.utils import weights as W

B, NPTS = 2, 600


def _frames(seeds=(1, 2), n=NPTS):
    frames = [blob_points(s, n) for s in seeds]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def _jax_cfg(mode=None):
    cfg = C.tiny_pvrcnn_cfg()
    if mode is not None:
        cfg.MODEL.BACKBONE_3D["MODE"] = mode
    return cfg


@pytest.fixture(scope="module")
def tiny():
    """Seeded flax variables of the tiny PV-RCNN, the port's model loaded
    with them, and the two blob frames."""
    pts, valid = _frames()
    jm, _ = jax_build(_jax_cfg())
    shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                 p, v, train=False),
                            jnp.asarray(pts), jnp.asarray(valid))
    variables = seeded_flax_variables(shapes, seed=0)
    model, _ = build_detector(C.tiny_pvrcnn_cfg(),
                              W.pvrcnn_state_dict_from_flax(variables), device="cpu")
    return variables, model, (pts, valid)


_JAX_RUNS = {}


def _jax_eval(variables, pts, valid, mode=None):
    """JAX's eval forward with every module's output captured, and its
    post-processing; one compile a mode."""
    if mode not in _JAX_RUNS:
        cfg = _jax_cfg(mode)
        jm, _ = jax_build(cfg)

        @jax.jit
        def run(v, p, pv):
            out, st = jm.apply(v, p, pv, train=False, capture_intermediates=True)
            return out, st["intermediates"], jax_post(
                out, cfg.MODEL.POST_PROCESSING, 1, has_roi_head=True)

        _JAX_RUNS[mode] = run
    return _JAX_RUNS[mode](jax.tree.map(jnp.asarray, variables), jnp.asarray(pts),
                           jnp.asarray(valid))


def _port_eval(model, pts, valid):
    """The port's eval forward, with the VSA's and the RoI-grid pool's
    outputs captured, and its post-processing."""
    seen = {}
    hooks = [model.pfe.register_forward_hook(lambda m, i, o: seen.update(vsa=o)),
             model.roi_head.roi_grid_pool_layer.register_forward_hook(
                 lambda m, i, o: seen.update(pool=o))]
    try:
        with torch.no_grad():
            out = model(to_torch(pts), to_torch(valid))
            pp = post_processing(out, model.cfg.model_cfg.POST_PROCESSING, 1, True)
    finally:
        for h in hooks:
            h.remove()
    return out, seen, pp


# --- configs and the build ----------------------------------------------


def test_configs():
    """The tiny config's base is __graft_entry__'s; the full one has
    pv_rcnn.yaml's widths: 896 channels into the fusion, 128 out, 2,048
    keypoints, a 6^3 grid of 64 + 64 channels into the shared FC."""
    assert C._graft_tiny_pvrcnn_cfg() == _tiny_pvrcnn_cfg()
    cfg = C.pvrcnn_detector_cfg()
    assert cfg.MODEL.BACKBONE_3D == {"NAME": "VoxelBackBone8x"}
    assert cfg.DATA_CONFIG == C.flagship_detector_cfg().DATA_CONFIG
    model, dcfg = build_detector(cfg, device="cpu")
    assert type(model).__name__ == "PVRCNN" and not model.training
    assert dcfg.max_voxels == 90000 and model.backbone_3d.dtype == torch.float32
    assert model.pfe.num_point_features_before_fusion == 896
    assert model.pfe.vsa_point_feature_fusion[0].weight.shape == (128, 896)
    assert model.point_head.cls_layers[0].weight.shape == (256, 896)
    assert model.roi_head.shared_fc_layer[0].weight.shape == (256, 128 * 216, 1)
    assert [len(layer.mlps) for layer in model.pfe.SA_layers] == [2, 2, 2, 2]
    keys = model.state_dict()
    for k in ("pfe.SA_rawpoints.mlps.1.3.weight", "pfe.SA_layers.3.mlps.0.4.running_var",
              "point_head.cls_layers.6.bias", "roi_head.roi_grid_pool_layer.mlps.1.0.weight",
              "roi_head.cls_layers.7.weight", "roi_head.reg_layers.7.bias"):
        assert k in keys, k
    assert keys["roi_head.reg_layers.7.weight"].shape == (7, 256, 1)


def test_build_detector_dispatch():
    """An unknown detector names the five the port has; SAMPLE_METHOD SPC
    builds, but a plain PV-RCNN cannot feed it proposals and raises JAX's
    ValueError at its forward, while PV-RCNN++ builds and runs with it."""
    cfg = C.tiny_pvrcnn_cfg()
    cfg.MODEL.NAME = "CenterPoint"
    with pytest.raises(NotImplementedError,
                       match="SECONDNet, SECONDNetIoU, PointPillar, PVRCNN, PVRCNNPlusPlus"):
        build_detector(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_detector(C.tiny_pvrcnn_cfg())
    spc = C.tiny_pvrcnn_cfg()
    spc.MODEL.PFE.SAMPLE_METHOD = "SPC"
    spc.MODEL.PFE["SPC_SAMPLING"] = {"NUM_SECTORS": 6, "SAMPLE_RADIUS_WITH_ROI": 1.6}
    pts, valid = (to_torch(a) for a in _frames())
    model, _ = build_detector(spc, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="SPC requires a detector that "
                                        "feeds rois"):
        model(pts, valid)
    spc.MODEL.NAME = "PVRCNNPlusPlus"
    model, _ = build_detector(spc, device="cpu")
    assert type(model).__name__ == "PVRCNNPlusPlus"
    with torch.no_grad():
        assert model(pts, valid)["keypoints"].shape == (B, 64, 3)


# --- sampling: the hash and the grid dedupe --------------------------------


def test_cell_hash_matches_jax():
    rng = np.random.RandomState(0)
    c = rng.randint(-2**24, 2**24, (50000, 3)).astype(np.int32)
    c[:4] = [[2**31 - 1, -2**31, 7], [-2**31, -2**31, -2**31], [0, 0, 0],
             [46341, 46341, 46341]]
    for t in (1 << 12, 1 << 16, 1 << 18):
        ref = np.asarray(JS.cell_hash(jnp.asarray(c), t))
        got = S.cell_hash(torch.from_numpy(c), t)
        assert_close(got, ref.astype(np.int32), name=f"cell_hash t={t}")
        assert (ref >= 0).all() and (ref < t).all()


@pytest.mark.parametrize("case", ["truncated", "under_cap", "overflowing_coords",
                                  "few_valid"])
def test_grid_subsample_matches_jax(case):
    """Bit for bit: more than 32,768 occupied cells (truncated in bucket
    order), fewer, coordinates whose cells overflow int32 in the hash
    products, and a mask with few valid points."""
    rng = np.random.RandomState(["truncated", "under_cap", "overflowing_coords",
                                 "few_valid"].index(case))
    n, scale, cell = 40000, 40.0, 0.35
    if case == "under_cap":
        scale = 4.0
    if case == "overflowing_coords":
        n, scale, cell = 36000, 5e4, 0.35
    pts = (rng.uniform(-1, 1, (n, 3)) * [scale, scale, scale / 10]).astype(np.float32)
    valid = rng.rand(n) < (0.02 if case == "few_valid" else 0.9)
    fn = jax.jit(JS.grid_subsample, static_argnames=("max_out", "table_size"))
    ji, jo = fn(jnp.asarray(pts), jnp.asarray(valid), cell, max_out=1 << 15)
    ti, to = S.grid_subsample(torch.from_numpy(pts), torch.from_numpy(valid), cell,
                              1 << 15)
    assert_close(to, np.asarray(jo), name="kept")
    assert_close(ti, np.asarray(ji).astype(np.int64), name="indices")
    kept = int(to.sum())
    assert 0 < kept <= (1 << 15)
    if case == "truncated":
        assert kept == 1 << 15


def test_keypoints_of_a_large_cloud_match_jax():
    """More than 2^15 points: the VSA's keypoints come from FPS over the
    grid dedupe's representatives, bit for bit JAX's sample_one."""
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.uniform([0, -40, -3], [70, 40, 1], (30000, 3)),
                          rng.normal([12, 3, -1], 1.5, (10000, 3))]).astype(np.float32)
    valid = rng.rand(pts.shape[0]) < 0.95
    cfg = C.tiny_pvrcnn_cfg()
    vsa = PFE.VoxelSetAbstraction(cfg.MODEL.PFE, [0, -40, -3, 70.4, 40, 1],
                                  [0.1, 0.1, 0.15], 64, 3)

    @jax.jit
    def sample_one(p, v):
        sidx, sok = JS.grid_subsample(p, v, 0.35, 1 << 15)
        sub = p[sidx]
        return sub[JS.farthest_point_sample(sub, 64, sok)]

    ref = np.asarray(sample_one(jnp.asarray(pts), jnp.asarray(valid)))
    got = vsa.sample_keypoints(torch.from_numpy(pts)[None], torch.from_numpy(valid)[None])
    assert_close(got[0], ref, name="keypoints")


# --- the ball query, grouping and pooling ----------------------------------


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("radius,nsample", [(0.4, 16), (0.8, 16), (1.5, 32)])
def test_ball_query_dense_matches_jax(radius, nsample, exact):
    rng = np.random.RandomState(1)
    sup = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    q = np.concatenate([rng.uniform(-5, 5, (200, 3)),
                        sup[:100] + rng.normal(0, 0.1, (100, 3))]).astype(np.float32)
    valid = rng.rand(3000) < 0.9
    ji, jv = JP.ball_query(jnp.asarray(q), jnp.asarray(sup), radius, nsample,
                           jnp.asarray(valid), exact=exact)
    ti, tv = P.ball_query(torch.from_numpy(q), torch.from_numpy(sup), radius, nsample,
                          torch.from_numpy(valid))
    assert_close(tv, np.asarray(jv), name="valid")
    assert_close(ti, np.asarray(ji).astype(np.int64), name="idx")
    assert 0 < int(tv.sum()) < tv.numel()


def _buckets(sup, valid, cell, table_size):
    """Member count of each bucket of JAX's grid table over ``sup``."""
    s = torch.from_numpy(sup)[torch.from_numpy(valid)]
    origin = s.amin(0)
    c = torch.floor((s - origin) / torch.tensor(cell)).to(torch.int32)
    return torch.bincount(S.cell_hash(c, table_size).long(), minlength=table_size)


@pytest.mark.parametrize("radius,nsample", [(0.8, 16), (1.6, 32)])
def test_ball_query_grid_matches_jax(radius, nsample):
    """At >= 16,384 supports (JAX's hash-grid path), on a cloud where no
    bucket overflows JAX's capacity, bit for bit."""
    rng = np.random.RandomState(2)
    n = P.GRID_BQ_MIN_SUPPORT + 3000
    sup = (rng.uniform(-1, 1, (n, 3)) * [40, 40, 2]).astype(np.float32)
    q = np.concatenate([sup[rng.choice(n, 150, replace=False)] + 0.05,
                        rng.uniform(-40, 40, (50, 3))]).astype(np.float32)
    valid = rng.rand(n) < 0.95
    cap = max(2 * nsample, 32)
    counts = _buckets(sup, valid, radius, JP.table_size_for(n, cap))
    assert int(counts.max()) <= cap                       # precondition
    ji, jv = JP.ball_query(jnp.asarray(q), jnp.asarray(sup), radius, nsample,
                           jnp.asarray(valid))
    ti, tv = P.ball_query(torch.from_numpy(q), torch.from_numpy(sup), radius, nsample,
                          torch.from_numpy(valid))
    assert_close(tv, np.asarray(jv), name="valid")
    assert_close(ti, np.asarray(ji).astype(np.int64), name="idx")
    assert int(tv.sum()) > 100


def test_ball_query_overflow_departure():
    """Deliberate departure (ROADMAP §3): a grid bucket holding more than
    JAX's capacity (32 for nsample 16) drops its highest-index members. Here
    35 low-index supports sit in the cell of 5 high-index ones, out of the
    query's radius; JAX finds none of the 5 in-radius supports, the port
    finds all 5, as a brute-force first-N does."""
    rng = np.random.RandomState(4)
    n, r, ns = P.GRID_BQ_MIN_SUPPORT, 0.4, 16
    bulk = rng.uniform(-10, 10, (2 * n, 3))
    bulk = bulk[np.abs(bulk).max(1) > 2][: n - 41]
    far = np.array([0.38, 0.2, 0.2]) + rng.uniform(-0.01, 0.01, (35, 3))
    near = np.array([0.02, 0.2, 0.2]) + rng.uniform(-0.01, 0.01, (5, 3))
    # the cells start at the cloud's minimum, (-10, -10, -10): x = 0 is an edge
    sup = np.concatenate([far, [[-10.0, -10.0, -10.0]], bulk, near]).astype(np.float32)
    q = np.array([[-0.35, 0.2, 0.2]], np.float32)
    assert sup.shape[0] == n
    d2 = ((sup - q) ** 2).sum(1)
    exact = np.nonzero(d2 <= r * r)[0][:ns]
    assert exact.tolist() == list(range(n - 5, n))
    ji, jv = JP.ball_query(jnp.asarray(q), jnp.asarray(sup), r, ns)
    ti, tv = P.ball_query(torch.from_numpy(q), torch.from_numpy(sup), r, ns)
    assert int(np.asarray(jv).sum()) == 0                 # JAX's table dropped them
    assert tv[0].tolist() == [True] * 5 + [False] * (ns - 5)
    assert ti[0, :5].tolist() == exact.tolist()
    assert int(_buckets(sup, np.ones(n, bool), r, JP.table_size_for(n, 32)).max()) > 32


def _form_fault_input():
    """ROADMAP §3's input for the distance-form fault: 10,000 valid supports
    uniform in 60 +- 10 x 20 +- 10 x -1 +- 1 m, padded with rows at 1e4 to
    20,000 (JAX's width), and 512 queries in the same box."""
    rng = np.random.RandomState(4)
    box = lambda n: (rng.uniform(-1, 1, (n, 3)) * [10, 10, 1]   # noqa: E731
                     + [60, 20, -1]).astype(np.float32)
    sup = box(10000)
    q = box(512)
    padded = np.concatenate([sup, np.full((10000, 3), 1e4, np.float32)])
    feats = rng.randn(20000, 6).astype(np.float32)
    return q, sup, padded, np.arange(20000) < 10000, feats


@pytest.mark.parametrize("layer", ["sa_layer", "vector_pool"])
def test_ball_query_form_follows_jax_width(layer):
    """Repaired fault (ROADMAP §3): the ball query takes its distance form
    from JAX's padded support width, not from the frame's compacted row
    count. On the compacted 10,000 rows the Gram form keeps, in row 161, a
    support outside the radius, where JAX's difference form (its width
    20,000 runs the hash grid) does not; with ``width`` the port's query
    equals JAX's, and so do an SA layer's (JAX's SALayer on the padded
    array) and a VectorPool group's (whose JAX query is ``ball_query`` on
    the padded array) outputs on the compacted frame, within 1e-5."""
    q, sup, padded, valid, feats = _form_fault_input()
    r, ns = 2.4, 16
    ji, jv = (np.asarray(a) for a in JP.ball_query(
        jnp.asarray(q), jnp.asarray(padded), r, ns, jnp.asarray(valid), exact=True))
    tq, ts = torch.from_numpy(q), torch.from_numpy(sup)
    gi, gv = P.ball_query(tq, ts, r, ns)             # the compacted count: Gram
    differ = ((gi.numpy() != ji) & jv).any(1) | (gv.numpy() != jv).any(1)
    assert np.nonzero(differ)[0].tolist() == [161]
    ti, tv = P.ball_query(tq, ts, r, ns, width=padded.shape[0])
    assert_close(tv, jv, name="valid")
    assert_close(ti, ji.astype(np.int64), name="idx")
    args = tuple(jnp.asarray(a)[None] for a in (q, padded, feats, valid))
    if layer == "sa_layer":
        jm = JPFE.SALayer((r,), (ns,), ((8, 8),), exact_ball_query=True)
        pm = PFE.SALayer(6, (r,), (ns,), ((8, 8),))
    else:
        jm = JPFE.VectorPoolAggregation((3, 3, 3), r, ns, (8,), 4)
        pm = PFE.VectorPoolAggregation(6, (3, 3, 3), r, ns, (8,), 4)
    variables = seeded_flax_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *args)), seed=5)
    ref = np.asarray(jax.jit(lambda v: jm.apply(v, *args))(
        jax.tree.map(jnp.asarray, variables)))
    sd = {}
    if layer == "sa_layer":
        W._sa_layer(sd, "l", variables["params"], variables["batch_stats"])
        pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    else:
        wrap = lambda t: {"group0": t}                            # noqa: E731
        W._sa_layer(sd, "l", wrap(variables["params"]), wrap(variables["batch_stats"]))
        pm.load_state_dict({k[len("l.layers.0."):]: v for k, v in sd.items()}, strict=True)
    pm.eval()
    frames = [(tq, ts, torch.from_numpy(feats[:10000]))]
    with torch.no_grad():
        got = pm(frames, width=padded.shape[0])
        compacted = pm(frames, width=sup.shape[0])
    assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5, name=f"{layer} output")
    if layer == "vector_pool":
        # the extra member moves row 161's bin means: the fault shows here
        assert np.abs(compacted[0, 161].numpy() - ref[0, 161]).max() > 1e-3


def test_group_features_and_masked_max_pool_match_jax():
    rng = np.random.RandomState(5)
    sup = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    feats = rng.randn(500, 6).astype(np.float32)
    q = rng.uniform(-3.5, 3.5, (64, 3)).astype(np.float32)
    ji, jv = JP.ball_query(jnp.asarray(q), jnp.asarray(sup), 0.5, 8)
    ti, tv = P.ball_query(torch.from_numpy(q), torch.from_numpy(sup), 0.5, 8)
    jg = JP.group_features(ji, jv, jnp.asarray(q), jnp.asarray(sup), jnp.asarray(feats))
    tg = P.group_features(ti, tv, torch.from_numpy(q), torch.from_numpy(sup),
                          torch.from_numpy(feats))
    assert_close(tg, np.asarray(jg), name="grouped")
    assert_close(P.group_features(ti, tv, torch.from_numpy(q), torch.from_numpy(sup)),
                 np.asarray(jg)[..., :3], name="grouped xyz")
    assert_close(P.masked_max_pool(tg, tv), np.asarray(JP.masked_max_pool(jg, jv)),
                 name="pooled")
    assert 0 < int(tv.any(1).sum()) < 64                  # empty groups pool to 0


# --- the SA layer ------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_sa_layer_matches_jax(train):
    """Two frames, two radii (0.4, 0.8; nsample 8, 16), supports with
    features and a mask: the output within 1e-5; in training also the batch
    statistics (over all groups' rows, empty slots included)."""
    rng = np.random.RandomState(6)
    q = rng.uniform(-2, 2, (2, 40, 3)).astype(np.float32)
    sup = rng.uniform(-2, 2, (2, 300, 3)).astype(np.float32)
    feats = rng.randn(2, 300, 5).astype(np.float32)
    valid = rng.rand(2, 300) < 0.8
    layer = JPFE.SALayer((0.4, 0.8), (8, 16), ((8, 8), (8, 16)))
    args = tuple(jnp.asarray(a) for a in (q, sup, feats, valid))
    shapes = jax.eval_shape(lambda: layer.init(jax.random.PRNGKey(0), *args))
    variables = seeded_flax_variables(shapes, seed=1)
    jv = jax.tree.map(jnp.asarray, variables)
    ref, mut = jax.jit(lambda v: layer.apply(v, *args, train=train,
                                             mutable=["batch_stats"]))(jv)
    sd = {}
    W._sa_layer(sd, "l", variables["params"], variables["batch_stats"])
    port = PFE.SALayer(5, (0.4, 0.8), (8, 16), ((8, 8), (8, 16)))
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    port.train(train)
    frames = [(torch.from_numpy(q[b]), torch.from_numpy(sup[b][valid[b]]),
               torch.from_numpy(feats[b][valid[b]])) for b in range(2)]
    with torch.no_grad():
        got = port(frames, width=300)
    assert got.shape == (2, 40, 24)
    assert_close(got, np.asarray(ref), atol=1e-5, rtol=1e-5, name="SA output")
    if train:
        new = {}
        W._sa_layer(new, "l", variables["params"],
                    jax.tree.map(np.asarray, mut["batch_stats"]))
        for k, v in port.state_dict().items():
            if "running" in k:
                assert_close(v, new[f"l.{k}"], atol=1e-5, rtol=1e-5, name=k)


# --- the head's geometry -------------------------------------------------------


def test_roi_grid_points_and_decode_match_jax():
    rng = np.random.RandomState(7)
    rois = np.concatenate([rng.uniform(-10, 10, (20, 3)), rng.uniform(1, 5, (20, 3)),
                           rng.uniform(-4, 4, (20, 1))], 1).astype(np.float32)
    reg = (0.3 * rng.randn(2, 10, 7)).astype(np.float32)
    for g in (3, 6):
        assert_close(H.roi_grid_points(torch.from_numpy(rois), g),
                     np.asarray(JH.roi_grid_points(jnp.asarray(rois), g)),
                     atol=1e-5, rtol=1e-5, name=f"grid {g}")
    r = rois.reshape(2, 10, 7)
    assert_close(H.decode_rcnn_boxes(torch.from_numpy(r), torch.from_numpy(reg)),
                 np.asarray(JH.decode_rcnn_boxes(jnp.asarray(r), jnp.asarray(reg))),
                 atol=1e-5, rtol=1e-5, name="decoded")


# --- the whole eval forward ------------------------------------------------------


def test_exporter_loads_strict(tiny):
    variables, model, _ = tiny
    sd = W.pvrcnn_state_dict_from_flax(variables)
    assert set(sd) == set(model.state_dict())
    # the first shared layer's rows: flax (G^3, C) -> the reference's (C, G^3)
    k0 = variables["params"]["roi_head"]["shared_fc0"]["kernel"]     # (27 * 16, 16)
    w = sd["roi_head.shared_fc_layer.0.weight"][:, :, 0]
    assert_close(w[:, 5 * 27 + 4], k0[4 * 16 + 5], name="row (c 5, p 4)")


@pytest.mark.parametrize("mode", [None, "sparse"])
def test_pvrcnn_eval_matches_jax(tiny, mode):
    """The tiny PV-RCNN's eval forward in JAX's default backbone mode
    (hybrid) and in its rulebook mode, against the port: the keypoints bit
    for bit, the VSA's features, the point logits, the RoI-grid pool, the
    heads and the refined boxes within 1e-5, the proposals, the final NMS's
    kept set and labels equal."""
    variables, model, (pts, valid) = tiny
    jo, inter, jp = _jax_eval(variables, pts, valid, mode)
    to, seen, tp = _port_eval(model, pts, valid)
    # preconditions: the rulebook mode's capacity (the input's rows) and the
    # default mode's extraction capacity (1.5x) were not reached
    assert (to["active_voxels"] <= B * 512).all() and to["active_voxels"][0] > 300

    vsa = inter["pfe"]["__call__"][0]
    assert_close(to["keypoints"], np.asarray(jo["keypoints"]), name="keypoints")
    for k in ("point_features_before_fusion", "point_features"):
        assert_close(seen["vsa"][k], np.asarray(vsa[k]), atol=1e-5, rtol=1e-5, name=k)
    # every source's block (bev 64, raw points 16, x_conv1-4 16, 16, 32, 32
    # channels) is live
    before = np.abs(to_numpy(seen["vsa"]["point_features_before_fusion"]))
    edges = np.cumsum([0, 64, 16, 16, 16, 32, 32])
    assert edges[-1] == before.shape[-1]
    for lo, hi in zip(edges[:-1], edges[1:]):
        assert (before[..., lo:hi].sum(-1) > 0).mean() > 0.5
    pool = inter["roi_head"]["roi_grid_pool"]["__call__"][0]
    assert_close(seen["pool"], np.asarray(pool), atol=1e-5, rtol=1e-5, name="grid pool")
    assert_close(to["point_logits"], np.asarray(jo["point_logits"]), atol=1e-5,
                 rtol=1e-5, name="point_logits")
    assert_close(to["spatial_features_2d"],
                 np.asarray(inter["backbone_2d"]["__call__"][0]), atol=1e-5, rtol=1e-5,
                 name="bev2d")
    assert_close(to["batch_cls_preds"], np.asarray(jo["batch_cls_preds"]), atol=1e-5,
                 rtol=1e-5, name="batch_cls_preds")
    assert_close(to["batch_box_preds"], np.asarray(jo["batch_box_preds"]), atol=1e-4,
                 rtol=1e-5, name="batch_box_preds")
    for k in ("roi_mask", "roi_labels"):
        assert_close(to[k], np.asarray(jo[k]), name=k)
    for k in ("rcnn_cls", "rcnn_reg", "rcnn_iou"):
        assert_close(to[k], np.asarray(jo[k]), atol=1e-5, rtol=1e-5, name=k)
    for k in ("rois", "batch_box_preds_refined"):
        assert_close(to[k], np.asarray(jo[k]), atol=1e-4, rtol=1e-5, name=k)
    for k in ("pred_mask", "pred_labels"):
        assert_close(tp[k], np.asarray(jp[k]), name=k)
    assert_close(tp["pred_boxes"], np.asarray(jp["pred_boxes"]), atol=1e-4, rtol=1e-5,
                 name="pred_boxes")
    assert_close(tp["pred_scores"], np.asarray(jp["pred_scores"]), atol=1e-5,
                 name="pred_scores")
    assert int(to["roi_mask"].sum()) > 4 and int(tp["pred_mask"].sum()) > 0


def test_pvrcnn_on_the_completed_frame_matches_jax(tiny):
    """The slice as a whole on the CPU: a SEE frame, then PV-RCNN on its
    output cloud through ``see_and_detect``, against JAX's PV-RCNN on that
    same cloud (the SEE frame itself is held against JAX in
    test_torch_frame.py)."""
    variables, model, _ = tiny
    img = (96, 128)
    proj = np.array([[72.0, 0, 64.0, 0], [0, 72.0, 47.5, 0], [0, 0, 1.0, 0]],
                    np.float32)
    scene = make_scene(3, 4096, 4, image_size=img, proj=proj, pts_per_car=300)
    vcn = VCNInference("VCN_VC", seeded_vcn_state_dict(0, num_coarse=128),
                       num_points=128, device="cpu")
    t = {k: to_torch(v) for k, v in scene.items()}
    pp, stats, new_pts, new_valid = see_and_detect(
        t["points"], t["valid"], t["det_boxes"], t["det_masks"], t["det_scores"],
        vcn, to_torch(proj), to_torch(LIDAR_TO_CAM), model, C.tiny_pvrcnn_cfg(), img,
        device="cpu", max_instance_pts=256, out_pts=128, cand_cap=512)
    assert new_pts.shape == (4096 + 4 * 128, 3)
    jo, _, jp = _jax_eval(variables, new_pts[None].numpy(), new_valid[None].numpy())
    for k in ("pred_mask", "pred_labels"):
        assert_close(pp[k], np.asarray(jp[k]), name=k)
    assert_close(pp["pred_boxes"], np.asarray(jp["pred_boxes"]), atol=1e-4, rtol=1e-5,
                 name="pred_boxes")
    assert_close(pp["pred_scores"], np.asarray(jp["pred_scores"]), atol=1e-5,
                 name="pred_scores")
    assert int(pp["pred_mask"].sum()) > 0 and bool(stats["inst_valid"].any())
