"""The port's data parallelism (seevcn_torch.parallel, train.shard_train_step,
the loader's rank rows) on the CPU, with two gloo ranks spawned on a free
local port (``seevcn_torch.testing.spawn_ranks``) where a world of 2 is
needed.

- The collectives at world 2 reproduce the JAX package's own two-process
  test (tests/test_multihost.py's WORKER) case for case; at world 1 each one
  is the identity.
- ``init_distributed``: the ``jax`` and ``auto`` environments start a group
  of 2; ``slurm`` reads SLURM_* with ``scontrol`` patched; a missing
  variable raises KeyError, an unknown launcher NotImplementedError.
- The batch norms at world 2 equal world 1 on the same global rows: the
  output, the input gradient, the summed parameter gradients and the
  running statistics, within 1e-6 (f32 sums in another order); so do they
  at world 4, (dp 2, mp 2), where the two mp ranks of a dp row add the same
  rows to the sums and to the count alike (a reduction of the sums alone
  over every rank would count each frame twice).
- One train step of each of the ten other detectors (CaDDN in both its
  forms), at world 2 (one frame a rank) against the port's world-1 step on
  the same two frames, in f64, the RoI sample and dropout drawn from the
  step's generator: loss terms within 1e-12 (relative), gradients before
  clipping within 2e-6 of their tensor's largest (the voxel backbones'
  sparse-conv weight gradients move by 4e-7 of theirs in f64 between one
  CPU thread and eight, with no second rank), the updated parameters within
  1e-8 where the gradient is sure (5% of its tensor's largest and 1e-6),
  2 lr elsewhere (Adam's first step of a gradient that is rounding noise),
  the running statistics within 1e-12; the two ranks' weights and buffers
  bit for bit equal.
- The mp axis (``parallel.spatial``, ``make_mesh(mp=2)``): the mesh layout
  at world 2 and 4 (rank r at dp index r // 2, mp index r % 2); scatter_w,
  gather_w and halo_w against slices of the whole map, their backwards
  against the gradients that the whole map's autograd gives, in f64 bit
  for bit (they only move values, and add one halo column a rank); a W
  that does not split raises ValueError. ``BaseBEVBackbone`` on W slabs at
  (dp 1, mp 2) and (dp 2, mp 2) against the unsharded module in f64:
  output, input gradient, parameter gradients summed over the ranks and
  running statistics within 1e-12. The eval forward of the tiny SECOND-IoU
  under the mp-2 mesh gives the unsharded batch_box_preds within 1e-10, its
  BEV backbone on 2 of 4 columns a rank; PointPillar, replicated, on all
  32. ``eval_one_epoch`` under that mesh: every frame on both ranks, the
  recall and frame count of world 1, its AP within 1e-4.
- The train steps of the tiny SECOND-IoU, focal and multi-head SECONDNet
  at world 4 (dp 2, mp 2), and of PointPillar (replicated) at (dp 1, mp 2),
  against the world-1 step by the world-2 steps' bounds, every rank's
  weights and buffers bit for bit equal.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BIAS_BEFORE_BN, DP_TINY_DETECTORS, MP_TINY_DETECTORS,
                        MP_TINY_REPLICATED, dp_tiny_case, kitti_cfg, seeded_state_dict,
                        write_kitti_split)
from seevcn_torch.data.kitti.dataset import KittiDataset
from seevcn_torch.data.loader import BackgroundLoader
from seevcn_torch.models.detectors import configs as DC
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.models.modules.backbone2d import BaseBEVBackbone
from seevcn_torch.parallel import collectives as COL
from seevcn_torch.parallel import distributed as D
from seevcn_torch.parallel.mesh import (Mesh, gather_rows, global_batch, global_count,
                                       make_mesh, set_active_mesh, shard_batch, stats_count,
                                       stats_sum)
from seevcn_torch.testing import (assert_close, bev_backbone_case, bn_case, dp_steps_worker,
                                  epoch_case, eval_case, free_port, mp_worker,
                                  one_cpu_thread, parallel_checks_worker, spawn_ranks,
                                  step_case)
from seevcn_torch.train.optim import build_lr_schedule


def _bn_cases():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)              # noqa: E731
    stats = lambda c: {"weight": 1 + 0.1 * f(c), "bias": f(c),    # noqa: E731
                       "running_mean": f(c), "running_var": 1 + rng.rand(c).astype(np.float32)}
    mask = rng.rand(24) < 0.7
    mask[:2] = mask[12:14] = False
    return [{"kind": "BatchNorm2d", "x": 2 + 3 * f(4, 3, 5, 6), "g": f(4, 3, 5, 6), **stats(3)},
            {"kind": "MaskedBatchNorm", "x": 1 + 2 * f(24, 5), "g": f(24, 5), "mask": mask,
             **stats(5)}]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The module's tiny models and checks on one CPU thread, as its spawned
    ranks run: on more they gain nothing and lose tenfold to the threads'
    contention."""
    with one_cpu_thread():
        yield


#: two BaseBEVBackbone layouts: the flagship's (strides 1, 2, upsampled by
#: 1, 2) and one with a stride-2 first level, a 2-strided downsample and a
#: final deblock; the first also narrowed to a W of 10 (a slab of 5, which
#: level 1's stride 2 does not split)
BEV_KW = [dict(input_channels=3, layer_nums=[2, 1], layer_strides=[1, 2], num_filters=[6, 8],
               upsample_strides=[1, 2], num_upsample_filters=[4, 4]),
          dict(input_channels=3, layer_nums=[1, 1], layer_strides=[2, 2], num_filters=[6, 8],
               upsample_strides=[0.5, 1, 2], num_upsample_filters=[4, 4])]


def _bev_cases():
    rng = np.random.RandomState(1)
    cases = []
    for i, kw in enumerate(BEV_KW):
        net = BaseBEVBackbone(**kw).double()
        sd = {k: v.double() if v.is_floating_point() else v
              for k, v in seeded_state_dict(3 + i, net, random_stats=True).items()}
        x = rng.randn(4, 8, 16, 3)
        with torch.no_grad():
            shape = net(torch.from_numpy(x)).shape
        cases.append({"kw": kw, "sd": sd, "x": x, "g": rng.randn(*shape)})
    return cases + [dict(cases[0], w=10)]


def _spatial_case():
    """The whole map x (B, H, W, C) and each check's upstream gradients (a
    leading axis of 2 where each mp rank's output is its own)."""
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 3, 8, 2
    return (rng.randn(b, h, w, c),
            {"scatter": rng.randn(2, b, h, w // 2, c), "gather": rng.randn(b, h, w, c),
             "halo": rng.randn(2, b, h, w // 2 + 2, c),
             "halo_stride2": rng.randn(2, b, h, w // 2 + 1, c)})


def _eval_cases():
    return [dp_tiny_case(k) for k in ("second_iou", MP_TINY_REPLICATED)]


@pytest.fixture(scope="module")
def epoch(tmp_path_factory):
    """``epoch_case``'s case: the tiny SECOND-IoU (scores from 0) over a
    synthetic KITTI split of 3 frames at 2 a batch, the tail padded."""
    root = str(tmp_path_factory.mktemp("kitti"))
    write_kitti_split(root, 3, seed=1, n_points=6000, n_cars=3)
    cfg = DC.tiny_detector_cfg()
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.0
    ds_cfg = kitti_cfg(root, POINT_CLOUD_RANGE=[0, -8, -2, 16, 8, 2])
    return {"cfg": cfg, "batch": 2,
            "sd": seeded_state_dict(0, build_detector(cfg, device="cpu")[0], random_stats=True),
            "dataset": (KittiDataset, (ds_cfg, ["Car"], False),
                        {"max_points": 1024, "max_boxes": 8})}


@pytest.fixture(scope="module")
def group(epoch):
    """Both ranks' results of ``parallel_checks_worker``, the mp axis's
    checks at (dp 1, mp 2) among them."""
    return spawn_ranks(parallel_checks_worker, 2, free_port(), _bn_cases(),
                       {"spatial": _spatial_case(), "bev": _bev_cases(),
                        "evals": _eval_cases(), "epochs": [epoch]})


@pytest.fixture(scope="module")
def mp_cases():
    """The step cases of the three sharded tiny detectors."""
    return [dp_tiny_case(k) for k in MP_TINY_DETECTORS]


@pytest.fixture(scope="module")
def mesh4(mp_cases):
    """Each rank's ``mp_checks`` at world 4, (dp 2, mp 2): the collectives,
    the BEV backbones, the batch norms outside the sharded region and the
    steps of the three sharded tiny detectors."""
    return spawn_ranks(mp_worker, 4, 2, {
        "spatial": _spatial_case(), "bev": _bev_cases()[:2], "bn": _bn_cases(),
        "steps": mp_cases})


def test_collectives_at_world_2_match_jax_multihost(group):
    for r, out in enumerate(group):
        assert (out["rank"], out["world"]) == (r, 2)
        assert out["merged"] == ["0_0", "0_1", "1_0", "1_1", "1_2"]
        assert abs(out["average"] - 1.5) < 1e-9
        assert abs(out["reduced"]["loss"] - 1.0) < 1e-9
        assert out["truncated"] == [0]


def test_collectives_are_the_identity_at_world_1():
    assert (COL.get_rank(), COL.get_world_size()) == (0, 1)
    assert COL.merge_results_dist(["a", "b", "c"]) == ["a", "b", "c"]
    assert COL.merge_results_dist(["a", "b", "c"], total_size=2) == ["a", "b"]
    assert COL.average_reduce_value(2.5) == 2.5
    assert COL.reduce_dict({"loss": 3}) == {"loss": 3.0}
    assert D.init_distributed("none") == (0, 1) and D.LAUNCHER is None


def test_jax_and_auto_launchers_start_a_group(group):
    for r, out in enumerate(group):
        assert out["jax"] == (r, 2) and out["auto"] == (r, 2)
        assert out["auto_sum"] == 3.0


def test_slurm_launcher_reads_the_slurm_environment(monkeypatch):
    calls = []

    def scontrol(cmd):
        calls.append(cmd)
        return "localhost"

    monkeypatch.setattr(D.subprocess, "getoutput", scontrol)
    for k in ("LOCAL_RANK", "SLURM_LOCALID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SLURM_NODELIST", "node[3-4]")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.delenv("SLURM_PROCID", raising=False)
    with pytest.raises(KeyError, match="SLURM_PROCID"):
        D.init_distributed("slurm", device="cpu")
    monkeypatch.setenv("SLURM_PROCID", "0")
    try:
        assert D.init_distributed("slurm", device="cpu") == (0, 1)
        assert torch.distributed.get_backend() == "gloo" and D.LAUNCHER == "slurm"
        assert COL.merge_results_dist([7]) == [7]
    finally:
        D.destroy_distributed()
    assert calls == ["scontrol show hostname node[3-4] | head -n1"]
    assert not torch.distributed.is_initialized() and D.DEVICE is None
    # the default port is JAX's 29501
    monkeypatch.delenv("MASTER_PORT")
    assert D._rendezvous("slurm", None, None, None) == ("tcp://localhost:29501", 1, 0)


def test_unknown_launcher_and_a_lost_group_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="mpi"):
        D.init_distributed("mpi", device="cpu")
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS"):
        D.init_distributed("jax", device="cpu")
    # no quiet single-rank run where a launcher's group is gone
    monkeypatch.setattr(D, "LAUNCHER", "jax")
    with pytest.raises(RuntimeError, match="not running"):
        COL.get_world_size()
    # a rank's card must exist
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            D.rank_device("cuda", 0)


def test_mesh_takes_block_rows_over_its_dp_axis(group, mesh4):
    """The (dp, mp) layout of JAX's make_mesh: rank r at dp index r // mp
    and mp index r % mp; the mp ranks of a dp row take the same rows."""
    with pytest.raises(ValueError, match="do not divide"):
        make_mesh(mp=2)                               # one rank
    assert make_mesh().world == 1 and make_mesh().dp == 1
    m = Mesh(3, 4, mp=2)
    assert (m.dp, m.dp_rank, m.mp_rank) == (2, 1, 1)
    for r, out in enumerate(group):
        assert out["mp"]["layout"] == (r, 1, 2, 0, r)
        assert out["mp"]["rows"] == list(range(8))
    for r, out in enumerate(mesh4):
        assert out["layout"] == (r, 2, 2, r // 2, r % 2)
        assert out["rows"] == list(range(4 * (r // 2), 4 * (r // 2) + 4))
    x = np.arange(12).reshape(6, 2)
    got = shard_batch(Mesh(1, 3), {"x": x, "t": (torch.arange(6), None), "n": 5})
    assert got["x"].tolist() == [[4, 5], [6, 7]] and got["t"][0].tolist() == [2, 3]
    assert got["t"][1] is None and got["n"] == 5
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(Mesh(0, 4), x)
    for r, out in enumerate(group):
        assert out["mesh"] == (r, 2)
        assert out["rows"] == [[4 * r, 4 * r + 1], [4 * r + 2, 4 * r + 3]]


def test_reductions_refuse_a_tensor_off_the_mesh_device():
    """A tensor made on another device than the mesh's (a count made on the
    CPU beside a card's batch, which NCCL refuses) raises before any
    collective runs, under gloo too."""
    prev = set_active_mesh(Mesh(0, 2, torch.device("cpu")))
    try:
        off = torch.ones(3, device="meta")
        for fn in (global_count, stats_count, stats_sum, gather_rows):
            with pytest.raises(RuntimeError, match="reached a collective"):
                fn(off)
        assert global_batch(3) == 6
    finally:
        set_active_mesh(prev)


@pytest.mark.parametrize("idx", [0, 1], ids=["BatchNorm2d", "MaskedBatchNorm"])
def test_batch_norm_at_world_2_equals_world_1(group, idx):
    case = _bn_cases()[idx]
    ref = bn_case(case)
    got = [out["bn"][idx] for out in group]
    for k in ("y", "x_grad"):
        assert_close(torch.cat([g[k] for g in got]), ref[k], atol=1e-6, rtol=1e-6, name=k)
    for k in ("weight_grad", "bias_grad"):
        assert_close(got[0][k] + got[1][k], ref[k], atol=1e-6, rtol=1e-6, name=k)
    for k in ("running_mean", "running_var"):
        for g in got:
            assert_close(g[k], ref[k], atol=1e-6, rtol=1e-6, name=k)
    if idx == 1:                                  # the padding rows stay zero
        assert not torch.cat([g["y"] for g in got])[~torch.from_numpy(case["mask"])].any()


class _Frames:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"points": np.full((3, 4), i, np.float32)}


def test_loader_assembles_each_ranks_rows():
    """Every rank shuffles alike and takes its block of each global batch:
    the ranks' batches, concatenated, are the world-1 loader's."""
    ref = list(BackgroundLoader(_Frames(), 4, keys=("points",), seed=3))
    parts = [list(BackgroundLoader(_Frames(), 4, keys=("points",), seed=3, rank=r, world=2))
             for r in range(2)]
    assert len(ref) == len(parts[0]) == len(parts[1]) == 2
    for i, batch in enumerate(ref):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][i]["points"], parts[1][i]["points"]]), batch["points"])
    with pytest.raises(ValueError, match="does not divide"):
        BackgroundLoader(_Frames(), 3, world=2)


# --- one train step of every other detector: world 2 against world 1 ------------

DETECTORS = DP_TINY_DETECTORS


@pytest.fixture(scope="module")
def dp_steps():
    """{key: (case, the world-1 step, each rank's world-2 step)}, and
    PointPillar's at (dp 1, mp 2) under ``pointpillar_mp2``."""
    keys = [*DETECTORS, f"{MP_TINY_REPLICATED}_mp2"]
    cases = [dp_tiny_case(k) for k in DETECTORS]
    cases.append(dict(cases[DETECTORS.index(MP_TINY_REPLICATED)], mp=2))
    with one_cpu_thread():         # the tiny models gain nothing from more
        ref = [step_case(c) for c in cases[:-1]]
    ref.append(ref[DETECTORS.index(MP_TINY_REPLICATED)])
    ranks = spawn_ranks(dp_steps_worker, 2, cases)
    return {k: (c, r, [ranks[0][i], ranks[1][i]])
            for i, (k, c, r) in enumerate(zip(keys, cases, ref))}


@pytest.mark.parametrize("key", DETECTORS)
def test_world_2_step_equals_world_1(dp_steps, key):
    _hold_step(*dp_steps[key])


def _hold_step(case, ref, got):
    """Rank 0's step ``got[0]`` against the world-1 step ``ref``: loss terms
    1e-12 (relative), gradients 2e-6 of their tensor's largest, updated
    parameters 1e-8 where the gradient is sure and 2 lr elsewhere, running
    statistics 1e-12; every rank's weights and buffers bit for bit rank
    0's."""
    for name in ("params", "buffers"):             # the ranks agree bit for bit
        for r in range(1, len(got)):
            for n, v in got[0][name].items():
                assert torch.equal(v, got[r][name][n]), f"rank {r}'s {n}"
    g = got[0]
    assert set(g["terms"]) == set(ref["terms"])
    for k, v in ref["terms"].items():
        assert_close(g["terms"][k], v, atol=1e-12, rtol=1e-12, name=k)
    scale = {n: r.abs().max().item() + 1e-30 for n, r in ref["grads"].items()}
    if BIAS_BEFORE_BN in scale:    # the conv bias that its batch norm cancels: noise
        scale[BIAS_BEFORE_BN] = scale[BIAS_BEFORE_BN.replace("bias", "weight")]
    for n, r in ref["grads"].items():
        assert_close(g["grads"][n], r, atol=2e-6 * scale[n], name=f"grad {n}")
    lr = build_lr_schedule(case["cfg"].OPTIMIZATION, 100)(0)
    for n, r in ref["params"].items():
        gr = ref["grads"][n].abs()
        sure = (gr >= 0.05 * gr.max()) & (gr >= 1e-6)
        assert_close(g["params"][n][sure], r[sure], atol=1e-8, name=f"updated {n}")
        assert_close(g["params"][n], r, atol=2 * lr, name=f"updated {n} (all)")
    for n, r in ref["buffers"].items():
        assert_close(g["buffers"][n], r, atol=1e-12, rtol=1e-12, name=n)
    # the step did real work: a foreground term above 0
    fg = next(k for k in ("rcnn_loss_reg", "loc_loss", "rpn_loss_loc") if k in ref["terms"])
    assert float(ref["terms"][fg]) > 0


# --- the mp axis -----------------------------------------------------------------

def _spatial_reference():
    """The whole map's answers to ``spatial_checks``: each rank's outputs
    and the gradients that autograd of the same slices and zero pads of
    the whole map gives back."""
    x, g = _spatial_case()
    w = x.shape[2] // 2
    full = torch.from_numpy(x).requires_grad_(True)
    pad = torch.nn.functional.pad(full, (0, 0, 1, 1))
    ref = {"scatter": [full[:, :, r * w:(r + 1) * w] for r in range(2)],
           "halo": [pad[:, :, r * w:r * w + w + 2] for r in range(2)],
           "halo_stride2": [pad[:, :, r * w:r * w + w + 1] for r in range(2)]}
    out = {}
    for name, ys in ref.items():
        grad, = torch.autograd.grad(sum((y * torch.from_numpy(g[name][r])).sum()
                                        for r, y in enumerate(ys)), full)
        out[name] = ([y.detach() for y in ys], grad)
    return x, g, out


@pytest.mark.parametrize("world", [2, 4])
def test_halo_scatter_and_gather_move_the_whole_maps_columns(group, mesh4, world):
    """scatter_w, gather_w and halo_w at mp 2 on each dp row: values and
    backwards bit for bit those of the whole map's slices (the halos' zeros
    at the true edges, the stride-2 conv's one left column), and the W or
    halo that does not fit raising ValueError."""
    x, g, ref = _spatial_reference()
    outs = [o["mp"]["spatial"] for o in group] if world == 2 else \
        [o["spatial"] for o in mesh4]
    w = x.shape[2] // 2
    for rank, got in enumerate(outs):
        r = rank % 2
        for name in ("scatter", "halo", "halo_stride2"):
            y, grad = got[name]
            assert torch.equal(y, ref[name][0][r]), name
        # a slab's gradient: the whole map's gradient at its columns
        assert torch.equal(got["scatter"][1], ref["scatter"][1]), "scatter backward"
        for name in ("halo", "halo_stride2"):
            assert torch.equal(got[name][1], ref[name][1][:, :, r * w:(r + 1) * w]), \
                f"{name} backward"
        edge = got["halo"][0][:, :, 0 if r == 0 else -1]
        assert not edge.any(), "the map's true edge is zero"
        assert got["halo_stride2"][0].shape[2] == w + 1
        assert torch.equal(got["gather"][0], torch.from_numpy(x))
        assert torch.equal(got["gather"][1], torch.from_numpy(g["gather"])[:, :, r * w:(r + 1) * w])
        assert "does not divide into 2 slabs" in got["odd_w"]
        assert "wider than the slab" in got["wide_halo"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("idx", range(len(BEV_KW)))
def test_bev_backbone_on_w_slabs_equals_the_whole_map(group, mesh4, world, idx):
    """BaseBEVBackbone on W slabs at (dp 1, mp 2) and (dp 2, mp 2) against
    the unsharded module on the same global batch, f64, within 1e-12:
    output and input gradient (each rank's rows), parameter gradients
    summed over every rank, running statistics on every rank."""
    case = _bev_cases()[idx]
    ref = bev_backbone_case(case)
    got = [o["mp"]["bev"][idx] for o in group] if world == 2 else \
        [o["bev"][idx] for o in mesh4]
    dp = world // 2
    rows = case["x"].shape[0] // dp
    for rank, g in enumerate(got):
        d = rank // 2
        assert g["slab_w"] == case["x"].shape[2] // 2
        for k in ("y", "x_grad"):
            assert_close(g[k], ref[k][d * rows:(d + 1) * rows], atol=1e-12, rtol=1e-12,
                         name=f"rank {rank} {k}")
        for n, v in ref["buffers"].items():
            assert_close(g["buffers"][n], v, atol=1e-12, rtol=1e-12, name=n)
    for n, v in ref["grads"].items():
        assert_close(sum(g["grads"][n] for g in got), v, atol=1e-12 * float(v.abs().max()),
                     name=f"grad {n}")


def test_bev_backbone_refuses_a_w_that_does_not_split(group):
    """W 10 at mp 2: a slab of 5 columns, which level 1's stride 2 does not
    split; XLA would pad the uneven shard, the port raises."""
    for out in group:
        err = out["mp"]["bev"][2]["error"]
        assert "level 1" in err and "W slab of 5" in err and "W 10" in err


@pytest.mark.parametrize("idx", [0, 1], ids=["BatchNorm2d", "MaskedBatchNorm"])
def test_batch_norm_at_dp_2_mp_2_equals_world_1(mesh4, idx):
    """At (dp 2, mp 2) a replicated batch norm, its statistics over every
    rank, equals world 1: each rank's output and input gradient on its dp
    row's rows (no frame's gradient taken twice), the parameter gradients
    summed over the dp rows (each mp rank holds the same), and the running
    statistics, within 1e-6."""
    case = _bn_cases()[idx]
    ref = bn_case(case)
    got = [out["bn"][idx] for out in mesh4]
    rows = case["x"].shape[0] // 2
    for rank, g in enumerate(got):
        d = rank // 2
        for k in ("y", "x_grad"):
            assert_close(g[k], ref[k][d * rows:(d + 1) * rows], atol=1e-6, rtol=1e-6,
                         name=f"rank {rank} {k}")
        for k in ("running_mean", "running_var"):
            assert_close(g[k], ref[k], atol=1e-6, rtol=1e-6, name=k)
    for k in ("weight_grad", "bias_grad"):
        assert torch.equal(got[0][k], got[1][k]) and torch.equal(got[2][k], got[3][k])
        assert_close(got[0][k] + got[2][k], ref[k], atol=1e-6, rtol=1e-6, name=k)


@pytest.mark.parametrize("idx", [0, 1], ids=["second_iou", MP_TINY_REPLICATED])
def test_eval_forward_under_the_mp_mesh_equals_unsharded(group, idx):
    """The eval forward under the (dp 1, mp 2) mesh: every rank's
    batch_box_preds and batch_cls_preds within 1e-10 of the unsharded
    forward's, in f64; SECOND-IoU's BEV backbone on 2 of the map's 4
    columns a rank, PointPillar's (replicated) on all 32."""
    case = _eval_cases()[idx]
    ref = eval_case(case)
    for out in group:
        got = out["mp"]["eval"][idx]
        assert got["bev_w"] == ref["bev_w"] // (2 if idx == 0 else 1)
        for k in ("batch_box_preds", "batch_cls_preds"):
            assert_close(got[k], ref[k], atol=1e-10, rtol=1e-10, name=k)
    assert ref["bev_w"] == (4 if idx == 0 else 32)


def test_eval_one_epoch_under_the_mp_mesh_equals_world_1(group, epoch):
    """``eval_one_epoch`` under the (dp 1, mp 2) mesh: both ranks run every
    frame (the dp index and size stride them), the first mp rank's
    predictions and counts alone are merged, and every rank's recall and
    frame count equal world 1's, its AP within 1e-4 (phase 23's bound: f32
    BEV maps summed on slabs)."""
    ref = epoch_case(epoch)
    assert ref["recall"]["num_gt"] > 0 and ref["ap"]
    for out in group:
        got = out["mp"]["epochs"][0]
        assert got["recall"] == ref["recall"]
        assert got["logs"][0].split(",")[0] == ref["logs"][0].split(",")[0] == "eval: 3 frames"
        for c, by_metric in ref["ap"].items():
            for m, by_diff in by_metric.items():
                for d, v in by_diff.items():
                    assert abs(got["ap"][c][m][d] - v) <= 1e-4, (c, m, d)


@pytest.fixture(scope="module")
def mp_world1_steps(mp_cases):
    with one_cpu_thread():
        return [step_case(c) for c in mp_cases]


@pytest.mark.parametrize("key", MP_TINY_DETECTORS)
def test_dp_mp_step_equals_world_1(mesh4, mp_cases, mp_world1_steps, key):
    """The step at world 4, (dp 2, mp 2), one frame a dp row, the BEV
    backbone on 2 of 4 columns a rank, against the world-1 step by the
    world-2 steps' bounds; every rank's weights and buffers bit for bit
    equal."""
    i = MP_TINY_DETECTORS.index(key)
    _hold_step(mp_cases[i], mp_world1_steps[i], [out["steps"][i] for out in mesh4])


def test_replicated_detector_at_mp_2_equals_world_1(dp_steps):
    """PointPillar, which JAX never constrains, at (dp 1, mp 2): both ranks
    run the whole batch and the whole map; the step equals world 1's."""
    case, ref, got = dp_steps[f"{MP_TINY_REPLICATED}_mp2"]
    _hold_step(case, ref, got)
