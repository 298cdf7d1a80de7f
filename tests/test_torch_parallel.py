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
  running statistics, within 1e-6 (f32 sums in another order).
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
"""

import numpy as np
import pytest
import torch

from chip_smoke import BIAS_BEFORE_BN, DP_TINY_DETECTORS, dp_tiny_case
from seevcn_torch.data.loader import BackgroundLoader
from seevcn_torch.parallel import collectives as COL
from seevcn_torch.parallel import distributed as D
from seevcn_torch.parallel.mesh import (Mesh, gather_rows, global_batch, global_count,
                                       global_sum, make_mesh, set_active_mesh, shard_batch)
from seevcn_torch.testing import (assert_close, bn_case, dp_steps_worker, free_port,
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


@pytest.fixture(scope="module")
def group():
    """Both ranks' results of ``parallel_checks_worker``."""
    return spawn_ranks(parallel_checks_worker, 2, free_port(), _bn_cases())


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


def test_mesh_takes_block_rows_and_has_no_mp_axis(group):
    with pytest.raises(NotImplementedError, match="item 6"):
        make_mesh(mp=2)
    assert make_mesh().world == 1
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
        for fn in (global_count, global_sum, gather_rows):
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
    """{key: (case, the world-1 step, each rank's world-2 step)}."""
    cases = [dp_tiny_case(k) for k in DETECTORS]
    with one_cpu_thread():         # the tiny models gain nothing from more
        ref = [step_case(c) for c in cases]
    ranks = spawn_ranks(dp_steps_worker, 2, cases)
    return {k: (c, r, [ranks[0][i], ranks[1][i]])
            for i, (k, c, r) in enumerate(zip(DETECTORS, cases, ref))}


@pytest.mark.parametrize("key", DETECTORS)
def test_world_2_step_equals_world_1(dp_steps, key):
    case, ref, got = dp_steps[key]
    for name in ("params", "buffers"):             # the ranks agree bit for bit
        for n, v in got[0][name].items():
            assert torch.equal(v, got[1][name][n]), f"rank 1's {n}"
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
