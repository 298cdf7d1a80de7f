"""The port's DA experiment (seevcn_torch/experiments/{da_generate,
da_experiment,da_table}.py) against the JAX package's scripts
(scripts/da_generate.py, scripts/da_experiment.py), imported from
scripts/ as tests/test_synth_da.py does, on the CPU at a small size.

- ``da_detector_cfg`` and ``lidar_boxes_to_annos``: equal to JAX's as plain
  trees and arrays.
- ``gen_set`` / ``gen_vc``: the files equal JAX's byte for byte (an .npz
  member by member: the zip headers carry the write time).
- ``complete``: both packages' ``complete`` on a 2-frame 16-beam set of
  ``generate_da_set(max_pts=4000)``, VCN_VC and VCN_CN at JAX's init
  weights (a ``{"variables": ...}`` pickle for JAX, the same weights through
  ``vcn_state_dict_from_flax`` as a .pth for the port): ``valid`` equal, the
  scan rows within 1e-5 m, and each completed instance's unique rows within
  1e-5 m of the other side's but for at most STRAY_ROWS rows a side, which
  lie within STRAY_M of it. Those rows are apart because the two packages'
  partial-mesh k-NN (k = 30) picks differently at near ties of its f32
  distances: fed the same coarse cloud, JAX's ``partial_mesh_batch`` and the
  port's select one coarse point apart in an instance of each frame here,
  and the selection, tiled to 1,024 rows, then shifts every later row of
  that instance.
- the train batch at pinned indices and flip equal to JAX's expression; the
  port's ``train`` at JAX's tiny eval grid (64 x 64 x 40,
  test_synth_da.py:120-127) for 4 steps equal bit for bit to 2 steps, a
  kill, and a ``--resume`` for 2; an unreadable checkpoint starts fresh.
- ``eval``: both packages' ``eval`` at the tiny grid on JAX's 5-frame set
  of test_synth_da.py, the same random weights (a reference-layout state
  dict carried into flax by ``detector_variables_from_torch``): the same
  ``n_dets`` and APs within 1e-6; the port at ``--eval_batch`` 1 and 3
  gives the same summary.
"""
import argparse
import json
import os
import pickle
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seeded_state_dict
from seevcn_tpu.models.vcn.nets import build_vcn as jax_build_vcn
from seevcn_tpu.utils.ckpt_compat import detector_variables_from_torch
from seevcn_torch.data.synth_da import generate_da_set
from seevcn_torch.experiments import da_experiment as DA
from seevcn_torch.experiments import da_generate as GEN
from seevcn_torch.experiments import da_table as TABLE
from seevcn_torch.testing import completed_rows_apart, one_cpu_thread
from seevcn_torch.utils.ckpt import save_detector_checkpoint
from seevcn_torch.utils.weights import vcn_state_dict_from_flax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
import da_experiment as JDA  # noqa: E402
import da_generate as JGEN  # noqa: E402

POINTS_ATOL = 1e-5
STRAY_ROWS, STRAY_M = 2, 0.1
AP_ATOL = 1e-6



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU runs on one thread: the tier-1 run puts six test
    processes on the host, and there the threads of a multi-threaded
    SECOND-IoU step contend, a step taking tens of seconds."""
    with one_cpu_thread():
        yield

def plain(tree):
    """A Cfg tree of either package as plain dicts and lists."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    return tree


def tiny_cfg(real):
    """JAX's tiny DA grid (64 x 64 x 40, test_synth_da.py:120-127) on
    either package's ``da_detector_cfg``."""
    def cfg(max_pts, mode="zfold"):
        c = real(max_pts, mode)
        c.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -6.4, -3, 12.8, 6.4, 1]
        c.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS = {"train": 2000,
                                                               "test": 2000}
        return c
    return cfg


def tiny_set(path, n=5, p=800):
    """JAX's eval set of test_synth_da.py:135-150: random points and two
    car boxes a frame."""
    rng = np.random.RandomState(7)
    pts = np.zeros((n, p, 3), np.float32)
    pts[..., 0] = rng.uniform(0.5, 12.0, (n, p))
    pts[..., 1] = rng.uniform(-6.0, 6.0, (n, p))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (n, p))
    gtb = np.zeros((n, 2, 8), np.float32)
    gtb[..., 0] = rng.uniform(3, 10, (n, 2))
    gtb[..., 1] = rng.uniform(-4, 4, (n, 2))
    gtb[..., 2] = -1.0
    gtb[..., 3:6] = [4.2, 1.9, 1.8]
    gtb[..., 7] = 1
    np.savez(path, points=pts, valid=np.ones((n, p), bool), gt_boxes=gtb,
             gt_mask=np.ones((n, 2), bool))
    return str(path)


@pytest.mark.parametrize("mode", ["zfold", "sparse"])
def test_da_detector_cfg_matches_jax(mode):
    assert plain(DA.da_detector_cfg(22000, mode)) == plain(JDA.da_detector_cfg(22000, mode))


@pytest.mark.parametrize("n", [12, 0])
def test_lidar_boxes_to_annos_matches_jax(n):
    rng = np.random.RandomState(2)
    boxes = rng.uniform(-3, 3, (n, 7)).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32) if n else None
    for s in (None, scores):
        got, ref = DA.lidar_boxes_to_annos(boxes, s), JDA._lidar_boxes_to_annos(boxes, s)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_generated_files_equal_jax(tmp_path):
    for pkg, gen in (("port", GEN), ("jax", JGEN)):
        os.makedirs(tmp_path / pkg)
        gen.gen_set(str(tmp_path / pkg / "tgt_val.npz"), 300, 2, 16, 2.0)
        gen.gen_vc(str(tmp_path / pkg / "vc_data"), 400, 1)
    with zipfile.ZipFile(tmp_path / "port" / "tgt_val.npz") as a, \
            zipfile.ZipFile(tmp_path / "jax" / "tgt_val.npz") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    files = _tree_files(tmp_path / "jax" / "vc_data")
    assert _tree_files(tmp_path / "port" / "vc_data") == files
    assert len(files) >= 3 * 3                       # some cars at each beam count
    for f in files:
        with open(tmp_path / "port" / "vc_data" / f, "rb") as a, \
                open(tmp_path / "jax" / "vc_data" / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.fixture(scope="module")
def da_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("da_set")
    pts, val, gtb, gtm = generate_da_set(5, 2, 16, max_pts=4000)
    path = str(d / "set.npz")
    np.savez(path, points=pts, valid=val, gt_boxes=gtb, gt_mask=gtm)
    return path


@pytest.mark.parametrize("model", ["VCN_VC", "VCN_CN"])
def test_complete_matches_jax(tmp_path, da_set, model):
    net = jax_build_vcn(model)
    init_in = {"input": jnp.zeros((1, 1024, 3))}
    if model == "VCN_CN":
        init_in["gt_boxes"] = jnp.asarray([[0, 0, 0, 4.2, 1.9, 1.6, 0.0]], jnp.float32)
    variables = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(1), init_in))
    with open(tmp_path / "vcn.pkl", "wb") as f:
        pickle.dump({"variables": variables}, f)
    torch.save({"base_model": vcn_state_dict_from_flax(variables, model)},
               tmp_path / "vcn.pth")
    JDA.cmd_complete(argparse.Namespace(cpu=False, set=da_set, vcn=str(tmp_path / "vcn.pkl"),
                                        model=model, out=str(tmp_path / "jax.npz")))
    got = DA.main(["complete", "--set", da_set, "--vcn", str(tmp_path / "vcn.pth"),
                   "--model", model, "--out", str(tmp_path / "port.npz"), "--cpu"])
    assert got["frames"] == 2 and np.isfinite(got["in_box"])
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    assert a["points"].shape == (2, 4000 + 8 * 1024, 3)
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert a["valid"][:, 4000:].any()                # completions were spliced
    np.testing.assert_allclose(a["points"][:, :4000], b["points"][:, :4000], rtol=0,
                               atol=POINTS_ATOL)
    rows = completed_rows_apart(*(x["points"][:, 4000:].reshape(2, 8, 1024, 3) for x in (a, b)),
                                POINTS_ATOL)
    assert rows["stray_rows_max"] <= STRAY_ROWS and rows["rows_apart_max"] <= STRAY_M, rows
    for k in ("gt_boxes", "gt_mask"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("flip", [False, True])
def test_batch_assembly_matches_jax(flip):
    rng = np.random.RandomState(3)
    pts = rng.randn(6, 50, 3).astype(np.float32)
    val = rng.rand(6, 50) > 0.3
    gt = rng.randn(6, 4, 8).astype(np.float32)
    idx = np.array([4, 0, 4, 2])
    got = DA.assemble_batch(torch.from_numpy(pts), torch.from_numpy(val), torch.from_numpy(gt),
                            torch.from_numpy(idx), torch.tensor(flip))
    # scripts/da_experiment.py:244-246
    flip_p = jnp.asarray([1.0, -1.0, 1.0], jnp.float32)
    flip_g = jnp.asarray([1, -1, 1, 1, 1, 1, -1, 1], jnp.float32)
    jflip = jnp.asarray(flip)
    ref = (jnp.asarray(pts)[idx] * jnp.where(jflip, flip_p, 1.0), jnp.asarray(val)[idx],
           jnp.asarray(gt)[idx] * jnp.where(jflip, flip_g, 1.0))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_draws_follow_the_step():
    """A step's draws depend on (seed, step) only: what a resumed run relies on."""
    a = DA.draw_batch(DA.step_generator(0, 5, "cpu"), 10, 4)
    b = DA.draw_batch(DA.step_generator(0, 5, "cpu"), 10, 4)
    c = DA.draw_batch(DA.step_generator(0, 6, "cpu"), 10, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) or not torch.equal(a[1], c[1])
    assert (0 <= a[0]).all() and (a[0] < 10).all()


class Killed(Exception):
    pass


def test_train_resume_is_bit_exact(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(DA, "da_detector_cfg", tiny_cfg(DA.da_detector_cfg))
    train_set = tiny_set(tmp_path / "train.npz")
    args = ["train", "--train", train_set, "--steps", "4", "--batch", "2", "--log_every", "1",
            "--ckpt_every", "2", "--cpu"]
    whole = DA.main(args + ["--out", str(tmp_path / "whole")])
    assert len(whole["losses"]) == 4 and np.isfinite(whole["losses"]).all()

    real_step, calls = DA.train_step, []

    def killed_at_step_3(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise Killed
        return real_step(*a, **kw)

    monkeypatch.setattr(DA, "train_step", killed_at_step_3)
    with pytest.raises(Killed):
        DA.main(args + ["--out", str(tmp_path / "cut")])
    monkeypatch.setattr(DA, "train_step", real_step)
    resumed = DA.main(args + ["--out", str(tmp_path / "cut"), "--resume"])
    assert resumed["start"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    ref = whole["state"].model.state_dict()
    for k, v in resumed["state"].model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    ck = [torch.load(tmp_path / d / "ckpt.pth", weights_only=False) for d in ("whole", "cut")]
    assert ck[0]["it"] == ck[1]["it"] == 4
    assert ck[0]["total_steps"] == 4 and ck[0]["cfg_mode"] == "zfold"
    for k, v in ck[0]["model_state"].items():
        assert torch.equal(v, ck[1]["model_state"][k]), k

    # an unreadable checkpoint: a fresh start, not a crash
    with open(tmp_path / "cut" / "ckpt.pth", "wb") as f:
        f.write(b"\x80\x02truncated")
    capsys.readouterr()
    fresh = DA.main(args[:4] + ["1"] + args[5:] + ["--out", str(tmp_path / "cut"), "--resume"])
    assert fresh["start"] == 0
    assert "resume skipped" in capsys.readouterr().out


def test_eval_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(DA, "da_detector_cfg", tiny_cfg(DA.da_detector_cfg))
    monkeypatch.setattr(JDA, "da_detector_cfg", tiny_cfg(JDA.da_detector_cfg))
    set_path = tiny_set(tmp_path / "set.npz")
    model, _ = DA.build_detector(DA.da_detector_cfg(800), device="cpu")
    sd = seeded_state_dict(0, model, random_stats=True)
    variables = jax.tree.map(np.asarray, detector_variables_from_torch(sd, "SECONDNetIoU"))
    with open(tmp_path / "ckpt.pkl", "wb") as f:
        pickle.dump({"params": variables["params"], "batch_stats": variables["batch_stats"],
                     "cfg_mode": "zfold"}, f)
    save_detector_checkpoint(str(tmp_path / "ckpt.pth"), sd)
    ref = JDA.cmd_eval(argparse.Namespace(
        cpu=False, ckpt=str(tmp_path / "ckpt.pkl"), set=set_path, mode="zfold",
        score_thresh=0.0, eval_batch=5, out_json=None))
    got = {}
    for b in (1, 3):
        got[b] = DA.main(["eval", "--ckpt", str(tmp_path / "ckpt.pth"), "--set", set_path,
                          "--score_thresh", "0.0", "--eval_batch", str(b),
                          "--out_json", str(tmp_path / f"b{b}.json"), "--cpu"])
    assert ref["n_dets"] > 0
    assert got[1]["n_dets"] == got[3]["n_dets"] == ref["n_dets"]
    for k in ("ap_3d_07_r40", "ap_bev_07_r40"):
        assert got[1][k] == got[3][k]
        assert abs(got[1][k] - ref[k]) <= AP_ATOL
    assert json.load(open(tmp_path / "b3.json")) == json.loads(json.dumps(got[3]))


def test_da_table_rows(tmp_path):
    with open(tmp_path / "ap_raw_tgt.json", "w") as f:
        json.dump({"ap_3d_07_r40": 1.94, "ap_bev_07_r40": 3.5, "n_frames": 128}, f)
    with open(tmp_path / "ap_extra.json", "w") as f:
        json.dump({}, f)
    lines = TABLE.main(["--protocol", "da2", str(tmp_path)])
    assert lines[0] == "| detector | eval set | 3D AP | BEV AP | frames |"
    assert "| raw | tgt val (16-beam, raw) | 1.94 | 3.50 | 128 |" in lines
    assert lines.count("| raw | src val (64-beam, raw) | — | — | — |") == 1
    assert lines[-1] == f"(unlisted: {tmp_path / 'ap_extra.json'})"
    assert len(TABLE.table(str(tmp_path), "da3")) == 2 + 7 + 2


def test_car_obj_equals_jax(tmp_path):
    import train_vcn_synthetic as JSYN          # scripts/, on the path above

    from seevcn_torch.experiments import train_vcn_synthetic as SYN

    for pkg, mod in (("port", SYN), ("jax", JSYN)):
        mod.write_car_obj(str(tmp_path / f"{pkg}.obj"), np.random.RandomState(0))
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()


@pytest.mark.parametrize("script", ["train_vcn_da", "train_vcn_synthetic"])
def test_vcn_trainers_write_loadable_checkpoints(tmp_path, script):
    """Each trainer's entry point at a small size on the CPU: one epoch, its
    checkpoint the reference's VCN .pth, equal to the trained net."""
    from seevcn_torch.experiments import train_vcn_da, train_vcn_synthetic
    from seevcn_torch.utils.ckpt import load_vcn_checkpoint

    out = str(tmp_path / "out")
    if script == "train_vcn_da":
        GEN.gen_vc(str(tmp_path / "vc"), 400, 1)
        _, state = train_vcn_da.main(["--epochs", "1", "--batch_size", "4", "--data",
                                      str(tmp_path / "vc"), "--out", out, "--model", "VCN_CN",
                                      "--cpu"])
        model = "VCN_CN"
    else:
        _, state = train_vcn_synthetic.main(["--epochs", "1", "--batch_size", "4", "--meshes",
                                             "2", "--poses", "4", "--out", out, "--cpu"])
        model = "VCN_VC"
    sd = load_vcn_checkpoint(os.path.join(out, "ckpt-last.pth"), model)
    live = state.model.state_dict()
    for k, v in sd.items():
        assert torch.equal(v.reshape(live[k].shape), live[k]), k
