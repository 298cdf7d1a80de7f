"""VCN training in the port against the JAX package on the CPU: both nets'
loss terms and gradients, VCNTrainer.train_step against JAX's jitted
train_step (SGD and Adam), step_per_update against optax.MultiSteps, the
learning-rate schedules and optimizers against optax, fit with validation,
checkpoints and images, and the CLI.

Sizes: num_coarse 128, N 128 input points, 256 complete points, batch 4;
the flax weights go across through vcn_state_dict_from_flax. Tolerances:
loss terms and running statistics 1e-5 (absolute and relative); gradients
5e-4 of each tensor's largest. A bias whose effect a batch norm in
training takes out has a gradient of 0 in exact arithmetic, so both sides
read rounding noise there: it is held under 1e-5 of its layer's largest
weight gradient on both sides instead (seevcn_torch.testing). The
max-pools send a channel's gradient to the point that holds its maximum;
where the runner-up is within the two frameworks' rounding of it (their
features agree to about 5e-6), the two can pick different points, and the
gradients then differ by design. So each comparison first checks that
every max-pool of both packages picks the same point for every channel.
Every JAX call is jitted, and each JAX model is initialised once per
module.
"""
import os
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seevcn_tpu.cli import train_vcn as jax_cli
from seevcn_tpu.models.vcn.nets import build_vcn as jax_build_vcn
from seevcn_tpu.models.vcn.runner import VCNTrainer as JaxTrainer
from seevcn_tpu.models.vcn.runner import build_vcn_optimizer as jax_build_opt
from seevcn_tpu.utils.ckpt_compat import load_vcn_checkpoint as jax_load_vcn
from seevcn_tpu.utils.config import Cfg as JaxCfg
from seevcn_torch.cli import train_vcn as cli
from seevcn_torch.models.vcn.dataset import VCDataset
from seevcn_torch.models.vcn.runner import VCNTrainer, init_vcn_weights
from seevcn_torch.models.vcn.nets import build_vcn
from seevcn_torch.testing import (VCN_BIASES_BEFORE_BN, assert_close,
                                  assert_vcn_grads_close, to_numpy, to_torch,
                                  vcn_loss_selections, vcn_pool_points,
                                  vcn_selection_flips)
from seevcn_torch.train.optim import MultiSteps, build_vcn_optimizer
from seevcn_torch.utils.config import Cfg
from seevcn_torch.utils.weights import vcn_state_dict_from_flax

B, N, M, NC = 4, 128, 256, 128
NAMES = ("VCN_VC", "VCN_CN")
VC_LOSSES = ["coarse", "partial", "translation", "rotation", "dims"]


def make_batch(seed, b=B, n=N, m=M):
    """Car-sized objects 8-20 m from the sensor: complete points on the
    surface of each GT box, the input a visible subset of them with noise."""
    rng = np.random.RandomState(seed)
    gt = np.concatenate([rng.uniform(8, 20, (b, 1)), rng.uniform(-6, 6, (b, 1)),
                         rng.uniform(-1, 0, (b, 1)), rng.uniform(3.8, 4.6, (b, 1)),
                         rng.uniform(1.6, 1.9, (b, 1)), rng.uniform(1.4, 1.6, (b, 1)),
                         rng.uniform(-np.pi, np.pi, (b, 1))], 1).astype(np.float32)
    comp = rng.uniform(-0.5, 0.5, (b, m, 3))
    face = rng.randint(0, 3, (b, m))
    np.put_along_axis(comp, face[..., None], np.sign(np.take_along_axis(
        comp, face[..., None], -1)) * 0.5, -1)
    comp = comp * gt[:, None, 3:6]
    c, s = np.cos(gt[:, 6])[:, None], np.sin(gt[:, 6])[:, None]
    comp = np.stack([comp[..., 0] * c - comp[..., 1] * s,
                     comp[..., 0] * s + comp[..., 1] * c, comp[..., 2]], -1) + gt[:, None, :3]
    near = np.argsort(np.linalg.norm(comp, axis=-1), axis=1)[:, :m // 2]
    pick = np.take_along_axis(near, rng.randint(0, m // 2, (b, n)), 1)
    inp = np.take_along_axis(comp, pick[..., None], 1) + rng.randn(b, n, 3) * 0.01
    return {"input": inp.astype(np.float32), "complete": comp.astype(np.float32),
            "gt_boxes": gt}


_VARS = {}


def flax_model(name):
    """(flax module, its init as numpy), once per module and name."""
    if name not in _VARS:
        model = jax_build_vcn(name, num_coarse=NC)
        inp = {"input": jnp.zeros((2, 64, 3)), "gt_boxes": jnp.ones((2, 7))}
        _VARS[name] = (model, jax.tree.map(np.asarray,
                                           model.init(jax.random.PRNGKey(3), inp)))
    return _VARS[name]


def torch_net(name, variables):
    net = build_vcn(name, num_coarse=NC)
    net.load_state_dict(vcn_state_dict_from_flax(variables, name), strict=True)
    return net.train()


def as_state_dict(tree, stats, name):
    """A flax params-shaped tree (gradients, updated params) in the port's key
    names."""
    return vcn_state_dict_from_flax({"params": tree, "batch_stats": stats}, name)


def check_group(got: dict, ref: dict, kind: str):
    if kind == "grad":
        assert_vcn_grads_close(got, ref)
        return
    for k, r in ref.items():
        assert_close(got[k], to_numpy(r), atol=1e-5, rtol=1e-5, name=k)


_POOL = {}


def jax_pool_points(name, params, stats, batch):
    """The points JAX's max-pools pick in training, (B, C) each: the pose
    encoder's (VCN_VC), then the feature encoder's two."""
    if name not in _POOL:
        model = flax_model(name)[0]

        @jax.jit
        def f(params, stats, batch):
            _, st = model.apply({"params": params, "batch_stats": stats}, batch,
                                train=True, capture_intermediates=True,
                                mutable=["batch_stats", "intermediates"])
            it = st["intermediates"]
            enc = [it["encoder"][m]["__call__"][0] for m in ("mlp_conv1", "mlp_conv2")]
            if "pose_encoder" in it:                # its dense2 output, before the max
                enc.insert(0, it["pose_encoder"]["dense2"]["__call__"][0].reshape(
                    batch["input"].shape[0], -1, 1024))
            return [e.argmax(1) for e in enc]
        _POOL[name] = f
    return [np.asarray(a) for a in _POOL[name](params, stats, batch)]


def assert_same_pool_points(picks, ref):
    assert len(picks) == len(ref)
    for p, r in zip(picks, ref):
        assert np.array_equal(p.numpy(), r), \
            "precondition: a max-pool picks another point in JAX"


@pytest.mark.parametrize("name", NAMES)
def test_losses_gradients_and_bn_statistics_match_jax(name):
    model, variables = flax_model(name)
    batch = make_batch(2)

    @jax.jit
    def jax_loss(params, batch):
        def f(p):
            out, mut = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                   batch, train=True, mutable=["batch_stats"])
            terms = model.loss(out, batch)
            return sum(terms.values()), (terms, mut["batch_stats"])
        return jax.value_and_grad(f, has_aux=True)(params)

    (_, (terms, stats)), grads = jax_loss(variables["params"], batch)
    net = torch_net(name, variables)
    t_in = {k: to_torch(v) for k, v in batch.items()}
    with vcn_pool_points(net) as picks:
        got = net.loss(net(t_in), t_in)
    assert_same_pool_points(picks, jax_pool_points(
        name, variables["params"], variables["batch_stats"], batch))
    sum(got.values()).backward()

    assert set(got) == set(terms)
    assert len(got) == (5 if name == "VCN_VC" else 2)
    for k in terms:
        assert_close(got[k].detach(), np.asarray(terms[k]), atol=1e-5, rtol=1e-5, name=k)
    ref_sd = as_state_dict(jax.tree.map(np.asarray, grads), stats, name)
    named = dict(net.named_parameters())
    check_group({k: p.grad for k, p in named.items()},
                {k: ref_sd[k] for k in named}, "grad")
    sd = net.state_dict()
    check_group(sd, {k: v for k, v in as_state_dict(variables["params"], stats, name).items()
                     if "running" in k}, "stats")
    assert all(float(p.grad.abs().max()) > 0 for k, p in named.items()
               if k not in VCN_BIASES_BEFORE_BN)


@pytest.mark.parametrize("name", NAMES)
def test_pinned_loss_choices_reproduce_the_loss(name):
    """vcn_loss_selections, which the card's gradient check pins to the
    CPU's choices: the losses run with a record's own choices pinned give
    the same terms (1e-6) and gradients (1e-5 of each tensor's largest) as
    the losses that made them, and make the same choices; a pinned choice
    that differs moves the loss, so the pin is taken."""
    _, variables = flax_model(name)
    t_in = {k: to_torch(v) for k, v in make_batch(2).items()}

    def run(pinned=None):
        net = torch_net(name, variables)
        with vcn_loss_selections(pinned) as made:
            terms = net.loss(net(t_in), t_in)
        sum(terms.values()).backward()
        return terms, {k: p.grad for k, p in net.named_parameters()}, made

    terms, grads, made = run()
    assert [w for w, _ in made if not w.startswith("geodesic")] == [
        "fps indices #1", "partial-mesh top-k mask #1", "partial-mesh top-k mask #2",
        "chamfer nearest 1->2 #1", "chamfer nearest 2->1 #1",
        "chamfer nearest 1->2 #2", "chamfer nearest 2->1 #2"]
    p_terms, p_grads, p_made = run(made)
    assert all(n == 0 for n, _ in vcn_selection_flips(p_made, made).values())
    for k in terms:
        assert_close(p_terms[k].detach(), terms[k].detach(), atol=1e-6, rtol=1e-6, name=k)
    assert_vcn_grads_close(p_grads, grads, tol=1e-5)
    other = [(w, s.flip(-1)) if w == "fps indices #1" else (w, s) for w, s in made]
    moved, _, _ = run(other)
    assert float((moved["coarse"] - terms["coarse"]).detach().abs()) > 1e-3


def _jax_trainer(cfg, name, tmp_path):
    tr = JaxTrainer(JaxCfg(cfg), work_dir=str(tmp_path / "jax"))
    tr.model = jax_build_vcn(name, num_coarse=NC)
    return tr


def _port_trainer(cfg, name, variables, tmp_path, total_steps=10):
    tr = VCNTrainer(Cfg(cfg), work_dir=str(tmp_path / "port"), device="cpu")
    tr.model = build_vcn(name, num_coarse=NC)   # the JAX trainer's override
    state = tr.init_state(total_steps)
    state.model.load_state_dict(vcn_state_dict_from_flax(variables, name))
    return tr, state


def _vc_cfg(opt, **extra):
    return {"model": {"NAME": "VCN_VC"}, "losses": VC_LOSSES,
            "loss_weights": [1.0, 1.0, 10.0, 1.0, 1.0], "optimizer": opt,
            "scheduler": {"type": "StepLR", "kwargs": {"step_size": 1, "gamma": 0.5}},
            **extra}


@pytest.mark.parametrize("opt", [
    {"type": "SGD", "kwargs": {"lr": 1e-3, "momentum": 0.9}},
    {"type": "Adam", "kwargs": {"lr": 1e-3, "weight_decay": 0.1}}],
    ids=["sgd", "adam"])
def test_two_train_steps_match_jax(opt, tmp_path):
    """Two steps on two batches, each from JAX's weights before it (the
    optimizer keeps its own moments): losses and running statistics within
    1e-5; parameters within 1e-5 where the gradient was sure in both steps
    (5% of its tensor's largest), and, as Adam's first step is
    lr g / (|g| + 1e-8), within 2 lr elsewhere."""
    cfg = _vc_cfg(opt)
    _, variables = flax_model("VCN_VC")
    jtr = _jax_trainer(cfg, "VCN_VC", tmp_path)
    jstate = jtr.init_state(make_batch(0), total_steps=10)
    jstate = {**jstate, "params": jax.tree.map(jnp.asarray, variables["params"]),
              "batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"]),
              "opt_state": jtr.tx.init(variables["params"])}
    tr, state = _port_trainer(cfg, "VCN_VC", variables, tmp_path)
    lr = opt["kwargs"]["lr"]
    sure = {}
    for i, seed in enumerate((7, 8)):
        batch = make_batch(seed)
        state.model.load_state_dict(as_state_dict(
            jax.tree.map(np.asarray, jstate["params"]),
            jax.tree.map(np.asarray, jstate["batch_stats"]), "VCN_VC"))
        pool = jax_pool_points("VCN_VC", jstate["params"], jstate["batch_stats"], batch)
        jstate, jm = jtr.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        with vcn_pool_points(state.model) as picks:
            m = tr.train_step(state, {k: to_torch(v) for k, v in batch.items()})
        assert_same_pool_points(picks, pool)
        assert list(m) == ["loss", "dims", "translation", "rotation", "coarse", "partial"]
        for k in jm:
            assert_close(m[k], np.asarray(jm[k]), atol=1e-5, rtol=1e-5, name=f"step {i} {k}")
        ref = as_state_dict(jax.tree.map(np.asarray, jstate["params"]),
                            jax.tree.map(np.asarray, jstate["batch_stats"]), "VCN_VC")
        sd = state.model.state_dict()
        check_group(sd, {k: v for k, v in ref.items() if "running" in k}, "stats")
        for k, p in state.model.named_parameters():
            g = p.grad.abs()
            sure[k] = sure.get(k, True) & (g >= 0.05 * g.max()) & (g >= 1e-6)
            tol = torch.where(sure[k], 1e-5 + 1e-5 * to_torch(ref[k]).abs(), 2 * lr)
            err = (sd[k] - to_torch(ref[k])).abs()
            assert (err <= tol).all(), (i, k, float(err.max()))
            if opt["type"] == "SGD":
                assert_close(sd[k], ref[k], atol=1e-5, rtol=1e-5, name=f"step {i} {k}")
    assert state.step == 2 and int(jstate["step"]) == 2


def test_step_per_update_matches_multisteps(tmp_path):
    """step_per_update=2 over four calls, against optax.MultiSteps: the
    parameters stay put on the first call of each pair, the accumulated mean
    matches JAX's acc_grads, and the second update reads the schedule at
    count 1 (StepLR every update here), not 3."""
    cfg = _vc_cfg({"type": "SGD", "kwargs": {"lr": 1e-2, "momentum": 0.0}},
                  step_per_update=2)
    _, variables = flax_model("VCN_VC")
    jtr = _jax_trainer(cfg, "VCN_VC", tmp_path)
    jstate = jtr.init_state(make_batch(0), total_steps=10)
    jstate = {**jstate, "params": jax.tree.map(jnp.asarray, variables["params"]),
              "batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"]),
              "opt_state": jtr.tx.init(variables["params"])}
    tr, state = _port_trainer(cfg, "VCN_VC", variables, tmp_path)
    assert isinstance(state.optimizer, MultiSteps)
    names = [n for n, _ in state.model.named_parameters()]
    for call in range(4):
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        batch = make_batch(40 + call)
        pool = jax_pool_points("VCN_VC", jstate["params"], jstate["batch_stats"], batch)
        jstate, _ = jtr.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        with vcn_pool_points(state.model) as picks:
            tr.train_step(state, {k: to_torch(v) for k, v in batch.items()})
        assert_same_pool_points(picks, pool)
        ms = jstate["opt_state"]
        assert int(ms.mini_step) == (call + 1) % 2
        assert int(ms.gradient_step) == (call + 1) // 2
        sd = state.model.state_dict()
        stats = jax.tree.map(np.asarray, jstate["batch_stats"])
        acc = as_state_dict(jax.tree.map(np.asarray, ms.acc_grads), stats, "VCN_VC")
        check_group(dict(zip(names, state.optimizer.acc)), {k: acc[k] for k in names}, "grad")
        if call % 2 == 0:
            for k in names:
                assert torch.equal(sd[k], before[k]), k
        ref = as_state_dict(jax.tree.map(np.asarray, jstate["params"]), stats, "VCN_VC")
        check_group(sd, {k: v for k, v in ref.items() if k in names}, "param")
        check_group(sd, {k: v for k, v in ref.items() if "running" in k}, "stats")
    assert state.optimizer.inner.inner.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.5)


def _sched_cfg(kind):
    if kind == "StepLR":
        return {"type": "StepLR", "kwargs": {"step_size": 3, "gamma": 0.7}}
    return {"type": "OneCycleLR"}


@pytest.mark.parametrize("opt,sched", [
    ("SGD", "StepLR"), ("SGD", "OneCycleLR"), ("Adam", "StepLR"),
    ("AdamW", "OneCycleLR"), ("Adam", None)])
def test_optimizer_and_schedule_match_optax(opt, sched):
    """One parameter vector on a fixed quadratic, its minimum far enough
    away that no gradient is near 0 (where Adam's update would be rounding
    noise), for 30 steps of total_steps 400 (StepLR decays every 12): the
    port's optimizer against the JAX package's build_vcn_optimizer, within
    1e-5 (absolute and relative), weight_decay 0.05 given to every
    optimizer (only AdamW reads it, as in the JAX package); the learning
    rate at every count against optax's schedule within 1e-5 (optax's in
    f32, the port's in f64)."""
    total, lr = 400, 0.1
    opt_cfg = {"type": opt, "kwargs": {"lr": lr, "weight_decay": 0.05,
                                       **({"momentum": 0.5} if opt == "SGD" else {})}}
    sched_cfg = _sched_cfg(sched) if sched else None
    tx = jax_build_opt(opt_cfg, sched_cfg, total)
    target = np.linspace(20, 60, 7).astype(np.float32)
    p = jnp.ones(7, jnp.float32)
    st = tx.init(p)

    @jax.jit
    def step(p, st):
        u, st = tx.update(2 * (p - target), st, p)
        return optax.apply_updates(p, u), st

    w = torch.nn.Parameter(torch.ones(7))
    topt = build_vcn_optimizer(opt_cfg, sched_cfg, total, [w])
    ref_sched = (optax.exponential_decay(lr, 3 * 4, 0.7, staircase=True) if sched == "StepLR"
                 else optax.cosine_onecycle_schedule(total, lr) if sched else (lambda c: lr))
    for count in range(30):
        p, st = step(p, st)
        topt.zero_grad()
        ((w - to_torch(target)) ** 2).sum().backward()
        topt.step(count)
        assert_close(w.detach(), np.asarray(p), atol=1e-5, rtol=1e-5, name=f"count {count}")
        assert topt.inner.param_groups[0]["lr"] == pytest.approx(
            float(ref_sched(count)), rel=1e-5)
    assert float(np.abs(np.asarray(p) - 1).min()) > 0.1          # it moved
    if opt != "AdamW":
        assert topt.inner.param_groups[0]["weight_decay"] == 0


def test_init_follows_flax_default_distribution():
    """A fresh port net: lecun-normal kernels (truncated at 2 std, variance
    1 / fan_in, as flax's init draws them), zero biases, identity batch
    norm; the same seed draws the same weights."""
    net = build_vcn("VCN_VC", num_coarse=NC)
    init_vcn_weights(net, torch.Generator().manual_seed(0))
    _, variables = flax_model("VCN_VC")
    ref = variables["params"]["encoder"]["mlp_conv2"]["dense0"]["kernel"]  # (512, 512)
    w = net.encoder.mlp_conv2[0].weight[:, :, 0].detach().numpy()
    assert abs(w.std() / ref.std() - 1) < 0.02
    bound = 2 / np.sqrt(512) / 0.87962566103423978
    assert np.abs(w).max() <= bound * (1 + 1e-6) and np.abs(ref).max() <= bound * (1 + 1e-6)
    sd = net.state_dict()
    assert all(not sd[k].any() for k in sd if k.endswith("bias") and "mlp" not in k)
    assert torch.equal(sd["encoder.mlp_conv1.1.running_var"], torch.ones(128))
    again = build_vcn("VCN_VC", num_coarse=NC)
    init_vcn_weights(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


# --------------------------------------------------------------------------- #
# fit, checkpoints and images; the CLI
# --------------------------------------------------------------------------- #

def make_vc_dir(root, n_models=2, n_views=4):
    """A VC-ShapeNet-layout directory (the JAX package's test layout)."""
    from seevcn_torch.geom.pcd_io import write_pcd

    rng = np.random.RandomState(0)
    for m in range(n_models):
        d = os.path.join(root, f"model{m:03d}")
        os.makedirs(os.path.join(d, "partial"), exist_ok=True)
        complete = (rng.randn(800, 3) * [2, 0.8, 0.6] + [10, 2, 0]).astype(np.float32)
        write_pcd(os.path.join(d, "complete.pcd"), complete)
        labels = {}
        for v in range(n_views):
            sel = rng.choice(800, 120, replace=False)
            write_pcd(os.path.join(d, "partial", f"{v:02d}.pcd"), complete[sel])
            labels[f"{v:02d}"] = {"gtbox": np.array([10, 2, 0, 4.2, 1.8, 1.5, 0.3],
                                                    np.float32)}
        with open(os.path.join(d, "labels.pkl"), "wb") as f:
            pickle.dump(labels, f)


def test_fit_writes_images_checkpoints_and_jax_reads_the_pth(tmp_path):
    make_vc_dir(str(tmp_path / "data"))
    ds = VCDataset(str(tmp_path / "data"), n_points=N, n_complete=M)
    cfg = Cfg({"model": {"NAME": "VCN_CN"}, "losses": ["coarse", "partial"],
               "loss_weights": [1.0, 0.5],
               "optimizer": {"type": "Adam", "kwargs": {"lr": 1e-4}},
               "scheduler": {"type": "StepLR", "kwargs": {"step_size": 10}}})
    tr = VCNTrainer(cfg, work_dir=str(tmp_path / "run"), device="cpu")
    tr.model = build_vcn("VCN_CN", num_coarse=NC)
    logs = []
    state = tr.fit(ds, val_ds=ds, epochs=1, batch_size=4, logger=logs.append)
    assert logs[0].startswith("ep 0 it 0: loss=") and "coarse=" in logs[0]
    assert any(line.startswith("ep 0 val: {'CDL1'") for line in logs)
    vis = tmp_path / "run" / "val_vis"
    pngs = sorted(vis.glob("*.png"))
    assert [p.name for p in pngs] == ["ep000_0.png", "ep000_1.png", "ep000_2.png"]
    for p in pngs:
        data = p.read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
        assert struct.unpack(">II", data[16:24]) == (900, 300)
    assert (vis / "ep000.html").read_text().count("const DATA =") == 1
    for name in ("ckpt-best", "ckpt-last"):
        assert (tmp_path / "run" / f"{name}.pth").exists()
        assert not (tmp_path / "run" / f"{name}.pth.tmp").exists()
    ck = tr.load_checkpoint(str(tmp_path / "run" / "ckpt-last.pth"))
    assert ck["epoch"] == 0 and ck["best_metrics"] == tr.best < np.inf
    sd = state.model.state_dict()
    assert all(torch.equal(ck["base_model"][k], v) for k, v in sd.items())
    variables = jax_load_vcn(str(tmp_path / "run" / "ckpt-last.pth"), "VCN_CN")
    back = vcn_state_dict_from_flax(jax.tree.map(np.asarray, variables), "VCN_CN")
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_cli_args_match_jax_and_main_trains_on_cpu(tmp_path):
    argv = ["--config", "c.yaml", "--data", "d", "--val_data", "v", "--exp_name", "e",
            "--epochs", "2", "--batch_size", "8", "--work_dir", "w", "--resume"]
    got = vars(cli.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == vars(jax_cli.parse_args(argv))
    assert cli.parse_args(argv).device == "cuda"

    make_vc_dir(str(tmp_path / "data"), n_models=1)
    (tmp_path / "vcn.yaml").write_text(
        "model:\n  NAME: VCN_CN\nlosses: [coarse]\nloss_weights: [1.0]\n"
        "optimizer:\n  type: Adam\n  kwargs:\n    lr: 0.001\n"
        "n_points: 64\nn_complete: 128\nmax_epoch: 1\ntotal_bs: 2\n")
    state = cli.main(["--config", str(tmp_path / "vcn.yaml"), "--data",
                      str(tmp_path / "data"), "--work_dir", str(tmp_path / "w"),
                      "--device", "cpu"])
    assert state.step == 2
    assert (tmp_path / "w" / "default" / "ckpt-last.pth").exists()


def test_entry_points_refuse_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg = Cfg({"model": {"NAME": "VCN_VC"}})
    with pytest.raises(RuntimeError, match="CUDA"):
        VCNTrainer(cfg, work_dir=str(tmp_path / "r"))
    (tmp_path / "c.yaml").write_text("model:\n  NAME: VCN_VC\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", str(tmp_path / "c.yaml"), "--data", str(tmp_path)])
