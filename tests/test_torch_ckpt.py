"""Reference ``.pth`` checkpoints through the port (seevcn_torch.utils.ckpt)
and through the JAX package's importer (seevcn_tpu.utils.ckpt_compat), at
``_tiny_detector_cfg`` and at VCN_VC's full width. The files are written
here, in the layouts the reference ships:

- a detector by JAX's ``save_detector_checkpoint`` (spconv 2.x), and a copy
  in the spconv 1.x layout with DDP ``module.`` prefixes and OpenPCDet's
  ``global_step`` buffer;
- a detector by the port's ``save_detector_checkpoint``, read by JAX;
- a VCN_VC ``{'base_model': ...}`` file with ``module.`` prefixes and the
  reference's ``final_conv`` layer.

Each file loads on both sides and the two models give equal outputs: the
detector's pre-NMS predictions within 1e-5 (f32 sums in another order,
as tests/test_torch_detector.py holds them) and its kept boxes equal, the
VCN's completions within 1e-4 m.
"""
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_detector_cfg
from chip_smoke import blob_points, seeded_state_dict
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.vcn import inference as JVI
from seevcn_tpu.models.vcn.nets import build_vcn as jax_build_vcn
from seevcn_tpu.utils import ckpt_compat as JC
from seevcn_tpu.utils.config import Cfg as JaxCfg
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.testing import assert_close, to_torch
from seevcn_torch.utils import ckpt as TC
from seevcn_torch.utils.config import Cfg

OUTS = ("batch_cls_preds", "batch_box_preds", "rcnn_iou")


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """The tiny detector's weights (random, with statistics), a .pth written
    by JAX from them, two frames, and the JAX model's eval outputs."""
    ref_sd = seeded_state_dict(0, build_detector(C.tiny_detector_cfg(), device="cpu")[0],
                               random_stats=True)
    variables = JC.detector_variables_from_torch(ref_sd, "SECONDNetIoU")
    path = tmp_path_factory.mktemp("ckpt") / "jax_second_iou.pth"
    JC.save_detector_checkpoint(str(path), jax.tree.map(jnp.asarray, variables))
    frames = [blob_points(seed, 600) for seed in (1, 2)]
    pts, valid = (np.stack(x) for x in zip(*frames))
    model, _ = jax_build(_tiny_detector_cfg())
    fwd = jax.jit(lambda v, p, m: model.apply(v, p, m, train=False))
    return {"path": path, "pts": pts, "valid": valid, "fwd": fwd,
            "ref": _jax_outputs(fwd, JC.load_detector_checkpoint(str(path)), pts, valid)}


def _jax_outputs(fwd, variables, pts, valid):
    out = fwd(jax.tree.map(jnp.asarray, variables), pts, valid)
    return {k: np.asarray(out[k]) for k in OUTS + ("roi_mask",)}


def _port_outputs(sd, pts, valid):
    model, _ = build_detector(C.tiny_detector_cfg(), sd, device="cpu")
    with torch.no_grad():
        return model(to_torch(pts), to_torch(valid))


def _assert_same(got, ref):
    for k in OUTS:
        assert_close(got[k], ref[k], atol=1e-5, rtol=1e-5, name=k)
    assert_close(got["roi_mask"], ref["roi_mask"], name="roi_mask")
    assert ref["roi_mask"].sum() > 0


def test_port_loads_jax_saved_detector(detector):
    d = detector
    sd = TC.load_detector_checkpoint(str(d["path"]))
    _assert_same(_port_outputs(sd, d["pts"], d["valid"]), d["ref"])


def test_port_loads_spconv1x_with_module_prefix_and_global_step(detector, tmp_path):
    """The layout OpenPCDet-era files carry: spconv 1.x (kz, ky, kx, in, out)
    weights, DDP ``module.`` keys and the ``global_step`` buffer."""
    d = detector
    ckpt = torch.load(d["path"], map_location="cpu", weights_only=False)
    sd = {}
    for k, v in ckpt["model_state"].items():
        if k.startswith("backbone_3d.") and v.dim() == 5:
            v = v.permute(1, 2, 3, 4, 0).contiguous()
        sd[f"module.{k}"] = v
    sd["module.global_step"] = torch.tensor(1234)
    ckpt["model_state"] = sd
    path = tmp_path / "spconv1x.pth"
    torch.save(ckpt, path)
    port_sd = TC.load_detector_checkpoint(str(path))
    assert "global_step" not in port_sd
    assert tuple(port_sd["backbone_3d.conv1.0.0.weight"].shape) == (16, 3, 3, 3, 16)
    _assert_same(_port_outputs(port_sd, d["pts"], d["valid"]), d["ref"])
    _assert_same(_port_outputs(port_sd, d["pts"], d["valid"]),
                 _jax_outputs(d["fwd"], JC.load_detector_checkpoint(str(path)),
                              d["pts"], d["valid"]))


def test_jax_loads_port_saved_detector(detector, tmp_path):
    """The port writes OpenPCDet's schema in the legacy (non-zipfile)
    pickle; JAX's loader reads it back to the same model."""
    d = detector
    model, _ = build_detector(C.tiny_detector_cfg(),
                              TC.load_detector_checkpoint(str(d["path"])), device="cpu")
    path = tmp_path / "port_second_iou.pth"
    TC.save_detector_checkpoint(str(path), model, epoch=3, it=42)
    assert not zipfile.is_zipfile(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert set(ckpt) == {"epoch", "it", "model_state", "optimizer_state", "version"}
    assert (ckpt["epoch"], ckpt["it"], ckpt["optimizer_state"]) == (3, 42, None)
    _assert_same(_port_outputs(ckpt["model_state"], d["pts"], d["valid"]),
                 _jax_outputs(d["fwd"], JC.load_detector_checkpoint(str(path)),
                              d["pts"], d["valid"]))


@pytest.mark.parametrize("shape", [(3, 3, 3, 16, 16), (16, 3, 3, 3, 16),
                                   (3, 3, 3, 3, 16), (16, 3, 3, 3, 3),
                                   (3, 1, 1, 64, 128), (128, 3, 1, 1, 64)])
def test_spconv_weight_layout_sniff_matches_jax(shape):
    """Either layout -> the port's 2.x parameter, read as the JAX importer
    reads it: (kz, ky, kx, in, out) after both, for every shape of the
    backbone (1.x wins where both readings fit). (3, 3, 3, 16, 16) is a 1.x
    ``conv1.0.0`` weight, the smallest input that did not load before."""
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = TC.spconv3d_weight({"c.weight": w}, "c")
    ref = JC.spconv3d_weight({"c.weight": w}, "c")                 # (K, in, out)
    assert got.shape[1:4] in ((3, 3, 3), (3, 1, 1))
    assert_close(np.transpose(got, (1, 2, 3, 4, 0)).reshape(ref.shape), ref,
                 name=str(shape))


def test_vcn_checkpoint_with_final_conv_loads_both_ways(tmp_path):
    """A reference VCN_VC file: ``{'base_model': ...}`` with ``module.``
    keys and ``final_conv.*``, which the port's VCNVC has no layer for (its
    forward never used it); strictly loaded as it was, it raised. Through
    the loaders both sides complete two objects alike (1e-4 m)."""
    model = jax_build_vcn("VCN_VC", num_coarse=1024)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), {"input": jnp.zeros((1, 1024, 3))}))
    sd = {f"module.{k}": torch.from_numpy(np.array(v)) for k, v in
          JC.vcn_state_dict_from_variables(variables, "VCN_VC").items()}
    sd["module.final_conv.weight"] = torch.randn(
        3, 1024, 1, generator=torch.Generator().manual_seed(0))
    sd["module.final_conv.bias"] = torch.zeros(3)
    path = tmp_path / "vcn_vc.pth"
    torch.save({"base_model": sd, "epoch": 7}, path)
    with pytest.raises(RuntimeError, match="final_conv"):
        VCNInference("VCN_VC", {k[len("module."):]: v for k, v in sd.items()},
                     device="cpu")

    cfg = {"MODEL": "VCN_VC", "CKPT_PATH": str(path), "NORM_WITH_GT": False,
           "SEL_K_NEAREST": 30, "CLUSTER_EPS": 0.4}
    port = VCNInference.from_cfg(Cfg(cfg), device="cpu")
    ref = JVI.VCNInference.from_cfg(JaxCfg(cfg))
    pc = (np.random.RandomState(1).randn(2, 1024, 3) * [2.0, 0.9, 0.7]).astype(np.float32)
    got = port(to_torch(pc))
    want = np.asarray(ref._forward(ref.variables, jnp.asarray(pc), None))
    assert_close(got[1], want[1], atol=1e-4, name="coarse")
    assert_close(got[3], want[3], atol=1e-4, name="clustered")
