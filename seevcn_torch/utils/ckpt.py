"""Reference ``.pth`` checkpoints: read them into the port's state dicts and
write the port's detector back in the reference's format.

The port's own copy of the ``.pth`` side of seevcn_tpu/utils/ckpt_compat.py
(``load_torch_checkpoint``, ``state_dict_to_numpy``, ``spconv3d_weight``,
``load_vcn_checkpoint``, ``load_detector_checkpoint``,
``save_detector_checkpoint``). The reference ships VCN weights as
``{'base_model': state_dict, ...}`` (see/.../models/VCN.py:35-37) and
OpenPCDet detectors as ``{'model_state': state_dict, 'epoch', 'it',
'optimizer_state', 'version'}`` (train_utils.py:145-178). The port's modules
keep the reference's key names, so a loader only unwraps, strips a DDP
``module.`` prefix, keeps the keys the JAX importer reads and normalises
the layouts; the result loads with ``strict=True``.

Two layouts differ between checkpoints. A VCN_VC file holds ``final_conv.*``,
which its forward never uses: the loader drops it. A spconv weight is stored
(out, kz, ky, kx, in) by spconv 2.x and (kz, ky, kx, in, out) by 1.x, the
layout OpenPCDet-era files carry: the loader reads both into the port's 2.x
parameter.

No CenterPoint or Voxel R-CNN ``.pth`` is read: the JAX package's
``ckpt_compat`` has no importer for either (OpenPCDet's CenterHead keeps
its branches' BN and a ``heads_list``, and its VoxelRCNNHead its
``roi_grid_pool_layers``, none of which the JAX package's modules hold),
and the port's loader reads what the JAX importer reads. Nor is a
PointRCNN or Part-A2 ``.pth``: ``ckpt_compat`` has no importer for either.
Their weights come from the JAX package's flax trees
(``utils/weights.py``). CaDDN's image backbone reads torchvision's
DeepLabV3 file (``deeplabv3_state_dict_from_torch``), the one file the JAX
importer reads for it.
"""
from __future__ import annotations

import numpy as np
import torch

# the detector's modules that hold weights; a real OpenPCDet file also holds
# Detector3DTemplate's ``global_step`` buffer, which nothing reads
_DETECTOR_MODULES = ("backbone_3d.", "backbone_2d.", "dense_head.", "roi_head.")


def load_torch_checkpoint(path: str) -> dict:
    """Read a torch ``.pth`` pickle onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def state_dict_to_numpy(state_dict, strip_module: bool = True) -> dict:
    """{key: numpy array}, without a DDP ``module.`` prefix."""
    out = {}
    for k, v in state_dict.items():
        if strip_module and k.startswith("module."):
            k = k[len("module."):]
        out[k] = _np(v)
    return out


def spconv3d_weight(sd: dict, prefix: str) -> np.ndarray:
    """A spconv weight in either on-disk layout -> the port's spconv 2.x
    parameter (out, kz, ky, kx, in).

    The reference's sniff, as written: kernel dims are small (1 or 3); a
    shape whose dims 1-3 are kernel-sized and whose dims 0-2 are not is 2.x;
    anything else is 1.x (kz, ky, kx, in, out), which also wins when both
    readings fit."""
    w = sd[f"{prefix}.weight"]
    if w.ndim != 5:
        raise ValueError(f"{prefix}: spconv weight of shape {w.shape}")
    looks_1x = all(s <= 3 for s in w.shape[0:3])
    looks_2x = all(s <= 3 for s in w.shape[1:4])
    if looks_2x and not looks_1x:
        return w
    return np.transpose(w, (4, 0, 1, 2, 3))


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def vcn_state_dict_from_torch(state_dict, model_name: str) -> dict:
    """A reference VCN_CN / VCN_VC state dict -> the port's, for
    ``build_vcn(model_name)``: ``module.`` stripped, ``final_conv.*`` (a
    VCN_VC layer its forward never uses) dropped. A batch-norm counter the
    file lacks is written as 0, as the flax exporters write it."""
    from ..models.vcn.nets import build_vcn

    sd = state_dict_to_numpy(state_dict)
    out = {}
    for k, v in build_vcn(model_name).state_dict().items():
        if k in sd:
            out[k] = sd[k]
        elif k.endswith("num_batches_tracked"):
            out[k] = np.zeros(v.shape, np.int64)
        else:
            raise KeyError(f"{model_name} checkpoint has no {k}")
    return _tensors(out)


def load_vcn_checkpoint(path: str, model_name: str) -> dict:
    """A reference VCN checkpoint (``{'base_model': ...}`` or a bare state
    dict) -> the port's state dict, which ``VCNInference`` loads strictly."""
    ckpt = load_torch_checkpoint(path)
    return vcn_state_dict_from_torch(ckpt.get("base_model", ckpt), model_name)


def detector_state_dict_from_torch(state_dict) -> dict:
    """An OpenPCDet SECOND-IoU state dict -> the port's: ``module.``
    stripped, only the weight modules' keys kept (``global_step`` goes), every
    spconv weight in the 2.x layout."""
    sd = state_dict_to_numpy(state_dict)
    out = {}
    for k, v in sd.items():
        if not k.startswith(_DETECTOR_MODULES):
            continue
        if k.startswith("backbone_3d.") and k.endswith(".weight") and v.ndim == 5:
            v = spconv3d_weight(sd, k[:-len(".weight")])
        out[k] = v
    return _tensors(out)


def load_detector_checkpoint(path: str) -> dict:
    """A reference detector checkpoint (``{'model_state': ...}`` or a bare
    state dict) -> the port's state dict, which ``build_detector`` loads
    strictly."""
    ckpt = load_torch_checkpoint(path)
    return detector_state_dict_from_torch(ckpt.get("model_state", ckpt))


def save_detector_checkpoint(path: str, model, epoch: int = 0, it: int = 0):
    """Write an OpenPCDet-format detector ``.pth`` (train_utils.py:145-178):
    the reference's schema and its legacy, non-zipfile pickle, so reference
    tooling reads it as it reads its own. ``model`` is the port's detector
    or its state dict; spconv weights go out in the 2.x layout."""
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    torch.save({"epoch": epoch, "it": it,
                "model_state": {k: v.detach().cpu().clone() for k, v in sd.items()},
                "optimizer_state": None, "version": "seevcn_torch+0.1"},
               path, _use_new_zipfile_serialization=False)


def deeplabv3_state_dict_from_torch(state_dict, num_classes: int) -> dict:
    """A torchvision deeplabv3_resnet50 / 101 state dict (the file CaDDN's
    DDN loads, ddn_template.py get_model) -> the port's ``DDNDeepLabV3``
    state dict (the same names): ``module.`` stripped, ``aux_classifier.*``
    dropped, and the last classifier conv ``classifier.4.*`` dropped when
    its class count is not ``num_classes`` (ddn_template.py:86-106's
    filter; the module then keeps its own init for it, as ckpt_compat's
    ``deeplabv3_variables_from_torch`` leaves that leaf out). A batch-norm
    counter the file lacks is written as 0."""
    sd = state_dict_to_numpy(state_dict)
    out = {k: v for k, v in sd.items() if not k.startswith("aux_classifier.")}
    if out["classifier.4.weight"].shape[0] != num_classes:
        out = {k: v for k, v in out.items() if not k.startswith("classifier.4.")}
    for k in [k for k in out if k.endswith(".running_var")]:
        out.setdefault(k.replace("running_var", "num_batches_tracked"), np.zeros((), np.int64))
    return _tensors(out)


def load_ddn_weights(ddn, state_dict) -> list:
    """Load ``deeplabv3_state_dict_from_torch``'s dict into a DDNDeepLabV3
    (``model.ddn`` of CaDDN): strictly, but for a dropped ``classifier.4``,
    which keeps its init. -> the names that kept their init."""
    missing, unexpected = ddn.load_state_dict(state_dict, strict=False)
    kept = sorted(missing)
    if unexpected or any(not k.startswith("classifier.4.") for k in kept):
        raise KeyError(f"DeepLabV3 state dict: missing {kept}, unexpected {unexpected}")
    return kept
