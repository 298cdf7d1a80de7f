"""Carry flax VCN weights into the port's torch modules.

A copy of the VCN export of seevcn_tpu/utils/ckpt_compat.py
(``vcn_state_dict_from_variables``), kept here because the port imports
nothing of the JAX package. It takes the flax variable tree as numpy arrays
(``{"params": ..., "batch_stats": ...}``) and returns a state dict in the
reference's key names, which ``VCNVC`` / ``VCNCN`` load with ``strict=True``.
A flax Dense kernel is (in, out); Conv1d's weight is (out, in, 1) and
Linear's (out, in).
"""
from __future__ import annotations

import numpy as np
import torch


def _dense_to_conv1d(leaf: dict) -> dict:
    out = {"weight": np.asarray(leaf["kernel"]).T[:, :, None]}
    if "bias" in leaf:
        out["bias"] = np.asarray(leaf["bias"])
    return out


def _dense_to_linear(leaf: dict) -> dict:
    out = {"weight": np.asarray(leaf["kernel"]).T}
    if "bias" in leaf:
        out["bias"] = np.asarray(leaf["bias"])
    return out


def _bn_join(params: dict, stats: dict) -> dict:
    return {"weight": np.asarray(params["scale"]),
            "bias": np.asarray(params["bias"]),
            "running_mean": np.asarray(stats["mean"]),
            "running_var": np.asarray(stats["var"]),
            "num_batches_tracked": np.asarray(0, np.int64)}


def vcn_state_dict_from_flax(variables: dict, model_name: str) -> dict:
    """Flax VCNVC/VCNCN variables (numpy leaves) -> torch state dict."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    sd = {}

    def put(prefix, leaf):
        for k, v in leaf.items():
            sd[f"{prefix}.{k}"] = torch.tensor(np.asarray(v))

    for mlp in ("mlp_conv1", "mlp_conv2"):
        for i, ci in enumerate((0, 3)):
            put(f"encoder.{mlp}.{ci}",
                _dense_to_conv1d(p["encoder"][mlp][f"dense{i}"]))
        put(f"encoder.{mlp}.1", _bn_join(p["encoder"][mlp]["bn0"],
                                         s["encoder"][mlp]["bn0"]))
    for i, li in enumerate((0, 2, 4)):
        put(f"shape_fc.{li}", _dense_to_linear(p["shape_fc"][f"fc{i}"]))

    if model_name.upper().endswith("VC"):
        for i, ci in enumerate((0, 2, 4)):
            put(f"pose_encoder.{ci}",
                _dense_to_conv1d(p["pose_encoder"][f"dense{i}"]))
        for i, li in enumerate((0, 2)):
            put(f"pose_fc.{li}", _dense_to_linear(p["pose_fc"][f"fc{i}"]))
    return sd
