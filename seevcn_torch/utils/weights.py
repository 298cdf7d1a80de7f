"""Carry flax weights into the port's torch modules.

Copies of the VCN and detector exports of seevcn_tpu/utils/ckpt_compat.py
(``vcn_state_dict_from_variables``, ``detector_state_dict_from_variables``),
kept here because the port imports nothing of the JAX package, and the
PV-RCNN, single-stage (SECONDNet, PointPillar), CenterPoint, Voxel R-CNN,
PointRCNN, Part-A2 and CaDDN exports, which the JAX package lacks. Each takes
the flax variable tree as numpy arrays (``{"params": ..., "batch_stats":
...}``) and returns a state dict in the reference's key names, which the
port's modules load with ``strict=True``. The reference has no seg2d
mapping; ``seg2d_state_dict_from_flax`` keeps the flax tree's own names. A
flax Dense kernel is (in, out); Conv1d's weight is (out, in, 1) and
Linear's (out, in); a flax Conv kernel is (kh, kw, in, out), Conv2d's (out,
in, kh, kw); a rulebook sparse-conv kernel is (K, in, out), spconv 2.x's
(out, kz, ky, kx, in).
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


def _conv_to_conv2d(leaf: dict) -> dict:
    out = {"weight": np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1))}
    if "bias" in leaf:
        out["bias"] = np.asarray(leaf["bias"])
    return out


def _convtranspose_to_deconv2d(leaf: dict) -> dict:
    # flax places a transposed conv's taps mirrored with respect to torch's
    # ConvTranspose2d: flip spatially, then (in, out, kh, kw)
    w = np.flip(np.asarray(leaf["kernel"]), axis=(0, 1))
    out = {"weight": np.transpose(w, (2, 3, 0, 1)).copy()}
    if "bias" in leaf:
        out["bias"] = np.asarray(leaf["bias"])
    return out


def _spconv_export(kernel, kz, ky, kx) -> np.ndarray:
    """(K, in, out) -> spconv 2.x (out, kz, ky, kx, in)."""
    kernel = np.asarray(kernel)
    w = kernel.reshape(kz, ky, kx, kernel.shape[1], kernel.shape[2])
    return np.transpose(w, (4, 0, 1, 2, 3))


def _put(sd: dict, prefix: str, leaf: dict) -> None:
    for k, v in leaf.items():
        sd[f"{prefix}.{k}"] = torch.tensor(np.array(v))


def _sparse_layer(sd: dict, key: str, leaf: dict, stats: dict, k=(3, 3, 3)) -> None:
    """A flax SpConvLayer (``kernel``, ``bn``) -> ``{key}.0`` and ``{key}.1``."""
    _put(sd, f"{key}.0", {"weight": _spconv_export(leaf["kernel"], *k)})
    _put(sd, f"{key}.1", _bn_join(leaf["bn"], stats["bn"]))


def _backbone_3d(sd: dict, bb: dict, bbs: dict) -> None:
    """The three 3D backbones, by the flax tree's names: VoxelBackBone8x
    (``conv{i}_down``, ``conv{i}_{j}`` layers), VoxelResBackBone8x (the
    ``conv{i}_{j}`` residual blocks with ``conv1`` and ``conv2``, into
    ``conv{i}.{j + 1}.conv1`` / ``.bn1`` / ``.conv2`` / ``.bn2``) and
    VoxelBackBone8xFocal (``focal{i}`` with ``kernel``, ``kernel_imp`` and
    ``bn``, into ``.conv.0``, ``.conv_imp`` and ``.conv.1``), each stage a
    list in the flax order."""
    order = {1: ["conv1_0"]}
    for i in (2, 3, 4):
        order[i] = [f"conv{i}_down", f"conv{i}_0", f"conv{i}_1"]
    if "conv1_1" in bb:                                   # residual
        order[1] = ["conv1_0", "conv1_1"]
    if "focal1" in bb:
        order[1] = ["focal1", "conv1_0"]
        for i in (2, 3):
            order[i].insert(2, f"focal{i}")
    _sparse_layer(sd, "backbone_3d.conv_input", bb["conv_input"], bbs["conv_input"])
    for i, names in order.items():
        for j, name in enumerate(names):
            key, leaf, st = f"backbone_3d.conv{i}.{j}", bb[name], bbs[name]
            if name.startswith("focal"):
                _sparse_layer(sd, f"{key}.conv", leaf, st)
                _put(sd, f"{key}.conv_imp",
                     {"weight": _spconv_export(leaf["kernel_imp"], 3, 3, 3)})
            elif "conv1" in leaf:                         # a residual block
                for c in ("1", "2"):
                    _put(sd, f"{key}.conv{c}",
                         {"weight": _spconv_export(leaf[f"conv{c}"]["kernel"], 3, 3, 3)})
                    _put(sd, f"{key}.bn{c}", _bn_join(leaf[f"conv{c}"]["bn"],
                                                      st[f"conv{c}"]["bn"]))
            else:
                _sparse_layer(sd, key, leaf, st)
    _sparse_layer(sd, "backbone_3d.conv_out", bb["conv_out"], bbs["conv_out"], (3, 1, 1))


def _backbone_2d(sd: dict, b2: dict, b2s: dict) -> None:
    """BaseBEVBackbone: ``block{i}_down`` and ``block{i}_{j}`` into
    ``blocks.{i}``; ``deblock{i}`` (a ``deconv``, or a ``conv`` for a stride
    below 1) and ``deblock_final`` into ``deblocks``."""
    blocks = sorted({k.split("_")[0] for k in b2 if k.startswith("block")})
    for bi, blk in enumerate(blocks):
        down = f"{blk}_down"
        _put(sd, f"backbone_2d.blocks.{bi}.1",
             {"weight": _conv_to_conv2d(b2[down]["conv"])["weight"]})
        _put(sd, f"backbone_2d.blocks.{bi}.2", _bn_join(b2[down]["bn"], b2s[down]["bn"]))
        layers = sorted(int(k.split("_")[1]) for k in b2
                        if k.startswith(f"{blk}_") and k.split("_")[1].isdigit())
        for j in layers:
            my = f"{blk}_{j}"
            _put(sd, f"backbone_2d.blocks.{bi}.{4 + 3 * j}",
                 {"weight": _conv_to_conv2d(b2[my]["conv"])["weight"]})
            _put(sd, f"backbone_2d.blocks.{bi}.{5 + 3 * j}",
                 _bn_join(b2[my]["bn"], b2s[my]["bn"]))
    names = [f"deblock{i}" for i in range(_count(b2, "deblock"))]
    if "deblock_final" in b2:
        names.append("deblock_final")
    for di, name in enumerate(names):
        leaf = b2[name]
        conv = _convtranspose_to_deconv2d(leaf["deconv"]) if "deconv" in leaf \
            else _conv_to_conv2d(leaf["conv"])
        _put(sd, f"backbone_2d.deblocks.{di}.0", conv)
        _put(sd, f"backbone_2d.deblocks.{di}.1", _bn_join(leaf["bn"], b2s[name]["bn"]))


def _dense_head(sd: dict, dh: dict, dhs: dict) -> None:
    """AnchorHeadSingle (``conv_cls``, ``conv_box``, ``conv_dir_cls``) or
    AnchorHeadMulti (``shared_conv`` + ``shared_bn`` into
    ``shared_conv.{0,1}``, ``head{g}_conv_*`` into ``rpn_heads.{g}.conv_*``,
    the keys of ckpt_compat's ``multi_dense_head_from_torch``)."""
    if "shared_conv" in dh:
        _put(sd, "dense_head.shared_conv.0",
             {"weight": _conv_to_conv2d(dh["shared_conv"])["weight"]})
        _put(sd, "dense_head.shared_conv.1", _bn_join(dh["shared_bn"], dhs["shared_bn"]))
    for name, leaf in dh.items():
        if name.startswith("head") and "_conv_" in name:
            g, conv = name[len("head"):].split("_", 1)
            _put(sd, f"dense_head.rpn_heads.{g}.{conv}", _conv_to_conv2d(leaf))
    for name in ("conv_cls", "conv_box", "conv_dir_cls"):
        if name in dh:
            _put(sd, f"dense_head.{name}", _conv_to_conv2d(dh[name]))


def _rpn_state_dict(p: dict, s: dict) -> dict:
    """The anchor RPN's modules: backbone_3d (where there is one),
    backbone_2d and dense_head."""
    sd = {}
    if "backbone_3d" in p:
        _backbone_3d(sd, p["backbone_3d"], s["backbone_3d"])
    _backbone_2d(sd, p["backbone_2d"], s["backbone_2d"])
    _dense_head(sd, p["dense_head"], s.get("dense_head", {}))
    return sd


def single_stage_state_dict_from_flax(variables: dict) -> dict:
    """Flax SECONDNet or PointPillar variables (numpy leaves) -> torch state
    dict of the port's model: the RPN as ``_rpn_state_dict`` gives it, and
    PointPillar's ``vfe.pfn{i}`` (``linear``, ``norm``) into OpenPCDet's
    ``vfe.pfn_layers.{i}.linear`` / ``.norm``."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _rpn_state_dict(p, s)
    for i in range(_count(p.get("vfe", {}), "pfn")):
        leaf, st = p["vfe"][f"pfn{i}"], s["vfe"][f"pfn{i}"]
        _put(sd, f"vfe.pfn_layers.{i}.linear", _dense_to_linear(leaf["linear"]))
        _put(sd, f"vfe.pfn_layers.{i}.norm", _bn_join(leaf["norm"], st["norm"]))
    return sd


def _count(tree: dict, prefix: str) -> int:
    return len([k for k in tree if k.startswith(prefix) and k[len(prefix):].isdigit()])


def _fc_stack(sd: dict, key: str, r: dict, rs: dict, fc: str, bn: str,
              out: str | None = None) -> None:
    """A flax Dense + BatchNorm stack (``{fc}{i}``, ``{bn}{i}``, then
    ``out``) into a make_fc_layers Sequential ``key``: conv i at index 4 i
    (a Dropout slot after each layer but the last, DP_RATIO > 0), the final
    conv at 4 n - 1."""
    n = _count(r, fc)
    for i in range(n):
        _put(sd, f"{key}.{4 * i}", _dense_to_conv1d(r[f"{fc}{i}"]))
        _put(sd, f"{key}.{4 * i + 1}", _bn_join(r[f"{bn}{i}"], rs[f"{bn}{i}"]))
    if out is not None:
        _put(sd, f"{key}.{4 * n - 1}", _dense_to_conv1d(r[out]))


def detector_state_dict_from_flax(variables: dict) -> dict:
    """Flax SECONDNetIoU variables (numpy leaves) -> torch state dict in the
    reference's OpenPCDet / spconv 2.x key names and layouts."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _rpn_state_dict(p, s)
    r, rs = p["roi_head"], s["roi_head"]
    _fc_stack(sd, "roi_head.shared_fc_layer", r, rs, "shared_fc", "shared_bn")
    _fc_stack(sd, "roi_head.iou_layers", r, rs, "iou_fc", "iou_bn", "iou_out")
    return sd


def _linear_bn_stack(sd: dict, key: str, p: dict, s: dict, fc: str, bn: str) -> None:
    """A flax Dense + BatchNorm stack (``{fc}{i}``, ``{bn}{i}``) -> the
    port's Linear + BN + ReLU Sequential ``key`` (Linear i at 3 i)."""
    for i in range(_count(p, fc)):
        _put(sd, f"{key}.{3 * i}", _dense_to_linear(p[f"{fc}{i}"]))
        _put(sd, f"{key}.{3 * i + 1}", _bn_join(p[f"{bn}{i}"], s[f"{bn}{i}"]))


def _vector_pool_layer(sd: dict, key: str, p: dict, s: dict) -> None:
    """A flax VectorPoolAggregationMSG (``group{g}`` with ``reduce``,
    ``post{i}``/``post_bn{i}``; ``msg_post{i}``/``msg_bn{i}``) ->
    ``{key}.layers.{g}.reduce``, ``.layers.{g}.post_mlps`` and
    ``{key}.msg_post_mlps``."""
    for g in range(_count(p, "group")):
        gp, gs = p[f"group{g}"], s[f"group{g}"]
        if "reduce" in gp:
            _put(sd, f"{key}.layers.{g}.reduce", _dense_to_linear(gp["reduce"]))
        _linear_bn_stack(sd, f"{key}.layers.{g}.post_mlps", gp, gs, "post", "post_bn")
    _linear_bn_stack(sd, f"{key}.msg_post_mlps", p, s, "msg_post", "msg_bn")


def _sa_layer(sd: dict, key: str, p: dict, s: dict) -> None:
    """A flax SALayer (``scale{i}.dense{j}``, ``bn{j}``) -> StackSAModuleMSG
    ``{key}.mlps.{i}.{3 j}`` (a 1x1 Conv2d) and ``.{3 j + 1}`` (its BN); a
    VectorPoolAggregationMSG as ``_vector_pool_layer``."""
    if "group0" in p:
        _vector_pool_layer(sd, key, p, s)
        return
    for i in range(_count(p, "scale")):
        sp, ss = p[f"scale{i}"], s[f"scale{i}"]
        for j in range(_count(sp, "dense")):
            w = np.asarray(sp[f"dense{j}"]["kernel"]).T[:, :, None, None]
            _put(sd, f"{key}.mlps.{i}.{3 * j}", {"weight": w})
            _put(sd, f"{key}.mlps.{i}.{3 * j + 1}", _bn_join(sp[f"bn{j}"], ss[f"bn{j}"]))


def pvrcnn_state_dict_from_flax(variables: dict) -> dict:
    """Flax PVRCNN or PVRCNNPlusPlus variables (numpy leaves) -> torch state
    dict of the port's model, in OpenPCDet's names: the RPN as SECOND-IoU's;
    ``pfe.SA_rawpoints``, ``pfe.SA_layers.{i}`` (the stages in ascending
    order, as FEATURES_SOURCE lists them; StackSA or VectorPool layers),
    ``pfe.vsa_point_feature_fusion``;
    ``point_head.cls_layers``; ``roi_head.roi_grid_pool_layer``,
    ``shared_fc_layer``, ``cls_layers``, ``reg_layers``. The first shared
    layer's input is flattened (C, G^3) in the reference and (G^3, C) in
    flax: its rows are permuted."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _rpn_state_dict(p, s)
    pf, pfs = p["pfe"], s["pfe"]
    if "sa_raw_points" in pf:
        _sa_layer(sd, "pfe.SA_rawpoints", pf["sa_raw_points"], pfs["sa_raw_points"])
    stages = sorted(k for k in pf if k.startswith("sa_x_conv"))
    for i, name in enumerate(stages):
        _sa_layer(sd, f"pfe.SA_layers.{i}", pf[name], pfs[name])
    _put(sd, "pfe.vsa_point_feature_fusion.0", _dense_to_linear(pf["fusion_dense"]))
    _put(sd, "pfe.vsa_point_feature_fusion.1",
         _bn_join(pf["fusion_bn"], pfs["fusion_bn"]))

    ph, phs = p["point_head"], s["point_head"]
    n = _count(ph, "fc")
    for i in range(n):
        _put(sd, f"point_head.cls_layers.{3 * i}", _dense_to_linear(ph[f"fc{i}"]))
        _put(sd, f"point_head.cls_layers.{3 * i + 1}", _bn_join(ph[f"bn{i}"], phs[f"bn{i}"]))
    _put(sd, f"point_head.cls_layers.{3 * n}", _dense_to_linear(ph["cls_out"]))

    r, rs = dict(p["roi_head"]), s["roi_head"]
    _sa_layer(sd, "roi_head.roi_grid_pool_layer", r["roi_grid_pool"], rs["roi_grid_pool"])
    pool = r["roi_grid_pool"]
    c = sum(np.shape(pool[f"scale{i}"][f"dense{_count(pool[f'scale{i}'], 'dense') - 1}"]
                     ["kernel"])[1] for i in range(_count(pool, "scale")))
    k0 = np.asarray(r["shared_fc0"]["kernel"])
    k0 = k0.reshape(-1, c, k0.shape[1]).transpose(1, 0, 2).reshape(k0.shape)
    r["shared_fc0"] = {**r["shared_fc0"], "kernel": k0}
    _fc_stack(sd, "roi_head.shared_fc_layer", r, rs, "shared_fc", "shared_bn")
    _fc_stack(sd, "roi_head.cls_layers", r, rs, "cls_fc", "cls_bn", "cls_out")
    _fc_stack(sd, "roi_head.reg_layers", r, rs, "reg_fc", "reg_bn", "reg_out")
    return sd


def centerpoint_state_dict_from_flax(variables: dict) -> dict:
    """Flax CenterPoint variables (numpy leaves) -> torch state dict of the
    port's model: ``backbone_3d`` and ``backbone_2d`` in OpenPCDet's names
    (as ``_rpn_state_dict``), the center head in the JAX package's:
    ``dense_head.shared_conv`` (a Conv2d with its bias), ``.shared_bn`` and
    ``.sep.{name}_conv0`` / ``.sep.{name}_out`` for each target."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    _backbone_3d(sd, p["backbone_3d"], s["backbone_3d"])
    _backbone_2d(sd, p["backbone_2d"], s["backbone_2d"])
    dh, dhs = p["dense_head"], s["dense_head"]
    _put(sd, "dense_head.shared_conv", _conv_to_conv2d(dh["shared_conv"]))
    _put(sd, "dense_head.shared_bn", _bn_join(dh["shared_bn"], dhs["shared_bn"]))
    for name, leaf in dh["sep"].items():
        _put(sd, f"dense_head.sep.{name}", _conv_to_conv2d(leaf))
    return sd


def voxel_rcnn_state_dict_from_flax(variables: dict) -> dict:
    """Flax VoxelRCNN variables (numpy leaves) -> torch state dict of the
    port's model: the RPN in OpenPCDet's names (as SECOND-IoU's), the RoI
    head in the JAX package's module names: ``roi_head.pre_{stage}`` (a
    Linear) and ``pre_bn_{stage}``, ``pool_{stage}`` (an SALayer, as
    ``_sa_layer`` maps it), ``{shared,cls,reg}_fc{i}`` (Linear) and
    ``_bn{i}``, ``cls_out`` and ``reg_out``. The first shared layer reads
    the pooled features flattened grid-major in both, so no row moves."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _rpn_state_dict(p, s)
    _voxel_rcnn_head(sd, "roi_head", p["roi_head"], s["roi_head"])
    return sd


def _voxel_rcnn_head(sd: dict, key: str, r: dict, rs: dict) -> None:
    """A flax VoxelRCNNHead into ``{key}.{its module names}``."""
    for name, leaf in r.items():
        if name.startswith("pool_"):
            _sa_layer(sd, f"{key}.{name}", leaf, rs[name])
        elif "scale" in leaf:
            _put(sd, f"{key}.{name}", _bn_join(leaf, rs[name]))
        else:
            _put(sd, f"{key}.{name}", _dense_to_linear(leaf))


def _residual_block(sd: dict, key: str, leaf: dict, st: dict) -> None:
    """A flax SparseBasicBlock (``conv1``, ``conv2``, each a kernel and a
    ``bn``) into ``{key}.conv1`` / ``.bn1`` / ``.conv2`` / ``.bn2``."""
    for c in ("1", "2"):
        _put(sd, f"{key}.conv{c}", {"weight": _spconv_export(leaf[f"conv{c}"]["kernel"], 3, 3, 3)})
        _put(sd, f"{key}.bn{c}", _bn_join(leaf[f"conv{c}"]["bn"], st[f"conv{c}"]["bn"]))


def _fc_head(sd: dict, key: str, p: dict, s: dict, name: str) -> None:
    """A flax ``{name}_fc{i}`` / ``{name}_bn{i}`` / ``{name}_out`` stack into
    a make_fc_layers Sequential ``key`` (Linear i at 3 i, the output Linear
    at 3 n)."""
    n = _count(p, f"{name}_fc")
    _linear_bn_stack(sd, key, p, s, f"{name}_fc", f"{name}_bn")
    _put(sd, f"{key}.{3 * n}", _dense_to_linear(p[f"{name}_out"]))


def pointrcnn_state_dict_from_flax(variables: dict) -> dict:
    """Flax PointRCNN variables (numpy leaves) -> torch state dict of the
    port's model: OpenPCDet's ``backbone_3d.SA_modules.{l}`` (the flax
    ``sa{l}``, as ``_sa_layer`` maps an SALayer) and
    ``backbone_3d.FP_modules.{l}.mlp`` (``fp{l}_dense{j}`` into the 1x1
    Conv2d at 3 j, ``fp{l}_bn{j}`` into its BN), ``point_head.cls_layers``
    and ``box_layers`` (the flax ``cls_*`` and ``reg_*`` stacks); the RoI
    head's JAX names, each a Linear with its bias: ``roi_head.xyz_up{i}``,
    ``merge_down``, ``cls_fc{i}``, ``cls_out``, ``reg_fc{i}``, ``reg_out``."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    bb, bbs = p["backbone_3d"], s["backbone_3d"]
    for li in range(_count(bb, "sa")):
        _sa_layer(sd, f"backbone_3d.SA_modules.{li}", bb[f"sa{li}"], bbs[f"sa{li}"])
    li = 0
    while f"fp{li}_dense0" in bb:
        j = 0
        while f"fp{li}_dense{j}" in bb:
            key = f"backbone_3d.FP_modules.{li}.mlp"
            w = np.asarray(bb[f"fp{li}_dense{j}"]["kernel"]).T[:, :, None, None]
            _put(sd, f"{key}.{3 * j}", {"weight": w})
            _put(sd, f"{key}.{3 * j + 1}", _bn_join(bb[f"fp{li}_bn{j}"], bbs[f"fp{li}_bn{j}"]))
            j += 1
        li += 1
    ph, phs = p["point_head"], s["point_head"]
    _fc_head(sd, "point_head.cls_layers", ph, phs, "cls")
    _fc_head(sd, "point_head.box_layers", ph, phs, "reg")
    for name, leaf in p["roi_head"].items():
        _put(sd, f"roi_head.{name}", _dense_to_linear(leaf))
    return sd


def _unet_decoder(sd: dict, key: str, bb: dict, bbs: dict) -> None:
    """A flax UNetV2's decoder (``up{i}`` with ``conv_t``, ``conv_m`` and
    ``conv_inv``) into ``{key}.conv_up_t{i}``, ``.conv_up_m{i}`` and
    ``.inv_conv{i}``, the last of stage 1 into ``.conv5.0``."""
    for i in (4, 3, 2, 1):
        up, ups = bb[f"up{i}"], bbs[f"up{i}"]
        _residual_block(sd, f"{key}.conv_up_t{i}", up["conv_t"], ups["conv_t"])
        _sparse_layer(sd, f"{key}.conv_up_m{i}", up["conv_m"], ups["conv_m"])
        last = f"{key}.inv_conv{i}" if i > 1 else f"{key}.conv5.0"
        _sparse_layer(sd, last, up["conv_inv"], ups["conv_inv"])


def parta2_state_dict_from_flax(variables: dict) -> dict:
    """Flax PartA2 variables (numpy leaves) -> torch state dict of the
    port's model: the RPN in OpenPCDet's names (the UNet's encoder as
    VoxelBackBone8x's); the decoder's flax ``up{i}`` into OpenPCDet's
    spconv_unet.py names, ``conv_t`` -> ``conv_up_t{i}`` (a residual
    block), ``conv_m`` -> ``conv_up_m{i}``, ``conv_inv`` -> ``inv_conv{i}``
    (i = 4, 3, 2) or, at stage 1, ``conv5.0``; the JAX package's names for
    the part head (``seg_out``, ``part_out``) and the RoI head
    (``roi_head.{shared,cls,reg}_fc{i}`` and ``_bn{i}``, ``cls_out``,
    ``reg_out``), whose first shared layer reads the pooled grid
    cell-major, channels minor, in both."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _rpn_state_dict(p, s)
    _unet_decoder(sd, "backbone_3d", p["backbone_3d"], s["backbone_3d"])
    for name in ("seg_out", "part_out", "cls_out", "reg_out"):
        key = name if name in ("seg_out", "part_out") else f"roi_head.{name}"
        _put(sd, key, _dense_to_linear(p[name]))
    for branch in ("shared", "cls", "reg"):
        for i in range(_count(p, f"{branch}_fc")):
            _put(sd, f"roi_head.{branch}_fc{i}", _dense_to_linear(p[f"{branch}_fc{i}"]))
            _put(sd, f"roi_head.{branch}_bn{i}",
                 _bn_join(p[f"{branch}_bn{i}"], s[f"{branch}_bn{i}"]))
    return sd


def seg2d_state_dict_from_flax(variables: dict) -> dict:
    """Flax MaskRCNN variables (numpy leaves) -> state dict of the port's
    MaskRCNN, whose module names mirror the flax tree's: a walk of that
    tree. A Dense becomes a Linear, a Conv a Conv2d, the mask head's
    ConvTranspose ``up`` a flipped ConvTranspose2d, and a BatchNorm's scale
    and bias join its batch statistics. A module that holds arrays and
    modules both, as a DeformConv2d holds its ``kernel`` (a Conv2d's
    weight here) and its ``offset_conv``, gives both."""
    sd = {}

    def walk(prefix, params, stats):
        for name, node in params.items():
            key = f"{prefix}{name}"
            leaf = {k: v for k, v in node.items() if not isinstance(v, dict)}
            tensors = {}
            if "kernel" in leaf:
                if np.ndim(leaf["kernel"]) == 2:
                    tensors = _dense_to_linear(leaf)
                elif name == "up":             # MaskHead's ConvTranspose
                    tensors = _convtranspose_to_deconv2d(leaf)
                else:
                    tensors = _conv_to_conv2d(leaf)
            elif "scale" in leaf:
                tensors = _bn_join(leaf, stats[name])
            for k, v in tensors.items():
                sd[f"{key}.{k}"] = torch.tensor(np.array(v))
            children = {k: v for k, v in node.items() if isinstance(v, dict)}
            if children:
                walk(f"{key}.", children, stats.get(name, {}))

    walk("", variables["params"], variables.get("batch_stats", {}))
    return sd


def seg2d_flax_from_state_dict(state_dict: dict) -> dict:
    """The inverse of ``seg2d_state_dict_from_flax``: a state dict of the
    port's MaskRCNN -> {"params", "batch_stats"}, nested dicts of numpy
    arrays in the flax tree's layout (a Linear's weight becomes a Dense
    kernel (in, out), a Conv2d's a Conv kernel (kh, kw, in, out), the mask
    head's ``up`` a flax ConvTranspose kernel (flipped back), and a batch
    norm's weight, bias and running statistics its scale, bias, mean and
    var); ``num_batches_tracked`` has no flax counterpart and is dropped."""
    params, stats = {}, {}

    def put(tree, path, leaf, value):
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = value

    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        prefix = ".".join(path)
        v = t.detach().cpu().numpy()
        if f"{prefix}.running_var" in state_dict:          # batch norm
            if leaf in ("weight", "bias"):
                put(params, path, "scale" if leaf == "weight" else "bias", v)
            elif leaf in ("running_mean", "running_var"):
                put(stats, path, "mean" if leaf == "running_mean" else "var", v)
        elif leaf == "bias":
            put(params, path, "bias", v)
        elif v.ndim == 2:                                 # Linear -> Dense
            put(params, path, "kernel", np.ascontiguousarray(v.T))
        elif path[-1] == "up":                            # ConvTranspose2d
            w = np.transpose(v, (2, 3, 0, 1))
            put(params, path, "kernel", np.ascontiguousarray(np.flip(w, axis=(0, 1))))
        else:                                             # Conv2d -> Conv
            put(params, path, "kernel", np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0))))
    return {"params": params, "batch_stats": stats}


def _conv_block(sd: dict, key: str, leaf: dict, st: dict) -> None:
    """A flax ConvBlock2d (``conv``, ``bn``) -> ``{key}.0`` and ``{key}.1``."""
    _put(sd, f"{key}.0", {"weight": _conv_to_conv2d(leaf["conv"])["weight"]})
    _put(sd, f"{key}.1", _bn_join(leaf["bn"], st["bn"]))


def _conv_bn(sd: dict, conv_key: str, bn_key: str, p: dict, s: dict, conv: str,
             bn: str) -> None:
    _put(sd, conv_key, {"weight": _conv_to_conv2d(p[conv])["weight"]})
    _put(sd, bn_key, _bn_join(p[bn], s[bn]))


def ddn_state_dict_from_flax(p: dict, s: dict, prefix: str = "") -> dict:
    """The JAX package's DDNDeepLabV3 subtree (params ``p``, batch stats
    ``s``) -> torchvision's deeplabv3_resnet names under ``prefix``: the
    inverse of ckpt_compat's ``deeplabv3_variables_from_torch``."""
    sd = {}
    bb, bbs = p["backbone"], s["backbone"]
    _conv_bn(sd, f"{prefix}backbone.conv1", f"{prefix}backbone.bn1", bb, bbs, "conv1", "bn1")
    for name in sorted(k for k in bb if k.startswith("layer")):
        si, bi = name[len("layer"):].split("_")
        key = f"{prefix}backbone.layer{si}.{bi}"
        blk, blks = bb[name], bbs[name]
        for c in (1, 2, 3):
            _conv_bn(sd, f"{key}.conv{c}", f"{key}.bn{c}", blk, blks, f"conv{c}", f"bn{c}")
        if "downsample_conv" in blk:
            _conv_bn(sd, f"{key}.downsample.0", f"{key}.downsample.1", blk, blks,
                     "downsample_conv", "downsample_bn")
    a, as_ = p["aspp"], s["aspp"]
    key = f"{prefix}classifier.0"
    for i in range(4):
        _conv_bn(sd, f"{key}.convs.{i}.0", f"{key}.convs.{i}.1", a, as_, f"conv{i}", f"bn{i}")
    _conv_bn(sd, f"{key}.convs.4.1", f"{key}.convs.4.2", a, as_, "pool_conv", "pool_bn")
    _conv_bn(sd, f"{key}.project.0", f"{key}.project.1", a, as_, "project", "project_bn")
    _conv_bn(sd, f"{prefix}classifier.1", f"{prefix}classifier.2", p, s, "head_conv", "head_bn")
    _put(sd, f"{prefix}classifier.4", _conv_to_conv2d(p["classifier"]))
    return sd


def caddn_state_dict_from_flax(variables: dict) -> dict:
    """Flax CaDDN variables (numpy leaves) -> torch state dict of the port's
    model: ``ddn`` in torchvision's DeepLabV3 names
    (``ddn_state_dict_from_flax``), the conv blocks ``channel_reduce``,
    ``image_backbone.c{1,2,3}`` and ``collapse`` as ``.0`` (conv) / ``.1``
    (BN), ``depth_head`` a Conv2d with its bias, then ``backbone_2d`` and
    ``dense_head`` as ``_rpn_state_dict`` gives them."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _rpn_state_dict(p, s)
    _conv_block(sd, "collapse", p["collapse"], s["collapse"])
    if "ddn" in p:
        sd.update(ddn_state_dict_from_flax(p["ddn"], s["ddn"], "ddn."))
    if "channel_reduce" in p:
        _conv_block(sd, "channel_reduce", p["channel_reduce"], s["channel_reduce"])
    if "image_backbone" in p:
        for c in ("c1", "c2", "c3"):
            _conv_block(sd, f"image_backbone.{c}", p["image_backbone"][c],
                        s["image_backbone"][c])
        _put(sd, "depth_head", _conv_to_conv2d(p["depth_head"]))
    return sd
