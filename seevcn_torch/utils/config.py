"""YAML config system, compatible with all three reference config dialects
(a copy of seevcn_tpu/utils/config.py; the port imports nothing of the JAX
package). PyYAML is imported only where a file is read.

The reference has three look-alike YAML systems (SURVEY.md §5):
  1. pcdet:  recursive ``_BASE_CONFIG_`` merge + dotted ``--set`` overrides
     (reference: detector3d/pcdet/config.py:16-84)
  2. VCN:    mmcv-style ``_base_`` includes (reference:
     see/surface_completion/models/vcn/utils/config.py:18-58)
  3. SEE:    flat YAML -> attribute dict (reference:
     see/surface_completion/datasets/shared_utils.py:393-402)

This single loader accepts all three verbatim: both ``_BASE_CONFIG_`` and
``_base_`` keys trigger a recursive load-and-merge, and the result is a
``Cfg`` (dict with attribute access).
"""
from __future__ import annotations

import copy
import os
from pathlib import Path


class Cfg(dict):
    """Dict with attribute access; nested dicts are converted recursively."""

    def __init__(self, d=None, **kw):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v
        for k, v in kw.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, Cfg):
            v = Cfg(v)
        elif isinstance(v, (list, tuple)):
            v = type(v)(Cfg(x) if isinstance(x, dict) and not isinstance(x, Cfg) else x for x in v)
        super().__setitem__(k, v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def __deepcopy__(self, memo):
        return Cfg({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def clone(self):
        return copy.deepcopy(self)


_BASE_KEYS = ("_BASE_CONFIG_", "_base_", "BASE_CONFIG")


def merge_new_config(config: Cfg, new_config: dict, root_dir: str | None = None) -> Cfg:
    """Recursive merge with base-config expansion (pcdet merge semantics)."""
    import yaml

    for base_key in _BASE_KEYS:
        if base_key in new_config:
            bases = new_config[base_key]
            if not isinstance(bases, (list, tuple)):
                bases = [bases]
            for base in bases:
                base_path = _resolve(base, root_dir)
                with open(base_path) as f:
                    base_cfg = yaml.safe_load(f) or {}
                merge_new_config(config, base_cfg, root_dir=os.path.dirname(base_path))
    for key, val in new_config.items():
        if key in _BASE_KEYS:
            continue
        if isinstance(val, dict):
            if not (key in config and isinstance(config[key], dict)):
                config[key] = Cfg()
            # recurse so nested _BASE_CONFIG_ blocks expand too (pcdet puts
            # them inside DATA_CONFIG / DATA_CONFIG_TAR)
            merge_new_config(config[key], val, root_dir=root_dir)
        else:
            config[key] = copy.deepcopy(val)
    return config


def _resolve(path: str, root_dir: str | None) -> str:
    """Resolve a base-config path: absolute, relative to the including file,
    or relative to any ancestor that makes it exist (the reference writes
    bases as repo-relative like ``cfgs/dataset_configs/x.yaml``)."""
    if os.path.isabs(path) and os.path.exists(path):
        return path
    cands = []
    if root_dir:
        cands.append(os.path.join(root_dir, path))
        d = Path(root_dir)
        for anc in [d, *d.parents]:
            cands.append(str(anc / path))
    cands.append(path)
    for c in cands:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"base config {path!r} not found (searched from {root_dir!r})")


def cfg_from_yaml_file(cfg_file: str, config: Cfg | None = None) -> Cfg:
    import yaml

    config = Cfg() if config is None else config
    with open(cfg_file) as f:
        new_config = yaml.safe_load(f) or {}
    merge_new_config(config, new_config, root_dir=os.path.dirname(os.path.abspath(cfg_file)))
    # pcdet sets TAG/EXP_GROUP_PATH from the filename (reference pcdet/config.py:71-84)
    config.setdefault("TAG", Path(cfg_file).stem)
    return config


def cfg_from_list(cfg_list, config: Cfg) -> Cfg:
    """Dotted KEY VALUE overrides (reference pcdet/config.py:16-48)."""
    import yaml

    assert len(cfg_list) % 2 == 0
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        keys = k.split(".")
        d = config
        for sub in keys[:-1]:
            assert sub in d, f"config key {sub} not found"
            d = d[sub]
        try:
            value = yaml.safe_load(v)
        except yaml.YAMLError:
            value = v
        if keys[-1] in d and isinstance(d[keys[-1]], (list, tuple)) and isinstance(value, str):
            value = [type(e)(x) for e, x in zip(d[keys[-1]], value.split(","))]
        d[keys[-1]] = value
    return config
