"""What the entries share: the two sides (the program, ``seevcn_torch``, and
the plain reference, ``benchmark.reference.seeref``), each built from the
same seeded weights; the precision switches; and the numbers that the
comparisons read."""
from __future__ import annotations

import copy
import importlib
import statistics
from contextlib import contextmanager

import numpy as np
import torch

from ..harness.weights import seeded_state_dict

PROGRAM = "seevcn_torch"
REFERENCE = "benchmark.reference.seeref"
# generator streams of one seed: each use draws from its own
STREAM_DET, STREAM_VCN, STREAM_ROI, STREAM_DROPOUT, STREAM_ORDER, STREAM_SAMPLE = 3, 4, 5, 6, 7, 8


# where each side keeps what the entries call: the program's module paths;
# the reference keeps its detectors one file each under models.detectors
LAYOUT = {"detectors": "models.detectors.second", "train": "train.train",
          "gt": "see.gt_completion", "inference": "models.vcn.inference",
          "nets": "models.vcn.nets", "config": "utils.config", "cuda": "ops.cuda"}
REFERENCE_LAYOUT = {**LAYOUT, "detectors": "models.detectors"}


class Side:
    """One implementation's modules, found by package name and imported
    when an entry first asks for one."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.layout = REFERENCE_LAYOUT if pkg == REFERENCE else LAYOUT

    def __getattr__(self, name: str):
        if name not in self.__dict__.get("layout", {}):
            raise AttributeError(name)
        mod = importlib.import_module(f"{self.pkg}.{self.layout[name]}")
        setattr(self, name, mod)
        return mod

    def get(self, name: str):
        """The module ``name``, or None where this side has none."""
        try:
            return getattr(self, name)
        except ModuleNotFoundError:
            return None

    @property
    def launches(self) -> dict:
        return getattr(self.cuda, "LAUNCHES", {}) if self.pkg != REFERENCE else {}

    def detector(self, det: dict, seed: int, device, train: bool):
        """The detector of config ``det`` with the seed's weights, on
        ``device``, at the train or test voxel cap -> (model, Cfg)."""
        cfg = self.config.Cfg(copy.deepcopy(det))
        cap = cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train" if train else "test"]
        model, _ = self.detectors.build_detector(cfg, None, max_voxels=int(cap), device=device)
        model.load_state_dict(seeded_state_dict(model, seed, STREAM_DET, device))
        return model, cfg

    def vcn(self, v: dict, seed: int, device):
        """VCNInference of the SEE config's VCN block with the seed's weights."""
        net = self.nets.build_vcn(v["model"], num_coarse=int(v["num_points"]))
        sd = seeded_state_dict(net, seed, STREAM_VCN, device)
        return self.inference.VCNInference(v["model"], sd, num_points=int(v["num_points"]),
                                           sel_k=int(v["sel_k"]),
                                           cluster_eps=float(v["cluster_eps"]), device=device)


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


@contextmanager
def control_precision(side: Side):
    """The control's precision, one step below the configuration's float32
    with TF32 off: TF32 on, also where the side's own functions turn it
    off."""
    mods = [m for m in map(side.get, ("gt", "inference")) if hasattr(m, "tf32_off")]
    saved = [m.tf32_off for m in mods]
    on = lambda: set_tf32(True)  # noqa: E731
    for m in mods:
        m.tf32_off = on
    set_tf32(True)
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.tf32_off = f
        set_tf32(False)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def cycle_order(seed: int, stream: int, pool: int):
    """Endless indices into the pool: seeded permutations back to back."""
    r = rng(seed, stream)
    while True:
        yield from r.permutation(pool).tolist()


class Reservoir:
    """A uniform sample of k items of a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.r = rng(seed, STREAM_SAMPLE)

    def offer(self, make):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.r.integers(self.seen))
            if j < self.k:
                self.items[j] = make()


def worst_leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """max over leaves of | |got| - |ref| | / max(|ref|, the median leaf's
    |ref|), over the leaves in ``keep`` (all by default)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    return max(abs(got.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def median_leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The median over leaves of the gap that ``worst_leaf_gap`` takes the
    largest of: steady where one leaf's noise is not."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    return statistics.median(abs(got.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def see_counts(side: Side, stats: dict, launches0: int) -> list:
    """A SEE call's counts on the host: instances isolated, sane and spliced
    (summed over its frames) and K1's launches since ``launches0``."""
    return [int(stats[k].sum()) for k in ("ok", "sane", "inst_valid")] + \
        [side.launches.get("min_sqdist_pruned", 0) - launches0]
