"""Timing, tracing and logging (port of seevcn_tpu/utils/profiling.py;
reference train_utils.py:18-62, common_utils.create_logger:85-100).

  * AverageMeter and Timer, the latter synchronizing the card (or reading one
    element back) before it stops the clock;
  * trace(log_dir): a ``torch.profiler`` capture of the CPU and CUDA
    activities, written to ``log_dir`` as a Chrome trace JSON;
  * annotate(name): a named span (``torch.profiler.record_function``);
  * create_logger: the rank-0 console and file logger;
  * MetricsWriter: scalars to TensorBoard through ``torch.utils.tensorboard``
    where the ``tensorboard`` package imports, else the JAX package's JSONL
    records (``metrics.jsonl``: tag, value, step, ts);
  * set_random_seed: Python's, numpy's and torch's generators.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def _tensors(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


class Timer:
    """Host-clock timing of a block that waits for the device work of
    ``sync`` (a tensor or a dict, list or tuple of them): with
    ``readback=False`` ``torch.cuda.synchronize`` on each CUDA device that
    holds one, with ``readback=True`` one element of the first tensor
    copied to the host."""

    def __init__(self):
        self.meter = AverageMeter()

    @contextlib.contextmanager
    def measure(self, sync=None, readback: bool = False):
        import torch

        t0 = time.perf_counter()
        yield
        if sync is not None:
            leaves = _tensors(sync)
            if readback:
                if leaves:
                    leaves[0].reshape(-1)[:1].cpu()
            else:
                for dev in {t.device for t in leaves if t.is_cuda}:
                    torch.cuda.synchronize(dev)
        self.meter.update(time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's CPU ops and, where CUDA is available, its CUDA
    kernels; on exit the trace goes to ``log_dir/trace_<pid>_<ns>.json``
    (Chrome trace format; chrome://tracing or Perfetto read it). The
    profiler is yielded, so the caller can also read ``key_averages()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named span in a trace(): a context manager."""
    from torch.profiler import record_function

    return record_function(name)


def create_logger(log_file=None, rank: int = 0, name: str = "seevcn_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if log_file is not None and rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsWriter:
    """Scalar sink: a TensorBoard event file where ``tensorboard`` imports,
    JSONL records otherwise."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            import tensorboard  # noqa: F401  (torch's writer needs the package)
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "ts": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


def set_random_seed(seed: int):
    """Seed Python's ``random``, numpy's global generator and torch's (CPU
    and every CUDA device)."""
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
