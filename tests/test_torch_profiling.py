"""The port's timing, tracing and logging (seevcn_torch.utils.profiling)
against the JAX package's (seevcn_tpu.utils.profiling) on the CPU.

The meters, the logger (levels, handlers, line format) and the JSONL
metric records must equal JAX's (the records but for their wall-clock
``ts``); tensorflow is hidden from the JAX side so that it takes its JSONL
route, and tensorboard from the port's for the same route. trace() must
write a Chrome trace JSON that names an annotate() span.
"""
import glob
import json
import logging
import os
import random
import sys

import numpy as np
import pytest
import torch

from seevcn_torch.utils import profiling as T
from seevcn_tpu.utils import profiling as J


def test_average_meter_matches_jax():
    mt, mj = T.AverageMeter(), J.AverageMeter()
    assert mt.avg == mj.avg == 0.0
    for v, n in [(1.0, 1), (3.0, 2), (np.float32(0.5), 4), (torch.tensor(2.0), 1)]:
        mt.update(v, n)
        mj.update(float(v), n)
        assert (mt.val, mt.sum, mt.count, mt.avg) == (mj.val, mj.sum, mj.count, mj.avg)
    mt.reset()
    assert (mt.val, mt.sum, mt.count) == (0.0, 0.0, 0)


def test_timer_sync_and_readback():
    """Nothing to wait for, CPU tensors in a dict (no CUDA device to
    synchronize) and a read-back of one element: each measure counts once."""
    t = T.Timer()
    with t.measure(sync=None):
        x = torch.zeros(10) + 1
    with t.measure(sync={"a": x, "b": [x * 2]}):
        y = x * 2
    with t.measure(sync=(y, x), readback=True):
        x.sum()
    assert t.meter.count == 3 and t.meter.sum > 0
    assert T._tensors({"a": x, "b": [y, (x,)], "c": 3}) == [x, y, x]


@pytest.mark.parametrize("rank", [0, 1])
def test_logger_matches_jax(tmp_path, rank):
    lt = T.create_logger(str(tmp_path / "t" / "log.txt"), rank=rank, name="port_log")
    lj = J.create_logger(str(tmp_path / "j" / "log.txt"), rank=rank, name="jax_log")
    assert lt.level == lj.level == (logging.INFO if rank == 0 else logging.WARNING)
    assert [type(h) for h in lt.handlers] == [type(h) for h in lj.handlers]
    assert lt.propagate is lj.propagate is False
    for lg in (lt, lj):
        lg.info("hello")
        lg.warning("careful")
        for h in lg.handlers:
            h.flush()
    if rank == 0:
        lines_t = (tmp_path / "t" / "log.txt").read_text().splitlines()
        lines_j = (tmp_path / "j" / "log.txt").read_text().splitlines()
        assert [ln.split("  ", 1)[1] for ln in lines_t] == \
            [ln.split("  ", 1)[1] for ln in lines_j] == [" INFO  hello", "WARNING  careful"]
    else:
        assert not (tmp_path / "t" / "log.txt").exists()


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]


def test_metrics_jsonl_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    wt, wj = T.MetricsWriter(str(tmp_path / "t")), J.MetricsWriter(str(tmp_path / "j"))
    for step, (tag, value) in enumerate([("loss", 1.5), ("lr", np.float32(1e-3)),
                                         ("loss", torch.tensor(0.25))]):
        wt.scalar(tag, value, step)
        wj.scalar(tag, float(value), np.int64(step))
    wt.close()
    wj.close()
    got = _records(tmp_path / "t" / "metrics.jsonl")
    assert got == _records(tmp_path / "j" / "metrics.jsonl")
    assert got[1] == {"tag": "lr", "value": float(np.float32(1e-3)), "step": 1}
    with open(tmp_path / "t" / "metrics.jsonl") as f:
        assert all(set(json.loads(line)) == {"tag", "value", "step", "ts"} for line in f)


def test_metrics_tensorboard_event_file(tmp_path, monkeypatch):
    """Where tensorboard imports, an event file and no JSONL (tensorflow
    hidden: its import here takes seconds and the writer does not need it);
    without tensorboard, the JSONL records."""
    import importlib.util

    has_tb = importlib.util.find_spec("tensorboard") is not None
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    w = T.MetricsWriter(str(tmp_path))
    w.scalar("loss", 2.0, 7)
    w.close()
    assert bool(glob.glob(str(tmp_path / "events.out.tfevents.*"))) == has_tb
    assert os.path.exists(tmp_path / "metrics.jsonl") != has_tb


def test_set_random_seed_matches_jax():
    draws = []
    for seed_fn in (T.set_random_seed, J.set_random_seed):
        assert seed_fn(7) == 7
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[0] == draws[1]
    T.set_random_seed(11)
    a = torch.rand(4)
    T.set_random_seed(11)
    assert torch.equal(a, torch.rand(4))


def test_trace_writes_chrome_trace_with_spans(tmp_path):
    with T.trace(str(tmp_path)) as prof:
        with T.annotate("demo/span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "demo/span" in names and "aten::mm" in names
    assert any(e.key == "demo/span" for e in prof.key_averages())
