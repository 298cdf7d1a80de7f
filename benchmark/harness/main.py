"""One run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the run does is found by name: the cell in ``BENCHMARK.json``
and ``benchmark/workloads/<cell>.json`` (its entry, configuration, traffic
and limits), the configuration in ``benchmark/configs/<config>.json``, the
traffic in ``benchmark/traffic/<traffic>.json``, the entry in
``benchmark/entries/<entry>.py`` and each metric in
``benchmark/metrics/<metric>.json``, whose reader is
``benchmark/readers/<reader>.py``. A new cell, configuration, traffic mix or
metric is new files.

The run: set-up (the entry builds the program, the traffic pool and the
weights from the seed, steps or frames through its first work and warms
up), the measured window of ``--seconds``, then (with ``--trace 1``) the
per-layer metrics from the spans and the device trace, the peak memory, the
program's state freed, and the comparison with the plain reference that
decides ``correct``. The last line of standard output is the result.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "seevcn_tpu")
# the device trace covers the window's first seconds (at most this many), so
# that reading it stays well inside a run's time limit; spans cover it all
TRACE_SECONDS = 10.0


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


class Run:
    """What the readers see of one run."""

    def __init__(self, cell, workload: dict, window: dict, spans, trace: dict | None,
                 peaks: dict):
        self.cell = cell
        self.workload = workload
        self.window = window
        self.spans = spans
        self.trace = trace
        self.peaks = peaks
        self.setup_s = None


def cell_spec(name: str, bench: Path = BENCH) -> dict:
    """The cell's entry in BENCHMARK.json, its workload file, its metrics
    (end-to-end and per-layer, each with its metric file) and its config."""
    spec = load_json(bench.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: {', '.join(cells)}")
    entry = cells[name]
    work = {**load_json(bench / "workloads" / f"{name}.json"), **entry,
            "bench_dir": str(bench)}

    def mine(metrics):
        out = []
        for m in metrics:
            if name in m.get("workloads", [name]):
                out.append({**m, **load_json(bench / "metrics" / f"{m['name']}.json")})
        return out

    return {"workload": work, "end_to_end": mine(spec["end_to_end"]),
            "per_layer": mine(spec["per_layer"]),
            "config": load_json(bench / "configs" / f"{entry['config']}.json")}


def read_metrics(metrics: list, run: Run) -> dict:
    out = {}
    for m in metrics:
        reader = importlib.import_module(f"benchmark.readers.{m['reader']}")
        v = reader.read(run, m)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, overrides: dict | None = None,
             diagnostics: bool = False) -> dict:
    """One run on ``device``; -> the result dict (``checks`` last).
    ``overrides`` goes to the entry (tests: sizes, a planted fault; the
    calibration: the control in the program's place)."""
    import torch

    from . import devtrace
    from .spans import Spans

    t_start = time.perf_counter() if t_start is None else t_start
    work = spec["workload"]
    entry = importlib.import_module(f"benchmark.entries.{work['entry']}")
    cell = entry.Cell(work, spec["config"], seed, device, **(overrides or {}))
    spans = Spans()
    metrics_wanted = spec["per_layer"] if trace else spec["end_to_end"]
    if trace:
        for m in metrics_wanted:
            if m.get("span"):
                spans.install(m["span"], cell.objects(), capture=m.get("capture", False))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    prof = devtrace.start_profiler() if trace and cuda else None
    traced = {}

    def stop_trace() -> float:
        """End the device trace; -> the seconds the stop took."""
        if cuda:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        traced["s"] = t_end - window_open
        devtrace.stop(prof)
        spans.stop_capture()
        return time.perf_counter() - t_end

    def tick() -> float:
        """Called by the window after each unit of work; -> seconds to
        leave out of the window (the device trace's stop, once)."""
        if prof is not None and not traced and time.perf_counter() - window_open >= TRACE_SECONDS:
            pause = stop_trace()
            print(f"trace: the first {traced['s']:.2f} s of the window traced; its stop took "
                  f"{pause:.2f} s, left out of the window", file=sys.stderr)
            return pause
        return 0.0

    window_open = time.perf_counter()
    window = cell.window(seconds, tick)
    window_s = time.perf_counter() - window_open
    if prof is not None and not traced:
        stop_trace()
    t_trace = time.perf_counter()
    summary = devtrace.summarize(prof) if prof is not None else None
    spans.restore()
    window["traced_s"] = traced.get("s", window_s)
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())) \
        if cuda else 0
    peaks = load_json(BENCH / "roofline" / "peaks.json")
    run = Run(cell, work, window, spans, summary, peaks)
    run.setup_s = window_open - t_start
    t_read = time.perf_counter()
    metrics = read_metrics(metrics_wanted, run)
    if trace:
        print(f"trace: summary {t_read - t_trace:.1f} s, readers {time.perf_counter() - t_read:.1f} s",
              file=sys.stderr)
    spans.spans.clear()
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = cell.check()
    print(f"check: the reference took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = bool(checks) and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(work.get("chips", 1)), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = window["traced_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    for line in cell.counts():
        print(line, file=sys.stderr)
    if diagnostics:
        result["diagnostics"] = getattr(cell, "diagnostics", None)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    import torch
    chips = int(spec["workload"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0

