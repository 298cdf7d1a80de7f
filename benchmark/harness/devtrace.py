"""The device trace of the traced window, from ``torch.profiler``: the
union of the device's operation intervals (busy), the operations that took
most time, and the longest idle gaps named by the host op that ran
through them."""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile


def start_profiler():
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof) -> None:
    """End the trace (after the device's queue drains)."""
    prof.__exit__(None, None, None)


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


def summarize(prof, top: int = 10) -> dict:
    """-> busy_s, kernels {name: seconds}, device_ops and idle_gaps (the
    ``breakdown`` lists), span_s (first device start to last device end)."""
    dev, cpu = [], []
    for ev in prof.profiler.kineto_results.events():
        t0, dur = _ns(ev, "start"), _ns(ev, "duration")
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():       # ranges over kernels, not work
                dev.append((t0, t0 + dur, ev.name()))
        elif dur > 0:
            cpu.append((t0, t0 + dur, ev.name()))
    if not dev:
        return {"busy_s": 0.0, "kernels": {}, "device_ops": [], "idle_gaps": [], "span_s": 0.0}
    dev.sort()
    per_name = defaultdict(float)
    merged = []
    for s, e, name in dev:
        per_name[name] += (e - s) * 1e-9
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:5000]
    cpu.sort()
    starts = [c[0] for c in cpu]
    by_host = defaultdict(float)
    for length, g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name, last = "(no host op)", -1
        for j in range(i, max(i - 400, -1), -1):
            if cpu[j][1] >= mid:
                name = cpu[j][2]
                break
            if cpu[j][1] > last:                  # the host op that ended last
                last, name = cpu[j][1], f"after {cpu[j][2]}"

        by_host[name] += length * 1e-9
    return {"busy_s": busy, "kernels": dict(per_name),
            "device_ops": sorted(([k, v] for k, v in per_name.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                                key=lambda kv: -kv[1])[:top],
            "span_s": (dev[-1][1] - dev[0][0]) * 1e-9}
