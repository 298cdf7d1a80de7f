#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell,
in one process: the program on a dozen seeds or more, the control (the
plain reference in the program's place, one precision step below the
configuration's: TF32 on) and the planted faults, each compared with the
reference as a benchmark run compares it.

    python3 benchmark/calibrate.py --workload second_iou_f32.train --seeds 12 \
        --modes program control half_batch --seconds 0 --out calib.jsonl

Each reading is one JSON line (mode, seed, the compared numbers). The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

MODES = {"program": {}, "control": {"program": "benchmark.reference.seeref", "control": True},
         "half_batch": {"fault": "half_batch"}, "unchanged": {"fault": "unchanged"},
         "alter_answer": {"fault": "alter_answer"}}


def main(argv=None) -> int:
    from benchmark.harness.main import cell_spec, run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--modes", nargs="+", default=["program", "control"])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--diagnostics", action="store_true")
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    out = open(args.out, "a") if args.out else None
    for mode in args.modes:
        for k in range(args.seeds):
            seed = args.first_seed + 7919 * k
            t0 = time.perf_counter()
            r = run_cell(spec, seed, args.seconds, False, device=args.device,
                         overrides=MODES[mode], diagnostics=args.diagnostics)
            line = {"workload": args.workload, "mode": mode, "seed": seed,
                    "seconds": round(time.perf_counter() - t0, 2), "attempted": r["attempted"],
                    **{k: v["value"] for k, v in r["checks"].items()}}
            if args.diagnostics:
                line["diagnostics"] = r.get("diagnostics")
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
