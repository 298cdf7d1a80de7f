"""Time the port's JPEG decoder (``seevcn_torch.data.jpeg.decode_jpeg``) of
one source tree on the committed 900 x 1600 fixtures: host clock, the
median of ``--reps`` decodes after one warm-up, a file the tree's decoder
refuses reported as such. ``--root`` picks the tree to import
``seevcn_torch`` from (another checkout, to compare two commits on one
host); its decoder is built there at first use. Prints one JSON line.

    python scripts/time_jpeg_decode.py [--root .] [--reps 5] [--rounds 1]
"""
import argparse
import json
import os
import statistics
import sys
import time

FILES = {"baseline": "nuscenes_900x1600_420.jpg",
         "progressive": "nuscenes_900x1600_progressive.jpg",
         "arithmetic": "arithmetic_900x1600.jpg"}


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=here)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from seevcn_torch.data import jpeg

    t0 = time.time()
    jpeg.build()
    out = {"root": args.root, "build_s": time.time() - t0, "ms": {}}
    for rnd in range(args.rounds):
        for mode, name in FILES.items():
            with open(os.path.join(here, "tests", "data", "jpeg", name), "rb") as f:
                blob = f.read()
            times = []
            try:
                for _ in range(args.reps + 1):
                    t = time.perf_counter()
                    jpeg.decode_jpeg(blob)
                    times.append((time.perf_counter() - t) * 1e3)
            except (NotImplementedError, ValueError) as e:
                out["ms"].setdefault(mode, []).append(f"refused: {e}")
                continue
            out["ms"].setdefault(mode, []).append(statistics.median(times[1:]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
