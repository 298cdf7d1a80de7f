"""Assemble the DA AP table from ``ap_*.json`` -> markdown rows (port of
scripts/da2_table.py and scripts/da3_table.py; ``--protocol`` picks the
row list).

da2: 2,048 source frames, VCN_VC completion of both domains (r4) and the
v2 protocol (source completed by VCN_CN with GT boxes, r5). da3: the
reference-protocol scale (4,096 source frames, about nuScenes' top-100 of
4,025, docs/DATASET_PREPARATION.md:21-22) with the v2 protocol; its last
four rows form the 2x2 in-domain attribution matrix (train {raw, cn} x
eval-src-val {raw, cn}).

Usage: python -m seevcn_torch.experiments.da_table [--protocol da2|da3] [dir]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

ROWS = {
    "da2": [
        ("ap_raw_src.json", "raw", "src val (64-beam, raw)"),
        ("ap_raw_tgt.json", "raw", "tgt val (16-beam, raw)"),
        ("ap_see_src.json", "see (r4 VC/VC)", "src val (VC-completed)"),
        ("ap_see_tgt.json", "see (r4 VC/VC)", "tgt val (VC-completed)"),
        ("ap_raw_tgtcomp.json", "raw", "tgt val (r4 VC-completed) — ablation"),
        ("ap_see2_src.json", "see2 (r5 CN/VC)", "src val (CN-completed)"),
        ("ap_see2_tgt.json", "see2 (r5 CN/VC)", "tgt val (r5 VC-completed)"),
        ("ap_raw_tgtcomp2.json", "raw",
         "tgt val (r5 VC-completed) — rotation-fix ablation"),
    ],
    "da3": [
        ("ap_raw3_tgt.json", "raw3", "tgt val (16-beam, raw)"),
        ("ap_see3_tgt.json", "see3 (CN src)", "tgt val (VC-completed) — protocol match"),
        ("ap_raw3_tgtcomp.json", "raw3", "tgt val (VC-completed) — test-time ablation"),
        ("ap_raw3_src.json", "raw3", "src val raw  [2x2: raw/raw]"),
        ("ap_raw3_srccomp.json", "raw3", "src val CN-completed  [2x2: raw/cn]"),
        ("ap_see3_src.json", "see3 (CN src)", "src val CN-completed  [2x2: cn/cn]"),
        ("ap_see3_srcraw.json", "see3 (CN src)", "src val raw  [2x2: cn/raw]"),
    ],
}


def table(d: str, protocol: str = "da2") -> list:
    """The table's lines for the ``ap_*.json`` under ``d``: a row each of
    ``protocol``'s list (dashes where its file is missing), then a note
    for each file the list does not name."""
    rows = ROWS[protocol]
    lines = ["| detector | eval set | 3D AP | BEV AP | frames |", "|---|---|---|---|---|"]
    for fname, det, desc in rows:
        p = os.path.join(d, fname)
        if not os.path.exists(p):
            lines.append(f"| {det} | {desc} | — | — | — |")
            continue
        with open(p) as f:
            j = json.load(f)
        lines.append(f"| {det} | {desc} | {j['ap_3d_07_r40']:.2f} | "
                     f"{j['ap_bev_07_r40']:.2f} | {j['n_frames']} |")
    extra = sorted(set(glob.glob(os.path.join(d, "ap_*.json"))) -
                   {os.path.join(d, r[0]) for r in rows})
    lines += [f"(unlisted: {p})" for p in extra]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description="The DA AP table as markdown.")
    ap.add_argument("--protocol", default="da2", choices=sorted(ROWS))
    ap.add_argument("dir", nargs="?", default=None, help="default: runs/<protocol>")
    args = ap.parse_args(argv)
    lines = table(args.dir or os.path.join("runs", args.protocol), args.protocol)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
