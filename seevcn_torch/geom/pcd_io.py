"""Minimal PCD read/write, no open3d dependency (the port's copy of
seevcn_tpu/geom/pcd_io.py).

The reference's on-disk interface for completed clouds is binary .pcd files
written by open3d (SEE_VCN.py:267-280) and read back by the SC datasets
(sc_kitti_dataset.py:20-33). This implements the same x/y/z float32 binary
subset plus ascii, so artifacts interop both directions.
"""
from __future__ import annotations

import numpy as np

_HEADER = """# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS x y z
SIZE 4 4 4
TYPE F F F
COUNT 1 1 1
WIDTH {n}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {n}
DATA {mode}
"""


def write_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    pts = np.asarray(points, np.float32)[:, :3]
    mode = "binary" if binary else "ascii"
    header = _HEADER.format(n=len(pts), mode=mode)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(pts).tobytes())
        else:
            np.savetxt(f, pts, fmt="%.8f")


def read_pcd(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n = 0
        mode = "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            key, _, rest = line.partition(" ")
            key = key.upper()
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(x) for x in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(x) for x in rest.split()]
            elif key == "POINTS":
                n = int(rest)
            elif key == "DATA":
                mode = rest.strip()
                break
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            data = np.atleast_2d(data)
            cols = {name: i for i, name in enumerate(fields)}
        else:
            np_types = {"F": "f", "I": "i", "U": "u"}
            dt = np.dtype([
                (name if counts[i] == 1 else f"{name}",
                 f"{np_types[types[i]]}{sizes[i]}" if counts[i] == 1
                 else (f"{np_types[types[i]]}{sizes[i]}", counts[i]))
                for i, name in enumerate(fields)])
            raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            data = np.stack([raw[name].astype(np.float64) for name in fields], axis=1)
            cols = {name: i for i, name in enumerate(fields)}
        idx = [cols["x"], cols["y"], cols["z"]]
        return np.ascontiguousarray(data[:, idx].astype(np.float32))
