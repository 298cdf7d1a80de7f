"""Hand-written CUDA kernels of the port and their build.

Each kernel lives in ``seevcn_torch/csrc/<name>.cu`` behind a plain C
interface. ``build`` compiles the sources with ``nvcc`` for ``sm_90a`` into
``seevcn_torch/_build/lib<name>-<hash>.so`` (one ``nvcc`` per source, all
started together) and ``load_library`` opens the result with ctypes. Nothing
is built or loaded at import time: the CPU tests import every module.

``LAUNCHES`` counts, per kernel, the launches its wrapper made.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("min_dist",)
LAUNCHES: dict[str, int] = {"min_sqdist_pruned": 0, "min_sqdist_diff": 0,
                            "min_sqdist_gram": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_SIGNATURES = {
    "min_dist": {
        # int min_sqdist_pruned(a, b, valid, n, m, r2, b4, sub_box, tile_box,
        #     keys, rank, hist, perm, out, stream)
        "min_sqdist_pruned": (
            [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [_P] * 9,
            ctypes.c_int),
        # int min_sqdist_diff(a, b, n, m, b4, out, stream)
        "min_sqdist_diff": ([_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
                            ctypes.c_int),
        # int min_sqdist_gram(a, b, n, m, b4, out, stream)
        "min_sqdist_gram": ([_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
                            ctypes.c_int),
    },
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named source that has no current library, all nvcc
    processes at once. Returns {name: nvcc's output (registers, spills)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The built kernel library ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib
