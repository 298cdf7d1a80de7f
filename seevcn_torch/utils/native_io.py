"""ctypes bindings for the native IO library (port of
seevcn_tpu/utils/native_io.py).

The library is ``native/seevcn_io.cpp``'s C ABI: KITTI ``.bin`` and binary
``.pcd`` readers, and a thread-pool prefetcher that reads files into
caller-owned fixed-shape buffers without the GIL (the reference's
DataLoader worker processes). The port compiles its own copy with ``g++``
into ``seevcn_torch/_build/libseevcn_io-<hash>.so`` at first use, without
``-march=native``, so that the file built on one host runs on another.
Every entry point has the numpy route as its plain version, taken when the
source or a compiler is missing or the build fails; ``native_available()``
says which route the module takes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..geom.pcd_io import read_pcd as _np_read_pcd
from . import cxx_build

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "seevcn_io.cpp"
BUILD_DIR = cxx_build.BUILD_DIR
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
_lib = None


def library_path() -> Path:
    return cxx_build.library_path(SOURCE, CXX_FLAGS, "libseevcn_io")


def build() -> Path:
    """Compile the library unless its current build exists; raises if the
    source or g++ is missing or the compile fails."""
    return cxx_build.build_shared(SOURCE, CXX_FLAGS, "libseevcn_io")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError):
        _lib = False
        return _lib
    lib.seevcn_read_bin.restype = ctypes.c_int64
    lib.seevcn_read_bin.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64]
    lib.seevcn_read_pcd.restype = ctypes.c_int64
    lib.seevcn_read_pcd.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
    lib.seevcn_prefetcher_create.restype = ctypes.c_void_p
    lib.seevcn_prefetcher_create.argtypes = [ctypes.c_int]
    lib.seevcn_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.seevcn_prefetcher_submit.restype = ctypes.c_uint64
    lib.seevcn_prefetcher_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.seevcn_prefetcher_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True when the entry points take the native library's route."""
    return bool(_load())


def read_bin(path: str, max_rows: int = 200000, row_floats: int = 4) -> np.ndarray:
    """A float32 ``.bin`` of ``row_floats`` columns -> its first ``max_rows``
    rows (N, row_floats). A missing file raises FileNotFoundError."""
    lib = _load()
    if not lib:
        return np.fromfile(path, dtype=np.float32).reshape(-1, row_floats)[:max_rows]
    buf = np.empty((max_rows, row_floats), np.float32)
    n = lib.seevcn_read_bin(path.encode(), buf.ctypes.data, max_rows, row_floats)
    if n < 0:
        raise FileNotFoundError(path)
    return buf[:n]


def read_pcd(path: str, max_rows: int = 200000) -> np.ndarray:
    """A ``.pcd``'s x y z -> its first ``max_rows`` rows (N, 3). The native
    route reads binary x y z files; an ascii or other layout takes the numpy
    reader."""
    lib = _load()
    if not lib:
        return _np_read_pcd(path)[:max_rows]
    buf = np.empty((max_rows, 3), np.float32)
    n = lib.seevcn_read_pcd(path.encode(), buf.ctypes.data, max_rows)
    if n == -2:                                    # ascii or not x y z
        return _np_read_pcd(path)[:max_rows]
    if n < 0:
        raise FileNotFoundError(path)
    return buf[:n]


class Prefetcher:
    """Threaded file prefetcher into fixed-shape buffers.

        pf = Prefetcher(n_threads=4)
        bufs, counts = pf.load([(path, "bin"), ...], max_rows=150000)
    """

    def __init__(self, n_threads: int = 4):
        self._lib = _load()
        self._handle = self._lib.seevcn_prefetcher_create(n_threads) if self._lib else None

    def load(self, entries, max_rows: int = 150000):
        """entries: (path, kind) pairs, kind "bin" or "pcd" -> (buffers (N,
        max_rows, 4 or 3) zero-padded, row counts (N,)); the width is 4 when
        the first entry is a ``.bin``."""
        n = len(entries)
        rf = 4 if entries and entries[0][1] == "bin" else 3
        bufs = np.zeros((n, max_rows, rf), np.float32)
        counts = np.zeros((n,), np.int64)
        if not self._lib:
            for i, (p, kind) in enumerate(entries):
                pts = read_bin(p, max_rows, rf) if kind == "bin" else read_pcd(p, max_rows)
                counts[i] = len(pts)
                bufs[i, :len(pts), :pts.shape[1]] = pts
            return bufs, counts
        last = 0
        for i, (p, kind) in enumerate(entries):
            last = self._lib.seevcn_prefetcher_submit(
                self._handle, p.encode(), bufs[i].ctypes.data, max_rows,
                4 if kind == "bin" else 3, counts[i:i + 1].ctypes.data)
        self._lib.seevcn_prefetcher_wait(self._handle, last)
        return bufs, counts

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.seevcn_prefetcher_destroy(self._handle)
