"""A baseline JPEG reader: ``cv2.imread(path)`` where OpenCV is not installed.

The decoder is C++ host code (``seevcn_torch/csrc/jpeg_decode.cpp``) with
libjpeg's arithmetic (the integer inverse DCT, fancy upsampling, the
fixed-point YCbCr tables), compiled with ``g++`` into
``seevcn_torch/_build/libseevcn_jpeg-<hash>.so`` at first use and bound
through ctypes. There is no other route: a missing compiler or a failed
build raises.

``read_jpeg`` returns what ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns
for a baseline or extended-Huffman JPEG of 1 or 3 components with sampling
factors 1 and 2: uint8 (H, W, 3) in BGR order, grayscale replicated to
three channels. A progressive, lossless, hierarchical, arithmetic-coded or
12-bit file raises NotImplementedError naming its marker; corrupt or
truncated data raises ValueError (libjpeg warns and fills with grey).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..utils import cxx_build

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "csrc" / "jpeg_decode.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_lib = None


def library_path() -> Path:
    return cxx_build.library_path(SOURCE, CXX_FLAGS, "libseevcn_jpeg")


def build() -> Path:
    """Compile the library unless its current build exists; raises if the
    source or g++ is missing or the compile fails."""
    return cxx_build.build_shared(SOURCE, CXX_FLAGS, "libseevcn_jpeg")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.seevcn_jpeg_info.restype = ctypes.c_int
        lib.seevcn_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int]
        lib.seevcn_jpeg_decode.restype = ctypes.c_int
        lib.seevcn_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                           ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def _check(code: int, err: ctypes.Array, name: str) -> None:
    if code == 1:
        raise NotImplementedError(f"{name}: {err.value.decode()}")
    if code:
        raise ValueError(f"{name}: {err.value.decode()}")


def jpeg_info(data: bytes, name: str = "JPEG") -> tuple[int, int, int]:
    """The encoded bytes -> (height, width, components) from the frame header."""
    lib = _load()
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(256)
    _check(lib.seevcn_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                                ctypes.byref(c), err, len(err)), err, name)
    return h.value, w.value, c.value


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """The encoded bytes -> uint8 (H, W, 3) BGR."""
    h, w, _ = jpeg_info(data, name)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    _check(_load().seevcn_jpeg_decode(data, len(data), out.ctypes.data, out.size, err,
                                      len(err)), err, name)
    return out


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> uint8 (H, W, 3) BGR, as ``cv2.imread`` reads it."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))
