"""A JPEG reader: ``cv2.imread(path)`` where OpenCV is not installed.

The decoder is C++ host code (``seevcn_torch/csrc/jpeg_decode.cpp``) that
follows libjpeg-turbo step for step (Huffman and arithmetic entropy
decoding, sequential and progressive frames with the block smoothing of an
incompletely refined one, the integer inverse DCT, the upsampler each
sampling ratio takes, the fixed-point colour tables), compiled with ``g++``
into ``seevcn_torch/_build/libseevcn_jpeg-<hash>.so`` at first use and bound
through ctypes. There is no other route: a missing compiler or a failed
build raises.

``read_jpeg`` returns what ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns:
uint8 (H, W, 3) in BGR order, grayscale replicated to three channels, CMYK
and YCCK converted as OpenCV converts them, turned by the EXIF orientation
as OpenCV turns it. A file that libjpeg refuses as well (cv2 returns None)
raises RefusedJpeg; corrupt or truncated data raises ValueError (libjpeg
warns and fills with grey).
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


class RefusedJpeg(ValueError):
    """A JPEG that libjpeg refuses too, so that ``cv2.imread`` returns None
    for it (a hierarchical frame, a DNL height, a sample precision other
    than 8 bits, ...)."""


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
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.seevcn_jpeg_info.restype = ctypes.c_int
        lib.seevcn_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, i32, i32, i32,
                                         ctypes.c_char_p, ctypes.c_int]
        lib.seevcn_jpeg_decode.restype = ctypes.c_int
        lib.seevcn_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                           ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def _check(code: int, err: ctypes.Array, name: str) -> None:
    if code == 3:
        raise RefusedJpeg(f"{name}: {err.value.decode()}")
    if code:
        raise ValueError(f"{name}: {err.value.decode()}")


def _info(data: bytes, name: str) -> tuple[int, int, int, int]:
    h, w, c, o = (ctypes.c_int32() for _ in range(4))
    err = ctypes.create_string_buffer(256)
    _check(_load().seevcn_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                                    ctypes.byref(c), ctypes.byref(o), err, len(err)), err, name)
    return h.value, w.value, c.value, o.value


def jpeg_info(data: bytes, name: str = "JPEG") -> tuple[int, int, int]:
    """The encoded bytes -> (height, width, components) from the frame header."""
    return _info(data, name)[:3]


def image_shape(data: bytes, name: str = "JPEG") -> tuple[int, int]:
    """(H, W) of the array ``cv2.imread`` returns: the frame header's, swapped
    by an EXIF orientation that transposes (5 to 8)."""
    h, w, _, orientation = _info(data, name)
    return (w, h) if 5 <= orientation <= 8 else (h, w)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: flips for 2-4, a transpose and then a flip
    for 5-8 (none for 1 and for values outside 1..8)."""
    if 5 <= orientation <= 8:
        img = img.transpose(1, 0, 2)
    axes = {2: 1, 3: (0, 1), 4: 0, 6: 1, 7: (0, 1), 8: 0}.get(orientation)
    if axes is not None:
        img = np.flip(img, axes)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """The encoded bytes -> uint8 (H, W, 3) BGR."""
    h, w, _, orientation = _info(data, name)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    _check(_load().seevcn_jpeg_decode(data, len(data), out.ctypes.data, out.size, err,
                                      len(err)), err, name)
    return _orient(out, orientation)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> uint8 (H, W, 3) BGR, as ``cv2.imread`` reads it."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))
