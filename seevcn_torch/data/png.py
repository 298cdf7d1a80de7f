"""A small PNG reader and writer (stdlib zlib and numpy), for KITTI's camera
images and depth maps where OpenCV is not installed.

``read_png`` reads the two kinds a KITTI split holds: 8-bit RGB (colour
type 2) or RGBA (6), and 16-bit grayscale (0), non-interlaced, with any of
the five row filters. It returns what ``cv2.imread`` gives in RGB order:
uint8 (H, W, 3) or (H, W, 4), or uint16 (H, W) for ``cv2.IMREAD_UNCHANGED``
on a depth map. Any other PNG raises. Rows filtered Sub or Up decode as
whole-row numpy operations; Average and Paeth, whose every byte depends on
the one before it, decode byte by byte in Python (a few hundred ms for a
KITTI image filtered so throughout).

``write_png`` writes the same kinds, each row with the filter it is given
(``filters``: one of 0-4 for all rows, or one a row).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: (bit depth, colour type) -> channels
_KINDS = {(8, 2): 3, (8, 6): 4, (16, 0): 1}


def _unfilter_rows(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The decompressed IDAT stream -> (height, stride) uint8, each row's
    filter undone (PNG spec §9)."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError("PNG: image data of the wrong size")
    rows = data.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, filt = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = filt.copy()
        elif kind == 1:                          # Sub: a running sum a lane
            cur = np.cumsum(filt.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:                          # Up
            cur = filt + prior
        elif kind in (3, 4):                     # Average, Paeth: byte by byte
            cur = bytearray(filt.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG file -> uint8 (H, W, 3 or 4) RGB(A), or uint16 (H, W) grayscale."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if (depth, colour) not in _KINDS or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}: read_png takes 8-bit RGB or RGBA and "
                         "16-bit grayscale, not interlaced")
    channels = _KINDS[(depth, colour)]
    bpp = channels * depth // 8
    rows = _unfilter_rows(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width)
    return rows.reshape(height, width, channels)


def _filter_row(kind: int, cur: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One row's bytes filtered with ``kind`` (the inverse of the reader's)."""
    c = cur.astype(np.int16)
    a = np.concatenate([np.zeros(bpp, np.int16), c[:-bpp]])
    b = prior.astype(np.int16)
    if kind == 0:
        pred = np.zeros_like(c)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        cc = np.concatenate([np.zeros(bpp, np.int16), b[:-bpp]])
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    else:
        raise ValueError(f"PNG: unknown row filter {kind}")
    return ((c - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, filters=0) -> None:
    """uint8 (H, W, 3 or 4) RGB(A) or uint16 (H, W) -> a PNG file, row y
    filtered with ``filters`` (an int, or a sequence of one a row)."""
    image = np.ascontiguousarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, colour, data = 16, 0, image.astype(">u2").view(np.uint8)
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] in (3, 4):
        depth, colour, data = 8, 2 if image.shape[2] == 3 else 6, image
    else:
        raise ValueError("write_png takes uint8 (H, W, 3 or 4) or uint16 (H, W)")
    height, width = image.shape[:2]
    bpp = _KINDS[(depth, colour)] * depth // 8
    rows = data.reshape(height, width * bpp)
    kinds = [filters] * height if isinstance(filters, int) else list(filters)
    prior = np.zeros(width * bpp, np.uint8)
    out = bytearray()
    for y in range(height):
        out.append(kinds[y])
        out += _filter_row(kinds[y], rows[y], prior, bpp).tobytes()
        prior = rows[y]
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(
            bytes(out), 6)) + _chunk(b"IEND", b""))
