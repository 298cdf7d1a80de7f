"""A small JPEG encoder for the decoder's tests and fixtures: it writes the
modes neither cv2 nor PIL writes, so that ``cv2.imread`` of its output can
be the reference of ``seevcn_torch.data.jpeg``.

It codes already-quantized DCT coefficient blocks (``blocks_from_image``
makes them from a picture with a floating-point forward DCT, any seeded
blocks do as well) under the quantization tables it is given:
  * Huffman, sequential (SOF0/SOF1, or any SOF code for a refusal probe),
    with a flat code of the symbols used, at 8 or 12 bits;
  * arithmetic, sequential (SOF9) and progressive (SOF10), a port of
    libjpeg's ``jcarith.c``: ``arith_encode`` with its renormalization and
    carry handling, the DC and AC statistics bins with DAC conditioning,
    ``finish_pass`` and ``emit_restart``;
  * lossless (SOF3), Huffman-coded differences of predictors 1-7 with a
    point transform.
It is test scaffolding: nothing on a decode path imports it.
"""
from __future__ import annotations

import struct

import numpy as np

#: zigzag position -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

#: jaricom.c's table D.2 (Qe, next index after an LPS, after an MPS, switch)
_ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
#: the same packed as jcarith.c reads it: Qe << 16 | next MPS << 8 | switch << 7 | next LPS
_PACKED = [(q << 16) | (m << 8) | (s << 7) | lps for q, lps, m, s in _ARITAB]

#: libjpeg's standard tables (jcparam.c), natural order
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                       24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
                      + [99] * 32)

#: the progression of libjpeg's jpeg_simple_progression for YCbCr
#: (components, Ss, Se, Ah, Al)
SIMPLE_PROGRESSION = [
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


def simple_progression(n: int) -> list:
    """jpeg_simple_progression's script for n components: the YCbCr one for
    3, else its all-purpose one (DC scans of all components, then each
    component's AC bands and refinements)."""
    if n == 3:
        return list(SIMPLE_PROGRESSION)
    every = tuple(range(n))
    script = [(every, 0, 0, 0, 1)]
    for band in ((1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1)):
        script += [((i,), *band) for i in every]
    script.append((every, 0, 0, 1, 0))
    return script + [((i,), 1, 63, 1, 0) for i in every]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def quant_table(quality: int, chroma: bool = False) -> np.ndarray:
    """jcparam.c's quality scaling of the standard table, 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = STD_CHROMA if chroma else STD_LUMA
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _dct_matrix() -> np.ndarray:
    u, x = np.mgrid[0:8, 0:8]
    m = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


def plane_blocks(plane: np.ndarray, bw: int, bh: int, quant: np.ndarray,
                 level: int = 128) -> np.ndarray:
    """A sample plane, edge-replicated to bh x bw blocks, -> its quantized
    coefficients (bh, bw, 64), natural order (float forward DCT, rounded)."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64), ((0, 8 * bh - h), (0, 8 * bw - w)), mode="edge")
    b = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - level
    c = _dct_matrix()
    f = np.einsum("ux,ijxy,vy->ijuv", c, b, c).reshape(bh, bw, 64)
    return np.round(f / quant).astype(np.int64)


def blocks_from_image(img: np.ndarray, sampling=((1, 1), (1, 1), (1, 1)), quality: int = 75,
                      ids=(1, 2, 3)) -> tuple[list, list]:
    """A uint8 BGR (H, W, 3) or gray (H, W) picture -> (components, quant
    tables): JFIF's RGB -> YCbCr, each chroma plane box-averaged to its
    sampling factor, the blocks of the MCU grid."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes, sampling = [img.astype(np.float64)], sampling[:1]
    else:
        b, g, r = (img[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = _ceil(w, 8 * hmax), _ceil(h, 8 * vmax)
    tables = [quant_table(quality), quant_table(quality, chroma=True)]
    comps = []
    for i, (plane, (hs, vs)) in enumerate(zip(planes, sampling)):
        fx, fy = hmax // hs, vmax // vs
        p = np.pad(plane, ((0, (-h) % fy), (0, (-w) % fx)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))
        p = p[:_ceil(h * vs, vmax), :_ceil(w * hs, hmax)]
        tq = 0 if i == 0 else 1
        comps.append({"id": ids[i], "h": hs, "v": vs, "tq": tq,
                      "blocks": plane_blocks(np.clip(p, 0, 255), mx * hs, my * vs, tables[tq])})
    return comps, tables[:1 + (len(comps) > 1)]


def picture(h: int, w: int, seed: int, gray: bool = False) -> np.ndarray:
    """A seeded uint8 BGR (H, W, 3) test picture, or its gray (H, W): two
    gradients, five filled discs and light noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 3 % 256],
                   -1).astype(np.int64)
    for _ in range(5):
        colour = rng.randint(0, 256, 3)
        cx, cy = rng.randint(0, w), rng.randint(0, h)
        r = rng.randint(1, max(2, min(h, w) // 3))
        img[(x - cx) ** 2 + (y - cy) ** 2 <= r * r] = colour
    img = np.clip(img + rng.randint(-12, 13, img.shape), 0, 255).astype(np.uint8)
    if gray:
        return ((img[..., 0] * 29 + img[..., 1] * 150 + img[..., 2] * 77 + 128) >> 8).astype(np.uint8)
    return img


def exif_app1(orientation: int | None = 1, thumbnail: bytes = b"",
              big_endian: bool = False) -> bytes:
    """An APP1 EXIF segment: IFD0 with the orientation tag (none if None)
    and, with ``thumbnail``, IFD1 pointing at that JPEG stored after it."""
    e = ">" if big_endian else "<"
    entries = [] if orientation is None else [struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)]
    ifd0_len = 2 + 12 * len(entries) + 4
    ifd1_at = 8 + ifd0_len if thumbnail else 0
    ifd0 = struct.pack(e + "H", len(entries)) + b"".join(entries) + struct.pack(e + "I", ifd1_at)
    tiff = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "I", 8) + ifd0
    if thumbnail:
        thumb_at = ifd1_at + 2 + 2 * 12 + 4
        tiff += struct.pack(e + "H", 2) + struct.pack(e + "HHII", 0x0201, 4, 1, thumb_at) + \
            struct.pack(e + "HHII", 0x0202, 4, 1, len(thumbnail)) + struct.pack(e + "I", 0) + \
            thumbnail
    return _segment(0xE1, b"Exif\x00\x00" + tiff)


def with_segment(blob: bytes, segment: bytes) -> bytes:
    """A JPEG with ``segment`` inserted right after its SOI."""
    return blob[:2] + segment + blob[2:]


# --- markers ---------------------------------------------------------------

def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def _dqt(tables) -> bytes:
    out = b""
    for i, t in enumerate(tables):
        t = np.asarray(t)[NATURAL]
        if t.max() > 255:
            out += bytes([0x10 | i]) + b"".join(struct.pack(">H", int(v)) for v in t)
        else:
            out += bytes([i]) + bytes(int(v) for v in t)
    return _segment(0xDB, out)


def _sof(code: int, precision: int, height: int, width: int, comps) -> bytes:
    body = struct.pack(">BHHB", precision, height, width, len(comps))
    for c in comps:
        body += bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]])
    return _segment(code, body)


def _sos(comps, tables, ss, se, ah, al) -> bytes:
    body = bytes([len(comps)])
    for c, (td, ta) in zip(comps, tables):
        body += bytes([c["id"], (td << 4) | ta])
    return _segment(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def _start(app: bytes | None) -> bytes:
    """SOI and the application segments: a JFIF APP0 unless ``app`` is given."""
    return b"\xff\xd8" + (jfif_app0() if app is None else app)


def jfif_app0() -> bytes:
    return _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe_app14(transform: int) -> bytes:
    return _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


def _mcu_order(comps, width, height, ids):
    """(whether an MCU starts, component index, bx, by) of every block of a
    scan over ``ids`` (jdinput.c per_scan_setup: a lone component's own
    blocks, else the frame's MCU grid)."""
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if len(ids) == 1:
        c = comps[ids[0]]
        wb = _ceil(_ceil(width * c["h"], hmax), 8)
        hb = _ceil(_ceil(height * c["v"], vmax), 8)
        for by in range(hb):
            for bx in range(wb):
                yield True, ids[0], bx, by
        return
    for my in range(_ceil(height, 8 * vmax)):
        for mx in range(_ceil(width, 8 * hmax)):
            first = True
            for i in ids:
                c = comps[i]
                for v in range(c["v"]):
                    for h in range(c["h"]):
                        yield first, i, mx * c["h"] + h, my * c["v"] + v
                        first = False


# --- Huffman ----------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)   # pad with ones
        out, self.out = bytes(self.out), bytearray()
        return out


def _flat_table(symbols) -> tuple[dict, bytes]:
    """A Huffman table of ``symbols``, each with a code of the same length
    (never all ones): -> ({symbol: (code, length)}, DHT counts + values)."""
    symbols = sorted(set(symbols)) or [0]
    n = len(symbols)
    length = n.bit_length()   # n < 2^length: the all-ones code stays free
    counts = [0] * 16
    counts[length - 1] = n
    return ({s: (i, length) for i, s in enumerate(symbols)}, bytes(counts) + bytes(symbols))


def _category(v: int) -> int:
    return abs(v).bit_length()


def _huff_symbols(block, pred):
    """A sequential block -> [(table, symbol, extra value, extra bits)]."""
    out = []
    diff = int(block[0]) - pred
    s = _category(diff)
    out.append((0, s, diff if diff >= 0 else diff - 1, s))
    zz = block[NATURAL]
    run = 0
    last = max((k for k in range(1, 64) if zz[k]), default=0)
    for k in range(1, last + 1):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            out.append((1, 0xF0, 0, 0))
            run -= 16
        s = _category(v)
        out.append((1, (run << 4) | s, v if v >= 0 else v - 1, s))
        run = 0
    if last < 63:
        out.append((1, 0x00, 0, 0))
    return out


def encode_huffman(comps, tables, width: int, height: int, *, sof: int = 0xC0,
                   precision: int = 8, app: bytes | None = None) -> bytes:
    """Sequential Huffman JPEG of ``comps`` (dicts of id, h, v, tq and their
    blocks (bh, bw, 64)) in one interleaved scan; component 0 takes tables
    0, the others tables 1. ``sof`` may name another frame type to probe
    what a reader refuses."""
    ids = list(range(len(comps)))
    syms, preds = [], [0] * len(comps)
    for _, i, bx, by in _mcu_order(comps, width, height, ids):
        blk = comps[i]["blocks"][by, bx]
        syms.append((i, _huff_symbols(blk, preds[i])))
        preds[i] = int(blk[0])
    sel = [0 if i == 0 else 1 for i in ids]
    used = {(cls, t): [] for cls in (0, 1) for t in set(sel)}
    for i, block_syms in syms:
        for cls, sym, _, _ in block_syms:
            used[(cls, sel[i])].append(sym)
    codes, dht = {}, b""
    for (cls, t), symbols in sorted(used.items()):
        codes[(cls, t)], spec = _flat_table(symbols)
        dht += bytes([(cls << 4) | t]) + spec
    bw = _BitWriter()
    for i, block_syms in syms:
        for cls, sym, val, bits in block_syms:
            code, length = codes[(cls, sel[i])][sym]
            bw.put(code, length)
            if bits:
                bw.put(val, bits)
    head = _start(app) + _dqt(tables) + \
        _sof(sof, precision, height, width, comps) + _segment(0xC4, dht)
    return head + _sos(comps, [(t, t) for t in sel], 0, 63, 0, 0) + bw.flush() + b"\xff\xd9"


# --- arithmetic (jcarith.c) -------------------------------------------------

class _ArithEncoder:
    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b: int):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        qe = _PACKED[sv & 0x7F]
        nl = qe & 0xFF
        nm = (qe >> 8) & 0xFF
        qe >>= 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        out, self.out = bytes(self.out), bytearray()
        self.reset()
        return out


class _ArithScan:
    """The statistics of one scan and the DC state of its components."""

    def __init__(self, enc, n, dac_l, dac_u, dac_k):
        self.e = enc
        self.dc = [bytearray(64) for _ in range(16)]
        self.ac = [bytearray(256) for _ in range(16)]
        self.fixed = bytearray([113])
        self.last = [0] * n
        self.ctx = [0] * n
        self.dac_l, self.dac_u, self.dac_k = dac_l, dac_u, dac_k

    def reset(self, tables, dc: bool, ac: bool):
        for i, (td, ta) in tables.items():
            if dc:
                self.dc[td][:] = bytes(64)
                self.last[i] = 0
                self.ctx[i] = 0
            if ac:
                self.ac[ta][:] = bytes(256)

    def _magnitude(self, stats, i0, v, ac_k=None, k=0):
        """Figures F.8-F.9 for v >= 1 from bin i0 (the step after X1 at
        dc bin 20, or at ac bin 189 / 217 by Kx)."""
        e = self.e
        m = 0
        v -= 1
        st = i0
        if v:
            e.encode(stats, st, 1)
            m = 1
            v2 = v
            if ac_k is None:
                st = 20
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    e.encode(stats, st, 1)
                    m <<= 1
                    st += 1
            else:
                v2 >>= 1
                if v2:
                    e.encode(stats, st, 1)
                    m <<= 1
                    st = 189 if k <= ac_k else 217
                    while True:
                        v2 >>= 1
                        if not v2:
                            break
                        e.encode(stats, st, 1)
                        m <<= 1
                        st += 1
        e.encode(stats, st, 0)
        st += 14
        while True:
            m >>= 1
            if not m:
                break
            e.encode(stats, st, 1 if m & v else 0)

    def dc_value(self, i, td, value):
        e, stats = self.e, self.dc[td]
        st = self.ctx[i]
        v = value - self.last[i]
        if v == 0:
            e.encode(stats, st, 0)
            self.ctx[i] = 0
            return
        self.last[i] = value
        e.encode(stats, st, 1)
        if v > 0:
            e.encode(stats, st + 1, 0)
            st += 2
            self.ctx[i] = 4
        else:
            v = -v
            e.encode(stats, st + 1, 1)
            st += 3
            self.ctx[i] = 8
        m = (v - 1).bit_length() and 1 << ((v - 1).bit_length() - 1)
        if m < (1 << self.dac_l[td]) >> 1:
            self.ctx[i] = 0
        elif m > (1 << self.dac_u[td]) >> 1:
            self.ctx[i] += 8
        self._magnitude(stats, st, v)

    def ac_values(self, ta, zz, ss, se):
        """AC coefficients ss..se (zigzag, already shifted) of one block."""
        e, stats = self.e, self.ac[ta]
        ke = max((k for k in range(ss, se + 1) if zz[k]), default=ss - 1)
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            e.encode(stats, st, 0)
            while zz[k] == 0:
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            e.encode(stats, st + 1, 1)
            v = int(zz[k])
            e.encode(self.fixed, 0, 0 if v > 0 else 1)
            self._magnitude(stats, st + 2, abs(v), self.dac_k[ta], k)
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, ta, cur, prev, ss, se, al):
        """Successive approximation of AC ss..se: ``cur`` = |coef| >> al with
        signs, ``prev`` = the same >> (al + 1) (figure G.10)."""
        e, stats = self.e, self.ac[ta]
        ke = max((k for k in range(ss, se + 1) if cur[k]), default=ss - 1)
        kex = max((k for k in range(ss, se + 1) if prev[k]), default=0)
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                e.encode(stats, st, 0)
            while True:
                v = abs(int(cur[k]))
                if v:
                    if v >> 1:
                        e.encode(stats, st + 2, v & 1)
                    else:
                        e.encode(stats, st + 1, 1)
                        e.encode(self.fixed, 0, 0 if cur[k] > 0 else 1)
                    break
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)


def _shift(v: np.ndarray, al: int) -> np.ndarray:
    """The point transform of AC coefficients: |v| >> al with v's sign."""
    return np.sign(v) * (np.abs(v) >> al)


def encode_arithmetic(comps, tables, width: int, height: int, *, progressive: bool = False,
                      restart: int = 0, dac=None, app: bytes | None = None,
                      write_dac: bool = False) -> bytes:
    """Arithmetic-coded JPEG (SOF9, or SOF10 with ``progressive``) of
    ``comps`` (as ``encode_huffman``'s): one interleaved scan, or the scans
    of ``simple_progression``; a restart marker every ``restart`` MCUs.
    ``dac`` maps a table to (L, U, Kx) conditioning, written as a DAC
    segment; ``write_dac`` writes the defaults (0, 1, 5) too."""
    n = len(comps)
    sel = [0 if i == 0 else 1 for i in range(n)]
    dac = dict(dac or {})
    dac_l, dac_u, dac_k = [0] * 16, [1] * 16, [5] * 16
    for t, (lo, up, kx) in dac.items():
        dac_l[t], dac_u[t], dac_k[t] = lo, up, kx
    script = simple_progression(n) if progressive else [(tuple(range(n)), 0, 63, 0, 0)]
    head = _start(app) + _dqt(tables) + \
        _sof(0xCA if progressive else 0xC9, 8, height, width, comps)
    if dac or write_dac:
        body = b""
        for t in sorted(set(sel)):
            body += bytes([t, (dac_u[t] << 4) | dac_l[t], 16 + t, dac_k[t]])
        head += _segment(0xCC, body)
    if restart:
        head += _segment(0xDD, struct.pack(">H", restart))
    out = head
    enc = _ArithEncoder()
    for ids, ss, se, ah, al in script:
        ids = list(ids)
        scan = _ArithScan(enc, n, dac_l, dac_u, dac_k)
        tabs = {i: (sel[i], sel[i]) for i in ids}
        need_dc = not progressive or (ss == 0 and ah == 0)
        need_ac = not progressive or ss != 0
        scan.reset(tabs, need_dc, need_ac)
        data, mcus, rst = b"", 0, 0
        for start, i, bx, by in _mcu_order(comps, width, height, ids):
            if start:
                if restart and mcus and mcus % restart == 0:
                    data += enc.finish() + bytes([0xFF, 0xD0 + rst])
                    rst = (rst + 1) & 7
                    scan.reset(tabs, need_dc, need_ac)
                mcus += 1
            blk = comps[i]["blocks"][by, bx].astype(np.int64)
            td, ta = tabs[i]
            if not progressive:
                scan.dc_value(i, td, int(blk[0]))
                scan.ac_values(ta, blk[NATURAL], 1, 63)
            elif ss == 0 and ah == 0:
                scan.dc_value(i, td, int(blk[0]) >> al)
            elif ss == 0:
                enc.encode(scan.fixed, 0, (int(blk[0]) >> al) & 1)
            elif ah == 0:
                scan.ac_values(ta, _shift(blk[NATURAL], al), ss, se)
            else:
                scan.ac_refine(ta, _shift(blk[NATURAL], al), _shift(blk[NATURAL], ah), ss, se, al)
        data += enc.finish()
        out += _sos([comps[i] for i in ids], [tabs[i] for i in ids], ss, se, ah, al) + data
    return out + b"\xff\xd9"


# --- lossless (SOF3) --------------------------------------------------------

def encode_lossless(planes, width: int, height: int, *, predictor: int = 1, pt: int = 0,
                    precision: int = 8, ids=(1, 2, 3, 4), app: bytes | None = None,
                    restart_rows: int = 0) -> bytes:
    """Lossless Huffman JPEG of full-size sample planes (sampling 1x1), one
    interleaved scan: predictor 1-7 (Ra, Rb, Rc, Ra+Rb-Rc, Ra+((Rb-Rc)>>1),
    Rb+((Ra-Rc)>>1), (Ra+Rb)>>1); the first row of the scan and of each
    restart interval (``restart_rows`` rows) predicting from the left and
    its first sample from 2^(P-Pt-1), a row's first sample from above."""
    planes = [np.asarray(p, np.int64) >> pt for p in planes]
    comps = [{"id": ids[i], "h": 1, "v": 1, "tq": 0} for i in range(len(planes))]
    diffs = []
    for y in range(height):
        first = y == 0 or (restart_rows and y % restart_rows == 0)
        if first and y:
            diffs.append(None)   # a restart marker
        for x in range(width):
            for p in planes:
                if first:
                    pred = p[y, x - 1] if x else 1 << (precision - pt - 1)
                elif x == 0:
                    pred = p[y - 1, x]
                else:
                    ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
                    pred = [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                            rb + ((ra - rc) >> 1), (ra + rb) >> 1][predictor]
                d = int(p[y, x] - pred) & 0xFFFF
                diffs.append(d - 0x10000 if d >= 0x8000 else d)
    symbols = [16 if d == -32768 else _category(d) for d in diffs if d is not None]
    codes, spec = _flat_table(symbols)
    bw = _BitWriter()
    data, rst = b"", 0
    for d in diffs:
        if d is None:
            data += bw.flush() + bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            continue
        s = 16 if d == -32768 else _category(d)
        code, length = codes[s]
        bw.put(code, length)
        if 0 < s < 16:
            bw.put(d if d >= 0 else d - 1, s)
    head = _start(app) + \
        _sof(0xC3, precision, height, width, comps) + _segment(0xC4, b"\x00" + spec)
    if restart_rows:
        head += _segment(0xDD, struct.pack(">H", restart_rows * width))
    body = bytes([len(comps)]) + b"".join(bytes([c["id"], 0]) for c in comps) + \
        bytes([predictor, 0, pt])
    return head + _segment(0xDA, body) + data + bw.flush() + b"\xff\xd9"
