"""The port's JPEG reader (seevcn_torch.data.jpeg, the C++ decoder in
seevcn_torch/csrc/jpeg_decode.cpp) against cv2.imread, and the image
dispatcher of the CLIs (seevcn_torch.data.image).

Inputs: synthetic pictures (gradients, filled shapes, noise from a seeded
RandomState) written by cv2 at qualities 50, 75 and 95, in the sampling
modes 4:4:4, 4:2:2, 4:2:0 and 4:4:0, grayscale, with restart intervals, at
odd and tiny sizes; the committed fixtures of tests/data/jpeg
(scripts/make_jpeg_fixtures.py) against the sha256 of cv2's array; and the
files both readers refuse, most from the test-side encoder
(seevcn_torch.testing_jpeg). tests/test_torch_jpeg_modes.py holds the
other modes (progressive, 4:1:1, arithmetic, four components, lossless,
EXIF orientation).

Tolerance: none. Every mode is cv2's array byte for byte (libjpeg-turbo's
integer IDCT, fancy upsampling and colour tables). A file cv2.imread
returns None for raises RefusedJpeg naming what libjpeg refuses;
truncated data raises ValueError.
"""
import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from seevcn_torch import testing_jpeg as E
from seevcn_torch.data.image import read_image_bgr
from seevcn_torch.data.jpeg import RefusedJpeg, decode_jpeg, image_shape, jpeg_info, read_jpeg

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _picture(h, w, seed, gray=False):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 3 % 256],
                   -1).astype(np.uint8)
    for _ in range(5):
        c = tuple(int(v) for v in rng.randint(0, 256, 3))
        cv2.circle(img, (int(rng.randint(0, w)), int(rng.randint(0, h))),
                   int(rng.randint(1, max(2, min(h, w) // 3))), c, -1)
    img = np.clip(img.astype(np.int16) + rng.randint(-12, 13, img.shape), 0, 255)
    img = img.astype(np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img


def _roundtrip(tmp_path, img, params):
    path = str(tmp_path / "x.jpg")
    assert cv2.imwrite(path, img, params)
    return path


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
def test_read_jpeg_matches_cv2(tmp_path, quality, sampling):
    """Every sampling mode at three qualities, at even, odd and tiny sizes
    (a component of 1 or 2 samples takes libjpeg's replicating
    upsampler), byte for byte."""
    for i, (h, w) in enumerate([(64, 96), (37, 53), (1, 1), (3, 5), (17, 2), (120, 161)]):
        path = _roundtrip(tmp_path, _picture(h, w, i), [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
        ref = cv2.imread(path)
        got = read_jpeg(path)
        assert got.dtype == np.uint8 and got.shape == ref.shape == (h, w, 3)
        np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w}")


@pytest.mark.parametrize("case", ["gray", "restart_1", "restart_3", "restart_gray"])
def test_grayscale_and_restart_intervals(tmp_path, case):
    """Grayscale comes back replicated to three channels; a DRI restart
    interval (RSTn markers, DC predictions reset) decodes the same."""
    gray = case.endswith("gray") or case == "gray"
    params = [] if case == "gray" else [cv2.IMWRITE_JPEG_RST_INTERVAL,
                                        3 if case != "restart_1" else 1]
    path = _roundtrip(tmp_path, _picture(45, 67, 7, gray=gray), params)
    with open(path, "rb") as f:
        blob = f.read()
    if case != "gray":
        assert b"\xff\xdd" in blob and b"\xff\xd0" in blob
    np.testing.assert_array_equal(read_jpeg(path), cv2.imread(path))
    assert jpeg_info(blob) == (45, 67, 1 if gray else 3)


def test_committed_fixtures_match_their_hashes():
    """The fixtures chip_smoke.py decodes on the card's host (which has no
    cv2), every mode among them: their recorded cv2 hashes and shapes, and
    cv2 itself here."""
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        table = json.load(f)
    assert len(table) == 14
    assert {rec["mode"] for rec in table.values()} == {
        "baseline", "baseline_gray", "baseline_411", "progressive", "progressive_exif",
        "arithmetic", "cmyk", "lossless"}
    assert sum(os.path.getsize(os.path.join(FIXTURES, k)) for k in table) < 1 << 20
    for name, rec in table.items():
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            assert image_shape(f.read()) == tuple(rec["shape"][:2]), name
        got = read_jpeg(path)
        assert list(got.shape) == rec["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"], name
        np.testing.assert_array_equal(got, cv2.imread(path))


def _with_byte(blob: bytes, offset: int, value: int) -> bytes:
    return blob[:offset] + bytes([value]) + blob[offset + 1:]


def _refused_file(case: str) -> bytes:
    """A file of a mode libjpeg refuses: cv2's own baseline file with a
    byte changed, or the test-side encoder's file."""
    img = E.picture(24, 40, 2)
    with open(os.path.join(FIXTURES, "odd_37x53.jpg"), "rb") as f:
        blob = f.read()
    sof = blob.index(b"\xff\xc0")
    comps, tables = E.blocks_from_image(img, ((1, 1), (1, 1), (1, 1)))
    planes = [img[..., i] for i in range(3)]
    if case.startswith("sof"):
        return _with_byte(blob, sof + 1, 0xC0 + int(case[3:]))
    if case == "precision_byte_12":
        return _with_byte(blob, sof + 4, 12)
    if case == "twelve_bit":   # well-formed: 12-bit levels and coefficients
        return E.encode_huffman([dict(c, blocks=c["blocks"] * 16) for c in comps], tables,
                                40, 24, sof=0xC1, precision=12)
    if case == "dnl_height":
        return blob[:sof + 5] + b"\x00\x00" + blob[sof + 7:]
    if case == "two_components":
        return E.encode_huffman(comps[:2], tables, 40, 24)
    if case == "five_components":
        return E.encode_huffman(comps + [dict(comps[0], id=4), dict(comps[0], id=5)], tables,
                                40, 24, app=b"")
    if case == "fractional_sampling":   # luma 3x1 over chroma 2x1
        c3 = E.blocks_from_image(img, ((3, 1), (3, 1), (3, 1)))[0]
        c3[1] = dict(c3[1], h=2, blocks=c3[1]["blocks"][:, :c3[1]["blocks"].shape[1] * 2 // 3])
        return E.encode_huffman(c3, tables, 40, 24)
    if case == "eleven_blocks_an_mcu":   # 2x4 + 1x2 + 1x1
        return E.encode_huffman(E.blocks_from_image(img, ((2, 4), (1, 2), (1, 1)))[0],
                                tables, 40, 24)
    if case == "lossless_gray":
        return E.encode_lossless(planes[:1], 40, 24)
    if case == "lossless_ycbcr":
        return E.encode_lossless(planes, 40, 24)
    if case == "lossless_ycck":
        return E.encode_lossless(planes + planes[:1], 40, 24, app=E.adobe_app14(2))
    if case == "lossless_12_bit":
        return E.encode_lossless([p.astype(np.int64) * 16 for p in planes], 40, 24,
                                 precision=12, app=E.adobe_app14(0))
    if case == "lossless_arithmetic":
        b = E.encode_lossless(planes, 40, 24, app=E.adobe_app14(0))
        return _with_byte(b, b.index(b"\xff\xc3") + 1, 0xCB)
    if case == "progressive_without_dht":
        prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
        return _without_first_tables(prog)
    assert case == "lossless_without_dht"
    return _without_first_tables(E.encode_lossless(planes, 40, 24, app=E.adobe_app14(0)))


def _without_first_tables(blob: bytes) -> bytes:
    """``blob`` without the DHT segments ahead of its first scan."""
    out, i = blob[:2], 2
    while blob[i + 1] != 0xDA:
        n = 2 + int.from_bytes(blob[i + 2:i + 4], "big")
        if blob[i + 1] != 0xC4:
            out += blob[i:i + n]
        i += n
    return out + blob[i:]


REFUSED = ["sof5", "sof6", "sof7", "sof13", "sof14", "sof15", "precision_byte_12", "twelve_bit",
           "dnl_height", "two_components", "five_components", "fractional_sampling",
           "eleven_blocks_an_mcu", "lossless_gray", "lossless_ycbcr", "lossless_ycck",
           "lossless_12_bit", "lossless_arithmetic", "progressive_without_dht",
           "lossless_without_dht"]


@pytest.mark.parametrize("case", REFUSED)
def test_unsupported_modes_raise(case):
    """What the decoder refuses, cv2.imread refuses too (None): hierarchical
    frames; a precision byte changed to 12 and a well-formed 12-bit file;
    a DNL height; 2 and 5 components; a fractional sampling ratio; 11
    blocks an MCU; lossless frames that need a colour conversion, 12-bit
    lossless and lossless arithmetic; progressive and lossless scans with
    no Huffman table (only the sequential decoder falls back on the
    standard ones). Progressive, 4:1:1 and arithmetic files now decode
    (tests/test_torch_jpeg_modes.py)."""
    blob = _refused_file(case)
    assert cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(RefusedJpeg):
        decode_jpeg(blob)


def _with_first_counts(blob: bytes, counts: list) -> bytes:
    """``blob`` with the code counts of its first Huffman table (lengths 1
    to 16) replaced by ``counts``, which hold as many codes as before."""
    at = blob.index(b"\xff\xc4") + 5        # marker, length, class/index
    counts = bytes(counts + [0] * (16 - len(counts)))
    assert sum(counts) == sum(blob[at:at + 16])
    return blob[:at] + counts + blob[at + 16:]


def test_corrupt_data_raises(tmp_path):
    """A file cut in its entropy-coded data, one without its SOI, one cut
    in its headers, and Huffman tables whose codes overflow their length
    (3 codes of 1 bit) or end in the all-ones code (12 codes that fill the
    code space, which jdhuff.c refuses too) raise ValueError (libjpeg would
    warn and fill). The first is refused before any code enters the table."""
    with open(_roundtrip(tmp_path, _picture(64, 64, 5), []), "rb") as f:
        blob = f.read()
    overflow = [3, 1, 2, 1, 1, 1, 1, 1, 1]
    all_ones = [1] * 10 + [2]
    for cut, match in ((blob[:len(blob) * 2 // 3], "premature end"), (blob[2:], "no SOI"),
                       (blob[:40], "truncated"),
                       (_with_first_counts(blob, overflow), "bad Huffman table"),
                       (_with_first_counts(blob, all_ones), "bad Huffman table")):
        with pytest.raises(ValueError, match=match):
            decode_jpeg(cut)


def test_read_image_bgr_dispatches_on_magic_bytes(tmp_path):
    """A JPEG named .png and a PNG named .jpg both read as cv2 reads them;
    RGBA and 8-bit gray PNGs come back as BGR."""
    from seevcn_torch.data.png import write_png

    img = _picture(30, 41, 9)
    jpg_as_png = _roundtrip(tmp_path, img, [])
    os.replace(jpg_as_png, tmp_path / "a.png")
    np.testing.assert_array_equal(read_image_bgr(str(tmp_path / "a.png")),
                                  cv2.imread(str(tmp_path / "a.png")))
    for i, arr in enumerate([img[..., ::-1], np.concatenate([img, img[..., :1]], -1),
                             img[..., 0]]):
        path = str(tmp_path / f"b{i}.jpg")
        write_png(path, np.ascontiguousarray(arr))
        np.testing.assert_array_equal(read_image_bgr(path), cv2.imread(path))
