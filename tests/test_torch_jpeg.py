"""The port's JPEG reader (seevcn_torch.data.jpeg, the C++ decoder in
seevcn_torch/csrc/jpeg_decode.cpp) against cv2.imread, and the image
dispatcher of the CLIs (seevcn_torch.data.image).

Inputs: synthetic pictures (gradients, filled shapes, noise from a seeded
RandomState) written by cv2 at qualities 50, 75 and 95, in the sampling
modes 4:4:4, 4:2:2, 4:2:0 and 4:4:0, grayscale, with restart intervals, at
odd and tiny sizes; and the committed fixtures of tests/data/jpeg
(scripts/make_jpeg_fixtures.py) against the sha256 of cv2's array.

Tolerance: none. Every baseline mode is cv2's array byte for byte
(libjpeg-turbo's integer IDCT, fancy upsampling and colour tables).
Progressive, 4:1:1, arithmetic-coded and 12-bit files raise
NotImplementedError naming their marker; truncated data raises ValueError.
"""
import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from seevcn_torch.data.image import read_image_bgr
from seevcn_torch.data.jpeg import decode_jpeg, jpeg_info, read_jpeg
from seevcn_torch.data.kitti.bootstrap import read_image_shape

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
    cv2): their recorded cv2 hashes, and cv2 itself here."""
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        table = json.load(f)
    assert len(table) == 8
    assert sum(os.path.getsize(os.path.join(FIXTURES, k)) for k in table) < 1 << 20
    for name, rec in table.items():
        path = os.path.join(FIXTURES, name)
        assert tuple(int(v) for v in read_image_shape(path)) == tuple(rec["shape"][:2])
        if rec["progressive"]:
            with pytest.raises(NotImplementedError, match="SOF2"):
                read_jpeg(path)
            continue
        got = read_jpeg(path)
        assert list(got.shape) == rec["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"], name
        np.testing.assert_array_equal(got, cv2.imread(path))


def _with_byte(blob: bytes, offset: int, value: int) -> bytes:
    return blob[:offset] + bytes([value]) + blob[offset + 1:]


def test_unsupported_modes_raise(tmp_path):
    """Progressive (cv2's IMWRITE_JPEG_PROGRESSIVE) and 4:1:1 are cv2's own
    files; arithmetic coding and 12-bit samples are a baseline file with its
    SOF0 marker or its precision byte changed."""
    img = _picture(40, 48, 3)
    prog = _roundtrip(tmp_path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive JPEG \\(SOF2\\)"):
        read_jpeg(prog)
    s411 = _roundtrip(tmp_path, img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    with pytest.raises(NotImplementedError, match="sampling factor 4x1"):
        read_jpeg(s411)
    with open(_roundtrip(tmp_path, img, []), "rb") as f:
        blob = f.read()
    sof = blob.index(b"\xff\xc0")
    with pytest.raises(NotImplementedError, match="arithmetic-coded JPEG \\(SOF9\\)"):
        decode_jpeg(_with_byte(blob, sof + 1, 0xC9))
    with pytest.raises(NotImplementedError, match="12-bit"):
        decode_jpeg(_with_byte(blob, sof + 4, 12))


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
