"""The JPEG modes beyond baseline in the port's decoder
(seevcn_torch/csrc/jpeg_decode.cpp behind seevcn_torch.data.jpeg), each
against cv2.imread (libjpeg-turbo) on the same bytes.

Inputs: seeded pictures (seevcn_torch.testing_jpeg.picture) written by
  * cv2: progressive at qualities 50/75/95 in 4:4:4, 4:2:2, 4:2:0 and
    4:4:0, gray, with restart intervals 1 and 3; 4:1:1 at odd widths,
    baseline and progressive; progressive files cut after each of their
    scans (EOI kept), whose first AC coefficients are not fully refined,
    so that libjpeg-turbo smooths them;
  * PIL: progressive and optimized files; CMYK with its Adobe marker;
  * the test-side encoder (seevcn_torch.testing_jpeg, a port of
    jcarith.c): arithmetic SOF9 and SOF10 with and without DAC and DRI,
    at sampling factors up to 4, cut progressions; YCCK; lossless with
    predictors 1-7, precisions 2-8, point transforms and restarts;
  * EXIF segments with each orientation (OpenCV turns the image), and a
    sequential file without DHT (libjpeg-turbo's standard tables).
The encoder's arithmetic files are themselves held against cv2: their
array equals cv2's of a Huffman file of the same coefficients.

Tolerance: none; every case is cv2's array byte for byte.
"""
import io

import cv2
import numpy as np
import pytest
from PIL import Image

from seevcn_torch import testing_jpeg as E
from seevcn_torch.data.jpeg import decode_jpeg, image_shape

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(64, 96), (37, 53), (1, 1), (3, 5), (17, 2), (120, 161)]
#: (h, v) of Y, Cb, Cr for the encoder's files
FACTORS = {"444": ((1, 1), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
           "420": ((2, 2), (1, 1), (1, 1)), "411": ((4, 1), (1, 1), (1, 1)),
           "410": ((4, 2), (1, 1), (1, 1)), "1x4": ((1, 4), (1, 1), (1, 1)),
           "3x2": ((3, 2), (1, 1), (1, 1))}


def cv2_decode(blob: bytes):
    return cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)


def cv2_encode(img, params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def assert_as_cv2(blob: bytes, what: str):
    ref = cv2_decode(blob)
    assert ref is not None, what
    got = decode_jpeg(blob)
    assert got.dtype == np.uint8 and got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=what)
    assert image_shape(blob) == ref.shape[:2], what


def scan_starts(blob: bytes) -> list:
    """The offsets of the SOS markers of a JPEG, walked segment by segment."""
    starts, i = [], 2
    while blob[i + 1] != 0xD9:
        if blob[i + 1] == 0xDA:
            starts.append(i)
            i += 2 + int.from_bytes(blob[i + 2:i + 4], "big")
            while not (blob[i] == 0xFF and blob[i + 1] != 0 and not 0xD0 <= blob[i + 1] <= 0xD7):
                i += 1
            continue
        i += 2 + int.from_bytes(blob[i + 2:i + 4], "big")
    return starts


def cut_after_each_scan(blob: bytes):
    """The file cut after its 1st, 2nd, ... scan (all but the last), EOI kept."""
    starts = scan_starts(blob)
    assert len(starts) > 1
    for k in range(1, len(starts)):
        yield k, blob[:starts[k]] + b"\xff\xd9"


# --- progressive Huffman (SOF2) --------------------------------------------

@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
def test_progressive_matches_cv2(quality, sampling):
    """cv2's progressive files (its jpeg_simple_progression: DC first and
    refine scans interleaved, AC scans of one component with EOB runs and
    successive approximation) at even, odd and tiny sizes."""
    for i, (h, w) in enumerate(SIZES):
        assert_as_cv2(cv2_encode(E.picture(h, w, i), [
            cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            SAMPLING[sampling], cv2.IMWRITE_JPEG_PROGRESSIVE, 1]), f"{h}x{w}")


@pytest.mark.parametrize("case", ["gray", "restart_1", "restart_3", "restart_gray"])
def test_progressive_gray_and_restart_intervals(case):
    """Gray progressive, and restart intervals, which reset the DC
    predictions and the EOB run."""
    gray = case.endswith("gray")
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if case != "gray":
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 1 if case == "restart_1" else 3]
    for i, (h, w) in enumerate(SIZES):
        blob = cv2_encode(E.picture(h, w, 10 + i, gray=gray), params)
        assert case == "gray" or b"\xff\xdd" in blob
        assert_as_cv2(blob, f"{h}x{w}")


@pytest.mark.parametrize("options", ["progressive", "optimize", "progressive_optimize",
                                     "progressive_444", "progressive_gray"])
def test_pil_progressive_and_optimized_match_cv2(options):
    """PIL's progressive and optimized files (their own Huffman tables,
    redefined between scans)."""
    kw = {"progressive": "progressive" in options, "optimize": "optimize" in options,
          "quality": 80}
    if options.endswith("444"):
        kw["subsampling"] = 0
    for i, (h, w) in enumerate(SIZES):
        img = E.picture(h, w, 20 + i, gray=options.endswith("gray"))
        bio = io.BytesIO()
        Image.fromarray(img if img.ndim == 2 else img[..., ::-1]).save(bio, "JPEG", **kw)
        assert_as_cv2(bio.getvalue(), f"{h}x{w}")


# --- 4:1:1 and other sampling factors up to 4 --------------------------------

@pytest.mark.parametrize("progressive", [0, 1])
def test_411_matches_cv2(progressive):
    """4:1:1 (32-pixel-wide MCUs, chroma replicated by int_upsample) at
    widths that are not a multiple of 32, and tiny ones."""
    for w in (1, 5, 31, 33, 63, 65, 97, 161):
        for quality in (50, 95):
            assert_as_cv2(cv2_encode(E.picture(19, w, w), [
                cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                SAMPLING["411"], cv2.IMWRITE_JPEG_PROGRESSIVE, progressive]), f"w {w}")


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411", "gray"])
def test_cut_progressive_is_smoothed_as_cv2(sampling):
    """A progressive file cut after each of its scans: its first AC
    coefficients are not all refined, so libjpeg-turbo's block smoothing
    (5x5 DC neighbourhoods; DC interpolation where only DC scans came)
    runs, including the rows near an iMCU row's edge."""
    params = [cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if sampling != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    for i, (h, w) in enumerate([(64, 96), (37, 53), (120, 161), (33, 70), (17, 2), (200, 150)]):
        blob = cv2_encode(E.picture(h, w, 30 + i, gray=sampling == "gray"), params)
        for k, cut in cut_after_each_scan(blob):
            assert_as_cv2(cut, f"{h}x{w} cut after scan {k}")


# --- arithmetic coding (SOF9, SOF10) -----------------------------------------

ARITH = {"plain": {}, "dac": {"dac": {0: (1, 3, 3), 1: (0, 2, 10)}},
         "restart": {"restart": 2}, "dac_restart": {"dac": {0: (2, 5, 1)}, "restart": 3,
                                                     "write_dac": True}}


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("case", list(ARITH))
def test_arithmetic_matches_cv2(progressive, case):
    """The encoder's arithmetic files, sequential and progressive, with and
    without DAC conditioning and restart intervals, at sampling factors up
    to 4; each also decodes in cv2 to the array of a Huffman file of the
    same coefficients."""
    for sampling in ("444", "420", "411", "1x4"):
        for i, (h, w) in enumerate([(37, 53), (1, 1), (17, 2), (40, 72)]):
            img = E.picture(h, w, 40 + i)
            comps, tables = E.blocks_from_image(img, FACTORS[sampling], quality=80)
            blob = E.encode_arithmetic(comps, tables, w, h, progressive=progressive,
                                       **ARITH[case])
            what = f"{sampling} {h}x{w}"
            assert_as_cv2(blob, what)
            np.testing.assert_array_equal(
                cv2_decode(blob), cv2_decode(E.encode_huffman(comps, tables, w, h)), what)


@pytest.mark.parametrize("sampling", ["420", "410", "3x2"])
def test_arithmetic_progressive_cut_is_smoothed_as_cv2(sampling):
    """Arithmetic progressions cut after each scan, at vertical sampling
    factors 2 and 4 (block smoothing over iMCU rows of 2 and 4 block
    rows) and a 3x2 luma (chroma by int_upsample)."""
    img = E.picture(75, 58, 50)
    comps, tables = E.blocks_from_image(img, FACTORS[sampling], quality=60)
    blob = E.encode_arithmetic(comps, tables, 58, 75, progressive=True, restart=5)
    for k, cut in cut_after_each_scan(blob):
        assert_as_cv2(cut, f"cut after scan {k}")


def test_arithmetic_probe_file_matches_cv2():
    """A baseline file whose SOF0 byte says SOF9: the Huffman data read as
    arithmetic-coded, which cv2 decodes (with a warning) and so does the
    port, to the same array."""
    blob = cv2_encode(E.picture(40, 48, 3), [])
    sof = blob.index(b"\xff\xc0")
    assert_as_cv2(blob[:sof + 1] + b"\xc9" + blob[sof + 2:], "SOF9 byte")


# --- four components ---------------------------------------------------------

@pytest.mark.parametrize("case", ["pil_cmyk", "pil_cmyk_progressive", "ycck", "adobe_1",
                                  "no_adobe", "ycck_arithmetic_progressive"])
def test_four_components_match_cv2(case):
    """CMYK as PIL writes it (Adobe transform 0, inverted values), YCCK
    (transform 2, and 1, which libjpeg takes for YCCK), four components
    without an Adobe marker (CMYK), each through OpenCV's CMYK -> BGR."""
    for i, (h, w) in enumerate([(40, 56), (17, 2), (33, 70)]):
        img = E.picture(h, w, 60 + i)
        if case.startswith("pil"):
            bio = io.BytesIO()
            Image.fromarray(img[..., ::-1]).convert("CMYK").save(
                bio, "JPEG", quality=85, progressive=case.endswith("progressive"))
            blob = bio.getvalue()
        else:
            comps, tables = E.blocks_from_image(img, ((2, 2), (1, 1), (1, 1)), quality=85)
            comps.append(dict(comps[0], id=4, blocks=-comps[0]["blocks"]))   # K: Y inverted
            app = {"ycck": E.adobe_app14(2), "adobe_1": E.adobe_app14(1),
                   "no_adobe": b"", "ycck_arithmetic_progressive": E.adobe_app14(2)}[case]
            blob = (E.encode_arithmetic(comps, tables, w, h, progressive=True, app=app)
                    if case.endswith("progressive") else
                    E.encode_huffman(comps, tables, w, h, app=app))
        assert_as_cv2(blob, f"{h}x{w}")


# --- lossless (SOF3) ---------------------------------------------------------

@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_matches_cv2(predictor):
    """Lossless files in the colour spaces cv2 reads them in (RGB by an
    Adobe marker or by component ids, CMYK), at precisions 2, 6 and 8,
    point transforms 0 and 1, with and without restart intervals."""
    for i, (h, w) in enumerate([(19, 33), (1, 1), (7, 3)]):
        img = E.picture(h, w, 70 + i)
        for precision in (2, 6, 8):
            planes = [img[..., c].astype(np.int64) * ((1 << precision) - 1) // 255
                      for c in (2, 1, 0)]
            for pt in (0, 1):
                for space in ("adobe_rgb", "rgb_ids", "cmyk"):
                    for restart_rows in (0, 2):
                        blob = E.encode_lossless(
                            planes + (planes[:1] if space == "cmyk" else []), w, h,
                            predictor=predictor, pt=pt, precision=precision,
                            ids=(82, 71, 66) if space == "rgb_ids" else (1, 2, 3, 4),
                            app={"adobe_rgb": E.adobe_app14(0)}.get(space, b""),
                            restart_rows=restart_rows)
                        assert_as_cv2(blob, f"{h}x{w} P{precision} Pt{pt} {space} "
                                            f"rst {restart_rows}")


# --- what cv2.imread does around the frame -------------------------------------

@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(orientation):
    """OpenCV turns the image by the EXIF orientation of the first APP1
    segment (little- and big-endian TIFF); the shape the demo reads turns
    with it."""
    blob = cv2_encode(E.picture(24, 40, 80), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    for big_endian in (False, True):
        assert_as_cv2(E.with_segment(blob, E.exif_app1(orientation, big_endian=big_endian)),
                      f"big endian {big_endian}")
    # only the first APP1 segment counts
    first = E.with_segment(E.with_segment(blob, E.exif_app1(orientation)), E.exif_app1(1))
    assert_as_cv2(first, "a second APP1 after an orientation-1 one")
    assert image_shape(first) == (24, 40)


def test_missing_huffman_tables_take_the_standard_ones():
    """A sequential file without its DHT segments (a Motion-JPEG frame):
    libjpeg-turbo's decoder fills the empty slots with the standard
    tables, which cv2's own files use."""
    for gray in (False, True):
        for params in ([], [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]):
            blob = cv2_encode(E.picture(40, 48, 90, gray=gray), params)
            out, i = blob[:2], 2
            while blob[i + 1] != 0xDA:
                n = 2 + int.from_bytes(blob[i + 2:i + 4], "big")
                if blob[i + 1] != 0xC4:
                    out += blob[i:i + n]
                i += n
            assert b"\xff\xc4" not in out[:i]
            assert_as_cv2(out + blob[i:], f"gray {gray} {params}")
