"""Write the JPEG fixtures of tests/data/jpeg/ and record, for each, its
mode, its shape and the sha256 of the array ``cv2.imread`` returns
(``fixtures.json``). The decoder's tests and ``chip_smoke.py`` hold
``seevcn_torch.data.jpeg.read_jpeg`` against those hashes where OpenCV is
not installed.

The files come from OpenCV, from PIL (CMYK) and, for the modes neither
writes (arithmetic coding, lossless), from the test-side encoder
``seevcn_torch.testing_jpeg``. The progressive copy of the demo's picture
carries an EXIF segment with a 16 x 9 JPEG thumbnail ahead of the frame.

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]
"""
import argparse
import hashlib
import io
import json
import os
import sys

import cv2
import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from seevcn_torch import testing_jpeg as E  # noqa: E402


def scene(h: int, w: int, seed: int, gray: bool = False) -> np.ndarray:
    """A road-like BGR picture: a sky gradient, a road, boxes and discs,
    light noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float64)
    horizon = h * 0.45
    sky = y < horizon
    img[sky] = np.stack([230 - 80 * y / h, 180 - 60 * y / h, 120 + 0 * y], -1)[sky]
    img[~sky] = np.stack([90 + 30 * x / w, 95 + 0 * x, 100 - 20 * x / w], -1)[~sky]
    img = img.astype(np.uint8)
    for _ in range(max(3, (h * w) // 60000)):
        c = tuple(int(v) for v in rng.randint(0, 256, 3))
        x0, y0 = int(rng.randint(0, w)), int(rng.randint(int(horizon), h))
        bw, bh = int(rng.randint(w // 20 + 2, w // 6 + 3)), int(rng.randint(h // 20 + 2, h // 8 + 3))
        cv2.rectangle(img, (x0, y0), (x0 + bw, y0 + bh), c, -1)
        cv2.circle(img, (x0 + bw // 4, y0 + bh), max(bh // 4, 1), (20, 20, 20), -1)
        cv2.circle(img, (x0 + 3 * bw // 4, y0 + bh), max(bh // 4, 1), (20, 20, 20), -1)
    cv2.putText(img, "SEE-VCN", (w // 10, max(int(horizon) // 2, 12)), cv2.FONT_HERSHEY_SIMPLEX,
                max(w / 600, 0.3), (255, 255, 255), 2)
    img = np.clip(img.astype(np.int16) + rng.randint(-3, 4, img.shape), 0, 255).astype(np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img


def cv2_jpeg(img, params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def cv2_writer(*params):
    return lambda img: cv2_jpeg(img, list(params))


def with_thumbnail(*params):
    def write(img):
        thumb = cv2_jpeg(cv2.resize(img, (16, 9), interpolation=cv2.INTER_AREA), [])
        blob = cv2_jpeg(img, list(params))
        return E.with_segment(blob, E.exif_app1(1, thumbnail=thumb))
    return write


def arithmetic(img) -> bytes:
    comps, tables = E.blocks_from_image(img, ((2, 2), (1, 1), (1, 1)), quality=90)
    return E.encode_arithmetic(comps, tables, img.shape[1], img.shape[0])


def cmyk_pil(img) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., ::-1])).convert("CMYK").save(
        bio, "JPEG", quality=90)
    return bio.getvalue()


def lossless_rgb(img) -> bytes:
    planes = [img[..., 2], img[..., 1], img[..., 0]]
    return E.encode_lossless(planes, img.shape[1], img.shape[0], predictor=4, pt=1,
                             app=E.adobe_app14(0))


PROGRESSIVE = (cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
FIXTURES = {
    # name: (height, width, seed of scene()'s picture, mode, writer)
    "nuscenes_900x1600_420.jpg": (900, 1600, 0, "baseline",
                                  cv2_writer(cv2.IMWRITE_JPEG_QUALITY, 90)),
    "demo_720x1260_420.jpg": (720, 1260, 1, "baseline", cv2_writer(cv2.IMWRITE_JPEG_QUALITY, 90)),
    "s444_120x200.jpg": (120, 200, 2, "baseline", cv2_writer(
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
    "s422_120x200.jpg": (120, 200, 3, "baseline", cv2_writer(
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
    "gray_96x128.jpg": (96, 128, 4, "baseline_gray", cv2_writer()),
    "restart_100x150.jpg": (100, 150, 5, "baseline", cv2_writer(cv2.IMWRITE_JPEG_RST_INTERVAL, 3)),
    "odd_37x53.jpg": (37, 53, 6, "baseline", cv2_writer()),
    "progressive_64x96.jpg": (64, 96, 7, "progressive", cv2_writer(cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
    # the pictures of the two baseline frames above, progressive
    "nuscenes_900x1600_progressive.jpg": (900, 1600, 0, "progressive", cv2_writer(*PROGRESSIVE)),
    "demo_720x1260_progressive_exif.jpg": (720, 1260, 1, "progressive_exif",
                                           with_thumbnail(*PROGRESSIVE)),
    "s411_75x203.jpg": (75, 203, 8, "baseline_411", cv2_writer(
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)),
    "arithmetic_900x1600.jpg": (900, 1600, 0, "arithmetic", arithmetic),
    "cmyk_96x128.jpg": (96, 128, 9, "cmyk", cmyk_pil),
    "lossless_rgb_48x64.jpg": (48, 64, 10, "lossless", lossless_rgb),
}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join("tests", "data", "jpeg"))
    out = p.parse_args().out
    os.makedirs(out, exist_ok=True)
    table = {}
    for name, (h, w, seed, mode, writer) in FIXTURES.items():
        blob = writer(scene(h, w, seed, gray=mode.endswith("gray")))
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(blob)
        arr = cv2.imread(path)
        assert arr is not None, name
        table[name] = {"mode": mode, "shape": list(arr.shape),
                       "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()}
    with open(os.path.join(out, "fixtures.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    print(json.dumps({k: os.path.getsize(os.path.join(out, k)) for k in table}))


if __name__ == "__main__":
    main()
