"""Write the JPEG fixtures of tests/data/jpeg/ with OpenCV and record, for
each, its shape and the sha256 of the array ``cv2.imread`` returns
(``fixtures.json``). The decoder's tests and ``chip_smoke.py`` hold
``seevcn_torch.data.jpeg.read_jpeg`` against those hashes where OpenCV is
not installed.

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]
"""
import argparse
import hashlib
import json
import os

import cv2
import numpy as np


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


FIXTURES = {
    # name: (height, width, gray, imwrite params)
    "nuscenes_900x1600_420.jpg": (900, 1600, False, [cv2.IMWRITE_JPEG_QUALITY, 90]),
    "demo_720x1260_420.jpg": (720, 1260, False, [cv2.IMWRITE_JPEG_QUALITY, 90]),
    "s444_120x200.jpg": (120, 200, False, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "s422_120x200.jpg": (120, 200, False, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "gray_96x128.jpg": (96, 128, True, []),
    "restart_100x150.jpg": (100, 150, False, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    "odd_37x53.jpg": (37, 53, False, []),
    "progressive_64x96.jpg": (64, 96, False, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join("tests", "data", "jpeg"))
    out = p.parse_args().out
    os.makedirs(out, exist_ok=True)
    table = {}
    for i, (name, (h, w, gray, params)) in enumerate(FIXTURES.items()):
        path = os.path.join(out, name)
        assert cv2.imwrite(path, scene(h, w, i, gray), params)
        arr = cv2.imread(path)
        table[name] = {"shape": list(arr.shape),
                       "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest(),
                       "progressive": "progressive" in name}
    with open(os.path.join(out, "fixtures.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    print(json.dumps({k: os.path.getsize(os.path.join(out, k)) for k in table}))


if __name__ == "__main__":
    main()
