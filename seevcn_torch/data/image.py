"""``cv2.imread(path)`` for the image files the port reads: a PNG
(``data/png.py``) or a JPEG (``data/jpeg.py``), told apart by their first
bytes, as OpenCV tells them apart."""
from __future__ import annotations

import numpy as np

from .jpeg import decode_jpeg
from .png import read_png


def read_image_bgr(path: str) -> np.ndarray:
    """A PNG or JPEG file -> uint8 (H, W, 3) BGR, as ``cv2.imread(path,
    cv2.IMREAD_COLOR)`` gives it: a PNG's alpha is dropped and its gray
    replicated; a 16-bit PNG raises."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] == b"\xff\xd8":
        return decode_jpeg(blob, str(path))
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG is not a colour image")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])
