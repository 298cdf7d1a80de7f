"""Frame plots drawn in numpy and written as PNGs (port of
seevcn_tpu/utils/viz.py, which draws with matplotlib; the card's host has
no matplotlib).

``draw_bev`` rasterizes a bird's-eye view on a white canvas of the JAX
figure's size (10 x 10 in at 150 dpi: 1500 x 1500 px): the points grey,
the completed points red, the predicted boxes blue with their scores at
their first corner in a built-in 3 x 5 digit font, the ground-truth boxes
teal (the JAX package's colours). x runs right and y up at one scale on
both axes (matplotlib's ``set_aspect("equal")``); box edges are OpenCV's
8-connected lines (``see/masks.line_pixels``). ``scatter_3d`` projects
the cloud in perspective from matplotlib's default 3-D view (elevation
30 degrees, azimuth -60), coloured by height along viridis, the box
wireframes blue, after the JAX package's subsample of ``max_points``.
Neither aims at matplotlib's pixels: no axes, ticks or antialiasing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.png import write_png
from ..geom.boxes import boxes_to_corners_3d, corners_bev
from ..see.masks import line_pixels

GREY = (0x80, 0x80, 0x80)
RED = (0xCC, 0x33, 0x11)
BLUE = (0x00, 0x77, 0xBB)
TEAL = (0x00, 0x99, 0x88)
# the edges of boxes_to_corners_3d's eight corners
BOX_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7))
# 3 x 5 glyphs, one row a string, for the scores
_GLYPHS = {
    "0": ("111", "101", "101", "101", "111"), "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"), "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"), "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"), "7": ("111", "001", "010", "010", "010"),
    "8": ("111", "101", "111", "101", "111"), "9": ("111", "101", "111", "001", "111"),
    ".": ("000", "000", "000", "000", "010"), "-": ("000", "000", "111", "000", "000"),
}
# viridis at 0, 1/4, 1/2, 3/4 and 1
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98],
                     [253, 231, 37]], np.float64)


def _bev_corners(boxes) -> np.ndarray:
    b = torch.as_tensor(np.asarray(boxes)[:, :7], dtype=torch.float32)
    return corners_bev(b).numpy()


class BEVView:
    """World (x, y) in metres -> pixel (column, row) on a canvas: x right, y
    up, one scale for both, the extent centred with a margin."""

    def __init__(self, lo, hi, size: tuple[int, int], margin: int = 20):
        self.height, self.width = size
        span = np.maximum(np.asarray(hi, np.float64) - np.asarray(lo, np.float64), 1e-6)
        self.scale = float(min((self.width - 2 * margin) / span[0],
                               (self.height - 2 * margin) / span[1]))
        self.center = (np.asarray(lo, np.float64) + np.asarray(hi, np.float64)) / 2

    def to_pixels(self, xy) -> np.ndarray:
        """(N, 2) metres -> (N, 2) int64 (column, row)."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        col = (xy[:, 0] - self.center[0]) * self.scale + self.width / 2
        row = (self.center[1] - xy[:, 1]) * self.scale + self.height / 2
        return np.floor(np.stack([col, row], -1)).astype(np.int64)


def _put(img: np.ndarray, px: np.ndarray, color, size: int = 1) -> None:
    """Paint size x size squares at the (column, row) pixels inside img."""
    h, w = img.shape[:2]
    for dy in range(size):
        for dx in range(size):
            c, r = px[:, 0] + dx, px[:, 1] + dy
            keep = (c >= 0) & (c < w) & (r >= 0) & (r < h)
            img[r[keep], c[keep]] = color


def draw_segment(img: np.ndarray, p0, p1, color) -> None:
    """An 8-connected line between two (column, row) pixels."""
    xs, ys = line_pixels(img.shape[1], img.shape[0], int(p0[0]), int(p0[1]),
                         int(p1[0]), int(p1[1]))
    img[ys, xs] = color


def draw_text(img: np.ndarray, text: str, at, color, scale: int = 2) -> None:
    """Digits, '.' and '-' in the 3 x 5 font, top left at ``at`` (column,
    row), each font pixel a scale x scale square."""
    col0, row0 = int(at[0]), int(at[1])
    for i, ch in enumerate(text):
        for r, bits in enumerate(_GLYPHS.get(ch, _GLYPHS["-"])):
            for c, bit in enumerate(bits):
                if bit == "1":
                    px = np.array([[col0 + (4 * i + c) * scale, row0 + r * scale]])
                    _put(img, px, color, scale)


def draw_bev(points, boxes=None, scores=None, gt_boxes=None, completed=None,
             size=(1500, 1500), point_size: int = 1):
    """-> (uint8 (H, W, 3) RGB canvas, its BEVView). The extent covers the
    points, the completed points and every box corner."""
    pts = np.asarray(points, np.float64)[:, :2]
    parts = [pts]
    comp = None if completed is None or len(completed) == 0 else \
        np.asarray(completed, np.float64)[:, :2]
    if comp is not None:
        parts.append(comp)
    sets = []
    for bset, color in ((gt_boxes, TEAL), (boxes, BLUE)):
        if bset is None or len(bset) == 0:
            continue
        corners = _bev_corners(bset)
        parts.append(corners.reshape(-1, 2))
        sets.append((bset, corners, color))
    allxy = np.concatenate(parts) if sum(len(p) for p in parts) else np.zeros((1, 2))
    view = BEVView(allxy.min(0), allxy.max(0), size)
    img = np.full((*size, 3), 255, np.uint8)
    _put(img, view.to_pixels(pts), GREY, point_size)
    if comp is not None:
        _put(img, view.to_pixels(comp), RED, 2 * point_size)
    for bset, corners, color in sets:
        for i, c in enumerate(corners):
            px = view.to_pixels(c)
            for k in range(4):
                draw_segment(img, px[k], px[(k + 1) % 4], color)
            if bset is boxes and scores is not None:
                draw_text(img, f"{float(scores[i]):.2f}", px[0] + 2, color)
    return img, view


def save_bev(path, points, boxes=None, scores=None, gt_boxes=None, completed=None,
             figsize=(10, 10), dpi=150):
    """draw_bev at figsize x dpi pixels, written as an RGB PNG -> path."""
    size = (int(figsize[1] * dpi), int(figsize[0] * dpi))
    img, _ = draw_bev(points, boxes, scores, gt_boxes, completed, size=size)
    write_png(path, img)
    return path


def subsample(points, max_points: int) -> np.ndarray:
    """The JAX package's subsample: ``max_points`` rows drawn without
    replacement by ``np.random.default_rng(0)``, or all rows."""
    p = np.asarray(points)
    if len(p) > max_points:
        p = p[np.random.default_rng(0).choice(len(p), max_points, replace=False)]
    return p


def project_3d(xyz, center, radius: float, size: tuple[int, int], elev: float = 30.0,
               azim: float = -60.0, distance: float = 10.0):
    """(N, 3) -> ((N, 2) pixel columns and rows, (N,) depth): a perspective
    camera looking at ``center`` from elevation ``elev`` and azimuth
    ``azim`` (degrees, matplotlib's convention) at ``distance`` times
    ``radius``, z up on the screen, the sphere of ``radius`` filling the
    shorter side."""
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    eye_dir = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.cross(eye_dir, right)
    rel = np.asarray(xyz, np.float64) - center
    depth = distance * radius - rel @ eye_dir
    f = distance * 0.5 * min(size) / 1.1
    u = f * (rel @ right) / np.maximum(depth, 1e-6)
    v = f * (rel @ up) / np.maximum(depth, 1e-6)
    px = np.stack([size[1] / 2 + u, size[0] / 2 - v], -1)
    return np.floor(px).astype(np.int64), depth


def scatter_3d(path, points, boxes=None, figsize=(10, 8), dpi=150, max_points=30000):
    """The cloud (subsampled as the JAX package does) and the box
    wireframes in perspective, written as an RGB PNG -> path."""
    size = (int(figsize[1] * dpi), int(figsize[0] * dpi))
    p = np.asarray(subsample(points, max_points), np.float64)[:, :3]
    lo, hi = p.min(0), p.max(0)
    center, radius = (lo + hi) / 2, max(float(np.linalg.norm(hi - lo)) / 2, 1e-6)
    img = np.full((*size, 3), 255, np.uint8)
    px, depth = project_3d(p, center, radius, size)
    z = (p[:, 2] - lo[2]) / max(hi[2] - lo[2], 1e-9) * (len(_VIRIDIS) - 1)
    k = np.minimum(z.astype(np.int64), len(_VIRIDIS) - 2)
    colors = (_VIRIDIS[k] + (z - k)[:, None] * (_VIRIDIS[k + 1] - _VIRIDIS[k])).round()
    order = np.argsort(-depth, kind="stable")          # far first, near on top
    h, w = size
    keep = order[(px[order, 0] >= 0) & (px[order, 0] < w) & (px[order, 1] >= 0)
                 & (px[order, 1] < h)]
    img[px[keep, 1], px[keep, 0]] = colors[keep].astype(np.uint8)
    if boxes is not None and len(boxes):
        corners = boxes_to_corners_3d(torch.as_tensor(np.asarray(boxes)[:, :7],
                                                      dtype=torch.float32)).numpy()
        for c in corners:
            cpx, _ = project_3d(c, center, radius, size)
            for i, j in BOX_EDGES:
                draw_segment(img, cpx[i], cpx[j], BLUE)
    write_png(path, img)
    return path
