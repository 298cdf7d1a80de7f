"""COCO-JSON instance masks (port of seevcn_tpu/see/masks.py).

The SEE stage reads 2D instance masks stored as COCO JSON, one file a
camera (the reference's generate_masks.py writes them, its datasets read
them with pycocotools). This module keeps the small part used: the
annotations of an image, polygon -> binary mask, the polygon shrink, and
the lidar points inside each mask, with no pycocotools.

The reference rasterizes with ``cv2.fillPoly``, which the card's host does
not have. ``polygons_to_mask`` is a numpy copy of its semantics (OpenCV
5.0's, for integer vertices: 8-connected lines, shift 0): the vertices
rounded half to even; every polygon's outline drawn with OpenCV's
Bresenham walk (``LineIterator``), clipped to the image as ``clipLine``
clips it; then all the polygons' edges filled together by OpenCV's
scanline rule (``FillEdgeCollection``): 16.16 fixed-point edges through the
vertices over half-open row ranges (an edge with an end outside the image
takes the columns of its clipped ends, and their rows where they differ),
the crossings of a row sorted and paired, each pair's span filled from the
ceiling of the left crossing to the floor of the right one. Pairing
crossings is the even-odd rule, so overlapping and self-intersecting
polygons fill as cv2's do; a polygon of under 6 numbers is skipped.

``external_contours`` is the border follower of ``cv2.findContours(mask,
RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``: Suzuki and Abe's raster scan with
OpenCV's marks, its direction codes and its compression to the points
where the direction changes, the image padded with a zero border, the
contours in cv2's order.
"""
from __future__ import annotations

import json

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


class CocoMasks:
    """Minimal COCO reader: images and annotations with polygon
    segmentation, from a path or a loaded dict."""

    def __init__(self, path_or_dict):
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                d = json.load(f)
        else:
            d = path_or_dict
        self.images = {im["id"]: im for im in d.get("images", [])}
        self.anns = {}
        self.img_to_anns = {}
        for a in d.get("annotations", []):
            self.anns[a["id"]] = a
            self.img_to_anns.setdefault(a["image_id"], []).append(a)
        self.file_to_img = {im.get("file_name"): im for im in d.get("images", [])}

    def get_ann_ids(self, img_ids):
        if not isinstance(img_ids, (list, tuple)):
            img_ids = [img_ids]
        out = []
        for i in img_ids:
            out.extend(a["id"] for a in self.img_to_anns.get(i, []))
        return out

    def load_anns(self, ann_ids):
        return [self.anns[i] for i in ann_ids]

    # pycocotools' names, which the reference calls
    def getAnnIds(self, imgIds):  # noqa: N802
        return self.get_ann_ids(imgIds)

    def loadAnns(self, ids):  # noqa: N802
        return self.load_anns(ids)

    def annToMask(self, ann):  # noqa: N802
        img = self.images[ann["image_id"]]
        return polygons_to_mask(ann["segmentation"], img["height"], img["width"])


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on integer end points: -> (inside, x1, y1, x2,
    y2), the segment cut to [0, width) x [0, height), each cut's offset
    computed in double and truncated toward zero."""
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line_pixels(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels (xs, ys) of OpenCV's 8-connected ``Line`` from (x1, y1) to
    (x2, y2) inside the image (``LineIterator`` left to right): clipped
    first when an end lies outside, then the Bresenham walk from the left
    end, the error starting at D - 2d (D the major and d the minor extent),
    a minor step whenever it is below 0. The k-th point's minor offset is
    then ceil((2 d k - D) / (2 D))."""
    if not (0 <= x1 < width and 0 <= x2 < width and 0 <= y1 < height and 0 <= y2 < height):
        inside, x1, y1, x2, y2 = clip_line(width, height, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    ydir = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    off = -((major - 2 * minor * k) // (2 * major)) if major else k
    if dy > dx:
        return x1 + off, y1 + ydir * k
    return x1 + k, y1 + ydir * off


def fill_poly(mask: np.ndarray, polys, value: int = 1) -> np.ndarray:
    """``cv2.fillPoly(mask, polys, value)`` for integer (K, 2) vertex arrays
    (8-connected, shift 0), in place; returns ``mask``."""
    height, width = mask.shape[:2]
    ex, edx, ey0, ey1 = [], [], [], []
    for poly in polys:
        v = np.asarray(poly, np.int64).reshape(-1, 2).tolist()
        px, py = v[-1]
        for qx, qy in v:
            xs, ys = line_pixels(width, height, px, py, qx, qy)
            mask[ys, xs] = value
            x0c, y0c, x1c, y1c = px << XY_SHIFT, py, qx << XY_SHIFT, qy
            if (px | qx) < 0 or px >= width or qx >= width or (py | qy) < 0 \
                    or py >= height or qy >= height:
                _, t0x, t0y, t1x, t1y = clip_line(width, height, px, py, qx, qy)
                x0c, x1c = t0x << XY_SHIFT, t1x << XY_SHIFT
                if t0y != t1y:
                    y0c, y1c = t0y, t1y
            if py != qy:
                num, den = x1c - x0c, y1c - y0c
                dx = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
                if py < qy:
                    ex.append(x0c + (py - y0c) * dx)
                    ey0.append(py)
                    ey1.append(qy)
                else:
                    ex.append(x1c + (qy - y1c) * dx)
                    ey0.append(qy)
                    ey1.append(py)
                edx.append(dx)
            px, py = qx, qy
    if len(ex) < 2:
        return mask
    ex, edx, ey0, ey1 = (np.array(a, np.int64) for a in (ex, edx, ey0, ey1))
    x_end = ex + (ey1 - ey0) * edx
    if ey1.max() < 0 or ey0.min() >= height or max(ex.max(), x_end.max()) < 0 \
            or min(ex.min(), x_end.min()) >= (width << XY_SHIFT):
        return mask
    # each edge crosses rows y0 <= y < y1 at x0 + (y - y0) dx; only rows
    # inside the image are drawn, and a row's crossings pair up on their own
    lo, hi = np.maximum(ey0, 0), np.minimum(ey1, height)
    n = np.maximum(hi - lo, 0)
    if not n.any():
        return mask
    edge = np.repeat(np.arange(len(ex)), n)
    y = lo[edge] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    x = ex[edge] + (y - ey0[edge]) * edx[edge]
    order = np.lexsort((x, y))
    y, x = y[order].reshape(-1, 2), x[order].reshape(-1, 2)
    x1, x2 = (x[:, 0] + XY_ONE - 1) >> XY_SHIFT, x[:, 1] >> XY_SHIFT
    keep = (x1 < width) & (x2 >= 0)
    rows, x1, x2 = y[keep, 0], np.maximum(x1[keep], 0), np.minimum(x2[keep], width - 1)
    diff = np.zeros((height, width + 1), np.int32)
    np.add.at(diff, (rows, x1), 1)
    np.add.at(diff, (rows, x2 + 1), -1)
    mask[np.cumsum(diff[:, :width], axis=1) > 0] = value
    return mask


#: OpenCV's chain-code steps (x, y) of the eight directions, east first and
#: counter-clockwise in image coordinates
_CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _trace_border(img: np.ndarray, start: int, width: int, x: int, y: int) -> list:
    """OpenCV's ``icvFetchContour`` of an outer border from the flat index
    ``start`` of the padded int8 image ``img`` (1 foreground, 0 background,
    marks 2 and -126), the chain compressed as CHAIN_APPROX_SIMPLE does:
    -> [(x, y), ...] in the unpadded image's coordinates. Marks the border
    in place."""
    deltas = [1, 1 - width, -width, -width - 1, -1, width - 1, width, width + 1] * 2
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        i1 = start + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:                                   # a single pixel
        img[start] = -126
        return [(x, y)]
    pts, i3, prev_s = [], start, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:                          # the right side was seen
            img[i3] = -126
        elif img[i3] == 1:
            img[i3] = 2
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _CODE_DELTAS[s][0]
        y += _CODE_DELTAS[s][1]
        if i4 == start and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def external_contours(mask: np.ndarray) -> list:
    """``cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)[0]`` for a 2D mask (nonzero = foreground): ->
    list of (K, 2) int32 arrays of (x, y) vertices, the outer borders of the
    components that lie in no hole of another, in cv2's order (the last
    found first)."""
    h, w = mask.shape
    pad = np.zeros((h + 2, w + 2), np.int8)
    pad[1:-1, 1:-1] = mask != 0
    width = w + 2
    flat = pad.reshape(-1)
    found = []
    for y in np.flatnonzero(pad.any(axis=1)):
        row = pad[y]
        x, prev, lnbd = 1, 0, 0
        while x < width:
            change = np.flatnonzero(row[x:] != prev)
            if not change.size:
                break
            x += int(change[0])
            p = int(row[x])
            if prev == 0 and p == 1 and lnbd <= 0:   # an outer border to follow
                found.append(_trace_border(flat, y * width + x, width, x - 1, y - 1))
                prev = int(row[x])
            else:
                prev = p
                if p not in (0, 1):
                    lnbd = p
            x += 1
    return [np.array(c, np.int32).reshape(-1, 2) for c in reversed(found)]


def polygons_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """COCO polygon list [[x0, y0, x1, y1, ...], ...] -> (H, W) uint8 mask,
    as the reference's ``cv2.fillPoly`` of the rounded vertices."""
    mask = np.zeros((height, width), np.uint8)
    polys = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
             for p in segmentation if len(p) >= 6]
    if polys:
        fill_poly(mask, polys, 1)
    return mask


def shrink_polygons(segmentation, shrink_percentage: float):
    """Scale each polygon toward its centroid by (1 - pct/100) (the
    reference's shared_utils.shrink_instance_masks)."""
    out = []
    s = 1.0 - shrink_percentage / 100.0
    for p in segmentation:
        pts = np.asarray(p, np.float64).reshape(-1, 2)
        c = pts.mean(axis=0)
        out.append(((pts - c) * s + c).reshape(-1).tolist())
    return out


def get_pts_in_mask(coco: CocoMasks, instances, imgfov: dict,
                    shrink_percentage: float = 0.0, use_bbox: bool = False) -> dict:
    """The in-FOV lidar points of each instance mask.

    imgfov: 'pts_img' (N, 2 int), 'pc_lidar' (N, 3+), 'pc_cam' (N, 3) or
    None, 'img_shape' (H, W), as a dataset adapter's
    ``map_pointcloud_to_image`` gives them. Returns the reference's
    instance_pts dict (shared_utils.py:36-106): per instance with at least
    one point, its image coordinates, camera and lidar points, and its
    annotation (with its ``bin_mask``)."""
    pts_img = imgfov["pts_img"]
    pc_lidar = imgfov["pc_lidar"]
    pc_cam = imgfov.get("pc_cam")
    h, w = imgfov["img_shape"]

    uv_list, cam_list, lidar_list, labels = [], [], [], []
    for inst_orig in instances:
        inst = dict(inst_orig)
        if not inst.get("segmentation") and not use_bbox:
            continue
        if use_bbox:
            x0, y0, bw, bh = inst["bbox"]
            mask = np.zeros((h, w), np.uint8)
            mask[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = 1
        else:
            seg = inst["segmentation"]
            if shrink_percentage:
                seg = shrink_polygons(seg, shrink_percentage)
            img = coco.images.get(inst["image_id"], {"height": h, "width": w})
            mask = polygons_to_mask(seg, img.get("height", h), img.get("width", w))
            inst["bin_mask"] = mask

        u = np.clip(pts_img[:, 0], 0, mask.shape[1] - 1)
        v = np.clip(pts_img[:, 1], 0, mask.shape[0] - 1)
        sel = mask[v, u].astype(bool)
        if not sel.any():
            continue
        lidar_list.append(pc_lidar[sel])
        uv_list.append(pts_img[sel])
        if pc_cam is not None:
            cam_list.append(pc_cam[sel])
        labels.append(inst)

    return {"img_uv": uv_list, "cam_xyz": cam_list,
            "lidar_xyz": lidar_list, "img_labels": labels}
