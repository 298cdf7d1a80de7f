"""The port's COCO mask interface (seevcn_torch.see.masks) and the mask CLI's
polygon side (seevcn_torch.cli.generate_masks) against cv2 and the JAX
package on the CPU.

The rasterizer is held pixel for pixel against ``cv2.fillPoly`` and the
border follower vertex for vertex (same contours, same order) against
``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``, on named cases
and on seeded random sweeps. ``CocoMasks``, ``shrink_polygons`` and
``get_pts_in_mask`` equal JAX's; ``detections_to_coco``'s JSON is JAX's
byte for byte.
"""
import json

import cv2
import numpy as np
import pytest

from seevcn_tpu.cli import generate_masks as JG
from seevcn_tpu.see import masks as JM
from seevcn_torch.cli import generate_masks as TG
from seevcn_torch.see import masks as TM

H, W = 48, 64

POLYGONS = {
    "convex": [[10, 5, 40, 8, 44, 30, 12, 35]],
    "concave": [[5, 5, 50, 5, 50, 40, 30, 15, 5, 40]],
    "self_intersecting": [[5, 5, 55, 40, 55, 5, 5, 40]],
    "several": [[2, 2, 12, 2, 7, 10], [20, 20, 40, 22, 35, 44], [50, 1, 63, 10, 52, 12]],
    "overlapping": [[5, 5, 40, 5, 40, 30, 5, 30], [20, 15, 60, 15, 60, 45, 20, 45]],
    "partly_outside": [[-20, -10, 30, 4, 70, 60, 10, 55], [50, -5, 80, 20, 60, 30]],
    "all_outside": [[-30, -20, -5, -3, -10, 30]],
    "half_coordinates": [[10.5, 4.5, 40.5, 8.5, 43.5, 30.5, 11.5, 35.49],
                         [0.5, 40.5, 20.5, 47.5, 2.5, 47.5]],
    "too_short": [[10, 10, 30, 30], [5, 5, 20, 5, 12, 20]],
    "degenerate": [[10, 10, 30, 10, 50, 10], [5, 20, 5, 40, 5, 30]],
}


def _cv2_fill(segmentation, h=H, w=W):
    mask = np.zeros((h, w), np.uint8)
    polys = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
             for p in segmentation if len(p) >= 6]
    if polys:
        cv2.fillPoly(mask, polys, 1)
    return mask


@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_polygons_to_mask_matches_cv2(name):
    seg = POLYGONS[name]
    got = TM.polygons_to_mask(seg, H, W)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cv2_fill(seg))
    np.testing.assert_array_equal(got, JM.polygons_to_mask(seg, H, W))


def test_polygons_to_mask_random_sweep():
    """Seeded random polygons of 3-12 vertices, 1-3 at once, inside, across
    and outside the image edges, at float coordinates."""
    rng = np.random.RandomState(0)
    for _ in range(400):
        seg = []
        for _ in range(rng.randint(1, 4)):
            k = rng.randint(3, 13)
            c = rng.uniform(-15, 80, 2)
            seg.append((c + rng.uniform(-30, 30, (k, 2))).reshape(-1).tolist())
        np.testing.assert_array_equal(TM.polygons_to_mask(seg, H, W), _cv2_fill(seg),
                                      err_msg=str(seg))


def _blob_masks():
    yy, xx = np.mgrid[:H, :W]
    ring = ((yy - 24) ** 2 + (xx - 30) ** 2 <= 15 ** 2) & ((yy - 24) ** 2 + (xx - 30) ** 2 > 6 ** 2)
    nested = ring.copy()
    nested[22:27, 28:33] = True                     # a component inside the hole
    border = np.zeros((H, W), bool)
    border[0:10, 0:20] = True
    border[30:, 50:] = True
    border[20:25, 0] = True
    single = np.zeros((H, W), bool)
    single[5, 5] = single[10, 40] = True
    diagonal = np.eye(H, W, dtype=bool) | np.eye(H, W, k=20, dtype=bool)[:, ::-1]
    several = np.zeros((H, W), bool)
    for y, x, r in ((8, 8, 5), (30, 12, 7), (20, 45, 9), (44, 60, 3)):
        several |= (yy - y) ** 2 + (xx - x) ** 2 <= r * r
    return {"blob": (yy - 20) ** 2 / 100 + (xx - 30) ** 2 / 300 <= 1, "ring": ring,
            "nested": nested, "border": border, "single_pixels": single,
            "diagonal": diagonal, "several": several, "full": np.ones((H, W), bool),
            "empty": np.zeros((H, W), bool)}


def _cv2_contours(mask):
    return [c.reshape(-1, 2) for c in cv2.findContours(
        mask.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]]


def _same_contours(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(_blob_masks()))
def test_external_contours_match_cv2(name):
    mask = _blob_masks()[name]
    _same_contours(TM.external_contours(mask), _cv2_contours(mask))
    assert TG.mask_to_polygons(mask) == JG.mask_to_polygons(mask)


def test_external_contours_random_sweep():
    """Seeded noise masks and unions of discs, some with holes, 1-30 pixels a
    side."""
    rng = np.random.RandomState(1)
    for t in range(600):
        h, w = rng.randint(1, 31, 2)
        if t % 3 == 0:
            mask = rng.rand(h, w) < rng.uniform(0.2, 0.8)
        else:
            yy, xx = np.mgrid[:h, :w]
            mask = np.zeros((h, w), bool)
            for _ in range(rng.randint(1, 5)):
                cy, cx, r = rng.randint(-3, 34), rng.randint(-3, 34), rng.randint(1, 9)
                d = (yy - cy) ** 2 + (xx - cx) ** 2
                mask |= d <= r * r
                if t % 3 == 2:
                    mask &= ~(d <= (r // 2) ** 2)
        _same_contours(TM.external_contours(mask), _cv2_contours(mask))


def test_coco_masks_and_points_match_jax():
    rng = np.random.RandomState(2)
    d = {"images": [{"id": 1, "file_name": "000000.png", "height": H, "width": W},
                    {"id": 2, "file_name": "000001.png", "height": H, "width": W}],
         "annotations": [
             {"id": 7, "image_id": 1, "segmentation": POLYGONS["concave"],
              "bbox": [5, 5, 45, 35], "score": 0.9, "category_id": 3},
             {"id": 8, "image_id": 1, "segmentation": POLYGONS["several"],
              "bbox": [2, 1, 61, 43], "score": 0.8, "category_id": 3},
             {"id": 9, "image_id": 1, "segmentation": [], "bbox": [30, 20, 10, 10],
              "score": 0.7, "category_id": 3},
             {"id": 10, "image_id": 2, "segmentation": POLYGONS["convex"],
              "bbox": [10, 5, 34, 30], "score": 0.6, "category_id": 3}]}
    tc, jc = TM.CocoMasks(d), JM.CocoMasks(d)
    for ids in (1, [1, 2], [3]):
        assert tc.getAnnIds(ids) == jc.getAnnIds(ids)
    assert tc.loadAnns([7, 10]) == jc.loadAnns([7, 10])
    np.testing.assert_array_equal(tc.annToMask(d["annotations"][1]),
                                  jc.annToMask(d["annotations"][1]))
    for pct in (0.0, 3.0, 25.0):
        got, ref = TM.shrink_polygons(POLYGONS["several"], pct), \
            JM.shrink_polygons(POLYGONS["several"], pct)
        assert got == ref
    n = 3000
    imgfov = {"pts_img": np.stack([rng.randint(-2, W + 2, n), rng.randint(-2, H + 2, n)], 1),
              "pc_lidar": rng.randn(n, 3).astype(np.float32),
              "pc_cam": rng.randn(n, 3), "img_shape": (H, W)}
    anns = tc.loadAnns(tc.getAnnIds(1))
    for shrink, bbox in ((0.0, False), (3.0, False), (0.0, True)):
        got = TM.get_pts_in_mask(tc, anns, imgfov, shrink_percentage=shrink, use_bbox=bbox)
        ref = JM.get_pts_in_mask(jc, anns, imgfov, shrink_percentage=shrink, use_bbox=bbox)
        assert set(got) == set(ref)
        for k in ("img_uv", "cam_xyz", "lidar_xyz"):
            assert len(got[k]) == len(ref[k]) > 0
            for a, b in zip(got[k], ref[k]):
                np.testing.assert_array_equal(a, b)
        assert [lab["id"] for lab in got["img_labels"]] == \
            [lab["id"] for lab in ref["img_labels"]]
        for a, b in zip(got["img_labels"], ref["img_labels"]):
            if "bin_mask" in b:
                np.testing.assert_array_equal(a["bin_mask"], b["bin_mask"])


def test_detections_to_coco_is_jax_byte_for_byte(tmp_path):
    masks = _blob_masks()
    per_image = [
        ("000000.png", (H, W), [
            {"mask": masks["nested"], "bbox": [15.5, 9.0, 30.25, 30.0], "score": 0.9,
             "category_id": 3},
            {"mask": masks["several"], "bbox": [1, 1, 62, 46], "score": 0.3},
            {"mask": masks["empty"], "bbox": [0, 0, 1, 1], "score": 0.95},
            {"segmentation": POLYGONS["convex"], "bbox": [10, 5, 34, 30], "score": 0.7}]),
        ("000001.png", (H, W), [
            {"mask": masks["border"], "bbox": [0, 0, W, H], "score": np.float32(0.61),
             "category_id": 1}]),
        ("000002.png", (H, W), [])]
    for thresh in (0.5, 0.2):
        got = TG.detections_to_coco(per_image, str(tmp_path / f"t{thresh}.json"), thresh)
        ref = JG.detections_to_coco(per_image, str(tmp_path / f"j{thresh}.json"), thresh)
        with open(got, "rb") as f, open(ref, "rb") as g:
            assert f.read() == g.read()
    with open(got) as f:
        assert len(json.load(f)["annotations"]) == 4          # the empty mask has none
