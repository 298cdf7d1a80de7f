"""The port's plots and exporters (seevcn_torch.utils.viz, utils.viz3d,
data.png.write_png) on the CPU.

The BEV plot is drawn in numpy (no matplotlib on the card's host), so it is
held to where its pixels must be: every point's pixel grey, every box edge
an 8-connected line between the pixels of the corners that the port's
``corners_bev`` gives (itself held against JAX's to 1e-6), completed
points red, the score digits blue. scatter_3d's subsample equals the rows
JAX's matplotlib scatter receives; export_ply is JAX's file byte for byte;
write_png round-trips through read_png and cv2.imread.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seevcn_torch.data.png import read_png, write_png
from seevcn_torch.geom.boxes import corners_bev
from seevcn_torch.see.masks import line_pixels
from seevcn_torch.utils import viz as V
from seevcn_torch.utils.viz3d import export_ply
from seevcn_tpu.geom.boxes import corners_bev as jax_corners_bev
from seevcn_tpu.utils import viz as JV
from seevcn_tpu.utils.viz3d import export_ply as jax_export_ply


def _frame(seed=0, n=4000):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform([0, -20, -2], [50, 20, 1], (n, 3)),
                          rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
    boxes = np.array([[12.0, 3.0, -1.0, 4.2, 1.8, 1.5, 0.4],
                      [30.0, -8.0, -1.0, 3.9, 1.7, 1.4, -2.1]], np.float32)
    return pts, boxes


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 3), (9, 14, 4)])
def test_write_png_roundtrips(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    ref = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), ref)


def test_corners_bev_matches_jax():
    _, boxes = _frame()
    np.testing.assert_allclose(corners_bev(torch.from_numpy(boxes)).numpy(),
                               np.asarray(jax_corners_bev(jnp.asarray(boxes))), atol=1e-6)


def test_bev_pixels_where_the_geometry_puts_them(tmp_path):
    pts, boxes = _frame()
    completed = pts[:50, :3] + 0.05
    img, view = V.draw_bev(pts, boxes=boxes, scores=np.array([0.87, 0.31]),
                           gt_boxes=boxes + np.float32([0.5, 0, 0, 0, 0, 0, 0]),
                           completed=completed, size=(600, 700))
    assert img.shape == (600, 700, 3) and img.dtype == np.uint8
    px = view.to_pixels(pts[:, :2])
    assert ((px >= 0) & (px < [700, 600])).all()           # the extent holds every point
    colors = img[px[:, 1], px[:, 0]]
    allowed = np.array([V.GREY, V.RED, V.BLUE, V.TEAL])
    assert (colors[:, None] == allowed[None]).all(-1).any(-1).all()
    assert (colors == V.GREY).all(-1).mean() > 0.9
    cpx = view.to_pixels(completed[:, :2])
    assert (img[cpx[:, 1], cpx[:, 0]] == V.RED).all(-1).mean() > 0.9
    for bset, color in ((boxes, V.BLUE), (boxes + np.float32([0.5, 0, 0, 0, 0, 0, 0]), V.TEAL)):
        corners = corners_bev(torch.from_numpy(bset)).numpy()
        for c in corners:
            cp = view.to_pixels(c)
            for k in range(4):
                xs, ys = line_pixels(700, 600, *cp[k], *cp[(k + 1) % 4])
                assert len(xs) > 10
                on = (img[ys, xs] == color).all(-1)
                # the other set's edges and the score digits may cross it
                assert on.mean() > 0.8, (color, k)
    # the scores are drawn in blue beside each box's first corner
    c0 = view.to_pixels(corners_bev(torch.from_numpy(boxes)).numpy()[:, 0])
    for c in c0:
        patch = img[c[1] + 2:c[1] + 12, c[0] + 2:c[0] + 34]
        assert (patch == V.BLUE).all(-1).sum() > 20
    path = V.save_bev(str(tmp_path / "bev.png"), pts, boxes=boxes, scores=[0.5, 0.6])
    assert read_png(path).shape == (1500, 1500, 3)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], read_png(path))


def test_scatter_3d_subsample_is_jax(tmp_path, monkeypatch):
    """JAX's scatter_3d hands matplotlib the rows of
    ``default_rng(0).choice``; the port's subsample picks the same rows."""
    from mpl_toolkits.mplot3d import Axes3D

    pts, boxes = _frame(3, n=3000)
    seen = {}

    def scatter(self, xs, ys, zs, *a, **k):
        seen["xyz"] = np.stack([xs, ys, zs], -1)

    monkeypatch.setattr(Axes3D, "scatter", scatter)
    JV.scatter_3d(str(tmp_path / "jax.png"), pts, boxes=boxes, max_points=1000)
    np.testing.assert_array_equal(V.subsample(pts, 1000)[:, :3], seen["xyz"])
    np.testing.assert_array_equal(V.subsample(pts, 5000), pts)
    path = V.scatter_3d(str(tmp_path / "port.png"), pts, boxes=boxes, max_points=1000)
    img = read_png(path)
    assert img.shape == (1200, 1500, 3)
    assert (img == V.BLUE).all(-1).sum() > 100                # the wireframes
    assert (img != 255).any(-1).sum() > 500                   # the points


@pytest.mark.parametrize("binary,colors", [(True, False), (True, True), (False, True)])
def test_export_ply_is_jax_byte_for_byte(tmp_path, binary, colors):
    pts, _ = _frame(5, n=200)
    rgb = np.random.RandomState(2).randint(0, 256, (200, 3)).astype(np.uint8) if colors else None
    export_ply(str(tmp_path / "t.ply"), pts, rgb, binary=binary)
    jax_export_ply(str(tmp_path / "j.ply"), pts, rgb, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
