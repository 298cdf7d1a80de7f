"""Camera calibration models, host-side numpy (the port's own copy of
seevcn_tpu/geom/calibration.py, which imports no JAX: the port imports
nothing of the JAX package).

  * KITTI's rectified chain (reference calibration_kitti.py and the SEE
    kitti_utils.py:15-125): velo -> ref (Tr_velo_to_cam) -> rect (R0) ->
    image (P2).
  * A generic json calibration with pinhole or fisheye distortion, the
    custom dataset's and the demo's (custom_dataset_objects.py:141-194,
    see_vcn_dataset.py:70-117).
"""
from __future__ import annotations

import json

import numpy as np


def inverse_rigid(tr: np.ndarray) -> np.ndarray:
    """Invert a (3,4) [R|t]."""
    inv = np.zeros_like(tr)
    inv[:3, :3] = tr[:3, :3].T
    inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return inv


class KittiCalibration:
    """KITTI calib: P2 (3,4), R0 (3,3), Tr_velo_to_cam (3,4)."""

    def __init__(self, calib):
        if isinstance(calib, (str,)):
            calib = self.parse_calib_file(calib)
        self.P2 = np.asarray(calib["P2"], np.float64).reshape(3, 4)
        self.R0 = np.asarray(calib["R0"], np.float64).reshape(3, 3)
        self.V2C = np.asarray(calib["Tr_velo2cam"], np.float64).reshape(3, 4)
        self.C2V = inverse_rigid(self.V2C)

    @staticmethod
    def parse_calib_file(path: str) -> dict:
        vals = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                vals[k.strip()] = np.array([float(x) for x in v.split()])
        return {
            "P2": vals["P2"].reshape(3, 4),
            "R0": vals.get("R0_rect", vals.get("R0", np.eye(3).ravel())).reshape(3, 3),
            "Tr_velo2cam": vals.get("Tr_velo_to_cam",
                                    vals.get("Tr_velo2cam")).reshape(3, 4),
        }

    @staticmethod
    def _hom(pts):
        return np.concatenate([pts, np.ones((len(pts), 1))], axis=1)

    # 3d <-> 3d -------------------------------------------------------------
    def lidar_to_rect(self, pts):
        ref = self._hom(np.asarray(pts, np.float64)) @ self.V2C.T
        return ref @ self.R0.T

    def rect_to_lidar(self, pts):
        ref = np.asarray(pts, np.float64) @ np.linalg.inv(self.R0).T
        return self._hom(ref) @ self.C2V.T

    # 3d -> 2d --------------------------------------------------------------
    def rect_to_img(self, pts_rect):
        uvw = self._hom(np.asarray(pts_rect, np.float64)) @ self.P2.T
        uv = uvw[:, :2] / uvw[:, 2:3]
        depth = uvw[:, 2] - self.P2[2, 3]
        return uv, depth

    def lidar_to_img(self, pts):
        return self.rect_to_img(self.lidar_to_rect(pts))

    # 2d -> 3d --------------------------------------------------------------
    def img_to_rect(self, u, v, depth):
        cu, cv = self.P2[0, 2], self.P2[1, 2]
        fu, fv = self.P2[0, 0], self.P2[1, 1]
        bx = self.P2[0, 3] / (-fu)
        by = self.P2[1, 3] / (-fv)
        x = (u - cu) * depth / fu + bx
        y = (v - cv) * depth / fv + by
        return np.stack([x, y, depth], axis=1)


class JsonCalibration:
    """Generic single-camera calib: 3x3 intrinsics, 4x4 lidar->camera
    extrinsics, distortion (pinhole k1 k2 p1 p2 k3 / fisheye k1..k4)."""

    def __init__(self, spec):
        if isinstance(spec, str):
            with open(spec) as f:
                spec = json.load(f)
        self.K = np.asarray(spec["intrinsic"], np.float64).reshape(3, 3)
        self.T = np.asarray(spec["extrinsic"], np.float64).reshape(4, 4)
        dist = spec.get("distortion", spec.get("distcoeff", []))
        self.distortion = np.asarray(dist, np.float64)
        # 4 coefficients = fisheye (equidistant), 5 = plumb-bob pinhole,
        # matching the demo's camera handling (see_vcn_dataset.py:70-117)
        self.model = spec.get("distortion_model",
                              "fisheye" if len(self.distortion) == 4 else "pinhole")

    def lidar_to_cam(self, pts):
        h = np.concatenate([pts[:, :3], np.ones((len(pts), 1))], axis=1)
        return (h @ self.T.T)[:, :3]

    def lidar_to_img(self, pts):
        cam = self.lidar_to_cam(pts)
        z = cam[:, 2]
        xn = cam[:, 0] / np.where(z == 0, 1e-9, z)
        yn = cam[:, 1] / np.where(z == 0, 1e-9, z)
        if len(self.distortion):
            xn, yn = self._distort(xn, yn)
        u = self.K[0, 0] * xn + self.K[0, 2]
        v = self.K[1, 1] * yn + self.K[1, 2]
        return np.stack([u, v], axis=1), z

    def _distort(self, x, y):
        r2 = x * x + y * y
        d = self.distortion
        if self.model == "fisheye":
            r = np.sqrt(r2)
            theta = np.arctan(r)
            theta_d = theta * (1 + d[0] * theta**2 + d[1] * theta**4
                               + d[2] * theta**6 + d[3] * theta**8)
            scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
            return x * scale, y * scale
        k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
        k3 = d[4] if len(d) > 4 else 0.0
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return xd, yd
