"""KITTI calibration: the numpy transforms between velodyne, rectified
camera and image frames.

The port's copy of `pcdet_tpu.utils.calibration.Calibration` (the
reference's pcdet/utils/calibration.py), the transforms the data pipeline
uses: lidar <-> rect and rect -> image.  The pixel back-projection and the
differentiable twin (`CalibrationJnp`) belong to the fork's pseudo-LiDAR
path and wait for it (ROADMAP.md queue 1 item 6).
"""
import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()
    out = {}
    key_map = {'P2': (2, (3, 4)), 'P3': (3, (3, 4)), 'R0': (4, (3, 3)),
               'Tr_velo2cam': (5, (3, 4))}
    for key, (line_no, shape) in key_map.items():
        vals = lines[line_no].strip().split(' ')[1:]
        out[key] = np.array(vals, dtype=np.float32).reshape(shape)
    return out


def _hom(pts):
    return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))


class Calibration:
    def __init__(self, calib_file):
        calib = get_calib_from_file(calib_file) if isinstance(calib_file, str) \
            else calib_file
        self.P2 = calib['P2']
        self.R0 = calib['R0']
        self.V2C = calib['Tr_velo2cam']

    def lidar_to_rect(self, pts_lidar):
        """(N, 3) velodyne -> (N, 3) rect camera: x_rect = R0 @ V2C @ x."""
        return np.dot(_hom(pts_lidar), np.dot(self.V2C.T, self.R0.T))

    def rect_to_lidar(self, pts_rect):
        """(N, 3) rect camera -> (N, 3) velodyne (inverse of lidar_to_rect)."""
        r0_ext = np.eye(4, dtype=np.float32)
        r0_ext[:3, :3] = self.R0
        v2c_ext = np.eye(4, dtype=np.float32)
        v2c_ext[:3, :4] = self.V2C
        inv = np.linalg.inv(np.dot(r0_ext, v2c_ext).T)
        return np.dot(_hom(pts_rect), inv)[:, 0:3]

    def rect_to_img(self, pts_rect):
        """(N, 3) rect -> image (N, 2) + rect-frame depth (N,)."""
        pts_2d_hom = np.dot(_hom(pts_rect), self.P2.T)
        pts_img = (pts_2d_hom[:, 0:2].T / pts_rect[:, 2]).T
        pts_rect_depth = pts_2d_hom[:, 2] - self.P2.T[3, 2]
        return pts_img, pts_rect_depth
