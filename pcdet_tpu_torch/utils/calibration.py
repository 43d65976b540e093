"""KITTI calibration: the numpy transforms between velodyne, rectified
camera and image frames, and a differentiable torch twin.

The port's copy of `pcdet_tpu.utils.calibration` (the reference's
pcdet/utils/calibration.py): `Calibration` (numpy: lidar <-> rect, rect ->
image, lidar -> image and the pixel back-projection `img_to_rect`) and
`CalibrationTorch`, the twin of `CalibrationJnp`, whose transforms take
tensors and are differentiable in the points and depths.  It backs the
fork's pseudo-LiDAR lift (`experiments.pseudolidar_points_from_depth`).
"""
import numpy as np
import torch


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

        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

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

    def lidar_to_img(self, pts_lidar):
        pts_rect = self.lidar_to_rect(pts_lidar)
        return self.rect_to_img(pts_rect)

    def img_to_rect(self, u, v, depth_rect):
        """Pixel (u, v) + depth -> rect 3D."""
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.concatenate((x.reshape(-1, 1), y.reshape(-1, 1),
                               depth_rect.reshape(-1, 1)), axis=1)


def _hom_t(pts):
    return torch.cat([pts, pts.new_ones((*pts.shape[:-1], 1))], dim=-1)


class CalibrationTorch:
    """Differentiable twin of `Calibration` on tensors (`pcdet_tpu`'s
    `CalibrationJnp`): the same math on the matrices of `calib`, held on
    `device` in `dtype`; gradients flow through the points and depths."""

    def __init__(self, calib, device='cuda', dtype=torch.float32):
        def t(m):
            return torch.as_tensor(np.asarray(m), dtype=dtype, device=device)
        self.P2, self.R0, self.V2C = t(calib.P2), t(calib.R0), t(calib.V2C)
        self.cu, self.cv = float(calib.cu), float(calib.cv)
        self.fu, self.fv = float(calib.fu), float(calib.fv)
        self.tx, self.ty = float(calib.tx), float(calib.ty)
        # rect -> lidar: the inverse of the extended R0 @ V2C, transposed,
        # taken once on the host in `dtype`
        r0_ext = torch.eye(4, dtype=dtype)
        r0_ext[:3, :3] = self.R0.cpu()
        v2c_ext = torch.eye(4, dtype=dtype)
        v2c_ext[:3, :4] = self.V2C.cpu()
        self.rect_to_lidar_mat = torch.linalg.inv(
            (r0_ext @ v2c_ext).T).to(device)

    def lidar_to_rect(self, pts_lidar):
        return _hom_t(pts_lidar) @ (self.V2C.T @ self.R0.T)

    def rect_to_lidar(self, pts_rect):
        return (_hom_t(pts_rect) @ self.rect_to_lidar_mat)[..., 0:3]

    def rect_to_img(self, pts_rect):
        pts_2d_hom = _hom_t(pts_rect) @ self.P2.T
        pts_img = pts_2d_hom[..., 0:2] / pts_rect[..., 2:3]
        depth = pts_2d_hom[..., 2] - self.P2.T[3, 2]
        return pts_img, depth

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return torch.stack([x, y, depth_rect], dim=-1)
