"""The KITTI-format tree writer of the Argoverse / nuScenes converters: the
port's copy of `pcdet_tpu.datasets.converters.kitti_writer`, over the
port's `utils/box_np_ops.py` and `utils/calibration.py`.

Produces exactly the layout `datasets.kitti.kitti_dataset.KittiDataset`
reads:

    <dst>/training/{velodyne,image_2,calib,label_2,planes}/<id>.*
    <dst>/ImageSets/{train,val}.txt

Boxes are handed over in the package's lidar convention ([x, y, z, w, l,
h, ry], z at the box bottom, local +y the heading) and written as
camera-frame label lines through the same calibration and box helpers that
read them back, so the label -> info -> gt_boxes_lidar round trip is exact
by construction.  The blank image_2 PNGs are written with PIL, imported
where an image is written (`write_images=False` writes none).
"""
import os

import numpy as np

from ...utils import box_np_ops
from ...utils.calibration import Calibration

# KITTI-style velodyne->camera axis permutation: x_c=-y_l, y_c=-z_l, z_c=x_l
V2C_DEFAULT = np.array([[0., -1., 0., 0.],
                        [0., 0., -1., 0.],
                        [1., 0., 0., 0.]], dtype=np.float32)
R0_DEFAULT = np.eye(3, dtype=np.float32)


def make_p2(fu, fv, cu, cv):
    return np.array([[fu, 0., cu, 0.],
                     [0., fv, cv, 0.],
                     [0., 0., 1., 0.]], dtype=np.float32)


def calib_lines(p2, r0=None, v2c=None):
    r0 = R0_DEFAULT if r0 is None else r0
    v2c = V2C_DEFAULT if v2c is None else v2c
    zeros12 = ' '.join(['0'] * 12)
    return [
        'P0: ' + zeros12,
        'P1: ' + zeros12,
        'P2: ' + ' '.join('%.12e' % v for v in np.asarray(p2).reshape(-1)),
        'P3: ' + ' '.join('%.12e' % v for v in np.asarray(p2).reshape(-1)),
        'R0_rect: ' + ' '.join('%.12e' % v for v in np.asarray(r0).reshape(-1)),
        'Tr_velo_to_cam: ' + ' '.join('%.12e' % v
                                      for v in np.asarray(v2c).reshape(-1)),
        'Tr_imu_to_velo: ' + zeros12,
    ]


class KittiWriter:
    def __init__(self, dst, image_shape=(375, 1242), p2=None, v2c=None,
                 ground_plane_d=1.73, write_images=True):
        """:param image_shape: (h, w) of the blank image_2 PNGs
        :param p2/v2c: camera intrinsics / velo->cam extrinsics (defaults:
            nominal pinhole + the standard axis permutation)
        :param ground_plane_d: camera height above road, planes/<id>.txt
        """
        self.dst = dst
        self.image_shape = tuple(int(v) for v in image_shape)
        self.p2 = make_p2(721.5, 721.5, image_shape[1] / 2.0,
                          image_shape[0] / 2.0) if p2 is None else p2
        self.v2c = V2C_DEFAULT if v2c is None else v2c
        self.ground_plane_d = float(ground_plane_d)
        self.write_images = write_images
        for sub in ['velodyne', 'image_2', 'calib', 'label_2', 'planes']:
            os.makedirs(os.path.join(dst, 'training', sub), exist_ok=True)
        os.makedirs(os.path.join(dst, 'ImageSets'), exist_ok=True)
        self._calib = Calibration({'P2': self.p2, 'R0': R0_DEFAULT,
                                   'Tr_velo2cam': self.v2c})
        self._split_ids = {'train': [], 'val': []}

    def _path(self, sub, sid, ext):
        return os.path.join(self.dst, 'training', sub, sid + ext)

    def write_frame(self, sid, split, points, boxes_lidar, names,
                    fov_only_labels=True, min_z_cam=0.5):
        """:param points: (N, 4) float32 [x, y, z, intensity 0..1], lidar frame
        :param boxes_lidar: (M, 7) [x, y, z(bottom), w, l, h, ry]
        :param names: (M,) class name strings (already KITTI vocabulary)
        :param fov_only_labels: drop objects behind the camera (the KITTI
            label format cannot express them; matches the public
            argoverse->KITTI adapters)
        """
        np.ascontiguousarray(points.astype(np.float32)).tofile(
            self._path('velodyne', sid, '.bin'))

        if self.write_images:
            from PIL import Image
            h, w = self.image_shape
            Image.new('RGB', (w, h)).save(self._path('image_2', sid, '.png'))

        with open(self._path('calib', sid, '.txt'), 'w') as f:
            f.write('\n'.join(calib_lines(self.p2, v2c=self.v2c)) + '\n')

        with open(self._path('planes', sid, '.txt'), 'w') as f:
            f.write('# Plane\nWidth 4\nHeight 1\n0 -1 0 %.6f\n'
                    % self.ground_plane_d)

        lines = []
        boxes_lidar = np.asarray(boxes_lidar, np.float32).reshape(-1, 7)
        if len(boxes_lidar):
            cam = box_np_ops.boxes3d_lidar_to_camera(boxes_lidar, self._calib)
            bboxes = box_np_ops.boxes3d_camera_to_imageboxes(
                cam, self._calib, image_shape=np.asarray(self.image_shape))
            for i in range(len(boxes_lidar)):
                xc, yc, zc, lc, hc, wc, ry = cam[i]
                if fov_only_labels and zc < min_z_cam:
                    continue
                alpha = float(ry - np.arctan2(xc, zc))
                lines.append(
                    '%s 0.00 0 %.6f %.2f %.2f %.2f %.2f '
                    '%.6f %.6f %.6f %.6f %.6f %.6f %.6f'
                    % (names[i], alpha, bboxes[i][0], bboxes[i][1],
                       bboxes[i][2], bboxes[i][3], hc, wc, lc, xc, yc, zc, ry))
        with open(self._path('label_2', sid, '.txt'), 'w') as f:
            f.write('\n'.join(lines) + ('\n' if lines else ''))
        self._split_ids[split].append(sid)

    def finalize(self):
        """Write ImageSets/{train,val}.txt from the frames seen."""
        for split, ids in self._split_ids.items():
            with open(os.path.join(self.dst, 'ImageSets', split + '.txt'),
                      'w') as f:
                f.write('\n'.join(sorted(ids)) + ('\n' if ids else ''))
        return {k: len(v) for k, v in self._split_ids.items()}
