"""Synthetic "boxes in a box" LiDAR scenes and their evaluation (numpy).

The port's copy of `pcdet_tpu.datasets.synthetic`: `make_scene` and what it
calls (cars, pedestrians and cyclists as point-sprinkled cuboid shells on
uniform or beam-structured ground), and `SyntheticDataset`, a
`dataset.DatasetTemplate` over such scenes with their annotations and the
official KITTI evaluator.  The same RandomState gives the same scene in
both packages.  In training its examples are `prepare_data`'s (host
voxelizer, augmentation, anchor targets), as `pcdet_tpu`'s; in evaluation
they are raw points for the device voxelizer, built as `pcdet_tpu`'s
`prepare_data` builds an eval example with its raw point cloud;
`eval_batches` collates them in index order.
"""
import numpy as np

from ..utils import common
from .dataset import DatasetTemplate

# class -> (w, l, h) mean sizes
SIZES = {
    'Car': (1.6, 3.9, 1.56),
    'Pedestrian': (0.6, 0.8, 1.73),
    'Cyclist': (0.6, 1.76, 1.73),
}


def lidar_ground_rings(rng, num_beams=64, elev_range=(-24.9, -0.5),
                       azim_range=(-48.0, 48.0), azim_step=0.17,
                       ground_z=-1.73, max_range=70.0, noise=0.02):
    """Ground returns of a spinning LiDAR: each downward beam meets the
    ground plane on a ring of radius h / tan(|elev|), so the returns are
    dense along rings, as in real scans."""
    elevs = np.radians(np.linspace(elev_range[0], elev_range[1], num_beams))
    azims = np.radians(np.arange(azim_range[0], azim_range[1], azim_step))
    pts = []
    sensor_h = -ground_z
    for el in elevs:
        if el >= -1e-3:
            continue
        r = sensor_h / np.tan(-el)
        if r > max_range:
            continue
        ring_az = azims + rng.uniform(-1e-3, 1e-3)
        x = r * np.cos(ring_az)
        y = r * np.sin(ring_az)
        n = len(ring_az)
        pts.append(np.stack([
            x + rng.normal(0, noise, n), y + rng.normal(0, noise, n),
            np.full(n, ground_z) + rng.normal(0, noise, n),
            rng.uniform(0, 1, n)], axis=1))
    if not pts:
        return np.zeros((0, 4), np.float32)
    return np.concatenate(pts).astype(np.float32)


def make_scene(rng, class_names, num_objects=8, num_ground=4000,
               pts_per_obj=300, x_range=(5, 60), y_range=(-30, 30),
               ground_mode='uniform', ring_keep=1.0):
    """Random scene: returns points (P, 4), gt_boxes (M, 7), gt_names (M,).

    :param ground_mode: 'uniform' scatters `num_ground` points in a z band;
        'rings' makes beam-structured ground (`lidar_ground_rings`;
        `num_ground` is ignored)
    :param ring_keep: fraction of ring returns kept (rings mode); about
        0.35 gives the ~17-20k points of a FOV-cropped KITTI scan
    """
    boxes, names = [], []
    for _ in range(num_objects):
        cls = class_names[rng.randint(len(class_names))]
        w, l, h = SIZES[cls]
        scale = rng.uniform(0.9, 1.1)
        w, l, h = w * scale, l * scale, h * scale
        x = rng.uniform(*x_range)
        y = rng.uniform(*y_range)
        z = rng.uniform(-1.8, -1.4)
        ry = rng.uniform(-np.pi, np.pi)
        boxes.append([x, y, z, w, l, h, ry])
        names.append(cls)
    boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 7)
    names = np.asarray(names)

    pts = []
    for b in boxes:
        x, y, z, w, l, h, ry = b
        local = np.stack([
            rng.uniform(-w / 2, w / 2, pts_per_obj),
            rng.uniform(-l / 2, l / 2, pts_per_obj),
            rng.uniform(0, h, pts_per_obj),
        ], axis=1)
        # points pushed to the box's faces, as LiDAR returns from shells
        face = rng.randint(0, 3, pts_per_obj)
        sign = rng.randint(0, 2, pts_per_obj) * 2 - 1
        local[face == 0, 0] = (w / 2) * sign[face == 0]
        local[face == 1, 1] = (l / 2) * sign[face == 1]
        local[face == 2, 2] = (h / 2) * (sign[face == 2] * 0.5 + 0.5) * 2
        c, s = np.cos(ry), np.sin(ry)
        gx = local[:, 0] * c + local[:, 1] * s + x
        gy = -local[:, 0] * s + local[:, 1] * c + y
        gz = local[:, 2] + z
        refl = rng.uniform(0, 1, pts_per_obj)
        pts.append(np.stack([gx, gy, gz, refl], axis=1))

    if ground_mode == 'rings':
        rings = lidar_ground_rings(rng)
        if ring_keep < 1.0:
            keep = rng.uniform(size=len(rings)) < ring_keep
            rings = rings[keep]
        pts.append(rings)
    else:
        ground = np.stack([
            rng.uniform(0, 69, num_ground),
            rng.uniform(-39, 39, num_ground),
            rng.normal(-1.75, 0.05, num_ground),
            rng.uniform(0, 1, num_ground),
        ], axis=1)
        pts.append(ground)
    points = np.concatenate(pts, axis=0).astype(np.float32)
    return points, boxes, names


class SyntheticDataset(DatasetTemplate):
    """`num_samples` scenes, scene i from RandomState(seed + i) with the
    `DATA_CONFIG.SYNTHETIC` knobs (NUM_SAMPLES, NUM_OBJECTS, NUM_GROUND,
    PTS_PER_OBJ, GROUND_MODE, RING_KEEP); training examples when
    `training`, else evaluation ones."""

    def __init__(self, cfg, training=False, num_samples=None, seed=0):
        super().__init__(cfg, cfg.CLASS_NAMES, training)
        data_cfg = cfg.DATA_CONFIG
        if not training and data_cfg.TEST.get('SHUFFLE_POINTS', False):
            raise ValueError('the evaluation does not shuffle points: '
                             'DATA_CONFIG.TEST.SHUFFLE_POINTS must be false')
        self.max_points = int(data_cfg.get('MAX_POINTS', 65536))
        syn = data_cfg.get('SYNTHETIC', {})
        self.num_samples = num_samples or int(syn.get('NUM_SAMPLES', 16))
        self.num_objects = int(syn.get('NUM_OBJECTS', 8))
        self.num_ground = int(syn.get('NUM_GROUND', 4000))
        self.pts_per_obj = int(syn.get('PTS_PER_OBJ', 300))
        self.ground_mode = str(syn.get('GROUND_MODE', 'uniform'))
        self.ring_keep = float(syn.get('RING_KEEP', 1.0))
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def get_raw(self, index):
        rng = np.random.RandomState(self.seed + index)
        points, boxes, names = make_scene(rng, self.class_names,
                                          num_objects=self.num_objects,
                                          num_ground=self.num_ground,
                                          pts_per_obj=self.pts_per_obj,
                                          ground_mode=self.ground_mode,
                                          ring_keep=self.ring_keep)
        return {'sample_idx': index, 'points': points,
                'gt_boxes_lidar': boxes, 'gt_names': names, 'calib': None}

    def __getitem__(self, index):
        if self.training:
            return self.prepare_data(self.get_raw(index), has_label=True,
                                     rng=self.sample_rng(index))
        return self.eval_example(index)

    def eval_example(self, index):
        """The eval example: the `use` features masked by the XY range,
        padded or cut to MAX_POINTS with a `point_mask`, and the GT of the
        config's classes with the class column, padded or cut to
        MAX_GT_BOXES."""
        raw = self.get_raw(index)
        data_cfg = self.cfg.DATA_CONFIG
        points = raw['points'][:, :data_cfg.NUM_POINT_FEATURES['use']]
        if data_cfg.MASK_POINTS_BY_RANGE:
            points = common.mask_points_by_range(points,
                                                 data_cfg.POINT_CLOUD_RANGE)
        n = min(len(points), self.max_points)
        pts_fixed = np.zeros((self.max_points, points.shape[1]), np.float32)
        pts_fixed[:n] = points[:n]
        pt_mask = np.zeros(self.max_points, dtype=bool)
        pt_mask[:n] = True

        selected = common.keep_arrays_by_name(raw['gt_names'],
                                              self.class_names)
        gt_boxes = raw['gt_boxes_lidar'][selected]
        gt_classes = np.array([self.class_names.index(n) + 1
                               for n in raw['gt_names'][selected]],
                              dtype=np.int32)
        gt_with_cls = np.concatenate(
            (gt_boxes, gt_classes.reshape(-1, 1).astype(np.float32)),
            axis=1).astype(np.float32)
        return {'sample_idx': index, 'points': pts_fixed,
                'point_mask': pt_mask,
                'gt_boxes': common.pad_or_trim_to(gt_with_cls,
                                                  self.max_gt_boxes)}

    # Eval glue: lidar boxes in a pseudo camera frame (x_c, y_c, z_c) =
    # (-y_l, -z_l, x_l), a pure rotation, so the rotated IoU between GT and
    # detections is preserved, and the official KITTI AP evaluator.
    @staticmethod
    def _lidar_to_camera_annos(boxes_lidar, names, scores=None):
        n = boxes_lidar.shape[0]
        loc = np.stack([-boxes_lidar[:, 1], -boxes_lidar[:, 2],
                        boxes_lidar[:, 0]], axis=1)
        dims = boxes_lidar[:, [4, 5, 3]]            # (l, h, w)
        return {
            'name': np.asarray(names),
            'truncated': np.zeros(n),
            'occluded': np.zeros(n, dtype=np.int64),
            'alpha': np.full(n, -10.0),
            'bbox': np.tile(np.array([[0., 0., 200., 160.]]), (n, 1)),
            'dimensions': dims.reshape(-1, 3),
            'location': loc.reshape(-1, 3),
            'rotation_y': boxes_lidar[:, 6].reshape(-1),
            'score': (np.asarray(scores) if scores is not None
                      else np.zeros(n)),
            'boxes_lidar': boxes_lidar,
        }

    def gt_annos(self):
        annos = []
        for i in range(len(self)):
            raw = self.get_raw(i)
            annos.append(self._lidar_to_camera_annos(raw['gt_boxes_lidar'],
                                                     raw['gt_names']))
        return annos

    def generate_annotations(self, batch, preds, class_names,
                             save_to_file=False, output_dir=None):
        """Camera-frame annos of a batch's host predictions (numpy
        boxes / scores / labels / valid); nothing is written to files."""
        annos = []
        for i in range(batch['batch_size']):
            valid = preds['valid'][i]
            boxes = np.asarray(preds['boxes'][i][valid])
            scores = np.asarray(preds['scores'][i][valid])
            labels = np.asarray(preds['labels'][i][valid])
            names = np.array([class_names[int(l) - 1] for l in labels])
            anno = self._lidar_to_camera_annos(boxes[:, :7], names, scores)
            anno['num_example'] = len(names)
            anno['sample_idx'] = np.array(
                [batch['sample_idx'][i]] * len(names))
            annos.append(anno)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """(result string, AP dict) of the official KITTI evaluator."""
        from .kitti.kitti_eval import eval as kitti_eval
        return kitti_eval.get_official_eval_result(self.gt_annos(), det_annos,
                                                   class_names)


def eval_batches(dataset, batch_size):
    """The dataset's eval examples collated in index order, the last batch
    short where the count does not divide: dicts of stacked numpy arrays,
    `sample_idx` and `batch_size`."""
    for start in range(0, len(dataset), batch_size):
        examples = [dataset.eval_example(i) for i in
                    range(start, min(start + batch_size, len(dataset)))]
        batch = {k: np.stack([ex[k] for ex in examples])
                 for k in examples[0] if k != 'sample_idx'}
        batch['sample_idx'] = np.array([ex['sample_idx'] for ex in examples])
        batch['batch_size'] = len(examples)
        yield batch
