"""GT-database paste-in sampler.

The port's copy of `pcdet_tpu.datasets.augmentation.dbsampler` (the
reference's pcdet/datasets/data_augmentation/dbsampler.py): per-class quota
sampling, BEV collision rejection against the scene, optional road-plane
snapping, point splicing.  Given a per-sample RandomState, `sample_all`
draws from it alone; without one, from the shuffled cycle of the global
stream.
"""
import copy
import os

import numpy as np

from ...utils import box_np_ops, common
from . import augmentation_utils


class BatchSampler:
    """Cyclic shuffled sampler over a class's db entries."""

    def __init__(self, sampled_list, name=None, shuffle=True):
        self._sampled_list = sampled_list
        self._indices = np.arange(len(sampled_list))
        if shuffle:
            np.random.shuffle(self._indices)
        self._idx = 0
        self._example_num = len(sampled_list)
        self._shuffle = shuffle

    def _reset(self):
        if self._shuffle:
            np.random.shuffle(self._indices)
        self._idx = 0

    def sample(self, num, rng=None):
        if rng is not None:
            # stateless deterministic draw (per-sample rng): statistically
            # equivalent to the shuffled-cycle; required because the cycle's
            # shared state is thread-order dependent under a worker pool
            n = len(self._sampled_list)
            idx = rng.choice(n, size=min(num, n), replace=num > n)
            return [self._sampled_list[i] for i in idx]
        if self._idx + num >= self._example_num:
            ret = self._indices[self._idx:].copy()
            self._reset()
        else:
            ret = self._indices[self._idx:self._idx + num]
            self._idx += num
        return [self._sampled_list[i] for i in ret]


class DataBaseSampler:
    def __init__(self, db_infos, sampler_cfg, class_names, logger=None):
        if logger is not None:
            for k, v in db_infos.items():
                logger.info('Database before filter %s: %d' % (k, len(v)))
        for prep_func, val in sampler_cfg.PREPARE.items():
            db_infos = getattr(self, prep_func)(db_infos, val)
        if logger is not None:
            for k, v in db_infos.items():
                logger.info('Database after filter %s: %d' % (k, len(v)))

        self.db_infos = db_infos
        self.rate = sampler_cfg.RATE
        self.sample_classes = []
        self.sample_max_nums = []
        for x in sampler_cfg.SAMPLE_GROUPS:
            name, num = x.split(':')
            if name not in class_names:
                continue
            self.sample_classes.append(name)
            self.sample_max_nums.append(int(num))

        self.sampler_dict = {k: BatchSampler(v, k, shuffle=True)
                             for k, v in self.db_infos.items()}

    # -------------------------------------------------------------- filters
    @staticmethod
    def filter_by_difficulty(db_infos, removed_difficulty):
        return {key: [info for info in dinfos
                      if info['difficulty'] not in removed_difficulty]
                for key, dinfos in db_infos.items()}

    @staticmethod
    def filter_by_min_points(db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(':')
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [info for info in db_infos[name]
                                  if info['num_points_in_gt'] >= min_num]
        return db_infos

    @staticmethod
    def filter_by_frontview(db_infos, front_dist_list):
        for name_num in front_dist_list:
            name = name_num.split(':')[0]
            db_infos[name] = [info for info in db_infos[name]
                              if info['box3d_lidar'][0] >= 0]
        return db_infos

    # -------------------------------------------------------------- sampling
    def sample_all(self, root_path, gt_boxes, gt_names, num_point_features=4,
                   road_planes=None, calib=None, rng=None):
        sample_num_per_class = []
        for class_name, max_num in zip(self.sample_classes,
                                       self.sample_max_nums):
            n = int(max_num - np.sum([x == class_name for x in gt_names]))
            sample_num_per_class.append(
                int(np.round(self.rate * n)))

        sampled = []
        sampled_gt_boxes = []
        avoid_coll_boxes = gt_boxes

        for class_name, num in zip(self.sample_classes, sample_num_per_class):
            if num > 0:
                sampled_cls = self.sample_class_v2(class_name, num,
                                                   avoid_coll_boxes, rng=rng)
                sampled += sampled_cls
                if sampled_cls:
                    boxes = np.stack([s['box3d_lidar'] for s in sampled_cls],
                                     axis=0).reshape(-1, 7)
                    sampled_gt_boxes.append(boxes)
                    avoid_coll_boxes = np.concatenate(
                        [avoid_coll_boxes, boxes], axis=0)

        if not sampled:
            return None

        sampled_gt_boxes = np.concatenate(sampled_gt_boxes, axis=0)
        mv_height = None
        if road_planes is not None and calib is not None:
            # snap sampled boxes onto the road plane (plane in rect frame)
            a, b, c, d = road_planes
            center = sampled_gt_boxes[:, 0:3]
            center_cam = calib.lidar_to_rect(center)
            cur_height_cam = (-d - a * center_cam[:, 0]
                              - c * center_cam[:, 2]) / b
            center_cam[:, 1] = cur_height_cam
            cur_lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
            mv_height = sampled_gt_boxes[:, 2] - cur_lidar_height
            sampled_gt_boxes[:, 2] -= mv_height

        s_points_list = []
        for count, info in enumerate(sampled):
            file_path = os.path.join(root_path, info['path'])
            s_points = np.fromfile(
                file_path, dtype=np.float32).reshape([-1, num_point_features])
            if 'rot_transform' in info:
                s_points = common.rotate_pc_along_z(s_points,
                                                    info['rot_transform'])
            s_points[:, :3] += info['box3d_lidar'][:3]
            if mv_height is not None:
                s_points[:, 2] -= mv_height[count]
            s_points_list.append(s_points)

        return {
            'gt_names': np.array([s['name'] for s in sampled]),
            'difficulty': np.array([s['difficulty'] for s in sampled]),
            'gt_boxes': sampled_gt_boxes,
            'points': np.concatenate(s_points_list, axis=0),
            'gt_masks': np.ones((len(sampled),), dtype=np.bool_),
            'group_ids': np.arange(gt_boxes.shape[0],
                                   gt_boxes.shape[0] + len(sampled)),
        }

    def sample_class_v2(self, name, num, gt_boxes, rng=None):
        """Sample `num` db objects, reject those colliding in BEV with the
        scene or with previously-accepted samples (greedy, in order)."""
        sampled = copy.deepcopy(self.sampler_dict[name].sample(num, rng=rng))
        num_gt = gt_boxes.shape[0]
        num_sampled = len(sampled)

        gt_bv = box_np_ops.boxes3d_to_corners3d_lidar(gt_boxes)[:, 0:4, 0:2]
        sp_boxes = np.stack([i['box3d_lidar'] for i in sampled],
                            axis=0).reshape(-1, 7)
        sp_bv = box_np_ops.boxes3d_to_corners3d_lidar(sp_boxes)[:, 0:4, 0:2]

        total_bv = np.concatenate([gt_bv, sp_bv], axis=0)
        coll_mat = augmentation_utils.box_collision_test(total_bv, total_bv)
        diag = np.arange(total_bv.shape[0])
        coll_mat[diag, diag] = False

        valid_samples = []
        for i in range(num_gt, num_gt + num_sampled):
            if coll_mat[i].any():
                coll_mat[i] = False
                coll_mat[:, i] = False
            else:
                valid_samples.append(sampled[i - num_gt])
        return valid_samples
