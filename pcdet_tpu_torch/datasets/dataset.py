"""Dataset base: the per-sample pipeline to fixed-shape examples, and the
batch collate.

The port's copy of `pcdet_tpu.datasets.dataset` (the reference's
pcdet/datasets/dataset.py prepare_data and collate_batch, in fixed shapes):
DB sampling, per-object noise, global flip / rotation / scaling, the range
filters, the host `VoxelGenerator` padded to MAX_NUMBER_OF_VOXELS and
sorted by voxel id, the `voxel_overflow` count, the GT padded to
MAX_GT_BOXES, Part-A²'s per-voxel targets and the anchor targets, all on
the host in numpy.  Each sample's randomness is one RandomState keyed on
(seed, epoch, index) (`set_sample_seed`, `sample_rng`), so a batch is the
same under any worker count and mode, and equal to `pcdet_tpu`'s.
"""
import numpy as np

from ..ops.voxelizer import VoxelGenerator
from ..utils import box_np_ops, common


class DatasetTemplate:
    def __init__(self, cfg, class_names=None, training=True):
        self.cfg = cfg
        self.class_names = list(class_names or cfg.CLASS_NAMES)
        self.training = training
        self.mode = 'TRAIN' if training else 'TEST'
        data_cfg = cfg.DATA_CONFIG
        self.max_gt_boxes = int(data_cfg.get('MAX_GT_BOXES', 128))
        vg_cfg = data_cfg.VOXEL_GENERATOR
        self.voxel_generator = VoxelGenerator(
            voxel_size=vg_cfg.VOXEL_SIZE,
            point_cloud_range=data_cfg.POINT_CLOUD_RANGE,
            max_num_points=vg_cfg.MAX_POINTS_PER_VOXEL,
            max_voxels=data_cfg[self.mode].MAX_NUMBER_OF_VOXELS,
        )
        self.grid_size = self.voxel_generator.grid_size
        self.anchor_targets = None       # set via set_anchor_targets()
        self.db_sampler = None
        self._augmentor = None

    def set_anchor_targets(self, anchor_targets):
        """Attach the host target assigner (models.anchors.AnchorHeadTargets)."""
        self.anchor_targets = anchor_targets

    # ------------------------------------------------------------------
    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def get_road_plane(self, sample_idx):
        return None

    # ------------------------------------------------------------------
    def set_sample_seed(self, base_seed, epoch):
        """Deterministic per-sample RNG (reference worker_init/per-worker
        seed equivalent): each sample's augmentation stream is a pure
        function of (base_seed, epoch, index), independent of worker count
        or thread arrival order."""
        self._base_seed = int(base_seed)
        self._epoch = int(epoch)

    def sample_rng(self, index):
        base = getattr(self, '_base_seed', None)
        if base is None:
            return np.random
        mix = (base * 1000003 + getattr(self, '_epoch', 0)) * 7919 + int(index)
        return np.random.RandomState(mix % (2 ** 31 - 1))

    def prepare_data(self, input_dict, has_label=True, rng=None):
        """Per-sample pipeline: augment -> voxelize -> fixed-shape example.

        :param input_dict: {sample_idx, points (N, C), calib?,
                            gt_boxes_lidar (M, 7)?, gt_names (M,)?}
        :param rng: optional np.random.RandomState for ALL augmentation
            randomness (see set_sample_seed); defaults to the global stream.
        """
        if rng is None:
            rng = np.random
        cfg = self.cfg
        data_cfg = cfg.DATA_CONFIG
        sample_idx = input_dict['sample_idx']
        points = input_dict['points']
        calib = input_dict.get('calib', None)

        gt_boxes = gt_names = gt_classes = None
        if has_label:
            gt_boxes = input_dict['gt_boxes_lidar'].copy()
            gt_names = input_dict['gt_names'].copy()

        if self.training:
            selected = common.drop_arrays_by_name(gt_names, ['DontCare', 'Sign'])
            gt_boxes = gt_boxes[selected]
            gt_names = gt_names[selected]
            gt_boxes_mask = np.array([n in self.class_names for n in gt_names],
                                     dtype=np.bool_)

            aug_cfg = data_cfg.get('AUGMENTATION', None)
            if self.db_sampler is not None:
                road_planes = self.get_road_plane(sample_idx) \
                    if aug_cfg.DB_SAMPLER.USE_ROAD_PLANE else None
                sampled = self.db_sampler.sample_all(
                    self.root_path, gt_boxes, gt_names, road_planes=road_planes,
                    num_point_features=data_cfg.NUM_POINT_FEATURES['total'],
                    calib=calib,
                    rng=None if rng is np.random else rng)
                if sampled is not None:
                    gt_names = np.concatenate([gt_names, sampled['gt_names']])
                    gt_boxes = np.concatenate([gt_boxes, sampled['gt_boxes']])
                    gt_boxes_mask = np.concatenate(
                        [gt_boxes_mask, sampled['gt_masks']])
                    points = box_np_ops.remove_points_in_boxes3d(
                        points, sampled['gt_boxes'])
                    points = np.concatenate([sampled['points'], points], axis=0)

            if aug_cfg is not None:
                from .augmentation import augmentation_utils
                npo = aug_cfg.NOISE_PER_OBJECT
                if npo.ENABLED:
                    gt_boxes, points = augmentation_utils.noise_per_object_v3_(
                        gt_boxes, points, gt_boxes_mask,
                        rotation_perturb=npo.GT_ROT_UNIFORM_NOISE,
                        center_noise_std=npo.GT_LOC_NOISE_STD,
                        num_try=100, rng=rng)

            gt_boxes = gt_boxes[gt_boxes_mask]
            gt_names = gt_names[gt_boxes_mask]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in gt_names],
                dtype=np.int32)

            if aug_cfg is not None:
                from .augmentation import augmentation_utils
                ngs = aug_cfg.NOISE_GLOBAL_SCENE
                if ngs.ENABLED:
                    gt_boxes, points = augmentation_utils.random_flip(
                        gt_boxes, points, rng=rng)
                    gt_boxes, points = augmentation_utils.global_rotation(
                        gt_boxes, points, rotation=ngs.GLOBAL_ROT_UNIFORM_NOISE,
                        rng=rng)
                    gt_boxes, points = augmentation_utils.global_scaling(
                        gt_boxes, points, *ngs.GLOBAL_SCALING_UNIFORM_NOISE,
                        rng=rng)

            pc_range = self.voxel_generator.point_cloud_range
            mask = box_np_ops.mask_boxes_outside_range(gt_boxes, pc_range)
            gt_boxes = gt_boxes[mask]
            gt_classes = gt_classes[mask]
            gt_names = gt_names[mask]
            gt_boxes[:, 6] = common.limit_period(gt_boxes[:, 6], offset=0.5,
                                                 period=2 * np.pi)

        points = points[:, :data_cfg.NUM_POINT_FEATURES['use']]
        if data_cfg[self.mode].SHUFFLE_POINTS:
            rng.shuffle(points)

        if data_cfg.MASK_POINTS_BY_RANGE:
            points = common.mask_points_by_range(points,
                                                 data_cfg.POINT_CLOUD_RANGE)

        example = {'sample_idx': sample_idx}

        # fork capability: the raw (fixed-shape) point cloud rides along for
        # a differentiable re-voxelization (reference experiments.py:32-282)
        if cfg.get('TORCH_VOXEL_GENERATOR', False):
            max_pts = int(data_cfg.get('MAX_POINTS', 65536))
            n = min(len(points), max_pts)
            pts_fixed = np.zeros((max_pts, points.shape[1]), np.float32)
            pts_fixed[:n] = points[:n]
            pt_mask = np.zeros(max_pts, dtype=bool)
            pt_mask[:n] = True
            example['points'] = pts_fixed
            example['point_mask'] = pt_mask

        # ---- voxelize to fixed shape
        vg = self.voxel_generator
        out = vg.generate(points, pad_to_max=True)
        n_vox = out['num_voxels']
        voxel_mask = np.zeros(vg.max_voxels, dtype=bool)
        voxel_mask[:n_vox] = True
        coords = out['coordinates'].astype(np.int32)
        coords[~voxel_mask] = -1
        # The sparse backbones require id-SORTED voxels (every rulebook is a
        # merge / rank lookup); the host voxelizer emits spconv's
        # first-appearance order, so sort here, in the stable ascending
        # linear-id order voxelize_torch produces.  Padding rows keep
        # sorting last (key INT64_MAX), preserving the valid-prefix mask.
        g = vg.grid_size                                  # (nx, ny, nz)
        lin = ((coords[:, 0].astype(np.int64) * g[1] + coords[:, 1]) * g[0]
               + coords[:, 2])
        key = np.where(voxel_mask, lin, np.iinfo(np.int64).max)
        order = np.argsort(key, kind='stable')
        coords = coords[order]
        voxel_mask = voxel_mask[order]
        example.update({
            'voxels': out['voxels'].astype(np.float32)[order],
            'num_points': out['num_points_per_voxel'].astype(np.int32)[order],
            'coordinates': coords,
            'voxel_mask': voxel_mask,
        })

        # cap-overflow telemetry: unique in-range voxels beyond MAX_VOXELS
        # are silently dropped (the explicit max_voxels contract, reference
        # dataset.py:162-181); count them so training logs can warn instead
        # of corrupting accuracy invisibly (surfaced as overflow/voxelizer).
        if n_vox >= vg.max_voxels:
            g = vg.grid_size
            cf = ((points[:, :3] - vg.point_cloud_range[:3])
                  / vg.voxel_size).astype(np.int64)
            ok = ((cf >= 0) & (cf < g[None, :])).all(axis=1)
            c = cf[ok]
            lin = (c[:, 2] * g[1] + c[:, 1]) * g[0] + c[:, 0]
            n_unique = len(np.unique(lin))
            example['voxel_overflow'] = np.int32(max(n_unique - n_vox, 0))
        else:
            example['voxel_overflow'] = np.int32(0)

        if has_label:
            if not self.training:
                selected = common.keep_arrays_by_name(gt_names, self.class_names)
                gt_boxes = gt_boxes[selected]
                gt_names = gt_names[selected]
                gt_classes = np.array(
                    [self.class_names.index(n) + 1 for n in gt_names],
                    dtype=np.int32)

            gt_with_cls = np.concatenate(
                (gt_boxes, gt_classes.reshape(-1, 1).astype(np.float32)),
                axis=1).astype(np.float32)
            gt_padded = common.pad_or_trim_to(gt_with_cls, self.max_gt_boxes)
            example['gt_boxes'] = gt_padded

            # Part-A² auxiliary per-voxel targets, 'dataset' mode
            # (reference dataset.py:194-264 spec; the shipped cfgs use
            # GENERATED_ON: dataset)
            backbone_cfg = cfg.MODEL.RPN.BACKBONE if 'MODEL' in cfg else {}
            if (self.training and 'TARGET_CONFIG' in backbone_cfg
                    and backbone_cfg.TARGET_CONFIG.GENERATED_ON == 'dataset'):
                voxel_centers = (
                    (coords[:, ::-1].astype(np.float32) + 0.5)
                    * vg.voxel_size + vg.point_cloud_range[0:3])
                seg_labels, part_labels = generate_voxel_part_targets(
                    voxel_centers, voxel_mask, gt_boxes, gt_classes,
                    backbone_cfg.TARGET_CONFIG)
                example['seg_labels'] = seg_labels
                example['part_labels'] = part_labels

            if self.training and self.anchor_targets is not None:
                targets = self.anchor_targets.assign(gt_with_cls)
                example['box_cls_labels'] = targets['labels'].astype(np.int32)
                example['box_reg_targets'] = \
                    targets['bbox_targets'].astype(np.float32)

        return example

def generate_voxel_part_targets(voxel_centers, voxel_mask, gt_boxes,
                                gt_classes, target_cfg):
    """Per-voxel fg class + intra-object part offsets, fixed shape.

    (reference dataset.py:217-264 / rpn_unet.generate_part_targets_cpu:
    61-107 — enlarged-box ignore region, canonical part coordinates.)
    """
    v = voxel_centers.shape[0]
    seg_labels = np.zeros(v, dtype=np.int32)
    part_labels = np.zeros((v, 3), dtype=np.float32)
    if gt_boxes.shape[0] == 0:
        seg_labels[~voxel_mask] = -1
        return seg_labels, part_labels

    extend = common.enlarge_box3d(gt_boxes,
                                  extra_width=target_cfg.GT_EXTEND_WIDTH)
    in_box = box_np_ops.points_in_boxes_mask(voxel_centers, gt_boxes)
    in_ext = box_np_ops.points_in_boxes_mask(voxel_centers, extend)
    for k in range(gt_boxes.shape[0]):
        fg = in_box[k] & voxel_mask
        seg_labels[fg] = gt_classes[k]
        ignore = np.logical_xor(fg, in_ext[k] & voxel_mask)
        seg_labels[ignore] = -1
        local = voxel_centers[fg] - gt_boxes[k, 0:3]
        local = common.rotate_pc_along_z(local.copy(), -gt_boxes[k, 6])
        part_labels[fg] = (local / gt_boxes[k, 3:6]
                           + np.array([0.5, 0.5, 0], dtype=np.float32))
    part_labels = np.maximum(part_labels, 0)
    seg_labels[~voxel_mask] = -1
    return seg_labels, part_labels


def collate_batch(batch_list):
    """Stack fixed-shape per-sample examples into a batch dict."""
    keys = batch_list[0].keys()
    ret = {}
    for key in keys:
        vals = [ex[key] for ex in batch_list]
        if key == 'sample_idx':
            ret[key] = np.array(vals)
        elif isinstance(vals[0], np.ndarray):
            ret[key] = np.stack(vals, axis=0)
        else:
            ret[key] = vals
    ret['batch_size'] = len(batch_list)
    return ret
