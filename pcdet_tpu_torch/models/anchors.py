"""Anchor grid and per-sample anchor targets, on the host in numpy.

The port's copy of `pcdet_tpu.models.anchors.AnchorHeadTargets` and its
chain: the per-class range anchor generators, `TargetAssigner` (forced
matches, positives above the matched threshold, negatives below the
unmatched one, the rest don't-care) on the nearest axis-aligned BEV IoU,
evaluated only on the window of anchors around the boxes, and the residual
encoding of the positives (`utils/box_coder.ResidualCoder.encode_np`); the
BEV helpers are `utils/box_np_ops`'.
Outputs are fixed-shape over the whole anchor grid and equal `pcdet_tpu`'s.
The positive-fraction sampling (SAMPLE_POS_FRACTION >= 0) is not ported:
no config sets it.
"""
import numpy as np

from ..utils.box_coder import ResidualCoder
from ..utils.box_np_ops import iou_axis_aligned, rbbox2d_to_near_bbox


def create_anchors_3d_range(feature_size, anchor_range, sizes, rotations,
                            dtype=np.float32):
    """Dense anchor grid over a range: (H, W, D, num_sizes, num_rots, 7).

    :param feature_size: [D, H, W] (zyx)
    :param anchor_range: [x0, y0, z0, x1, y1, z1]
    """
    anchor_range = np.asarray(anchor_range, dtype)
    z_centers = np.linspace(anchor_range[2], anchor_range[5], feature_size[0],
                            dtype=dtype)
    y_centers = np.linspace(anchor_range[1], anchor_range[4], feature_size[1],
                            dtype=dtype)
    x_centers = np.linspace(anchor_range[0], anchor_range[3], feature_size[2],
                            dtype=dtype)
    sizes = np.reshape(np.asarray(sizes, dtype=dtype), [-1, 3])
    rotations = np.asarray(rotations, dtype=dtype)
    rets = list(np.meshgrid(x_centers, y_centers, z_centers, rotations,
                            indexing='ij'))
    tile_shape = [1] * 5
    tile_shape[-2] = int(sizes.shape[0])
    for i in range(len(rets)):
        rets[i] = np.tile(rets[i][..., np.newaxis, :], tile_shape)
        rets[i] = rets[i][..., np.newaxis]
    sizes_full = np.reshape(sizes, [1, 1, 1, -1, 1, 3])
    tile_size_shape = list(rets[0].shape)
    tile_size_shape[3] = 1
    sizes_full = np.tile(sizes_full, tile_size_shape)
    rets.insert(3, sizes_full)
    ret = np.concatenate(rets, axis=-1)
    return np.transpose(ret, [2, 1, 0, 3, 4, 5])


class AnchorGeneratorRange:
    def __init__(self, anchor_ranges, sizes, rotations, class_name,
                 match_threshold, unmatch_threshold):
        self.sizes = sizes
        self.anchor_ranges = anchor_ranges
        self.rotations = rotations
        self.class_name = class_name
        self.match_threshold = match_threshold
        self.unmatch_threshold = unmatch_threshold

    @property
    def num_anchors_per_localization(self):
        num_size = np.asarray(self.sizes).reshape([-1, 3]).shape[0]
        return len(self.rotations) * num_size

    def generate(self, feature_map_size):
        return create_anchors_3d_range(feature_map_size, self.anchor_ranges,
                                       self.sizes, self.rotations)


def build_anchor_generators(anchor_generator_cfgs, class_names):
    """One AnchorGeneratorRange per class, ordered by `class_names`."""
    gens = []
    for cur_name in class_names:
        cur_cfg = next((a for a in anchor_generator_cfgs
                        if a['class_name'] == cur_name), None)
        assert cur_cfg is not None, 'Not found anchor config: %s' % cur_name
        gens.append(AnchorGeneratorRange(
            anchor_ranges=cur_cfg['anchor_range'],
            sizes=cur_cfg['sizes'],
            rotations=cur_cfg['rotations'],
            class_name=cur_cfg['class_name'],
            match_threshold=cur_cfg['matched_threshold'],
            unmatch_threshold=cur_cfg['unmatched_threshold']))
    return gens


class TargetAssigner:
    """Per-class anchor-GT matching (detectron-style with forced matches)."""

    def __init__(self, anchor_generators, pos_fraction,
                 region_similarity_fn_name, box_coder):
        if pos_fraction >= 0 or region_similarity_fn_name != \
                'nearest_iou_similarity':
            raise ValueError('only SAMPLE_POS_FRACTION < 0 and '
                             'nearest_iou_similarity are ported, got %r, %r'
                             % (pos_fraction, region_similarity_fn_name))
        self.anchor_generators = anchor_generators
        self.box_coder = box_coder

    @property
    def num_anchors_per_location(self):
        return sum(g.num_anchors_per_localization
                   for g in self.anchor_generators)

    def _per_class(self, feature_map_size):
        for gen in self.anchor_generators:
            anchors = gen.generate(feature_map_size)
            anchors = anchors.reshape([*anchors.shape[:3], -1,
                                       anchors.shape[-1]])
            num = int(np.prod(anchors.shape[:-1]))
            yield gen, anchors, num

    def generate_anchors(self, feature_map_size):
        """Anchors of every class, concatenated on the per-location axis."""
        return np.concatenate([a for _, a, _ in
                               self._per_class(feature_map_size)], axis=-2)

    def generate_anchors_dict(self, feature_map_size):
        return {gen.class_name: {
            'anchors': anchors,
            'matched_thresholds': np.full([num], gen.match_threshold,
                                          anchors.dtype),
            'unmatched_thresholds': np.full([num], gen.unmatch_threshold,
                                            anchors.dtype)}
            for gen, anchors, num in self._per_class(feature_map_size)}

    def assign_v2(self, anchors_dict, gt_boxes, gt_classes, gt_names):
        """Assign per class, concatenated over the per-location anchor axis.

        :return: flat (A,) labels, (A, 7) bbox_targets and
            bbox_src_targets, (A,) bbox_outside_weights
        """
        targets_list = []
        feature_map_size = None
        for class_name, anchor_dict in anchors_dict.items():
            mask = np.array([c == class_name for c in gt_names],
                            dtype=np.bool_)
            flat_anchors = anchor_dict['anchors'].reshape(
                -1, anchor_dict['anchors'].shape[-1])
            if 'near_bbox' not in anchor_dict:
                anchor_dict['near_bbox'] = rbbox2d_to_near_bbox(
                    flat_anchors[:, [0, 1, 3, 4, 6]])
            if 'grid' not in anchor_dict:
                # the class's anchors lie on a regular (1, ny, nx, nloc, 7)
                # grid with y / x centers on linspaces
                a = anchor_dict['anchors']
                anchor_dict['grid'] = {
                    'yc': np.ascontiguousarray(a[0, :, 0, 0, 1]),
                    'xc': np.ascontiguousarray(a[0, 0, :, 0, 0]),
                    'nloc': int(a.shape[3]),
                    'half_extent': float(np.max(a[0, 0, 0, :, 3:5]) / 2.0),
                }
            targets_list.append(self.create_target_np(
                flat_anchors, gt_boxes[mask], gt_classes[mask],
                anchor_dict['matched_thresholds'],
                anchor_dict['unmatched_thresholds'],
                anchor_dict['near_bbox'], anchor_dict['grid']))
            feature_map_size = anchor_dict['anchors'].shape[:3]

        code = self.box_coder.code_size
        fm = feature_map_size

        def cat(key, last):
            return np.concatenate(
                [t[key].reshape(*fm, -1, *last) for t in targets_list],
                axis=3).reshape(-1, *last)
        return {'labels': cat('labels', ()),
                'bbox_targets': cat('bbox_targets', (code,)),
                'bbox_src_targets': cat('bbox_src_targets', (code,)),
                'bbox_outside_weights': cat('bbox_outside_weights', ())}

    @staticmethod
    def _candidate_idx(grid, gt_boxes):
        """Flat indices of the anchors whose near-bbox can overlap some GT's
        near-bbox: one index-window rectangle of the regular grid per GT.
        Every other anchor has overlap exactly 0."""
        yc, xc, nloc = grid['yc'], grid['xc'], grid['nloc']
        me = grid['half_extent'] + 1e-4
        gt_near = rbbox2d_to_near_bbox(gt_boxes[:, [0, 1, 3, 4, 6]])
        ix_lo = np.searchsorted(xc, gt_near[:, 0] - me, side='left')
        ix_hi = np.searchsorted(xc, gt_near[:, 2] + me, side='right')
        iy_lo = np.searchsorted(yc, gt_near[:, 1] - me, side='left')
        iy_hi = np.searchsorted(yc, gt_near[:, 3] + me, side='right')
        cells = np.zeros((len(yc), len(xc)), dtype=bool)
        for m in range(len(gt_near)):
            cells[iy_lo[m]:iy_hi[m], ix_lo[m]:ix_hi[m]] = True
        flat_cells = np.flatnonzero(cells.ravel())
        return (flat_cells[:, None] * nloc
                + np.arange(nloc)[None, :]).reshape(-1)

    def create_target_np(self, all_anchors, gt_boxes, gt_classes,
                         matched_threshold, unmatched_threshold,
                         anchors_near_bbox, grid):
        """Single-class targets over the candidate window of `grid`:
        forced matches (each GT's best anchors, ties included), positives at
        overlap >= matched_threshold, negatives below unmatched_threshold,
        the rest -1."""
        num_inside = all_anchors.shape[0]
        labels = np.full((num_inside,), -1, dtype=np.int32)
        anchors_with_max_overlap = gt_inds_force = None
        anchor_to_gt_argmax = None
        cand = (self._candidate_idx(grid, gt_boxes)
                if len(gt_boxes) > 0 and num_inside > 0 else None)
        if cand is not None and len(cand) == 0:
            # every GT window falls outside the anchor grid: all background
            anchors_with_max_overlap = np.zeros(0, np.int64)
            gt_inds_force = np.zeros(0, np.int64)
            anchor_to_gt_argmax = np.zeros(num_inside, dtype=np.int64)
            bg_inds = np.arange(num_inside)
        elif cand is not None:
            gt_near = rbbox2d_to_near_bbox(gt_boxes[:, [0, 1, 3, 4, 6]])
            overlap = iou_axis_aligned(anchors_near_bbox[cand], gt_near)
            a2g_argmax_c = overlap.argmax(axis=1)
            a2g_max_c = overlap[np.arange(len(cand)), a2g_argmax_c]
            gt_to_anchor_max = overlap.max(axis=0)
            gt_to_anchor_max[gt_to_anchor_max == 0] = -1
            forced_rows = np.where(overlap == gt_to_anchor_max)[0]
            anchors_with_max_overlap = cand[forced_rows]
            gt_inds_force = a2g_argmax_c[forced_rows]
            labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]
            pos_c = a2g_max_c >= matched_threshold[cand]
            labels[cand[pos_c]] = gt_classes[a2g_argmax_c[pos_c]]
            bg_mask = np.ones(num_inside, dtype=bool)
            bg_mask[cand[a2g_max_c >= unmatched_threshold[cand]]] = False
            bg_inds = np.flatnonzero(bg_mask)
            anchor_to_gt_argmax = np.zeros(num_inside, dtype=np.int64)
            anchor_to_gt_argmax[cand] = a2g_argmax_c
        else:
            bg_inds = np.arange(num_inside)

        if cand is None:
            labels[:] = 0
        else:
            labels[bg_inds] = 0
            labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]

        code = self.box_coder.code_size
        bbox_targets = np.zeros((num_inside, code), dtype=all_anchors.dtype)
        bbox_src_targets = np.zeros((num_inside, code),
                                    dtype=all_anchors.dtype)
        fg_inds = np.where(labels > 0)[0]
        if cand is not None and len(fg_inds) > 0:
            fg_gt_boxes = gt_boxes[anchor_to_gt_argmax[fg_inds], :]
            fg_anchors = all_anchors[fg_inds, :]
            bbox_targets[fg_inds, :] = self.box_coder.encode_np(fg_gt_boxes,
                                                                fg_anchors)
            src = fg_gt_boxes.copy()
            src[:, 0:3] = fg_gt_boxes[:, 0:3] - fg_anchors[:, 0:3]
            bbox_src_targets[fg_inds, :] = src
        bbox_outside_weights = np.zeros((num_inside,), dtype=all_anchors.dtype)
        bbox_outside_weights[labels > 0] = 1.0
        return {'labels': labels, 'bbox_targets': bbox_targets,
                'bbox_src_targets': bbox_src_targets,
                'bbox_outside_weights': bbox_outside_weights}


class AnchorHeadTargets:
    """The anchor cache of one model config and its per-sample assignment:
    the feature map is grid_size[:2] // DOWNSAMPLED_FACTOR and the flat
    anchors concatenate the classes on the per-location axis."""

    def __init__(self, anchor_target_cfg, grid_size, class_names,
                 box_coder=None):
        self.class_names = list(class_names)
        self.box_coder = box_coder or ResidualCoder()
        gens = build_anchor_generators(anchor_target_cfg.ANCHOR_GENERATOR,
                                       class_names)
        self.assigner = TargetAssigner(
            anchor_generators=gens,
            pos_fraction=anchor_target_cfg.SAMPLE_POS_FRACTION,
            region_similarity_fn_name=anchor_target_cfg.REGION_SIMILARITY_FN,
            box_coder=self.box_coder)
        feature_map_size = (np.asarray(grid_size[:2])
                            // anchor_target_cfg.DOWNSAMPLED_FACTOR)
        feature_map_size = [*feature_map_size, 1][::-1]     # [1, ny, nx]
        self.feature_map_size = feature_map_size
        anchors = self.assigner.generate_anchors(feature_map_size)
        self.anchors = anchors.reshape([-1, 7]).astype(np.float32)
        self.anchors_dict = self.assigner.generate_anchors_dict(
            feature_map_size)
        self.num_anchors_per_location = self.assigner.num_anchors_per_location

    @property
    def num_anchors(self):
        return self.anchors.shape[0]

    def assign(self, gt_boxes_with_cls):
        """Targets for one sample.

        :param gt_boxes_with_cls: (M, 8) [x, y, z, w, l, h, r, class 1..C],
            zero rows at the end stripped
        :return: labels (A,), bbox_targets (A, 7), bbox_src_targets (A, 7),
            bbox_outside_weights (A,)
        """
        gt_boxes_with_cls = np.asarray(gt_boxes_with_cls)
        cnt = gt_boxes_with_cls.shape[0] - 1
        while cnt > 0 and gt_boxes_with_cls[cnt].sum() == 0:
            cnt -= 1
        cur = gt_boxes_with_cls[:cnt + 1]
        if cur.shape[0] == 1 and cur.sum() == 0:
            cur = cur[:0]
        gt_boxes = cur[:, :7]
        gt_classes = cur[:, 7].astype(np.int32)
        gt_names = np.array(self.class_names)[
            np.clip(gt_classes - 1, 0, len(self.class_names) - 1)]
        return self.assigner.assign_v2(self.anchors_dict, gt_boxes,
                                       gt_classes, gt_names)
