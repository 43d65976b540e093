"""Post-processing on tensors.

Port of `pcdet_tpu.models.detector3d`: the selection-before-decode
`post_process_from_head` of the one-stage detectors (including the
MULTI_CLASSES_NMS branch): a masked top-k over the raw logits, decode of the
`NMS_PRE_MAXSIZE_LAST` survivors only, then the batched rotated NMS; and
the decode-everything `post_process_batch` (class-agnostic with a labels
override, or per class) that Part-A²'s refined boxes go through.  The
top-k is a stable descending sort so that ties (empty BEV regions give
exactly equal logits) break by lower anchor index, as `jax.lax.top_k` does.
`TrainHooks` holds what a detector wrapper tells the trainer beyond its
forward and loss.
"""
import torch

from ..ops import nms as nms_ops
from ..parallel import ddp
from ..ops import rotated_iou
from ..utils import torch_common
from .rpn_head import anchor_head_loss


class TrainHooks:
    """What a detector wrapper tells `train.trainer.Trainer` beyond forward
    and loss.  The defaults are a model's that draws nothing at random,
    freezes nothing and takes no targets past the anchor targets."""

    # True: the model draws at random in training, from the device
    # generator that the trainer hands to `set_generator`
    draws = False
    # the ranks that share the global batch (`parallel.ddp`; set by the
    # trainer): the losses divide by the global batch's normalizers
    process_group = None
    # True: `host_targets` reads the voxel coords (Part-A²'s per-voxel
    # targets), so the trainer gives it the step's coords
    coord_targets = False

    def frozen_prefixes(self):
        """Parameter name prefixes that the optimizer leaves out."""
        return ()

    def host_targets(self, coords, gt_boxes):
        """The targets made on the host beside the anchor targets, as
        (name, numpy array) pairs for the batch's one upload.

        :param coords: (B, V, 3) ZYX voxel coords, -1 rows for padding:
            numpy, or a tensor on the device (None where the batch's
            points are voxelized in the step and no host target needs them)
        :param gt_boxes: (B, M, 8) boxes with class ids, zero rows padding
        """
        return []


def _take(x, idx):
    """x (B, A, ...) gathered at idx (B, K) along dim 1."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def topk_decode(rank_scores, box_raw, dir_raw, anchors, box_coder, head_args,
                score_thresh, pre):
    """Masked top-`pre` anchors by raw score, decoded.

    :param rank_scores: (B, A) raw logits; :param box_raw: (B, A, code)
    :param dir_raw: (B, A, bins) or None; :param anchors: (A, 7)
    :return: dict idx (B, pre), boxes (B, pre, 7), boxes5 (B, pre, 5),
        rank (B, pre), valid (B, pre) bool
    """
    valid = torch.sigmoid(rank_scores) >= score_thresh
    ranked = torch.where(valid, rank_scores, nms_ops.NEG_INF)
    _, idx = nms_ops.topk_stable(ranked, pre)                    # (B, pre)
    boxes = box_coder.decode_with_head_direction(
        box_preds=_take(box_raw, idx), anchors=anchors[idx],
        dir_cls_preds=None if dir_raw is None else _take(dir_raw, idx),
        num_dir_bins=head_args.get('num_direction_bins', 2),
        dir_offset=head_args.get('dir_offset', 0.78539),
        dir_limit_offset=head_args.get('dir_limit_offset', 0.0),
        use_binary_dir_classifier=head_args.get('use_binary_dir_classifier',
                                                False))
    return {'idx': idx, 'boxes': boxes,
            'boxes5': torch_common.boxes3d_to_bev_corner_format(boxes),
            'rank': _take(rank_scores, idx), 'valid': _take(valid, idx)}


def post_process_from_head(ret_dict, anchors, box_coder, num_class,
                           head_args, test_cfg, class_labels_override=None):
    """NHWC head outputs -> fixed-shape detections: dict boxes (B, post, 7),
    scores (B, post), labels (B, post) int32, valid (B, post) bool, num (B,)
    int32 (each with C * post slots under MULTI_CLASSES_NMS)."""
    tc = test_cfg
    box_raw = ret_dict['box_preds']
    batch_size = box_raw.shape[0]
    num_anchors = anchors.shape[0]
    box_raw = box_raw.reshape(batch_size, num_anchors, -1)
    cls_preds = ret_dict['cls_preds'].reshape(batch_size, num_anchors, -1)
    dir_raw = ret_dict.get('dir_cls_preds', None)
    if dir_raw is not None:
        dir_raw = dir_raw.reshape(batch_size, num_anchors, -1)

    score_thresh = float(tc.SCORE_THRESH)
    nms_thresh = float(tc.NMS_THRESH)
    nms_post = int(tc.NMS_POST_MAXSIZE_LAST)
    use_raw_score = bool(tc.get('USE_RAW_SCORE', True))
    rotated = str(tc.get('NMS_TYPE', 'nms_gpu')) != 'nms_normal_gpu'
    pre = min(int(tc.NMS_PRE_MAXSIZE_LAST), num_anchors)

    def run_one(rank_scores, labels):
        cand = topk_decode(rank_scores, box_raw, dir_raw, anchors, box_coder,
                           head_args, score_thresh, pre)
        rank_g = cand['rank']
        selected, num = nms_ops.nms_bev_batched(
            cand['boxes5'], rank_g, nms_thresh, pre_max=pre,
            post_max=nms_post, valid_mask=cand['valid'], rotated=rotated)
        ok = selected >= 0
        sel = torch.where(ok, selected, 0).long()
        score_src = rank_g if use_raw_score else torch.sigmoid(rank_g)
        boxes = cand['boxes']
        return {
            'boxes': _take(boxes, sel) * ok[..., None].to(boxes.dtype),
            'scores': torch.where(ok, _take(score_src, sel), 0.0),
            'labels': torch.where(ok, _take(_take(labels, cand['idx']), sel),
                                  0).to(torch.int32),
            'valid': ok,
            'num': num,
        }

    if bool(tc.get('MULTI_CLASSES_NMS', False)):
        outs = [run_one(cls_preds[..., k],
                        torch.full(cls_preds.shape[:2], k + 1,
                                   dtype=torch.int32, device=cls_preds.device))
                for k in range(cls_preds.shape[-1])]
        return {k: (torch.cat([o[k] for o in outs], dim=1)
                    if k != 'num' else sum(o[k] for o in outs))
                for k in outs[0]}

    if cls_preds.shape[-1] > 1:
        rank_scores = torch.amax(cls_preds, dim=-1)
        class_labels = (torch.argmax(cls_preds, dim=-1) + 1).to(torch.int32)
    else:
        rank_scores = cls_preds[..., 0]
        class_labels = (torch.ones_like(rank_scores, dtype=torch.int32)
                        if class_labels_override is None
                        else class_labels_override)
    return run_one(rank_scores, class_labels)


def decode_single_stage(ret_dict, anchors, box_coder, num_class, head_args):
    """NHWC head outputs -> every anchor's class logits (B, A, C) and
    decoded box (B, A, 7) (`pcdet_tpu.models.detector3d.
    decode_single_stage`: the decode-everything path)."""
    box_preds = ret_dict['box_preds']
    batch_size, num_anchors = box_preds.shape[0], anchors.shape[0]
    cls_preds = ret_dict['cls_preds'].reshape(batch_size, num_anchors, -1)
    dir_preds = ret_dict.get('dir_cls_preds', None)
    if dir_preds is not None:
        dir_preds = dir_preds.reshape(batch_size, num_anchors, -1)
    boxes = box_coder.decode_with_head_direction(
        box_preds=box_preds.reshape(batch_size, num_anchors, -1),
        anchors=anchors[None].expand(batch_size, -1, -1),
        dir_cls_preds=dir_preds,
        num_dir_bins=head_args.get('num_direction_bins', 2),
        dir_offset=head_args.get('dir_offset', 0.78539),
        dir_limit_offset=head_args.get('dir_limit_offset', 0.0),
        use_binary_dir_classifier=head_args.get('use_binary_dir_classifier',
                                                False))
    return cls_preds, boxes


def _select(selected, box_preds, score_src, labels):
    """The NMS survivors' boxes, scores and labels, zero on padding."""
    ok = selected >= 0
    sel = torch.where(ok, selected, 0).long()
    return {'boxes': _take(box_preds, sel) * ok[..., None].to(box_preds.dtype),
            'scores': torch.where(ok, _take(score_src, sel), 0.0),
            'labels': torch.where(ok, _take(labels, sel), 0).to(torch.int32),
            'valid': ok}


def post_process_batched(cls_preds, box_preds, score_thresh, nms_thresh,
                         nms_pre, nms_post, use_raw_score=True,
                         class_labels_override=None, rotated=True):
    """Class-agnostic NMS of decoded boxes, the whole batch in one batched
    NMS (`pcdet_tpu.models.detector3d.post_process_batched`).

    :param cls_preds: (B, A, C) logits; :param box_preds: (B, A, 7)
    :param class_labels_override: (B, A) int32 labels of a one-class
        score (Part-A²'s RoI labels)
    :return: dict boxes (B, post, 7), scores, labels, valid, num (B,)
    """
    if cls_preds.dim() > 2 and cls_preds.shape[-1] > 1:
        rank_scores = torch.amax(cls_preds, dim=-1)
        class_labels = (torch.argmax(cls_preds, dim=-1) + 1).to(torch.int32)
    else:
        rank_scores = cls_preds.reshape(cls_preds.shape[0], -1)
        class_labels = (torch.ones_like(rank_scores, dtype=torch.int32)
                        if class_labels_override is None
                        else class_labels_override)
    normalized = torch.sigmoid(rank_scores)
    selected, num = nms_ops.nms_bev_batched(
        torch_common.boxes3d_to_bev_corner_format(box_preds), rank_scores,
        nms_thresh, pre_max=nms_pre, post_max=nms_post,
        valid_mask=normalized >= score_thresh, rotated=rotated)
    out = _select(selected, box_preds,
                  rank_scores if use_raw_score else normalized, class_labels)
    out['num'] = num
    return out


def post_process_sample(cls_preds, box_preds, score_thresh, nms_thresh,
                        nms_pre, nms_post, use_raw_score=True,
                        class_labels_override=None, rotated=True):
    """`post_process_batched` of one sample: (A, C), (A, 7) -> dict of
    (post, ...)."""
    out = post_process_batched(
        cls_preds[None], box_preds[None], score_thresh, nms_thresh, nms_pre,
        nms_post, use_raw_score=use_raw_score,
        class_labels_override=(None if class_labels_override is None
                               else class_labels_override[None]),
        rotated=rotated)
    return {k: v[0] for k, v in out.items()}


def multi_classes_nms_batched(cls_preds, box_preds, score_thresh, nms_thresh,
                              nms_pre, nms_post, use_raw_score=True,
                              rotated=True):
    """Per-class NMS of decoded boxes, each class one batched NMS into
    `nms_post` slots of its own, concatenated (`pcdet_tpu.models.
    detector3d.multi_classes_nms_batched`)."""
    boxes5 = torch_common.boxes3d_to_bev_corner_format(box_preds)
    outs = []
    for k in range(cls_preds.shape[-1]):
        rank_scores = cls_preds[..., k]
        normalized = torch.sigmoid(rank_scores)
        selected, num = nms_ops.nms_bev_batched(
            boxes5, rank_scores, nms_thresh, pre_max=nms_pre,
            post_max=nms_post, valid_mask=normalized >= score_thresh,
            rotated=rotated)
        o = _select(selected, box_preds,
                    rank_scores if use_raw_score else normalized,
                    torch.full_like(rank_scores, k + 1, dtype=torch.int32))
        o['num'] = num
        outs.append(o)
    return {k: (torch.cat([o[k] for o in outs], dim=1) if k != 'num'
                else sum(o[k] for o in outs)) for k in outs[0]}


def post_process_batch(batch_cls_preds, batch_box_preds, test_cfg,
                       class_labels_override=None):
    """Post-processing of decoded boxes by `MODEL.TEST`: per-class NMS under
    MULTI_CLASSES_NMS, else class-agnostic (with the labels override)
    (`pcdet_tpu.models.detector3d.post_process_batch`)."""
    multi = bool(test_cfg.get('MULTI_CLASSES_NMS', False))
    kwargs = dict(
        score_thresh=float(test_cfg.SCORE_THRESH),
        nms_thresh=float(test_cfg.NMS_THRESH),
        nms_pre=int(test_cfg.NMS_PRE_MAXSIZE_LAST),
        nms_post=int(test_cfg.NMS_POST_MAXSIZE_LAST),
        use_raw_score=bool(test_cfg.get('USE_RAW_SCORE', True)),
        rotated=str(test_cfg.get('NMS_TYPE', 'nms_gpu')) != 'nms_normal_gpu')
    if multi:
        return multi_classes_nms_batched(batch_cls_preds, batch_box_preds,
                                         **kwargs)
    return post_process_batched(batch_cls_preds, batch_box_preds,
                                class_labels_override=class_labels_override,
                                **kwargs)


def merge_overflow_tb(tb, ret_dict, batch):
    """Cap-overflow counters as `overflow/*` scalars
    (`pcdet_tpu.models.detector3d.merge_overflow_tb`): the sparse levels'
    drops from `ret_dict['overflow']`, the voxelizer's from
    `batch['voxel_overflow']`.  Any nonzero count means a static cap
    truncated the scene."""
    for k, v in (ret_dict.get('overflow') or {}).items():
        if v is not None:
            tb['overflow/' + k] = torch.as_tensor(v).sum()
    if 'voxel_overflow' in batch:
        tb['overflow/voxelizer'] = torch.as_tensor(
            batch['voxel_overflow']).sum()
    return tb


def detector_loss(model, ret_dict, batch):
    """A one-stage detector's training loss (`pcdet_tpu`'s PointPillar and
    SECONDNet `loss`): `anchor_head_loss` at the config's loss weights and
    head arguments, then the `overflow/*` counters.

    :param model: a `PointPillar` or `SECONDNet` wrapper (cfg, head_args,
        anchors, num_class, box_coder, process_group: the loss is the
        rank's share of the global batch's)
    :param batch: carries `box_cls_labels` (B, A) int32 and
        `box_reg_targets` (B, A, 7)
    :return: loss, tb dict of scalar tensors
    """
    lw = model.cfg.MODEL.LOSSES.LOSS_WEIGHTS
    a = model.head_args
    loss, tb = anchor_head_loss(
        ret_dict, model.anchors, batch['box_cls_labels'],
        batch['box_reg_targets'], num_class=model.num_class,
        loss_weights={
            'rpn_cls_weight': float(lw['rpn_cls_weight']),
            'rpn_loc_weight': float(lw['rpn_loc_weight']),
            'rpn_dir_weight': float(lw.get('rpn_dir_weight', 0.2)),
            'code_weights': list(lw['code_weights']),
        },
        box_code_size=model.box_coder.code_size,
        encode_background_as_zeros=a.get('encode_background_as_zeros', True),
        use_direction_classifier=a.get('use_direction_classifier', True),
        dir_offset=a.get('dir_offset', 0.78539),
        num_direction_bins=a.get('num_direction_bins', 2),
        world=ddp.world_size(model.process_group))
    merge_overflow_tb(tb, ret_dict, batch)
    return loss, tb


def batch_recall(boxes, valid, gt_boxes, thresh_list=(0.5, 0.7),
                 overlap_fn=None):
    """IoU3D recall counters of a batch against its (padded) GT, summed over
    the batch and kept on the device (`pcdet_tpu.train.eval_loop.
    _batch_recall`): a GT counts where its |box| sums > 0; the IoU is 0
    outside valid x valid; a GT is recalled at t when its best IoU > t.

    :param boxes: (B, K, 7); :param valid: (B, K) bool
    :param gt_boxes: (B, G, 8) zero-padded, class in the last column
    :param overlap_fn: the BEV overlap of `rotated_iou.boxes_iou3d_batched`
        (default kernel A)
    :return: {'gt': count, 'rcnn_<t>': recalled count} as 0-dim tensors
    """
    gt_valid = torch.abs(gt_boxes[..., :7]).sum(dim=-1) > 0
    iou = rotated_iou.boxes_iou3d_batched(boxes, gt_boxes[..., :7],
                                          overlap_fn)
    iou = torch.where(valid[..., :, None] & gt_valid[..., None, :], iou, 0.0)
    best_per_gt = torch.amax(iou, dim=-2)
    out = {'gt': gt_valid.sum()}
    for t in thresh_list:
        out['rcnn_%s' % str(t)] = ((best_per_gt > t) & gt_valid).sum()
    return out


def recall_counts(final_boxes, final_valid, gt_boxes, thresh_list=(0.5, 0.7)):
    """One sample's recall counters (`pcdet_tpu.models.detector3d.
    recall_counts`): `batch_recall` of a batch of one.

    :param final_boxes: (K, 7), :param final_valid: (K,) bool
    :param gt_boxes: (G, 8) zero-padded
    """
    return batch_recall(final_boxes[None], final_valid[None], gt_boxes[None],
                        thresh_list)
