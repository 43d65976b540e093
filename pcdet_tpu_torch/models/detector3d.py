"""Selection-before-decode post-processing on tensors.

Port of `pcdet_tpu.models.detector3d.post_process_from_head` (including the
MULTI_CLASSES_NMS branch): a masked top-k over the raw logits, decode of the
`NMS_PRE_MAXSIZE_LAST` survivors only, then the batched rotated NMS.  The
top-k is a stable descending sort so that ties (empty BEV regions give
exactly equal logits) break by lower anchor index, as `jax.lax.top_k` does.
"""
import torch

from ..ops import nms as nms_ops
from ..ops import rotated_iou
from ..utils import torch_common
from .rpn_head import anchor_head_loss


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
        anchors, num_class, box_coder)
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
        num_direction_bins=a.get('num_direction_bins', 2))
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
