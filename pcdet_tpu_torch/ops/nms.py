"""Batched exact greedy NMS (rotated or axis-aligned) on tensors.

Port of `pcdet_tpu.ops.nms.nms_bev_batched`.  Outputs keep the fixed-shape
contract: `selected` (G, post_max) int32 indices padded with -1, plus `num`.

Greedy stays exact: each round takes the `block` highest-ranked alive boxes
of every sample, computes their (block, pre) IoU rows, resolves greedy
exactly within the block, and kills what the block's keepers suppress.  On
CUDA tensors with the default `overlap_fn` the rounds run on the card in one
launch of kernel F (`nms_fused`), which reads nothing back on the host; its
rounds a group are `last_device_rounds()`.  On CPU tensors, or with a
caller's own `overlap_fn`, the rounds run eagerly (`_lazy_greedy_batched`,
F's oracle): one launch of the overlap function a round, and every round and
every frontier step inside a block reads a flag on the host.  Each launch of
F, and each eager round, is one span `pcdet.nms.round`
(`utils.profiler.span`).
"""
import torch

from ..utils.profiler import span
from . import nms_fused, rotated_iou
from .rotated_overlap import pair_overlap_batched

NEG_INF = -1e9
BLOCK = 64          # boxes resolved per greedy round (JAX's TPU block)
_LAST_ROUNDS = None


def last_device_rounds():
    """The (G,) int32 rounds each group ran in the last launch of kernel F
    (on the card, not synchronised), or None before the first."""
    return _LAST_ROUNDS


def topk_stable(x, k):
    """Top-k along dim 1 with ties broken by lower index, as
    `jax.lax.top_k` does (torch.topk makes no such promise)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _greedy_suppress_batched(iou, valid, thresh):
    """Exact greedy over (G, K, K) IoU in rank order by the frontier fixed
    point: a box is kept once no higher-ranked box that could still suppress
    it is alive.  (G, K) valid -> (G, K) keep."""
    k = iou.shape[1]
    idx = torch.arange(k, device=iou.device)
    sup = ((iou > thresh) & (idx[:, None] < idx[None, :])[None]
           & valid[:, :, None])
    kept = torch.zeros_like(valid)
    alive = valid.clone()
    while bool(alive.any()):
        blocked = (sup & alive[:, :, None]).any(dim=1)
        frontier = alive & ~blocked
        suppressed = (sup & frontier[:, :, None]).any(dim=1)
        kept = kept | frontier
        alive = alive & ~frontier & ~suppressed
    return kept


def _lazy_greedy_batched(top_boxes, top_valid, thresh, post_max, rotated,
                         overlap_fn=pair_overlap_batched):
    """Batched exact greedy NMS with lazy blocked IoU rows.

    :param top_boxes: (G, pre, 5) in descending score order per group
    :param top_valid: (G, pre) bool
    :param rotated: rotated IoU rows (overlap_fn) vs axis-aligned rows
    :return: (G, pre) bool keep mask
    """
    g, pre = top_boxes.shape[0], top_boxes.shape[1]
    dev = top_boxes.device
    block = min(BLOCK, pre)
    if rotated:
        corners = rotated_iou.boxes5_to_corners(top_boxes).contiguous()
    area = _box_area(top_boxes)                                    # (G, pre)
    positions = torch.arange(pre, device=dev)[None].expand(g, pre)
    keep = torch.zeros((g, pre), dtype=torch.bool, device=dev)
    alive = top_valid.clone()
    n = torch.zeros(g, dtype=torch.int64, device=dev)

    while True:
        upd = alive.any(dim=1) & (n < post_max)                    # (G,)
        if not bool(upd.any()):
            break
        with span('pcdet.nms.round'):
            # first `block` alive boxes per group, in rank order
            cnt = torch.cumsum(alive.long(), dim=1)
            in_block = alive & (cnt <= block)
            slot = torch.clamp(cnt - 1, 0, block - 1)
            blk = torch.sort(torch.where(alive, positions, pre),
                             dim=1).values[:, :block]              # (G, B)
            blk_valid = blk < pre
            blk_idx = torch.where(blk_valid, blk, 0)

            if rotated:
                cb = torch.gather(corners, 1, blk_idx[:, :, None, None]
                                  .expand(g, block, 4, 2)).contiguous()
                inter = overlap_fn(cb, corners)                # (G, B, pre)
            else:
                bb = torch.gather(top_boxes, 1, blk_idx[:, :, None].expand(
                    g, block, 5))
                iw = torch.clamp(
                    torch.minimum(bb[:, :, None, 2], top_boxes[:, None, :, 2])
                    - torch.maximum(bb[:, :, None, 0],
                                    top_boxes[:, None, :, 0]), min=0)
                ih = torch.clamp(
                    torch.minimum(bb[:, :, None, 3], top_boxes[:, None, :, 3])
                    - torch.maximum(bb[:, :, None, 1],
                                    top_boxes[:, None, :, 1]), min=0)
                inter = iw * ih
            area_blk = torch.gather(area, 1, blk_idx)              # (G, B)
            iou_blk = inter / torch.clamp(
                area_blk[:, :, None] + area[:, None, :] - inter, min=1e-8)

            # exact greedy within each block (rows and columns in rank
            # order)
            iou_bb = torch.gather(iou_blk, 2,
                                  blk_idx[:, None, :].expand(g, block, block))
            keep_b = _greedy_suppress_batched(iou_bb, blk_valid, thresh)

            kill = ((iou_blk > thresh) & keep_b[:, :, None]).any(dim=1)
            keep_full = torch.gather(keep_b, 1, slot) & in_block
            keep = keep | (keep_full & upd[:, None])
            alive = torch.where(upd[:, None], alive & ~kill & ~in_block,
                                alive)
            n = n + torch.where(upd, keep_b.sum(dim=1), 0)
    return keep


def _box_area(top_boxes):
    return ((top_boxes[..., 2] - top_boxes[..., 0])
            * (top_boxes[..., 3] - top_boxes[..., 1]))


def _fused_greedy(top_boxes, top_valid, thresh, post_max, rotated):
    """`_lazy_greedy_batched`'s keep mask from one launch of kernel F."""
    global _LAST_ROUNDS
    geo = (rotated_iou.boxes5_to_corners(top_boxes) if rotated
           else top_boxes).contiguous()
    with span('pcdet.nms.round'):
        keep, _LAST_ROUNDS = nms_fused.greedy(
            geo, _box_area(top_boxes).contiguous(), top_valid.contiguous(),
            thresh, post_max, rotated)
    return keep


def nms_bev_batched(boxes5, scores, thresh, pre_max=4096, post_max=500,
                    valid_mask=None, rotated=True,
                    overlap_fn=pair_overlap_batched):
    """Batch-parallel fixed-shape NMS.

    :param boxes5: (G, A, 5) [x1, y1, x2, y2, ry], :param scores: (G, A)
    :param valid_mask: (G, A) bool, boxes to consider
    :param rotated: rotated IoU (nms_gpu) vs axis-aligned (nms_normal_gpu)
    :param overlap_fn: the rotated pair-overlap function of the eager
        rounds; the default takes kernel F on CUDA tensors, another (say
        `pair_overlap_batched_plain`, or kernel A wrapped) the eager loop
    :return: selected (G, post_max) int32 (-1 pad), num_selected (G,) int32
    """
    g, a = boxes5.shape[0], boxes5.shape[1]
    pre_max = min(pre_max, a)
    if valid_mask is None:
        valid_mask = torch.ones((g, a), dtype=torch.bool, device=boxes5.device)
    ranked = torch.where(valid_mask, scores, NEG_INF)
    top_scores, order = topk_stable(ranked, pre_max)               # (G, pre)
    top_valid = top_scores > NEG_INF / 2
    top_boxes = torch.gather(boxes5, 1, order[:, :, None].expand(g, pre_max, 5))

    if boxes5.device.type == 'cuda' and overlap_fn is pair_overlap_batched:
        keep = _fused_greedy(top_boxes, top_valid, thresh, post_max, rotated)
    else:
        keep = _lazy_greedy_batched(top_boxes, top_valid, thresh, post_max,
                                    rotated=rotated, overlap_fn=overlap_fn)

    positions = torch.arange(pre_max, device=boxes5.device)[None]
    keep_rank = torch.where(keep, positions, pre_max)
    sorted_rank, sel_order = torch.sort(keep_rank, dim=1, stable=True)
    sel_valid = sorted_rank[:, :post_max] < pre_max
    selected = torch.where(sel_valid,
                           torch.gather(order, 1, sel_order[:, :post_max]),
                           -1).to(torch.int32)
    if selected.shape[1] < post_max:                             # pre < post
        pad = torch.full((g, post_max - selected.shape[1]), -1,
                         dtype=torch.int32, device=boxes5.device)
        selected = torch.cat([selected, pad], dim=1)
    num = torch.clamp(keep.sum(dim=1), max=post_max).to(torch.int32)
    return selected, num
