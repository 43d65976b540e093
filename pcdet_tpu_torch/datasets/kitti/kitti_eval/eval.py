"""Official KITTI AP evaluation (41-point / R40 PR sampling).

The port's copy of `pcdet_tpu.datasets.kitti.kitti_eval.eval`'s
`get_official_eval_result` and everything it calls (the PCDet reference's
kitti_object_eval_python/eval.py: the matching rules, threshold selection,
ignore semantics and PR sampling, replicated exactly).  The hot loops are
the native f64 functions of `native.py` on the host.  Also the COCO-style
result, `get_coco_eval_result`.
"""
import io as sysio

import numpy as np

from . import native

CLASS_TO_NAME = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                 4: 'Person_sitting', 5: 'Truck'}


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Pick score thresholds that sample recall uniformly (eval.py:8-25)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (((r_recall - current_recall) < (current_recall - l_recall))
                and (i < len(scores) - 1)):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Per-frame ignore flags by class/occlusion/truncation/height
    (eval.py:28-81)."""
    CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting',
                   'truck']
    MIN_HEIGHT = [40, 25, 25]
    MAX_OCCLUSION = [0, 1, 2]
    MAX_TRUNCATION = [0.15, 0.3, 0.5]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_valid_gt = 0
    for i in range(len(gt_anno['name'])):
        bbox = gt_anno['bbox'][i]
        gt_name = gt_anno['name'][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(len(dt_anno['name'])):
        valid_class = 1 if dt_anno['name'][i].lower() == current_cls_name \
            else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


image_box_overlap = native.image_box_overlap


def bev_box_overlap(boxes, qboxes, criterion=-1):
    return native.rotate_iou_eval(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D (camera-frame) overlap: rotated BEV inter x height overlap
    (eval.py:119-152) — the height part vectorised instead of numba."""
    rinc = native.rotate_iou_eval(boxes[:, [0, 2, 3, 5, 6]],
                                  qboxes[:, [0, 2, 3, 5, 6]], 2)
    n, k = rinc.shape
    if n == 0 or k == 0:
        return rinc
    # camera y points down; box y is the bottom face, extends to y - h
    min_y = np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
    max_y = np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4])
    iw = min_y - max_y
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = iw * rinc
    if criterion == -1:
        ua = vol_a + vol_b - inc
    elif criterion == 0:
        ua = np.broadcast_to(vol_a, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vol_b, inc.shape)
    else:
        ua = np.ones_like(inc)
    out = np.where((rinc > 0) & (iw > 0), inc / ua, 0.0)
    return out


def get_split_parts(num, num_part):
    same_part = num // num_part
    remain_num = num % num_part
    if same_part == 0:
        return [num]
    if remain_num == 0:
        return [same_part] * num_part
    return [same_part] * num_part + [remain_num]


def calculate_iou_partly(gt_annos, dt_annos, metric, num_parts=50):
    """Chunked IoU matrices (eval.py:338-412). NOTE: in eval_class this is
    called with (dt, gt) so rows are detections."""
    assert len(gt_annos) == len(dt_annos)
    total_dt_num = np.stack([len(a['name']) for a in dt_annos], 0)
    total_gt_num = np.stack([len(a['name']) for a in gt_annos], 0)
    num_examples = len(gt_annos)
    split_parts = get_split_parts(num_examples, num_parts)
    parted_overlaps = []
    example_idx = 0

    def cat(key, annos, cols=None):
        vals = [a[key] if cols is None else a[key][:, cols] for a in annos]
        return np.concatenate(vals, 0)

    for num_part in split_parts:
        gt_part = gt_annos[example_idx:example_idx + num_part]
        dt_part = dt_annos[example_idx:example_idx + num_part]
        if metric == 0:
            overlap_part = image_box_overlap(cat('bbox', gt_part),
                                             cat('bbox', dt_part))
        elif metric == 1:
            gt_boxes = np.concatenate(
                [cat('location', gt_part, [0, 2]),
                 cat('dimensions', gt_part, [0, 2]),
                 cat('rotation_y', gt_part)[..., None]], axis=1)
            dt_boxes = np.concatenate(
                [cat('location', dt_part, [0, 2]),
                 cat('dimensions', dt_part, [0, 2]),
                 cat('rotation_y', dt_part)[..., None]], axis=1)
            overlap_part = bev_box_overlap(gt_boxes, dt_boxes).astype(np.float64)
        elif metric == 2:
            gt_boxes = np.concatenate(
                [cat('location', gt_part), cat('dimensions', gt_part),
                 cat('rotation_y', gt_part)[..., None]], axis=1)
            dt_boxes = np.concatenate(
                [cat('location', dt_part), cat('dimensions', dt_part),
                 cat('rotation_y', dt_part)[..., None]], axis=1)
            overlap_part = d3_box_overlap(gt_boxes, dt_boxes).astype(np.float64)
        else:
            raise ValueError('unknown metric')
        parted_overlaps.append(overlap_part)
        example_idx += num_part

    overlaps = []
    example_idx = 0
    for j, num_part in enumerate(split_parts):
        gt_num_idx, dt_num_idx = 0, 0
        for i in range(num_part):
            gt_box_num = total_gt_num[example_idx + i]
            dt_box_num = total_dt_num[example_idx + i]
            overlaps.append(parted_overlaps[j][
                gt_num_idx:gt_num_idx + gt_box_num,
                dt_num_idx:dt_num_idx + dt_box_num])
            gt_num_idx += gt_box_num
            dt_num_idx += dt_box_num
        example_idx += num_part
    return overlaps, parted_overlaps, total_gt_num, total_dt_num


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    total_dc_num, ignored_gts, ignored_dets, dontcares = [], [], [], []
    total_num_valid_gt = 0
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt_annos[i], dt_annos[i], current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
        ignored_dets.append(np.array(ignored_det, dtype=np.int64))
        dc_bboxes = (np.stack(dc_bboxes, 0).astype(np.float64) if dc_bboxes
                     else np.zeros((0, 4), dtype=np.float64))
        total_dc_num.append(dc_bboxes.shape[0])
        dontcares.append(dc_bboxes)
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt_annos[i]['bbox'], gt_annos[i]['alpha'][..., None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt_annos[i]['bbox'], dt_annos[i]['alpha'][..., None],
             dt_annos[i]['score'][..., None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, np.stack(total_dc_num, axis=0), total_num_valid_gt)


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, num_parts=50):
    """Per-(class, difficulty, overlap) PR curves (eval.py:446-551)."""
    assert len(gt_annos) == len(dt_annos)
    num_examples = len(gt_annos)
    split_parts = get_split_parts(num_examples, num_parts)

    overlaps, parted_overlaps, total_dt_num, total_gt_num = \
        calculate_iou_partly(dt_annos, gt_annos, metric, num_parts)
    N_SAMPLE_PTS = 41
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap,
                          N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_dc_num, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    _, _, _, _, thresholds = native.compute_statistics(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap=min_overlap, thresh=0.0,
                        compute_fp=False)
                    thresholdss += thresholds.tolist()
                thresholds = np.array(get_thresholds(np.array(thresholdss),
                                                     total_num_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                idx = 0
                for j, num_part in enumerate(split_parts):
                    native.fused_compute_statistics(
                        parted_overlaps[j], pr,
                        total_gt_num[idx:idx + num_part],
                        total_dt_num[idx:idx + num_part],
                        total_dc_num[idx:idx + num_part],
                        np.concatenate(gt_datas_list[idx:idx + num_part], 0),
                        np.concatenate(dt_datas_list[idx:idx + num_part], 0),
                        np.concatenate(dontcares[idx:idx + num_part], 0),
                        np.concatenate(ignored_gts[idx:idx + num_part], 0),
                        np.concatenate(ignored_dets[idx:idx + num_part], 0),
                        metric, min_overlap=min_overlap,
                        thresholds=thresholds, compute_aos=compute_aos)
                    idx += num_part
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:],
                                                   axis=-1)
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, PR_detail_dict=None):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret['precision'])
    mAP_bbox_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['bbox'] = ret['precision']
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret['orientation'])
        mAP_aos_R40 = get_mAP_R40(ret['orientation'])
        if PR_detail_dict is not None:
            PR_detail_dict['aos'] = ret['orientation']
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps)
    mAP_bev = get_mAP(ret['precision'])
    mAP_bev_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['bev'] = ret['precision']
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps)
    mAP_3d = get_mAP(ret['precision'])
    mAP_3d_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['3d'] = ret['precision']
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, mAP_bbox_R40, mAP_bev_R40,
            mAP_3d_R40, mAP_aos_R40)


def do_coco_style_eval(gt_annos, dt_annos, current_classes, overlap_ranges,
                       compute_aos):
    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            # (start, stop, count): numpy 2 takes the count only as an int
            lo, hi, num = overlap_ranges[:, i, j]
            min_overlaps[:, i, j] = np.linspace(lo, hi, int(num))
    out = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                  compute_aos)
    mAP_bbox, mAP_bev, mAP_3d, mAP_aos = out[0], out[1], out[2], out[3]
    mAP_bbox = mAP_bbox.mean(-1)
    mAP_bev = mAP_bev.mean(-1)
    mAP_3d = mAP_3d.mean(-1)
    if mAP_aos is not None:
        mAP_aos = mAP_aos.mean(-1)
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             PR_detail_dict=None):
    """AP (R11 + R40) for bbox/bev/3d/aos at easy/mod/hard (eval.py:637-759)."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)

    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]

    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break

    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                           compute_aos, PR_detail_dict=PR_detail_dict)

    result = ''
    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        cls_name = CLASS_TO_NAME[curcls]
        for i in range(min_overlaps.shape[0]):
            result += print_str(
                '{} AP@{:.2f}, {:.2f}, {:.2f}:'.format(
                    cls_name, *min_overlaps[i, :, j]))
            result += print_str('bbox AP:{:.4f}, {:.4f}, {:.4f}'.format(
                *mAPbbox[j, :, i]))
            result += print_str('bev  AP:{:.4f}, {:.4f}, {:.4f}'.format(
                *mAPbev[j, :, i]))
            result += print_str('3d   AP:{:.4f}, {:.4f}, {:.4f}'.format(
                *mAP3d[j, :, i]))
            if compute_aos:
                result += print_str('aos  AP:{:.2f}, {:.2f}, {:.2f}'.format(
                    *mAPaos[j, :, i]))
                if i == 0:
                    for d, dn in enumerate(['easy', 'moderate', 'hard']):
                        ret_dict['%s_aos_%s' % (cls_name, dn)] = mAPaos[j, d, 0]
            result += print_str(
                '{} AP_R40@{:.2f}, {:.2f}, {:.2f}:'.format(
                    cls_name, *min_overlaps[i, :, j]))
            result += print_str('bbox AP:{:.4f}, {:.4f}, {:.4f}'.format(
                *mAPbbox_R40[j, :, i]))
            result += print_str('bev  AP:{:.4f}, {:.4f}, {:.4f}'.format(
                *mAPbev_R40[j, :, i]))
            result += print_str('3d   AP:{:.4f}, {:.4f}, {:.4f}'.format(
                *mAP3d_R40[j, :, i]))
            if compute_aos:
                result += print_str('aos  AP:{:.2f}, {:.2f}, {:.2f}'.format(
                    *mAPaos_R40[j, :, i]))
                if i == 0:
                    for d, dn in enumerate(['easy', 'moderate', 'hard']):
                        ret_dict['%s_aos_%s_R40' % (cls_name, dn)] = \
                            mAPaos_R40[j, d, 0]
            if i == 0:
                for d, dn in enumerate(['easy', 'moderate', 'hard']):
                    ret_dict['%s_3d_%s' % (cls_name, dn)] = mAP3d[j, d, 0]
                    ret_dict['%s_bev_%s' % (cls_name, dn)] = mAPbev[j, d, 0]
                    ret_dict['%s_image_%s' % (cls_name, dn)] = mAPbbox[j, d, 0]
                    ret_dict['%s_3d_%s_R40' % (cls_name, dn)] = \
                        mAP3d_R40[j, d, 0]
                    ret_dict['%s_bev_%s_R40' % (cls_name, dn)] = \
                        mAPbev_R40[j, d, 0]
                    ret_dict['%s_image_%s_R40' % (cls_name, dn)] = \
                        mAPbbox_R40[j, d, 0]
    return result, ret_dict


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """COCO-style averaged-overlap AP (eval.py:762-821)."""
    class_to_range = {0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10],
                      2: [0.25, 0.7, 10], 3: [0.5, 0.95, 10],
                      4: [0.25, 0.7, 10]}
    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    overlap_ranges = np.zeros([3, 3, len(current_classes)])
    for i, curcls in enumerate(current_classes):
        overlap_ranges[:, :, i] = np.array(class_to_range[curcls])[:, None]
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break
    mAPbbox, mAPbev, mAP3d, mAPaos = do_coco_style_eval(
        gt_annos, dt_annos, current_classes, overlap_ranges, compute_aos)
    result = ''
    for j, curcls in enumerate(current_classes):
        o_range = np.array(class_to_range[curcls])[[0, 2, 1]]
        o_range[1] = (o_range[2] - o_range[0]) / (o_range[1] - 1)
        result += print_str('{} coco AP@{:.2f}:{:.2f}:{:.2f}:'.format(
            CLASS_TO_NAME[curcls], *o_range))
        result += print_str('bbox AP:{:.2f}, {:.2f}, {:.2f}'.format(
            *mAPbbox[j]))
        result += print_str('bev  AP:{:.2f}, {:.2f}, {:.2f}'.format(
            *mAPbev[j]))
        result += print_str('3d   AP:{:.2f}, {:.2f}, {:.2f}'.format(
            *mAP3d[j]))
        if compute_aos:
            result += print_str('aos  AP:{:.2f}, {:.2f}, {:.2f}'.format(
                *mAPaos[j]))
    return result
