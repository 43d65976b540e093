"""Evaluation loop: detect and recall on the device, annotations on a worker
thread, the official KITTI AP on the host.

Port of `pcdet_tpu.train.eval_loop.eval_one_epoch` (the PCDet reference's
tools/eval_utils/eval_utils.py:eval_one_epoch): per batch, the upload (a
data loader's voxelized batch through `detector.upload`, with SECOND's
books; raw points through the device voxelizer), the detector's forward
and predict, the recall counters through kernel A
(`models.detector3d.batch_recall`) and the cap-overflow counters, both
summed on the device and fetched once after the loop; the predictions are
fetched to the host on a one-worker thread pool, which writes the
annotations while the loop dispatches the next batch; then `result.pkl`
where a `result_dir` is given, and `dataset.evaluation`.

    cfg = detect.load_config(detect.SECOND_CFG)
    det = detect.build_detector(cfg, 'cuda')
    dataset = SyntheticDataset(cfg)
    result = eval_one_epoch(det, eval_batches(dataset, 2), dataset, cfg)

or, from a KITTI tree, `dataset, loader = datasets.build_dataloader(cfg, 2,
training=False)` and `eval_one_epoch(det, loader, dataset, cfg)`.
"""
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..models.detector3d import batch_recall, merge_overflow_tb


def eval_one_epoch(detector, batches, dataset, cfg, result_dir=None,
                   logger=None, save_to_file=False):
    """Evaluate `detector` on its device over `batches`.

    :param detector: a `detect.build_detector` detector
    :param batches: eval batches, numpy: raw points
        (`datasets.synthetic.eval_batches`: points (B, P, C), point_mask (B,
        P)) or voxelized (a `datasets.loader.DataLoader`'s: voxels,
        num_points, coordinates, voxel_mask, voxel_overflow, SECOND's
        `hb_*` books), each with gt_boxes (B, G, 8), sample_idx, batch_size
    :param dataset: gives `generate_annotations` and `evaluation`
    :return: the evaluator's AP dict with `recall/gt`, `recall/rcnn_<t>`,
        `overflow/*` and `sec_per_example` (the loop's seconds per example,
        the evaluator excluded)
    """
    class_names = list(cfg.CLASS_NAMES)
    thresh_list = tuple(cfg.MODEL.TEST.RECALL_THRESH_LIST)
    dev = detector.device

    det_annos = []
    recall = {'gt': 0}
    for t in thresh_list:
        recall['rcnn_%s' % str(t)] = 0

    start = time.time()
    n_examples = 0
    recall_dev = None
    overflow_dev = None

    def annotate(batch, dev_preds):
        # the device -> host copy runs on this worker thread, so the loop
        # keeps dispatching the next batch while annotations are written
        host_preds = {k: v.cpu().numpy() for k, v in dev_preds.items()}
        return dataset.generate_annotations(
            batch, host_preds, class_names, save_to_file=save_to_file,
            output_dir=(str(result_dir) + '/final_result/data'
                        if result_dir else None))

    with torch.inference_mode(), ThreadPoolExecutor(max_workers=1) as pool:
        futures = []
        for batch in batches:
            if 'voxels' in batch:
                vox = detector.upload(batch)
                ret = detector.model.forward(vox)
            else:
                vox, ret = detector.forward(
                    torch.as_tensor(batch['points'], device=dev),
                    torch.as_tensor(batch['point_mask'], device=dev))
            preds = detector.model.predict(ret)
            n_examples += batch['batch_size']
            ovf = merge_overflow_tb({}, ret, vox)
            overflow_dev = ovf if overflow_dev is None else {
                k: overflow_dev[k] + v for k, v in ovf.items()}

            if 'gt_boxes' in batch:
                gt = (vox['gt_boxes'] if 'gt_boxes' in vox else
                      torch.as_tensor(batch['gt_boxes'], device=dev))
                rc = batch_recall(preds['boxes'], preds['valid'], gt,
                                  thresh_list)
                recall_dev = rc if recall_dev is None else {
                    k: recall_dev[k] + v for k, v in rc.items()}

            futures.append(pool.submit(annotate, batch, preds))

        for f in futures:
            det_annos += f.result()
    if recall_dev is not None:
        for k, v in recall_dev.items():
            recall[k] = recall.get(k, 0) + int(v)
    overflow = {k: int(v) for k, v in (overflow_dev or {}).items()}
    if logger is not None:
        for k, v in overflow.items():
            if v > 0:
                logger.warning(
                    'CAP OVERFLOW %s: %d active sites dropped over the eval '
                    'run — results are TRUNCATED; raise the corresponding '
                    'cap' % (k, v))

    sec_per_example = (time.time() - start) / max(n_examples, 1)
    if logger is not None:
        logger.info('Generate label finished(sec_per_example: %.4f second).'
                    % sec_per_example)
        gt = max(recall['gt'], 1)
        for t in thresh_list:
            logger.info('recall_rcnn_%s: %f'
                        % (t, recall['rcnn_%s' % str(t)] / gt))

    if result_dir is not None:
        with open(str(result_dir) + '/result.pkl', 'wb') as f:
            pickle.dump(det_annos, f)

    result_str, result_dict = dataset.evaluation(
        det_annos, class_names, eval_metric=cfg.MODEL.TEST.EVAL_METRIC,
        output_dir=result_dir)
    if logger is not None:
        logger.info(result_str)
    result_dict['sec_per_example'] = sec_per_example
    result_dict.update({('recall/%s' % k): v for k, v in recall.items()})
    result_dict.update(overflow)
    return result_dict
