"""Offline evaluation of a pickled result list against pickled GT infos.

The port's copy of `pcdet_tpu.datasets.kitti.kitti_eval_cli` (the
reference's pcdet/datasets/kitti/kitti_eval.py): a result.pkl (a list of
det annos) against kitti_infos_*.pkl.

Usage:
    python -m pcdet_tpu_torch.datasets.kitti.kitti_eval_cli \
        --pred_infos output/.../result.pkl \
        --gt_infos data/kitti/kitti_infos_val.pkl
"""
import argparse
import copy
import pickle

from .kitti_eval.eval import get_official_eval_result


def evaluation(det_annos, gt_infos, class_names, **kwargs):
    if 'annos' not in gt_infos[0]:
        return 'None', {}
    eval_det = copy.deepcopy(det_annos)
    eval_gt = [copy.deepcopy(info['annos']) for info in gt_infos]
    return get_official_eval_result(eval_gt, eval_det, class_names)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pred_infos', type=str, required=True)
    parser.add_argument('--gt_infos', type=str, required=True)
    parser.add_argument('--class_names', type=str, nargs='+',
                        default=['Car', 'Pedestrian', 'Cyclist'])
    args = parser.parse_args(argv)

    with open(args.pred_infos, 'rb') as f:
        pred_infos = pickle.load(f)
    with open(args.gt_infos, 'rb') as f:
        gt_infos = pickle.load(f)
    result_str, _ = evaluation(pred_infos, gt_infos, args.class_names)
    print(result_str)


if __name__ == '__main__':
    main()
