"""Offline evaluation of KITTI result files against label files (the
reference's evaluate.py, with argparse); the port's copy of
`pcdet_tpu.datasets.kitti.kitti_eval.evaluate`.

Usage: python -m pcdet_tpu_torch.datasets.kitti.kitti_eval.evaluate \
         --label_path .../label_2 --result_path .../final_result/data \
         --label_split_file .../val.txt --current_class Car
"""
import argparse

from . import eval as kitti_eval
from . import kitti_common as kitti


def evaluate(label_path, result_path, label_split_file, current_class='Car',
             coco=False, score_thresh=-1):
    with open(label_split_file, 'r') as f:
        image_ids = [int(line) for line in f.readlines() if line.strip()]
    dt_annos = kitti.get_label_annos(result_path)
    gt_annos = kitti.get_label_annos(label_path, image_ids)
    if score_thresh > 0:
        dt_annos = [
            {k: (v[a['score'] > score_thresh] if hasattr(v, '__len__')
                 and len(v) == len(a['score']) else v)
             for k, v in a.items()} for a in dt_annos]
    if coco:
        return kitti_eval.get_coco_eval_result(gt_annos, dt_annos,
                                               current_class)
    result, _ = kitti_eval.get_official_eval_result(gt_annos, dt_annos,
                                                    current_class)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--label_path', required=True)
    parser.add_argument('--result_path', required=True)
    parser.add_argument('--label_split_file', required=True)
    parser.add_argument('--current_class', default='Car')
    parser.add_argument('--coco', action='store_true')
    parser.add_argument('--score_thresh', type=float, default=-1)
    args = parser.parse_args(argv)
    print(evaluate(args.label_path, args.result_path, args.label_split_file,
                   args.current_class, args.coco, args.score_thresh))


if __name__ == '__main__':
    main()
