"""KITTI label/result file <-> anno-dict helpers.

The port's copy of `pcdet_tpu.datasets.kitti.kitti_eval.kitti_common` (the
reference's kitti_object_eval_python/kitti_common.py: get_label_anno,
add_difficulty_to_annos, kitti_result_line).
"""
import pathlib
import re

import numpy as np


def get_image_index_str(img_idx):
    return '{:06d}'.format(img_idx)


def get_label_anno(label_path):
    annotations = {k: [] for k in
                   ['name', 'truncated', 'occluded', 'alpha', 'bbox',
                    'dimensions', 'location', 'rotation_y']}
    with open(label_path, 'r') as f:
        lines = f.readlines()
    content = [line.strip().split(' ') for line in lines if line.strip()]
    annotations['name'] = np.array([x[0] for x in content])
    annotations['truncated'] = np.array([float(x[1]) for x in content])
    annotations['occluded'] = np.array([int(float(x[2])) for x in content])
    annotations['alpha'] = np.array([float(x[3]) for x in content])
    annotations['bbox'] = np.array(
        [[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4)
    # KITTI labels store h, w, l -> annos use l, h, w (camera)
    annotations['dimensions'] = np.array(
        [[float(v) for v in x[8:11]] for x in content]
    ).reshape(-1, 3)[:, [2, 0, 1]]
    annotations['location'] = np.array(
        [[float(v) for v in x[11:14]] for x in content]).reshape(-1, 3)
    annotations['rotation_y'] = np.array(
        [float(x[14]) for x in content]).reshape(-1)
    if content and len(content[0]) == 16:
        annotations['score'] = np.array([float(x[15]) for x in content])
    else:
        annotations['score'] = np.zeros([len(annotations['bbox'])])
    return annotations


def get_label_annos(label_folder, image_ids=None):
    if image_ids is None:
        filepaths = pathlib.Path(label_folder).glob('*.txt')
        prog = re.compile(r'^\d{6}.txt$')
        image_ids = sorted(int(p.name[:6]) for p in filepaths
                           if prog.match(p.name))
    annos = []
    label_folder = pathlib.Path(label_folder)
    for idx in image_ids:
        name = ('%06d.txt' % idx) if isinstance(idx, int) else ('%s.txt' % idx)
        annos.append(get_label_anno(label_folder / name))
    return annos


def add_difficulty_to_annos(annos):
    """0 easy / 1 moderate / 2 hard / -1 unknown per KITTI rules."""
    min_height = [40, 25, 25]
    max_occlusion = [0, 1, 2]
    max_trunc = [0.15, 0.3, 0.5]
    dims = annos['dimensions']
    bbox = annos['bbox']
    height = bbox[:, 3] - bbox[:, 1]
    occlusion = annos['occluded']
    truncation = annos['truncated']
    diff = []
    easy_mask = np.ones((len(dims),), dtype=bool)
    moderate_mask = np.ones((len(dims),), dtype=bool)
    hard_mask = np.ones((len(dims),), dtype=bool)
    for i, (h, o, t) in enumerate(zip(height, occlusion, truncation)):
        if o > max_occlusion[0] or h <= min_height[0] or t > max_trunc[0]:
            easy_mask[i] = False
        if o > max_occlusion[1] or h <= min_height[1] or t > max_trunc[1]:
            moderate_mask[i] = False
        if o > max_occlusion[2] or h <= min_height[2] or t > max_trunc[2]:
            hard_mask[i] = False
    is_easy = easy_mask
    is_moderate = np.logical_xor(easy_mask, moderate_mask)
    is_hard = np.logical_xor(hard_mask, moderate_mask)
    for i in range(len(dims)):
        if is_easy[i]:
            diff.append(0)
        elif is_moderate[i]:
            diff.append(1)
        elif is_hard[i]:
            diff.append(2)
        else:
            diff.append(-1)
    annos['difficulty'] = np.array(diff, np.int32)
    return diff


def kitti_result_line(result_dict, precision=4):
    prec_float = '{:.%df}' % precision
    res_line = []
    all_field_default = {
        'name': None, 'truncated': -1, 'occluded': -1, 'alpha': -10,
        'bbox': None, 'dimensions': [-1, -1, -1], 'location': [-1000] * 3,
        'rotation_y': -10, 'score': 0.0,
    }
    res_dict = [(key, None) for key in all_field_default]
    res_dict = dict(res_dict)
    for key, val in result_dict.items():
        if all_field_default[key] is None and val is None:
            raise ValueError('you must specify a value for {}'.format(key))
        res_dict[key] = val
    for key, val in res_dict.items():
        if val is None:
            val = all_field_default[key]
        if key in ['truncated', 'occluded', 'alpha', 'rotation_y', 'score']:
            res_line.append(prec_float.format(val))
        elif key == 'name':
            res_line.append(val)
        elif key in ['bbox', 'dimensions', 'location']:
            if key == 'dimensions':
                val = [val[1], val[2], val[0]]  # lhw -> hwl (label file order)
            res_line += [prec_float.format(v) for v in val]
        else:
            raise ValueError('unknown key. supported key:{}'.format(
                res_dict.keys()))
    return ' '.join(res_line)
