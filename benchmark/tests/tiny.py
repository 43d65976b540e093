"""Tiny copies of the benchmark's cells for the CPU tests: the same files
at a 32 x 32 m grid and narrow RPNs, in a copy of the benchmark folder."""
import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_SCENE = {'num_objects': 4, 'pts_per_obj': 200, 'x_range': [3, 28],
              'y_range': [-14, 14], 'ring_keep': 0.35}
RANGE = [0, -16.0, -3, 32.0, 16.0, 1]


def tiny_model(model):
    m = copy.deepcopy(model)
    d = m['DATA_CONFIG']
    d['POINT_CLOUD_RANGE'] = list(RANGE)
    d['MAX_POINTS'] = 8192
    d['MAX_GT_BOXES'] = 16
    second = m['MODEL']['NAME'] != 'PointPillar'
    if second:
        d['VOXEL_GENERATOR']['VOXEL_SIZE'] = [0.25, 0.25, 0.25]
        d['TRAIN']['MAX_NUMBER_OF_VOXELS'] = 3000
        d['TEST']['MAX_NUMBER_OF_VOXELS'] = 3000
        m['MODEL']['RPN']['BACKBONE']['ARGS']['level_caps_test'] = [
            4096, 3072, 2048, 1024]
    else:
        d['VOXEL_GENERATOR']['VOXEL_SIZE'] = [0.5, 0.5, 4]
        d['VOXEL_GENERATOR']['MAX_POINTS_PER_VOXEL'] = 16
        d['TEST']['MAX_NUMBER_OF_VOXELS'] = 2000
        m['MODEL']['VFE']['ARGS']['num_filters'] = [32]
    a = m['MODEL']['RPN']['RPN_HEAD']['ARGS']
    a['num_input_features'] = 128 if second else 32
    a['layer_nums'] = [1, 1]
    a['layer_strides'] = [1, 2] if second else [2, 2]
    a['num_filters'] = [32, 64]
    a['upsample_strides'] = [1, 2]
    a['num_upsample_filters'] = [32, 32]
    for g in m['MODEL']['RPN']['RPN_HEAD']['TARGET_CONFIG'][
            'ANCHOR_GENERATOR']:
        r = g['anchor_range']
        g['anchor_range'] = [0, -16.0, r[2], 32.0, 16.0, r[5]]
    t = m['MODEL']['TEST']
    t['NMS_PRE_MAXSIZE_LAST'] = 512
    t['NMS_POST_MAXSIZE_LAST'] = 64
    return m


def tiny_bench(tmp):
    """A copy of the benchmark folder under `tmp` whose cells are tiny;
    returns its root."""
    root = Path(tmp) / 'benchmark'
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        '__pycache__', 'tests'))
    shutil.copy(BENCH.parent / 'BENCHMARK.json', Path(tmp) / 'BENCHMARK.json')
    for f in (root / 'configs').glob('*.json'):
        c = json.loads(f.read_text())
        c['model'] = tiny_model(c['model'])
        f.write_text(json.dumps(c))
    for f in (root / 'workloads').glob('*.json'):
        w = json.loads(f.read_text())
        w.update(scene=TINY_SCENE, batch=2, pool=6, traced_batches=1,
                 checked_batches=1)
        f.write_text(json.dumps(w))
    return root
