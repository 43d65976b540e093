"""Config loading: the yaml configs under `tools/cfgs/` as attribute dicts.

The port's copy of `pcdet_tpu.config.cfg_from_yaml_file` and the `EDict`
it builds (`pcdet_tpu/utils/edict.py`): the same defaults, the same derived
flags, so a config loads to the same dict in both packages.
"""
from pathlib import Path

import yaml


class EDict(dict):
    """dict with recursive attribute access: d.a.b == d['a']['b']."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, EDict):
            return EDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError:
            raise AttributeError(k)

    def copy(self):
        return EDict(self)

    def __deepcopy__(self, memo):
        import copy
        return EDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def get_default_cfg():
    cfg = EDict()
    cfg.ROOT_DIR = str((Path(__file__).resolve().parent / '..').resolve())
    cfg.LOCAL_RANK = 0
    cfg.TAG = 'default'
    # the reference fork's capability flags, at their defaults
    cfg.TAG_PTS_WITH_RGB = False
    cfg.MODE = '3dobjdet'
    cfg.ALTERNATE_PT_CLOUD_ABS_DIR = ''
    cfg.PERCENT_OF_PTS = 100
    cfg.TAG_PTS_IF_IN_GT_BBOXES = False
    cfg.INJECT_SEMANTICS = False
    cfg.INJECT_SEMANTICS_HEIGHT = 0
    cfg.INJECT_SEMANTICS_WIDTH = 0
    cfg.INJECT_SEMANTICS_MODE = 'binary_car_mask'
    cfg.TRAIN_SEMANTIC_NETWORK = False
    cfg.SEMANTICS_ZERO_OUT = False
    cfg.USE_PSEUDOLIDAR = False
    cfg.DEPTH_MAP_TOP_MARGIN_PCT = 0.35
    cfg.SPARSIFY_PL_PTS = True
    return cfg


def cfg_preprocess(cfg):
    """Derived flags and the fixed-shape defaults MAX_GT_BOXES (128) and
    MAX_POINTS (65536)."""
    cfg.TORCH_VOXEL_GENERATOR = bool(cfg.get('USE_PSEUDOLIDAR', False)
                                     or cfg.get('INJECT_SEMANTICS', False))
    data_cfg = cfg.get('DATA_CONFIG', None)
    if data_cfg is not None:
        data_cfg.setdefault('MAX_GT_BOXES', 128)
        data_cfg.setdefault('MAX_POINTS', 65536)
    return cfg


def cfg_from_yaml_file(cfg_file, config=None):
    """The yaml file over the defaults; TAG is the file's stem."""
    if config is None:
        config = get_default_cfg()
    with open(cfg_file, 'r') as f:
        new_config = yaml.load(f, Loader=yaml.FullLoader)
    config.update(EDict(new_config))
    config.TAG = Path(cfg_file).stem
    cfg_preprocess(config)
    return config
