"""Config loading: the yaml configs under `tools/cfgs/` as attribute dicts.

The port's copy of `pcdet_tpu.config`'s `cfg_from_yaml_file` and the `EDict`
it builds (`pcdet_tpu/utils/edict.py`): the same defaults, the same derived
flags, so a config loads to the same dict in both packages; and of the
CLIs' `cfg_from_list` (`--set` overrides) and `log_config_to_file`.
"""
from ast import literal_eval
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


def cfg_from_list(cfg_list, config):
    """Apply dotted-path CLI overrides ['K.E.Y', 'value', ...].

    Semantics mirror the reference cfg_from_list (type coercion via
    literal_eval, 'k:v,...' grammar for dict leaves, 'a,b,c' for list leaves).
    """
    assert len(cfg_list) % 2 == 0, cfg_list
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split('.')
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, 'NotFoundKey: %s' % subkey
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, 'NotFoundKey: %s' % subkey
        try:
            value = literal_eval(v)
        except Exception:
            value = v

        if type(value) != type(d[subkey]) and isinstance(d[subkey], dict):
            for src in value.split(','):
                cur_key, cur_val = src.split(':')
                val_type = type(d[subkey][cur_key])
                d[subkey][cur_key] = val_type(cur_val)
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], list):
            val_list = value.split(',')
            d[subkey] = [type(d[subkey][0])(x) for x in val_list]
        else:
            assert type(value) == type(d[subkey]), \
                'type {} does not match original type {}'.format(
                    type(value), type(d[subkey]))
            d[subkey] = value
    return config


def log_config_to_file(cfg, pre='cfg', logger=None):
    for key, val in cfg.items():
        if isinstance(val, dict):
            logger.info('\n%s.%s = edict()' % (pre, key))
            log_config_to_file(val, pre=pre + '.' + key, logger=logger)
            continue
        logger.info('%s.%s: %s' % (pre, key, val))
