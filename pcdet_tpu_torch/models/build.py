"""Model factory keyed by `cfg.MODEL.NAME`.

Twin of `pcdet_tpu.models.build.build_network` (the reference's
`pcdet/models/__init__.py` registry).  `detect.build_detector` and
`train.trainer.build_trainer` both build their model here.
"""


def build_network(cfg, grid_size, device='cuda', generator=None, loads=None):
    """PointPillar or SECOND by `cfg.MODEL.NAME`.

    :param grid_size: the voxel grid (nx, ny, nz)
    :param generator: a CPU torch.Generator for random weights (None: the
        modules' own init, to be overwritten by a state_dict)
    :param loads: SECOND's `ops.sparse.Loads` (None: the backbone's
        default); PointPillar has no sparse convs and takes none
    """
    name = cfg.MODEL.NAME
    if name in ('SECOND', 'second_net'):
        from .second import SECONDNet
        return SECONDNet(cfg, grid_size, device=device, generator=generator,
                         loads=loads)
    if loads is not None:
        raise ValueError('loads apply to SECOND\'s sparse convs, not %r'
                         % name)
    if name == 'PointPillar':
        from .pointpillar import PointPillar
        return PointPillar(cfg, grid_size, device=device, generator=generator)
    if name in ('PartA2', 'PartA2_net'):
        raise NotImplementedError(
            'Part-A2 is not ported yet (ROADMAP.md queue 1 item 5)')
    raise NotImplementedError('no port of model %r' % name)
