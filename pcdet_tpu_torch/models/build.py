"""Model factory keyed by `cfg.MODEL.NAME`.

Twin of `pcdet_tpu.models.build.build_network` (the reference's
`pcdet/models/__init__.py` registry).  `detect.build_detector` and
`train.trainer.build_trainer` both build their model here.
"""


SPARSE_MODELS = ('SECOND', 'second_net', 'PartA2', 'PartA2_net')


def build_network(cfg, grid_size, device='cuda', generator=None, loads=None):
    """PointPillar, SECOND or Part-A² (Part-A²-fc by its RCNN head) by
    `cfg.MODEL.NAME`.

    :param grid_size: the voxel grid (nx, ny, nz)
    :param generator: a CPU torch.Generator for random weights (None: the
        modules' own init, to be overwritten by a state_dict)
    :param loads: the sparse convs' `ops.sparse.Loads` (SECOND's and
        Part-A²'s; None: the backbone's default); PointPillar has no sparse
        convs and takes none
    """
    name = cfg.MODEL.NAME
    if name in ('SECOND', 'second_net'):
        from .second import SECONDNet
        return SECONDNet(cfg, grid_size, device=device, generator=generator,
                         loads=loads)
    if name in ('PartA2', 'PartA2_net'):
        from .parta2 import PartA2Net
        return PartA2Net(cfg, grid_size, device=device, generator=generator,
                         loads=loads)
    if loads is not None:
        raise ValueError('loads apply to sparse convs, and %r has none'
                         % name)
    if name == 'PointPillar':
        from .pointpillar import PointPillar
        return PointPillar(cfg, grid_size, device=device, generator=generator)
    raise NotImplementedError('no port of model %r' % name)
