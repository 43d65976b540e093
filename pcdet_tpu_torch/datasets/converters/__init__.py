"""Dataset -> KITTI-format converters (Argoverse, nuScenes): the port's copy
of `pcdet_tpu.datasets.converters`, numpy and the standard library only.

The reference fork trains its argo / nuscenes configs on externally
converted "*-kitti-format" trees and pins the train / val log lists in
code (reference argoverse-splits.py:1-96, nuscenes-splits.py:1-173).  Here
the conversion is part of the package (`python -m pcdet_tpu_torch.tools.
convert_to_kitti`), and the pinned splits ship as data files under
converters/splits/.
"""
from . import argoverse, nuscenes  # noqa: F401
