"""pcdet_tpu_torch — PyTorch and CUDA port of pcdet_tpu for NVIDIA Hopper.

The package mirrors `pcdet_tpu`'s layout (`ops/`, `models/`, `utils/`) and is
held to it module by module.  Plain tensor work is PyTorch; every Pallas
kernel of `pcdet_tpu` becomes a kernel written by hand for `sm_90a`, with
its CUDA sources under `csrc/`.  Framework-free helpers (config loading,
anchors, the numpy voxel generator, synthetic scenes) are imported from
`pcdet_tpu` as they are; nothing here imports jax or flax.

The first slice is PointPillar detection, raw scan to boxes:
`detect.build_detector(cfg, device).detect(points, point_mask)`.
"""

__version__ = "0.1.0"
