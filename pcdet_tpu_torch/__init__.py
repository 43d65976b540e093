"""pcdet_tpu_torch — PyTorch and CUDA port of pcdet_tpu for NVIDIA Hopper.

The package mirrors `pcdet_tpu`'s layout (`ops/`, `models/`, `utils/`) and is
held to it module by module.  Plain tensor work is PyTorch; every Pallas
kernel of `pcdet_tpu` becomes a kernel written by hand for `sm_90a`, with
its CUDA sources under `csrc/`.  It imports nothing of `pcdet_tpu` (nor jax
or flax): the framework-free code it needs (config loading, the data
pipeline, anchor targets, the host rulebook builder, the KITTI evaluator)
is its own copy.

Entry points: `detect.build_detector(cfg, device).detect(points,
point_mask)` (PointPillar, SECOND), `train.trainer.build_trainer`
(PointPillar, SECOND), and the command lines `python -m
pcdet_tpu_torch.tools.{create_data,train,test}` over a KITTI-format tree.
"""

__version__ = "0.1.0"
