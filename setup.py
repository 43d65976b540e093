"""Packaging for pcdet_tpu and its PyTorch/CUDA port, pcdet_tpu_torch.

Mirrors the reference's setup.py role (version = 0.1.0+<git sha>).  No
extension is compiled at install time: pcdet_tpu's device path is
JAX/XLA/Pallas and its native host component (pcdet_tpu/native) is built by
g++ at first use; pcdet_tpu_torch's CUDA kernels (pcdet_tpu_torch/csrc/*.cu)
are built by nvcc, and its host rulebook builder and KITTI evaluator
(csrc/*.cpp) by g++, at first use.
"""
import subprocess

from setuptools import find_packages, setup


def get_git_commit_number():
    try:
        cmd_out = subprocess.run(['git', 'rev-parse', 'HEAD'],
                                 stdout=subprocess.PIPE, check=True)
        return cmd_out.stdout.decode('utf-8')[:7]
    except Exception:
        return '0000000'


version = '0.1.0+%s' % get_git_commit_number()

if __name__ == '__main__':
    setup(
        name='pcdet_tpu',
        version=version,
        description='TPU-native LiDAR 3D object detection (PCDet capabilities on JAX/XLA)',
        install_requires=['numpy', 'pyyaml', 'jax', 'flax', 'optax', 'orbax-checkpoint'],
        extras_require={'torch': ['torch']},
        license='Apache License 2.0',
        packages=find_packages(exclude=['tools', 'tests', 'output']),
        package_data={'pcdet_tpu.native': ['*.cpp'],
                      'pcdet_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh', 'csrc/*.cpp',
                                          'datasets/converters/splits/*.txt']},
    )
