"""Build a CUDA source of `csrc/` with nvcc at first use and load it via ctypes.

Each library has a plain C interface (no PyTorch headers), so nvcc takes
seconds.  Libraries go to `build/pcdet_tpu_torch/` at the repository root,
named by a hash of their sources, the shared headers (`csrc/*.cuh`) and
the flags, so an edited source rebuilds and an unchanged one is reused.
The host libraries (`csrc/*.cpp`) build the same way with g++
(`build_host_library`).  `check_operands` holds the operand contract the C
entries share.  Nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'pcdet_tpu_torch'

# IEEE rounding per operation (no contraction to FMA, no fast math), so each
# kernel rounds as its plain PyTorch version's separate ops do.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC')

BUILD_LOG = {}     # name -> {'seconds': float, 'cached': bool, 'ptxas': str}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cand = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found (PATH or CUDA_HOME/bin): the CUDA '
                       'kernels of pcdet_tpu_torch are built at first use')


def load_library(name, sources):
    """Build (once per source hash) and load `lib<name>.so` from `sources`
    (file names under csrc/).  Raises on any build or load failure.  Callers
    cache the loaded library."""
    paths = [CSRC_DIR / s for s in sources]
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in paths + sorted(CSRC_DIR.glob('*.cuh')):
        h.update(p.read_bytes())
    lib_path = BUILD_DIR / ('lib%s-%s.so' % (name, h.hexdigest()[:16]))
    t0 = time.perf_counter()
    ptxas = ''
    cached = lib_path.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name('%s.tmp%d' % (lib_path.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-o', str(tmp),
               *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed (%d) for %s:\n%s\n%s' % (
                proc.returncode, name, ' '.join(cmd), proc.stderr))
        ptxas = proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    BUILD_LOG[name] = {'seconds': time.perf_counter() - t0, 'cached': cached,
                       'ptxas': ptxas}
    return lib


GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')


def host_library_path(name, source):
    """Where `build_host_library` puts lib<name> built from csrc/`source`:
    named by a hash of the source and the flags."""
    h = hashlib.sha256(' '.join(GXX_FLAGS).encode()
                       + (CSRC_DIR / source).read_bytes())
    return BUILD_DIR / ('lib%s-%s.so' % (name, h.hexdigest()[:16]))


def build_host_library(path, source):
    """Build `path` (from `host_library_path`) from csrc/`source` with g++,
    with OpenMP where it builds, unless it exists.  Raises RuntimeError
    when g++ fails."""
    if path.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name('%s.tmp%d-%d' % (path.name, os.getpid(),
                                           threading.get_ident()))
    cmd = ['g++', *GXX_FLAGS, '-fopenmp', '-o', str(tmp),
           str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:                       # again without OpenMP
        cmd.remove('-fopenmp')
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('g++ failed (%d): %s' % (proc.returncode,
                                                    proc.stderr))
    os.replace(tmp, path)


def check(lib, rc):
    """Raise if a C entry returned a nonzero cudaError_t."""
    if rc != 0:
        msg = lib.pcdet_cuda_error_string(rc)
        raise RuntimeError('CUDA launch failed: %d %s' % (
            rc, msg.decode() if msg else '?'))


def check_operands(int32, others):
    """The operand contract of every C entry: the (name, tensor) pairs of
    `int32` are int32 (else TypeError); those and the pairs of `others`
    lie on one device and are contiguous (else ValueError)."""
    for name, t in int32:
        if t.dtype != torch.int32:
            raise TypeError('%s must be int32, got %s' % (name, t.dtype))
    named = list(others) + list(int32)
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError('tensors on different devices: %s' % sorted(
            str(d) for d in devices))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
