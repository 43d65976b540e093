"""Rulebook gather-GEMM of the sparse convolutions (kernels B and C).

    out[b, v] = sum_k feats[b, rules[b, v, k]] @ W[k]

`gather_gemm` replaces two TPU kernels of
`pcdet_tpu.ops.pallas.gather_gemm`: `_gather_matmul_fwd_only` (B, f32
features and weights) and `_gather_matmul_packed_call` (C, bf16-rounded
features and weights, there packed in pairs into int32 words).  Both
accumulate in f32 and return f32.  On a CUDA tensor it launches the
hand-written kernel `csrc/gather_gemm.cu` (built with nvcc at first use) by
the dtype of `feats`: B (f32, FFMA, tap-major and channel-inner `fmaf`, the
order of the plain version's per-element sum) or C (bf16 on the tensor
cores, f32 sums in their order, bitwise repeatable), or raises; on a CPU
tensor it computes the plain version, `gather_gemm_plain`.  There is no
fallback from the one to the other.

`LAUNCHES` counts kernel launches per variant, so a run can show that its
path went through the kernels; a call with `dgrad=True` (a feature
gradient, `ops/sparse.py:RulebookConv`) counts under the `_dgrad` key.
"""
import ctypes
import functools

import torch

from . import cuda_build

LAUNCHES = {'gather_gemm_f32': 0, 'gather_gemm_bf16': 0,
            'gather_gemm_f32_dgrad': 0, 'gather_gemm_bf16_dgrad': 0}
CIN = (4, 16, 32, 64, 128)     # the kernel's instances (csrc/gather_gemm.cu)
COUT = (16, 32, 64, 128)
MAX_TAPS = 64
_MAX_GRID_Y = 65535
_SOURCES = ('gather_gemm.cu',)


@functools.cache
def build():
    """Build (or reuse) and load the kernel library; returns it."""
    lib = cuda_build.load_library('gather_gemm', _SOURCES)
    fn = lib.pcdet_gather_gemm
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pcdet_gather_gemm_tile_rows.argtypes = [ctypes.c_int] * 3
    lib.pcdet_gather_gemm_tile_rows.restype = ctypes.c_int
    lib.pcdet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcdet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tile_rows(dtype, cin, cout):
    """Output rows per block of the (dtype, Cin, Cout) instance (builds the
    library)."""
    return build().pcdet_gather_gemm_tile_rows(int(dtype == torch.bfloat16),
                                               cin, cout)


def gather_gemm_plain(feats, rules, weights, n_live):
    """The plain PyTorch version: gather, then one (V, K*Cin) @ (K*Cin, Cout)
    product per sample, in f32 (bf16 inputs are widened exactly first, so
    the products are those of the bf16 values and the sums are f32; f64
    inputs, a CPU reference, stay f64).  Rows at or past n_live[b] are
    zero."""
    b, v, k = rules.shape
    cin, cout = feats.shape[-1], weights.shape[-1]
    dt = torch.float64 if feats.dtype == torch.float64 else torch.float32
    f = feats.to(dt)
    batch = torch.arange(b, device=feats.device)[:, None, None]
    gathered = f[batch, rules.long()].reshape(b, v, k * cin)
    out = torch.matmul(gathered, weights.to(dt).reshape(k * cin, cout))
    live = torch.arange(v, device=feats.device)[None] < n_live[:, None]
    return out * live[..., None].to(out.dtype)


def _check(feats, rules, weights, n_live):
    if feats.dim() != 3 or rules.dim() != 3 or weights.dim() != 3:
        raise ValueError('want feats (B, V_in+1, Cin), rules (B, V_out, K), '
                         'weights (K, Cin, Cout); got %s, %s, %s' % (
                             tuple(feats.shape), tuple(rules.shape),
                             tuple(weights.shape)))
    b, _, k = rules.shape
    if (feats.shape[0] != b or weights.shape[0] != k
            or weights.shape[1] != feats.shape[2]
            or tuple(n_live.shape) != (b,)):
        raise ValueError('shapes disagree: feats %s, rules %s, weights %s, '
                         'n_live %s' % (tuple(feats.shape), tuple(rules.shape),
                                        tuple(weights.shape),
                                        tuple(n_live.shape)))
    if feats.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError('feats must be float32 or bfloat16, got %s'
                        % feats.dtype)
    if weights.dtype != feats.dtype:
        raise TypeError('weights (%s) must have the dtype of feats (%s)'
                        % (weights.dtype, feats.dtype))
    cuda_build.check_operands((('rules', rules), ('n_live', n_live)),
                              (('feats', feats), ('weights', weights)))


def gather_gemm(feats, rules, weights, n_live, dgrad=False):
    """:param feats: (B, V_in + 1, Cin) f32 (kernel B) or bf16 (kernel C);
        row V_in of every sample is zeros
    :param rules: (B, V_out, K) int32 rows of feats, misses at V_in
    :param weights: (K, Cin, Cout), the dtype of feats
    :param n_live: (B,) int32 live output rows (a prefix); rows past it are
        zero
    :param dgrad: count the launch as a feature gradient's
    :return: (B, V_out, Cout) f32
    """
    _check(feats, rules, weights, n_live)
    if feats.device.type == 'cpu':
        return gather_gemm_plain(feats, rules, weights, n_live)
    if feats.device.type != 'cuda':
        raise ValueError('unsupported device %s' % feats.device)
    if feats.dtype == torch.float64:
        raise TypeError('no float64 kernel: float64 runs on the CPU only')
    b, v_out, k = rules.shape
    v_in1, cin = feats.shape[1], feats.shape[2]
    cout = weights.shape[2]
    if cin not in CIN or cout not in COUT or not 1 <= k <= MAX_TAPS:
        raise ValueError('no kernel instance for Cin=%d, Cout=%d, K=%d '
                         '(Cin in %s, Cout in %s, K <= %d)' % (
                             cin, cout, k, CIN, COUT, MAX_TAPS))
    if b > _MAX_GRID_Y or max(v_in1 * cin, v_out * max(k, cout)) >= 2 ** 31:
        raise ValueError('batch or table too large: B=%d V_in+1=%d V_out=%d'
                         % (b, v_in1, v_out))
    bf16 = feats.dtype == torch.bfloat16
    # the kernels copy rows and W[k] in 16-byte pieces (8 for bf16 Cin 4)
    if feats.data_ptr() % min(16, cin * feats.element_size()) \
            or weights.data_ptr() % 16:
        raise ValueError('feats and weights must start on a 16-byte '
                         'boundary (8 for bf16 Cin=4)')
    lib = build()
    out = torch.empty((b, v_out, cout), dtype=torch.float32,
                      device=feats.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcdet_gather_gemm(
            int(bf16), feats.data_ptr(), rules.data_ptr(), weights.data_ptr(),
            n_live.data_ptr(), out.data_ptr(), b, v_in1, v_out, k, cin, cout,
            stream)
    cuda_build.check(lib, rc)
    LAUNCHES['gather_gemm_%s%s' % ('bf16' if bf16 else 'f32',
                                   '_dgrad' if dgrad else '')] += 1
    return out
