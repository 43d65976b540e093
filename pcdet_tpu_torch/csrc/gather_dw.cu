// Weight gradient of a rulebook sparse convolution (kernel D), for sm_90a.
//
// Replaces three TPU kernels of pcdet_tpu/ops/pallas/gather_gemm.py that
// compute one function through different load strategies:
//   D   gather_dw (pallas_call body _dw_kernel): per-row table loads;
//   D'  gather_dw_seg (_dw_kernel_seg): one (S, Cin) segment load per
//       (tile, tap group), rows routed by one-hot matmuls;
//   D'' gather_dw_xwin (_dw_kernel_xwin): one (3, Cin) x-window load per
//       (row, tap group).
// The segment and window loads answered Mosaic's cost of one scalar-indexed
// row load; a Hopper block loads its own gathered rows, so one kernel covers
// all three (gather_dw_xwin.cu keeps D'' and D' for kw=3 books given as
// selectors).
//
// Contract, summed over the batch of B samples:
//   dW[k, i, o] = sum_b sum_{v < n_live[b]} feats[b, rules[b, v, k], i] * g[b, v, o]
// feats (B, V_in + 1, Cin) f32 with row V_in all zeros; rules (B, V_out, K)
// int32 in [0, V_in] (misses routed to V_in; a rule outside [0, V_in) reads
// nothing); g (B, V_out, Cout) f32; n_live (B,) int32 on the device: rows at
// or past it contribute nothing, whatever g holds there.  dW (K, Cin, Cout)
// f32.
//
// Layout: gather_dw_common.cuh's core, one block per (row chunk, block of
// three taps, sample), grid (n_chunks, ceil(K / 3), B).  Per 64-row
// sub-tile the block copies the rules of its three taps, each found
// (row, tap)'s table row and the g rows once for the three taps, lists per
// tap the rows that find it, and multiplies those only.  The partials (B,
// n_chunks, K, Cin, Cout) are summed per element in a fixed order by a
// second launch; no atomics: two launches on the same inputs give the same
// bits.
//
// What bounds it: on SECOND's books 2 Cin Cout operations per found tap of
// a live row (f32, outside the tensor cores) against the copies of the
// found rows and of g; under the default loads it runs once per train step,
// at conv_out (K = 3, 64 -> 128).  Measured: PERF.md section 6.
#include "gather_dw_common.cuh"

namespace {

using dw_common::kRules;

template <int CIN, int COUT>
__global__ void __launch_bounds__(dw_common::Cfg<CIN, COUT, kRules>::kThreads, 1)
gather_dw_partial(const float* __restrict__ feats, const int* __restrict__ rules,
                  const float* __restrict__ g, const int* __restrict__ n_live,
                  float* __restrict__ partial, int v_in1, int v_out, int k_taps,
                  int chunk_rows) {
  dw_common::partial_body<CIN, COUT, kRules>(feats, rules, nullptr, g, n_live, partial,
                                             nullptr, v_in1, v_out, k_taps, chunk_rows, 0);
}

// Calls f(integral_constant<Cin>, integral_constant<Cout>) for an instance;
// `otherwise` for any other pair.
template <typename F>
int with_instance(int cin, int cout, int otherwise, F&& f) {
#define PCDET_DW_CASE(CI, CO)                                                      \
  if (cin == CI && cout == CO)                                                     \
    return f(std::integral_constant<int, CI>{}, std::integral_constant<int, CO>{});
  PCDET_DW_CASE(4, 16)
  PCDET_DW_CASE(16, 16)
  PCDET_DW_CASE(16, 32)
  PCDET_DW_CASE(32, 32)
  PCDET_DW_CASE(32, 64)
  PCDET_DW_CASE(64, 64)
  PCDET_DW_CASE(64, 128)
  PCDET_DW_CASE(128, 64)
  PCDET_DW_CASE(64, 32)
  PCDET_DW_CASE(32, 16)
#undef PCDET_DW_CASE
  return otherwise;
}

}  // namespace

// Launches both passes on `stream`, does not synchronise, allocates
// nothing: `partial` holds B * ceil(V_out / chunk_rows) * K * Cin * Cout
// floats.  Returns the cudaError_t of the launches (0 on success); a
// (Cin, Cout) pair without an instance, K outside 1..64, or chunk_rows not
// a positive multiple of 64 returns cudaErrorInvalidValue.  The caller
// checks shapes, dtypes, contiguity and 16-byte alignment; B <= 65535;
// V_out >= 1.
extern "C" int pcdet_gather_dw(const float* feats, const int* rules,
                               const float* g, const int* n_live,
                               float* partial, float* out, int b, int v_in1,
                               int v_out, int k_taps, int cin, int cout,
                               int chunk_rows, void* stream) {
  if (k_taps < 1 || k_taps > 64 || v_in1 < 1 || b < 1 || v_out < 1 ||
      chunk_rows < dw_common::kRows || chunk_rows % dw_common::kRows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = (v_out + chunk_rows - 1) / chunk_rows;
  const int blocks = (k_taps + dw_common::kTaps - 1) / dw_common::kTaps;
  return with_instance(cin, cout, static_cast<int>(cudaErrorInvalidValue), [&](auto ci, auto co) {
    constexpr int CI = decltype(ci)::value;
    constexpr int CO = decltype(co)::value;
    return dw_common::launch_two_pass<CI, CO, kRules>(
        gather_dw_partial<CI, CO>, 0, n_chunks, blocks, b, k_taps, partial, out,
        static_cast<cudaStream_t>(stream), feats, rules, g, n_live, partial, v_in1, v_out,
        k_taps, chunk_rows);
  });
}

// Pass-1 blocks of the (Cin, Cout) instance resident on the current device
// at once; minus a cudaError_t on failure (cudaErrorInvalidValue: no
// instance).
extern "C" int pcdet_gather_dw_resident(int cin, int cout) {
  return with_instance(cin, cout, -static_cast<int>(cudaErrorInvalidValue), [&](auto ci, auto co) {
    constexpr int CI = decltype(ci)::value;
    constexpr int CO = decltype(co)::value;
    return dw_common::resident_blocks<CI, CO, kRules>(gather_dw_partial<CI, CO>, 0);
  });
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
