// Weight gradient of the kw=3 sparse convolutions by x-window and segment
// loads (kernels D'' and D'), for sm_90a.
//
// Replaces two TPU kernels of pcdet_tpu/ops/pallas/gather_gemm.py:
//   D'' gather_dw_xwin (body _dw_kernel_xwin): one (3, Cin) window load per
//       (output row, tap group);
//   D'  gather_dw_seg (body _dw_kernel_seg): one (S, Cin) segment load per
//       (64-row tile, tap group), E's windows where the span exceeds S.
// Both compute kernel D's function (csrc/gather_dw.cu) over a kw=3 book
// given as selectors (base, sel; see csrc/gather_gemm_xwin.cu).
//
// Contract, summed over the batch of B samples:
//   dW[3g + dx, i, o] = sum_b sum_{v < n_live[b]} feats[b, base + off_dx, i] * g[b, v, o]
// (misses contribute nothing); feats (B, V_in + 1, Cin) f32, row V_in all
// zeros; base, sel (B, V_out, G) int32; g (B, V_out, Cout) f32; n_live (B,)
// int32 on the device; dW (3G, Cin, Cout) f32.
//
// Layout: gather_dw_common.cuh's core, one block per (row chunk, tap group,
// sample), grid (n_chunks, G, B).  Per 64-row sub-tile the block copies the
// selectors, the g rows once for the group's three x-taps and the table
// rows the group reads: each row's selected window rows (D''), or the
// tile's span of window starts, each row once, where it is at most S rows
// (D', counted per (tile, group) in tally[0], the window branch in
// tally[1]); the descriptors are computed over every row of the tile below
// V_out, as pcdet_tpu's segment_desc does.  It lists per x-tap the live
// rows that find it and multiplies those only.  The partials have kernel
// D's layout (B, n_chunks, 3G, Cin, Cout) and its fixed-order second pass;
// no atomics in the sums: two launches on the same inputs give the same
// bits.
//
// What bounds it: 2 Cin Cout operations per found tap of a live row (f32,
// outside the tensor cores) against the copies of the span or the windows
// and of g, once per tap group.  D' is the default dW of the 11 kw=3 convs
// of SECOND's training; measured: PERF.md section 6.
#include "gather_dw_common.cuh"

namespace {

using dw_common::kSegment;
using dw_common::kWindow;

template <int CIN, int COUT, bool SEG>
__global__ void __launch_bounds__(
    dw_common::Cfg<CIN, COUT, SEG ? kSegment : kWindow>::kThreads, 1)
gather_dw_xwin_partial(const float* __restrict__ feats, const int* __restrict__ base,
                       const int* __restrict__ sel, const float* __restrict__ g,
                       const int* __restrict__ n_live, float* __restrict__ partial,
                       unsigned long long* __restrict__ tally, int v_in1,
                       int v_out, int groups, int chunk_rows, int seg_rows) {
  dw_common::partial_body<CIN, COUT, SEG ? kSegment : kWindow>(
      feats, base, sel, g, n_live, partial, tally, v_in1, v_out, groups, chunk_rows, seg_rows);
}

// Calls f(integral_constant<Cin>, integral_constant<Cout>, integral_constant
// <SEG>) for an instance; `otherwise` for any other pair.
template <typename F>
int with_instance(int seg, int cin, int cout, int otherwise, F&& f) {
#define PCDET_DWX_CASE(CI, CO)                                                     \
  if (cin == CI && cout == CO)                                                     \
    return seg ? f(std::integral_constant<int, CI>{}, std::integral_constant<int, CO>{}, \
                   std::true_type{})                                               \
               : f(std::integral_constant<int, CI>{}, std::integral_constant<int, CO>{}, \
                   std::false_type{});
  PCDET_DWX_CASE(4, 16)
  PCDET_DWX_CASE(16, 16)
  PCDET_DWX_CASE(16, 32)
  PCDET_DWX_CASE(32, 32)
  PCDET_DWX_CASE(32, 64)
  PCDET_DWX_CASE(64, 64)
  PCDET_DWX_CASE(128, 64)
  PCDET_DWX_CASE(64, 32)
  PCDET_DWX_CASE(32, 16)
#undef PCDET_DWX_CASE
  return otherwise;
}

}  // namespace

// Launches both passes on `stream`, does not synchronise, allocates
// nothing: `partial` holds B * ceil(V_out / chunk_rows) * 3G * Cin * Cout
// floats.  `seg` selects D' (segment rows `seg_rows`, 1..1022, and the two
// `tally` counters) over D''.  Returns the cudaError_t of the launches (0 on
// success); a (Cin, Cout) pair without an instance, groups outside 1..21,
// seg_rows outside 1..1022 or chunk_rows not a positive multiple of 64
// returns cudaErrorInvalidValue, and a seg_rows whose staging does not fit
// in shared memory the error of setting it.  The caller checks shapes,
// dtypes, contiguity and 16-byte alignment; B, G <= 65535; V_out >= 1.
extern "C" int pcdet_gather_dw_xwin(int seg, const float* feats, const int* base,
                                    const int* sel, const float* g,
                                    const int* n_live, float* partial,
                                    float* out, unsigned long long* tally,
                                    int b, int v_in1, int v_out, int groups,
                                    int cin, int cout, int chunk_rows,
                                    int seg_rows, void* stream) {
  if (groups < 1 || groups > 21 || v_in1 < 1 || b < 1 || v_out < 1 ||
      chunk_rows < dw_common::kRows || chunk_rows % dw_common::kRows != 0 ||
      (seg && (seg_rows < 1 || seg_rows > 1022))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!seg) seg_rows = 0;
  const int n_chunks = (v_out + chunk_rows - 1) / chunk_rows;
  return with_instance(seg, cin, cout, static_cast<int>(cudaErrorInvalidValue),
                       [&](auto ci, auto co, auto sg) {
                         constexpr int CI = decltype(ci)::value;
                         constexpr int CO = decltype(co)::value;
                         constexpr bool SG = decltype(sg)::value;
                         return dw_common::launch_two_pass<CI, CO, SG ? kSegment : kWindow>(
                             gather_dw_xwin_partial<CI, CO, SG>, seg_rows, n_chunks, groups,
                             b, 3 * groups, partial, out, static_cast<cudaStream_t>(stream),
                             feats, base, sel, g, n_live, partial, tally, v_in1, v_out,
                             groups, chunk_rows, seg_rows);
                       });
}

// Pass-1 blocks of the instance resident on the current device at once
// (seg_rows for D'; ignored for D''); minus a cudaError_t on failure.
extern "C" int pcdet_gather_dw_xwin_resident(int seg, int cin, int cout, int seg_rows) {
  if (seg && (seg_rows < 1 || seg_rows > 1022)) return -static_cast<int>(cudaErrorInvalidValue);
  return with_instance(seg, cin, cout, -static_cast<int>(cudaErrorInvalidValue),
                       [&](auto ci, auto co, auto sg) {
                         constexpr int CI = decltype(ci)::value;
                         constexpr int CO = decltype(co)::value;
                         constexpr bool SG = decltype(sg)::value;
                         return dw_common::resident_blocks<CI, CO, SG ? kSegment : kWindow>(
                             gather_dw_xwin_partial<CI, CO, SG>, SG ? seg_rows : 0);
                       });
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
