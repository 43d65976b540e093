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
// Layout: pass 1 runs one block per (row chunk, tap group, sample), grid
// (n_chunks, G, B).  A chunk is walked in 64-row sub-tiles aligned to the
// 64-row tiles of the book; for each the block stages the sub-tile's g rows
// once for all three taps of its group (kernel D stages them once per tap)
// and the table rows the group reads: E's per-row windows (D''), or E''s
// segment of the tile's span when it is at most S rows (D', counted per
// (tile, group) in tally[0], the window branch in tally[1]).  Each thread
// accumulates a 3 TI x 4 block of the group's (3 Cin) x Cout slab over the
// rows of its row group, one __fmaf_rn per product; row groups are summed
// through shared memory in a fixed order and the block writes one partial
// slab for its (sample, chunk, group), which is dW[3g .. 3g+2] of that
// partial: the partials have kernel D's layout (B, n_chunks, K, Cin, Cout),
// and pass 2 is D's fixed-order sum.  No atomics in the sums: two launches
// on the same inputs give the same bits.  The staging and pass 2 are
// gather_common.cuh's, shared with E / E' and D.
//
// What bounds it: per row a thread does 3 TI * 4 FMAs for 3 TI + 4 shared
// loads (D: TI * 4 for TI + 4), and g is read once per tap group, a third
// of D's reads; the partials' round trip through memory is D's.
#include "gather_common.cuh"

namespace {

using gather_common::kNoTap;
using gather_common::staged_row;
using gather_common::staged_rows;

constexpr int kRows = gather_common::kTileRows;
constexpr int kThreads = 256;

template <int CIN, int COUT>
struct Cfg {
  static constexpr int TI = CIN < 4 ? CIN : 4;     // Cin per thread and tap
  static constexpr int TO = 4;                     // Cout per thread
  static constexpr int NO = COUT / TO;
  static constexpr int M = (CIN / TI) * NO;        // micro-tiles of the slab
  static constexpr int RG = kThreads / M;          // row groups
  static_assert(CIN % TI == 0 && COUT % TO == 0, "tile");
  static_assert(M <= kThreads && kThreads % M == 0, "threads");
  static constexpr int FS = CIN + 1;               // padded strides
  static constexpr int GS = COUT + 1;
  static size_t stage_bytes(int seg_rows) {
    return sizeof(float) * (staged_rows(seg_rows) * FS + kRows * GS) +
           sizeof(int) * (6 * kRows + 2);
  }
  static constexpr size_t kReduce =
      RG > 1 ? sizeof(float) * RG * 3 * CIN * COUT : 0;
  static size_t smem(int seg_rows) {
    const size_t s = stage_bytes(seg_rows);
    return s > kReduce ? s : kReduce;
  }
};

template <int CIN, int COUT, bool SEG>
__global__ void __launch_bounds__(kThreads)
gather_dw_xwin_partial(const float* __restrict__ feats, const int* __restrict__ base,
                       const int* __restrict__ sel, const float* __restrict__ g,
                       const int* __restrict__ n_live, float* __restrict__ partial,
                       unsigned long long* __restrict__ tally, int v_in1,
                       int v_out, int groups, int chunk_rows, int seg_rows) {
  using C = Cfg<CIN, COUT>;
  constexpr int TI = C::TI;
  const int n_staged = staged_rows(SEG ? seg_rows : 0);
  const int zero = n_staged - 1;
  // the S-sized staged rows last, so every other offset is a constant (with
  // them first, nvcc kept the shared addresses in per-thread registers and
  // D' ran slower)
  extern __shared__ float smem[];
  int* s_base = reinterpret_cast<int*>(smem);          // [kRows]
  int* s_sel = s_base + kRows;                         // routing
  int* s_raw = s_sel + kRows;                          // descriptor
  int* s_idx = s_raw + kRows;                          // [kRows][3]
  int* s_span = s_idx + 3 * kRows;                     // lo, hi
  float* s_g = smem + 6 * kRows + 2;                   // [kRows][GS]
  float* s_f = s_g + kRows * C::GS;                    // [n_staged][FS]

  const int chunk = blockIdx.x;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int m = tid % C::M;
  const int rg = tid / C::M;
  const int i0 = (m / C::NO) * TI;
  const int o0 = (m % C::NO) * C::TO;
  const int live = min(max(n_live[b], 0), v_out);
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(row_begin + chunk_rows, live);
  const float* feats_b = feats + static_cast<long long>(b) * v_in1 * CIN;
  const float* g_b = g + static_cast<long long>(b) * v_out * COUT;
  const long long sel_b = static_cast<long long>(b) * v_out * groups;

  for (int c = tid; c < C::FS; c += kThreads) s_f[zero * C::FS + c] = 0.0f;
  float acc[3][TI][C::TO];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < C::TO; ++j) acc[d][i][j] = 0.0f;

  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    const int n = min(kRows, row_end - row0);
    __syncthreads();                    // the previous sub-tile is consumed
    if (tid < kRows) {
      const int r = row0 + tid;
      int bs = 0, sl = kNoTap;
      if (r < v_out) {
        bs = base[sel_b + static_cast<long long>(r) * groups + grp];
        sl = sel[sel_b + static_cast<long long>(r) * groups + grp];
      }
      s_base[tid] = bs;
      s_raw[tid] = sl;
      s_sel[tid] = tid < n ? sl : kNoTap;
    }
    if (SEG && tid == 0) gather_common::reset_span(s_span);
    for (int e = tid; e < n * COUT; e += kThreads) {
      const int r = e / COUT;
      s_g[r * C::GS + e % COUT] = g_b[static_cast<long long>(row0 + r) * COUT + e % COUT];
    }
    __syncthreads();
    int anchor;
    const bool covered = gather_common::stage_group<float, CIN, kThreads, SEG>(
        feats_b, v_in1, seg_rows, s_base, s_sel, s_raw, s_span, s_f, tally,
        anchor);
    if (tid < kRows) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        s_idx[3 * tid + dx] =
            staged_row(s_sel[tid], s_base[tid], tid, dx, covered, anchor, zero) * C::FS;
    }
    __syncthreads();
    for (int r = rg; r < n; r += C::RG) {
      float a[3][TI];
      float gv[C::TO];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float* src = s_f + s_idx[3 * r + d] + i0;
#pragma unroll
        for (int i = 0; i < TI; ++i) a[d][i] = src[i];
      }
#pragma unroll
      for (int j = 0; j < C::TO; ++j) gv[j] = s_g[r * C::GS + o0 + j];
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int j = 0; j < C::TO; ++j)
            acc[d][i][j] = __fmaf_rn(a[d][i], gv[j], acc[d][i][j]);
    }
  }

  // the partial slab of (sample, chunk, group): dW[3 grp + d] rows
  constexpr int SLAB = 3 * CIN * COUT;
  float* out = partial +
      ((static_cast<long long>(b) * gridDim.x + chunk) * groups + grp) * SLAB;
  if (C::RG == 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < C::TO; ++j)
          out[(d * CIN + i0 + i) * COUT + o0 + j] = acc[d][i][j];
    return;
  }
  __syncthreads();                      // staging buffers are free again
  float* s_red = smem;                  // [RG][SLAB]
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < C::TO; ++j)
        s_red[rg * SLAB + (d * CIN + i0 + i) * COUT + o0 + j] = acc[d][i][j];
  __syncthreads();
  for (int e = tid; e < SLAB; e += kThreads) {
    float s = s_red[e];
    for (int q = 1; q < C::RG; ++q) s += s_red[q * SLAB + e];
    out[e] = s;
  }
}

template <int CIN, int COUT, bool SEG>
int launch(const float* feats, const int* base, const int* sel, const float* g,
           const int* n_live, float* partial, float* out,
           unsigned long long* tally, int b, int v_in1, int v_out, int groups,
           int chunk_rows, int seg_rows, cudaStream_t stream) {
  auto kernel = gather_dw_xwin_partial<CIN, COUT, SEG>;
  const size_t smem = Cfg<CIN, COUT>::smem(SEG ? seg_rows : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (v_out + chunk_rows - 1) / chunk_rows;
  kernel<<<dim3(n_chunks, groups, b), kThreads, smem, stream>>>(
      feats, base, sel, g, n_live, partial, tally, v_in1, v_out, groups,
      chunk_rows, seg_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gather_common::launch_sum_partials(partial, out, b * n_chunks,
                                            3 * groups * CIN * COUT, stream);
}

template <bool SEG>
int dispatch(int cin, int cout, const float* feats, const int* base,
             const int* sel, const float* g, const int* n_live, float* partial,
             float* out, unsigned long long* tally, int b, int v_in1,
             int v_out, int groups, int chunk_rows, int seg_rows,
             cudaStream_t s) {
#define PCDET_DWX_CASE(CI, CO)                                                 \
  if (cin == CI && cout == CO)                                                 \
    return launch<CI, CO, SEG>(feats, base, sel, g, n_live, partial, out,      \
                               tally, b, v_in1, v_out, groups, chunk_rows,     \
                               seg_rows, s);
  PCDET_DWX_CASE(4, 16)
  PCDET_DWX_CASE(16, 16)
  PCDET_DWX_CASE(16, 32)
  PCDET_DWX_CASE(32, 32)
  PCDET_DWX_CASE(32, 64)
  PCDET_DWX_CASE(64, 64)
#undef PCDET_DWX_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches both passes on `stream`, does not synchronise, allocates
// nothing: `partial` holds B * ceil(V_out / chunk_rows) * 3G * Cin * Cout
// floats.  `seg` selects D' (segment rows `seg_rows`, 1..1022, and the two
// `tally` counters) over D''.  Returns the cudaError_t of the launches (0 on
// success); a (Cin, Cout) pair without an instance, groups outside 1..21,
// seg_rows outside 1..1022 or chunk_rows not a positive multiple of 64
// returns cudaErrorInvalidValue.  The caller checks shapes, dtypes and
// contiguity; B, G <= 65535; V_out >= 1.
extern "C" int pcdet_gather_dw_xwin(int seg, const float* feats, const int* base,
                                    const int* sel, const float* g,
                                    const int* n_live, float* partial,
                                    float* out, unsigned long long* tally,
                                    int b, int v_in1, int v_out, int groups,
                                    int cin, int cout, int chunk_rows,
                                    int seg_rows, void* stream) {
  if (groups < 1 || groups > 21 || v_in1 < 1 || b < 1 || v_out < 1 ||
      chunk_rows < kRows || chunk_rows % kRows != 0 ||
      (seg && (seg_rows < 1 || seg_rows > 1022))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg) {
    return dispatch<true>(cin, cout, feats, base, sel, g, n_live, partial, out,
                          tally, b, v_in1, v_out, groups, chunk_rows, seg_rows, s);
  }
  return dispatch<false>(cin, cout, feats, base, sel, g, n_live, partial, out,
                         tally, b, v_in1, v_out, groups, chunk_rows, 0, s);
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
