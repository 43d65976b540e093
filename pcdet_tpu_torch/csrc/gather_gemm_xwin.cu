// Gather-GEMM of the kw=3 sparse convolutions by x-window and segment
// loads (kernels E and E'), for sm_90a.
//
// Replaces two TPU kernels of pcdet_tpu/ops/pallas/gather_gemm.py:
//   E   _gather_matmul_xwin_call (bodies _kernel_xwin, _kernel_xwin_packed):
//       one (3, Cin) window load per (output row, tap group), 2-bit selects;
//   E'  _gather_matmul_seg_call (body _kernel_seg): one (S, Cin) segment load
//       per (64-row tile, tap group), 10-bit offsets into it, and E's
//       per-row windows where the tile's span exceeds S.
// Both compute kernel B's function (csrc/gather_gemm.cu) over a kw=3 book
// given as selectors instead of rules.  A tap group g is the three x-taps
// 3g, 3g+1, 3g+2 of one (dz, dy): its found rows lie in three consecutive
// rows of the sorted table, base[b, v, g] .. base + 2, and bits 2dx..2dx+1
// of sel[b, v, g] give the window row of x-tap dx (3: a miss; 0x3f: a row
// with no tap of the group).
//
// Contract, per sample b of a batch of B:
//   out[b, v, :] = sum_g sum_dx feats[b, base + off_dx, :] @ W[3g + dx]  (f32)
// feats (B, V_in + 1, Cin), row V_in all zeros; base, sel (B, V_out, G)
// int32; W (3G, Cin, Cout); n_live (B,) int32 on the device.  Rows at or
// past n_live are written as zeros and read nothing.  The bf16 instances
// read __nv_bfloat16 features and weights and widen them on staging.  The
// window or segment is read only up to row V_in: the table is not padded.
//
// Layout, as kernel B: one block per (64-row tile, sample), 256 threads,
// each keeping a 4-row by Cout/16-column block of sums in registers.  For
// each tap group the block stages W[3g .. 3g+2] (3 Cin x Cout f32) and the
// rows the group reads in shared memory, then every thread routes each of
// its rows' three x-taps to a staged row (or a zero row) and runs
// tap-major, channel-inner __fmaf_rn, kernel B's order: E and E' give B's
// bits on the same book.
//   E   stages, per output row, the window rows that one of its taps
//       selects (rows base .. base + 2 of the table).
//   E'  reduces the tile's window starts in shared memory to the anchor
//       (the least base over rows with a tap in the group) and the span
//       (the greatest base + 3, less the anchor).  Span <= S: it stages the
//       span's contiguous rows once and routes each tap to row
//       base - anchor + off.  Else it takes E's windows.  The branch taken
//       is counted per (tile, group) in tally[0] (segment) / tally[1]
//       (window).  The descriptors are computed over every row of the tile
//       below V_out, as pcdet_tpu's segment_desc does.
// The staging is gather_common.cuh's.
//
// xwin_selectors_kernel builds a book's selectors from its rules on the
// card, in one pass (one thread per (row, group)).
//
// What bounds it: as kernel B, shared-memory loads and FFMA issue (per tap
// a thread does 4 * Cout/16 FMAs for 4 + Cout/16 shared loads); the loads
// from device memory differ: B loads K rows per output row, the zero row
// included, E loads only the found rows, and E' loads each row of a
// tile's span once for all of the tile's taps of a group.
#include "gather_common.cuh"

namespace {

using gather_common::kNoTap;
using gather_common::kTileRows;
using gather_common::staged_row;
using gather_common::staged_rows;
using gather_common::to_f32;

constexpr int kThreads = 256;
constexpr int kColGroups = 16;
constexpr int kRowGroups = kThreads / kColGroups;       // 16
constexpr int kRowsPerThread = kTileRows / kRowGroups;  // 4

template <int CIN, int COUT>
size_t smem_bytes(int seg_rows) {
  return sizeof(float) * (3 * CIN * COUT + staged_rows(seg_rows) * (CIN + 1)) +
         sizeof(int) * (3 * kTileRows + 2);
}

template <typename T, int CIN, int COUT, bool SEG>
__global__ void __launch_bounds__(kThreads)
gather_gemm_xwin_kernel(const T* __restrict__ feats, const int* __restrict__ base,
                        const int* __restrict__ sel, const T* __restrict__ w,
                        const int* __restrict__ n_live, float* __restrict__ out,
                        unsigned long long* __restrict__ tally, int v_in1,
                        int v_out, int groups, int seg_rows) {
  constexpr int CN = COUT / kColGroups;
  constexpr int RS = CIN + 1;                           // staged row stride
  const int n_staged = staged_rows(SEG ? seg_rows : 0);
  const int zero = n_staged - 1;
  extern __shared__ float smem[];
  float* s_w = smem;                                    // [3 CIN][COUT]
  float* s_rows = s_w + 3 * CIN * COUT;                 // [n_staged][RS]
  int* s_base = reinterpret_cast<int*>(s_rows + n_staged * RS);  // [64]
  int* s_sel = s_base + kTileRows;                      // [64] routing
  int* s_raw = s_sel + kTileRows;                       // [64] descriptor
  int* s_span = s_raw + kTileRows;                      // lo, hi

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int live = min(max(n_live[b], 0), v_out);
  float* out_b = out + static_cast<long long>(b) * v_out * COUT;

  if (row0 >= live) {                                   // dead tile: zeros only
    for (int e = tid; e < kTileRows * COUT; e += kThreads) {
      const int r = row0 + e / COUT;
      if (r < v_out) out_b[static_cast<long long>(r) * COUT + e % COUT] = 0.0f;
    }
    return;
  }
  for (int c = tid; c < RS; c += kThreads) s_rows[zero * RS + c] = 0.0f;

  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;
  float acc[kRowsPerThread][CN];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;

  const T* feats_b = feats + static_cast<long long>(b) * v_in1 * CIN;
  const long long sel0 = (static_cast<long long>(b) * v_out + row0) * groups;
  for (int g = 0; g < groups; ++g) {
    __syncthreads();                  // the previous group is consumed
    const T* wg = w + static_cast<long long>(3 * g) * CIN * COUT;
    for (int e = tid; e < 3 * CIN * COUT; e += kThreads) s_w[e] = to_f32(wg[e]);
    if (tid < kTileRows) {
      const int r = row0 + tid;
      int bs = 0, sl = kNoTap;
      if (r < v_out) {
        bs = base[sel0 + static_cast<long long>(tid) * groups + g];
        sl = sel[sel0 + static_cast<long long>(tid) * groups + g];
      }
      s_base[tid] = bs;
      s_raw[tid] = sl;
      s_sel[tid] = r < live ? sl : kNoTap;
    }
    if (SEG && tid == 0) gather_common::reset_span(s_span);
    __syncthreads();
    int anchor;
    const bool covered = gather_common::stage_group<T, CIN, kThreads, SEG>(
        feats_b, v_in1, seg_rows, s_base, s_sel, s_raw, s_span, s_rows, tally,
        anchor);
    __syncthreads();
    int idx[kRowsPerThread][3];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + kRowGroups * i;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        idx[i][dx] = staged_row(s_sel[r], s_base[r], r, dx, covered, anchor, zero) * RS;
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float* wd = s_w + dx * CIN * COUT;
#pragma unroll 8
      for (int c = 0; c < CIN; ++c) {
        float a[kRowsPerThread];
        float bw[CN];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) a[i] = s_rows[idx[i][dx] + c];
#pragma unroll
        for (int j = 0; j < CN; ++j) bw[j] = wd[c * COUT + cg + kColGroups * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = __fmaf_rn(a[i], bw[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + rg + kRowGroups * i;
    if (row >= v_out) continue;
    float* o = out_b + static_cast<long long>(row) * COUT;
#pragma unroll
    for (int j = 0; j < CN; ++j) o[cg + kColGroups * j] = acc[i][j];
  }
}

template <typename T, int CIN, int COUT, bool SEG>
int launch(const void* feats, const int* base, const int* sel, const void* w,
           const int* n_live, float* out, unsigned long long* tally, int b,
           int v_in1, int v_out, int groups, int seg_rows, cudaStream_t stream) {
  auto kernel = gather_gemm_xwin_kernel<T, CIN, COUT, SEG>;
  const size_t smem = smem_bytes<CIN, COUT>(SEG ? seg_rows : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((v_out + kTileRows - 1) / kTileRows, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), base, sel, static_cast<const T*>(w), n_live,
      out, tally, v_in1, v_out, groups, seg_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SEG>
int dispatch(int cin, int cout, const void* feats, const int* base,
             const int* sel, const void* w, const int* n_live, float* out,
             unsigned long long* tally, int b, int v_in1, int v_out,
             int groups, int seg_rows, cudaStream_t s) {
#define PCDET_XWIN_CASE(CI, CO)                                               \
  if (cin == CI && cout == CO)                                                \
    return launch<T, CI, CO, SEG>(feats, base, sel, w, n_live, out, tally, b, \
                                  v_in1, v_out, groups, seg_rows, s);
  PCDET_XWIN_CASE(4, 16)
  PCDET_XWIN_CASE(16, 16)
  PCDET_XWIN_CASE(16, 32)
  PCDET_XWIN_CASE(32, 32)
  PCDET_XWIN_CASE(32, 64)
  PCDET_XWIN_CASE(64, 64)
  PCDET_XWIN_CASE(32, 16)
  PCDET_XWIN_CASE(64, 32)
#undef PCDET_XWIN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// A kw=3 book's x-window selectors, one thread per (row, tap group): the
// window start base (the least found row, 0 if none), the 2-bit window row
// of each x-tap (3: a miss, or a found tap outside the 3-row window, which
// is counted into *dropped), as pcdet_tpu/ops/sparse.py:_xwin_selectors.
__global__ void __launch_bounds__(kThreads)
xwin_selectors_kernel(const int* __restrict__ rules, int n_in, long long n,
                      int* __restrict__ base, int* __restrict__ sel,
                      unsigned long long* __restrict__ dropped) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned out_of_window = 0;
  if (i < n) {
    const int* r = rules + 3 * i;
    int lo = INT_MAX;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      if (r[dx] != n_in) lo = min(lo, r[dx]);
    const int bs = lo == INT_MAX ? 0 : lo;
    int packed = 0;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      int off = 3;
      if (r[dx] != n_in) {
        off = r[dx] - bs;
        if (off > 2) {
          off = 3;
          ++out_of_window;
        }
      }
      packed |= off << (2 * dx);
    }
    base[i] = bs;
    sel[i] = packed;
  }
  out_of_window = __reduce_add_sync(0xffffffffu, out_of_window);
  if ((threadIdx.x & 31) == 0 && out_of_window)
    atomicAdd(dropped, static_cast<unsigned long long>(out_of_window));
}

}  // namespace

// The selectors of `n` (row, tap group)s of a kw=3 book: rules (n, 3)
// int32 with misses at n_in -> base, sel (n,) int32; adds the dropped taps
// to *dropped.  Launches on `stream`, does not synchronise.  Returns the
// cudaError_t of the launch.
extern "C" int pcdet_xwin_selectors(const int* rules, int n_in, long long n,
                                    int* base, int* sel,
                                    unsigned long long* dropped, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  xwin_selectors_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rules, n_in, n, base, sel, dropped);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`, does not synchronise, allocates nothing.  `seg`
// selects E' (segment rows `seg_rows`, 1..1022; `tally` two counters it
// adds to) over E (`seg_rows` and `tally` unused).  `bf16` selects the
// __nv_bfloat16 instances.  Returns the cudaError_t of the launch (0 on
// success); a (Cin, Cout) pair without an instance, groups outside 1..21 or
// seg_rows outside 1..1022 returns cudaErrorInvalidValue.  The caller
// checks shapes, dtypes and contiguity; b <= 65535.
extern "C" int pcdet_gather_gemm_xwin(int seg, int bf16, const void* feats,
                                      const int* base, const int* sel,
                                      const void* w, const int* n_live,
                                      float* out, unsigned long long* tally,
                                      int b, int v_in1, int v_out, int groups,
                                      int cin, int cout, int seg_rows,
                                      void* stream) {
  if (groups < 1 || groups > 21 || v_in1 < 1 ||
      (seg && (seg_rows < 1 || seg_rows > 1022))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || v_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg) {
    return bf16 ? dispatch<__nv_bfloat16, true>(cin, cout, feats, base, sel, w, n_live, out, tally, b, v_in1, v_out, groups, seg_rows, s)
                : dispatch<float, true>(cin, cout, feats, base, sel, w, n_live, out, tally, b, v_in1, v_out, groups, seg_rows, s);
  }
  return bf16 ? dispatch<__nv_bfloat16, false>(cin, cout, feats, base, sel, w, n_live, out, tally, b, v_in1, v_out, groups, 0, s)
              : dispatch<float, false>(cin, cout, feats, base, sel, w, n_live, out, tally, b, v_in1, v_out, groups, 0, s);
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
