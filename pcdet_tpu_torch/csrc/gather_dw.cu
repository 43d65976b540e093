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
// all three.
//
// Contract, summed over the batch of B samples:
//   dW[k, i, o] = sum_b sum_{v < n_live[b]} feats[b, rules[b, v, k], i] * g[b, v, o]
// feats (B, V_in + 1, Cin) f32 with row V_in all zeros; rules (B, V_out, K)
// int32 in [0, V_in] (misses routed to V_in; a rule outside [0, V_in) reads
// nothing); g (B, V_out, Cout) f32; n_live (B,) int32 on the device: rows at
// or past it contribute nothing, whatever g holds there.  dW (K, Cin, Cout)
// f32.
//
// Layout: pass 1 runs one block per (row chunk, tap, sample), grid
// (n_chunks, K, B).  A chunk is `chunk_rows` output rows (a multiple of
// kRows), walked in sub-tiles of kRows rows: the block stages the sub-tile's
// rules for its tap, the gathered feature rows (kRows x Cin) and the g rows
// (kRows x Cout) in shared memory, and each thread accumulates a TI x TO
// block of the Cin x Cout sum over the rows of its row group in registers,
// one __fmaf_rn per product.  Row groups (kThreads / micro-tiles of them)
// are summed through shared memory in a fixed order, and the block writes
// one partial (Cin x Cout) for its (sample, chunk, tap).  Pass 2 sums the
// partials per output element in a fixed order (sample, then chunk;
// gather_common.cuh's sum_partials, shared with D'' and D').  No atomics:
// two launches on the same inputs give the same bits.
//
// What bounds it: per row a thread does TI * TO FMAs for TI + TO shared
// loads, as in kernel B; g is re-read from L2 once per tap (27x for a
// 3x3x3 book), and the partials make one extra round trip through memory
// (n_chunks * K * Cin * Cout floats per sample).  Staging g once per block
// for every tap, wgmma on the (Cin x rows) x (rows x Cout) products and a
// persistent grid are later work.
#include "gather_common.cuh"

namespace {

constexpr int kRows = 64;          // rows per staged sub-tile
constexpr int kThreads = 256;

template <int CIN, int COUT>
struct Cfg {
  static constexpr int TI = (CIN * COUT > 4096) ? 8 : 4;   // Cin per thread
  static constexpr int TO = 4;                              // Cout per thread
  static constexpr int NO = COUT / TO;                      // column blocks
  static constexpr int M = (CIN / TI) * NO;                 // micro-tiles
  static constexpr int RG = kThreads / M;                   // row groups
  static_assert(CIN % TI == 0 && COUT % TO == 0, "tile");
  static_assert(M <= kThreads && kThreads % M == 0, "threads");
  static constexpr int FS = CIN + 1;                        // padded strides
  static constexpr int GS = COUT + 1;
  static constexpr size_t kStage =
      sizeof(float) * kRows * (FS + GS) + sizeof(int) * kRows;
  static constexpr size_t kReduce =
      RG > 1 ? sizeof(float) * RG * CIN * COUT : 0;
  static constexpr size_t kSmem = kStage > kReduce ? kStage : kReduce;
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
gather_dw_partial(const float* __restrict__ feats, const int* __restrict__ rules,
                  const float* __restrict__ g, const int* __restrict__ n_live,
                  float* __restrict__ partial, int v_in1, int v_out,
                  int k_taps, int chunk_rows) {
  using C = Cfg<CIN, COUT>;
  extern __shared__ float smem[];
  float* s_f = smem;                                   // [kRows][FS]
  float* s_g = s_f + kRows * C::FS;                    // [kRows][GS]
  int* s_r = reinterpret_cast<int*>(s_g + kRows * C::GS);  // [kRows]

  const int chunk = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int m = tid % C::M;
  const int rg = tid / C::M;
  const int i0 = (m / C::NO) * C::TI;
  const int o0 = (m % C::NO) * C::TO;
  const int live = min(max(n_live[b], 0), v_out);
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(row_begin + chunk_rows, live);
  const int zero_row = v_in1 - 1;
  const float* feats_b = feats + static_cast<long long>(b) * v_in1 * CIN;
  const float* g_b = g + static_cast<long long>(b) * v_out * COUT;
  const int* rules_b = rules + static_cast<long long>(b) * v_out * k_taps;

  float acc[C::TI][C::TO];
#pragma unroll
  for (int i = 0; i < C::TI; ++i)
#pragma unroll
    for (int j = 0; j < C::TO; ++j) acc[i][j] = 0.0f;

  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    const int n = min(kRows, row_end - row0);
    __syncthreads();                    // the previous sub-tile is consumed
    if (tid < n) {
      const int x = rules_b[static_cast<long long>(row0 + tid) * k_taps + k];
      s_r[tid] = static_cast<unsigned>(x) < static_cast<unsigned>(zero_row)
                     ? x : -1;
    }
    __syncthreads();
    for (int e = tid; e < n * CIN; e += kThreads) {
      const int r = e / CIN;
      const int c = e % CIN;
      const int src = s_r[r];
      s_f[r * C::FS + c] =
          src >= 0 ? feats_b[static_cast<long long>(src) * CIN + c] : 0.0f;
    }
    for (int e = tid; e < n * COUT; e += kThreads) {
      const int r = e / COUT;
      s_g[r * C::GS + e % COUT] =
          g_b[static_cast<long long>(row0 + r) * COUT + e % COUT];
    }
    __syncthreads();
    for (int r = rg; r < n; r += C::RG) {
      float a[C::TI];
      float w[C::TO];
#pragma unroll
      for (int i = 0; i < C::TI; ++i) a[i] = s_f[r * C::FS + i0 + i];
#pragma unroll
      for (int j = 0; j < C::TO; ++j) w[j] = s_g[r * C::GS + o0 + j];
#pragma unroll
      for (int i = 0; i < C::TI; ++i)
#pragma unroll
        for (int j = 0; j < C::TO; ++j) acc[i][j] = __fmaf_rn(a[i], w[j], acc[i][j]);
    }
  }

  float* out = partial +
      ((static_cast<long long>(b) * gridDim.x + chunk) * k_taps + k) * CIN * COUT;
  if (C::RG == 1) {
#pragma unroll
    for (int i = 0; i < C::TI; ++i)
#pragma unroll
      for (int j = 0; j < C::TO; ++j) out[(i0 + i) * COUT + o0 + j] = acc[i][j];
    return;
  }
  __syncthreads();                      // staging buffers are free again
  float* s_red = smem;                  // [RG][CIN * COUT]
#pragma unroll
  for (int i = 0; i < C::TI; ++i)
#pragma unroll
    for (int j = 0; j < C::TO; ++j)
      s_red[rg * CIN * COUT + (i0 + i) * COUT + o0 + j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < CIN * COUT; e += kThreads) {
    float s = s_red[e];
    for (int q = 1; q < C::RG; ++q) s += s_red[q * CIN * COUT + e];
    out[e] = s;
  }
}

template <int CIN, int COUT>
int launch(const float* feats, const int* rules, const float* g,
           const int* n_live, float* partial, float* out, int b, int v_in1,
           int v_out, int k_taps, int chunk_rows, cudaStream_t stream) {
  auto kernel = gather_dw_partial<CIN, COUT>;
  const size_t smem = Cfg<CIN, COUT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (v_out + chunk_rows - 1) / chunk_rows;
  kernel<<<dim3(n_chunks, k_taps, b), kThreads, smem, stream>>>(
      feats, rules, g, n_live, partial, v_in1, v_out, k_taps, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gather_common::launch_sum_partials(partial, out, b * n_chunks,
                                            k_taps * CIN * COUT, stream);
}

}  // namespace

// Launches both passes on `stream`, does not synchronise, allocates
// nothing: `partial` holds B * ceil(V_out / chunk_rows) * K * Cin * Cout
// floats.  Returns the cudaError_t of the launches (0 on success); a
// (Cin, Cout) pair without an instance, K outside 1..64, or chunk_rows not
// a positive multiple of 64 returns cudaErrorInvalidValue.  The caller
// checks shapes, dtypes and contiguity; B, K <= 65535; V_out >= 1.
extern "C" int pcdet_gather_dw(const float* feats, const int* rules,
                               const float* g, const int* n_live,
                               float* partial, float* out, int b, int v_in1,
                               int v_out, int k_taps, int cin, int cout,
                               int chunk_rows, void* stream) {
  if (k_taps < 1 || k_taps > 64 || v_in1 < 1 || b < 1 || v_out < 1 ||
      chunk_rows < kRows || chunk_rows % kRows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCDET_DW_CASE(CI, CO)                                              \
  if (cin == CI && cout == CO)                                             \
    return launch<CI, CO>(feats, rules, g, n_live, partial, out, b, v_in1, \
                          v_out, k_taps, chunk_rows, s);
  PCDET_DW_CASE(4, 16)
  PCDET_DW_CASE(16, 16)
  PCDET_DW_CASE(16, 32)
  PCDET_DW_CASE(32, 32)
  PCDET_DW_CASE(32, 64)
  PCDET_DW_CASE(64, 64)
  PCDET_DW_CASE(64, 128)
#undef PCDET_DW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
