// Rulebook gather-GEMM of the sparse 3D convolutions, for sm_90a.
//
// Replaces two TPU kernels of pcdet_tpu/ops/pallas/gather_gemm.py:
//   B  _gather_matmul_fwd_only (pallas_call body _kernel): f32 features and
//      weights, f32 accumulation at Precision.HIGHEST;
//   C  _gather_matmul_packed_call (body _kernel_packed): bf16-rounded
//      features and weights, f32 accumulation.  The TPU kernel packs two
//      bf16 channels per int32 word because Mosaic cannot load narrow bf16
//      rows; Hopper loads bf16 directly, so C is this kernel instantiated for
//      __nv_bfloat16.  A bf16 product is exact in f32, so C's math is B's
//      on bf16-rounded inputs.
//
// Contract, per sample b of a batch of B:
//   out[b, v, :] = sum_k feats[b, rules[b, v, k], :] @ W[k]     (f32)
// feats (B, V_in + 1, Cin) with row V_in all zeros; rules (B, V_out, K)
// int32 in [0, V_in] (misses routed to V_in); W (K, Cin, Cout); n_live (B,)
// int32 on the device.  Rows v >= n_live[b] are written as zeros and read
// nothing: live rows are a sorted prefix of every sparse level, so a tile
// whose first row is past n_live skips all its loads.  (Row-granular: a
// live tile's rows past n_live gather the zero row, which the rulebooks
// route them to anyway.)  A rule outside [0, V_in] reads the zero row.
//
// The same kernel gives a conv's feature gradient over the mirrored (subm)
// or transposed (strided) rulebook with W[k] transposed, g as the table;
// Cin = 128 serves conv_out's 128 -> 64 feature gradient.
//
// Layout: one block per (tile of kTileRows output rows, sample): grid
// (ceil(V_out / kTileRows), B).  The block loads its tile's rules once; then
// for each tap k it stages W[k] (Cin x Cout, at most 128 x 128 f32 = 64 KB)
// and the tile's gathered rows (kTileRows x Cin, as f32) in shared memory,
// and each thread accumulates a 4-row by Cout/16-column block of the output
// in registers with explicit fmaf (one rounding per multiply-add, no TF32,
// no tensor cores).  Thread columns are interleaved (col = cg + 16 j) so a
// warp's weight reads hit 16 consecutive banks; gathered rows are padded to
// Cin + 1 floats so the two rows a warp reads sit in different banks.
//
// What bounds it: shared-memory traffic and FFMA issue.  Per tap a thread
// does 4 * Cout/16 FMAs for 4 + Cout/16 shared loads, and the block
// re-stages W[k] from L2 for every tile.  At SECOND's conv2_1 (B2, 66k live
// rows, K=27, 32 -> 32) it ran 3.65 GFLOP in 0.228 ms on an H100 SXM at
// 700 W: 16 TFLOP/s, a quarter of the 67 TFLOP/s FFMA peak, and no tensor
// cores.  wgmma on bf16 tiles, TMA / cp.async double buffering of the
// gathered rows and a persistent grid are the later PRs' work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;                         // output rows per block
constexpr int kThreads = 256;
constexpr int kColGroups = 16;
constexpr int kRowGroups = kThreads / kColGroups;     // 16
constexpr int kRowsPerThread = kTileRows / kRowGroups;  // 4
constexpr int kMaxTaps = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int CIN, int COUT>
constexpr size_t smem_bytes(int k_taps) {
  return sizeof(int) * kTileRows * k_taps +
         sizeof(float) * (CIN * COUT + kTileRows * (CIN + 1));
}

template <typename T, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
gather_gemm_kernel(const T* __restrict__ feats, const int* __restrict__ rules,
                   const T* __restrict__ w, const int* __restrict__ n_live,
                   float* __restrict__ out, int v_in1, int v_out, int k_taps) {
  constexpr int CN = COUT / kColGroups;
  constexpr int GS = CIN + 1;                         // padded row stride
  extern __shared__ float smem[];
  int* s_rules = reinterpret_cast<int*>(smem);        // [kTileRows][k_taps]
  float* s_w = smem + kTileRows * k_taps;             // [CIN][COUT]
  float* s_g = s_w + CIN * COUT;                      // [kTileRows][GS]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int live = min(n_live[b], v_out);
  float* out_b = out + static_cast<long long>(b) * v_out * COUT;

  if (row0 >= live) {                                 // dead tile: zeros only
    for (int e = tid; e < kTileRows * COUT; e += kThreads) {
      const int r = row0 + e / COUT;
      if (r < v_out) out_b[static_cast<long long>(r) * COUT + e % COUT] = 0.0f;
    }
    return;
  }

  const int zero_row = v_in1 - 1;
  const int* rules_b = rules + (static_cast<long long>(b) * v_out + row0) * k_taps;
  for (int e = tid; e < kTileRows * k_taps; e += kThreads) {
    int src = zero_row;
    if (row0 + e / k_taps < live) {
      const int x = rules_b[e];
      if (static_cast<unsigned>(x) < static_cast<unsigned>(v_in1)) src = x;
    }
    s_rules[e] = src;
  }

  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;
  float acc[kRowsPerThread][CN];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;

  const T* feats_b = feats + static_cast<long long>(b) * v_in1 * CIN;
  for (int k = 0; k < k_taps; ++k) {
    __syncthreads();                  // rules staged / previous tap consumed
    const T* wk = w + static_cast<long long>(k) * CIN * COUT;
    for (int e = tid; e < CIN * COUT; e += kThreads) s_w[e] = to_f32(wk[e]);
    for (int e = tid; e < kTileRows * CIN; e += kThreads) {
      const int r = e / CIN;
      const int c = e % CIN;
      const int src = s_rules[r * k_taps + k];
      s_g[r * GS + c] = to_f32(feats_b[static_cast<long long>(src) * CIN + c]);
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < CIN; ++c) {
      float a[kRowsPerThread];
      float bw[CN];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = s_g[(rg + kRowGroups * i) * GS + c];
#pragma unroll
      for (int j = 0; j < CN; ++j) bw[j] = s_w[c * COUT + cg + kColGroups * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = __fmaf_rn(a[i], bw[j], acc[i][j]);
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

template <typename T, int CIN, int COUT>
int launch(const void* feats, const int* rules, const void* w,
           const int* n_live, float* out, int b, int v_in1, int v_out,
           int k_taps, cudaStream_t stream) {
  auto kernel = gather_gemm_kernel<T, CIN, COUT>;
  const size_t smem = smem_bytes<CIN, COUT>(k_taps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((v_out + kTileRows - 1) / kTileRows, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), rules, static_cast<const T*>(w), n_live,
      out, v_in1, v_out, k_taps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CIN>
int dispatch_cout(int cout, const void* feats, const int* rules, const void* w,
                  const int* n_live, float* out, int b, int v_in1, int v_out,
                  int k_taps, cudaStream_t stream) {
  switch (cout) {
    case 16: return launch<T, CIN, 16>(feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    case 32: return launch<T, CIN, 32>(feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    case 64: return launch<T, CIN, 64>(feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    case 128: return launch<T, CIN, 128>(feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int cin, int cout, const void* feats, const int* rules,
             const void* w, const int* n_live, float* out, int b, int v_in1,
             int v_out, int k_taps, cudaStream_t stream) {
  switch (cin) {
    case 4: return dispatch_cout<T, 4>(cout, feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    case 16: return dispatch_cout<T, 16>(cout, feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    case 32: return dispatch_cout<T, 32>(cout, feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    case 64: return dispatch_cout<T, 64>(cout, feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    case 128: return dispatch_cout<T, 128>(cout, feats, rules, w, n_live, out, b, v_in1, v_out, k_taps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  `bf16`
// selects kernel C (feats and w are __nv_bfloat16) over kernel B (float).
// Returns the cudaError_t of the launch (0 on success); an unsupported
// Cin (4, 16, 32, 64, 128), Cout (16, 32, 64, 128) or K (1..64) returns
// cudaErrorInvalidValue.  The caller checks shapes, dtypes and contiguity;
// b <= 65535.
extern "C" int pcdet_gather_gemm(int bf16, const void* feats, const int* rules,
                                 const void* w, const int* n_live, float* out,
                                 int b, int v_in1, int v_out, int k_taps,
                                 int cin, int cout, void* stream) {
  if (k_taps < 1 || k_taps > kMaxTaps || v_in1 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || v_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(cin, cout, feats, rules, w, n_live, out, b,
                                   v_in1, v_out, k_taps, s);
  }
  return dispatch<float>(cin, cout, feats, rules, w, n_live, out, b, v_in1,
                         v_out, k_taps, s);
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
