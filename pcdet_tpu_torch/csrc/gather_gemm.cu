// Rulebook gather-GEMM of the sparse 3D convolutions, for sm_90a.
//
// Replaces two TPU kernels of pcdet_tpu/ops/pallas/gather_gemm.py:
//   B  _gather_matmul_fwd_only (:700, pallas_call :712, body _kernel): f32
//      features and weights, f32 accumulation at Precision.HIGHEST;
//   C  _gather_matmul_packed_call (:659, pallas_call :669, body
//      _kernel_packed): bf16-rounded features and weights, f32 accumulation.
//      The TPU kernel packs two bf16 channels per int32 word because Mosaic
//      cannot load narrow bf16 rows; Hopper loads bf16 directly.
//
// Contract, per sample b of a batch of B:
//   out[b, v, :] = sum_k feats[b, rules[b, v, k], :] @ W[k]     (f32)
// feats (B, V_in + 1, Cin) with row V_in all zeros; rules (B, V_out, K)
// int32 in [0, V_in] (misses routed to V_in); W (K, Cin, Cout); n_live (B,)
// int32 on the device.  Rows v >= n_live[b] are written as zeros and read
// nothing: live rows are a sorted prefix of every sparse level, so a tile
// whose first row is past n_live only writes zeros.  A rule outside
// [0, V_in) is a miss: it reads nothing and contributes zeros, as the zero
// row would.  The same kernels give a conv's feature gradient over the
// mirrored (subm) or transposed (strided) rulebook with W[k] transposed, g as
// the table (Cin = 128: conv_out's 128 -> 64 feature gradient).
//
// Both kernels: one block per (tile of TR output rows, sample).  The block
// stages its tile's rules once in shared memory (misses and rows past n_live
// as -1) and ORs the taps found in any row into a 64-bit mask.  It walks
// only those taps, in increasing order, through an NS-stage cp.async ring:
// the tile's gathered rows of tap k (16-byte copies, a miss zero-filled with
// src-size 0, so the zero row is never fetched) and W[k] land in stage
// k mod NS while the block computes an earlier tap, with one __syncthreads
// per tap.  TR (64, 128 or 256) and NS (2 or 3) are chosen per (Cin, Cout)
// instance so that the ring and the rules of K = 64 fit in 227 KB.  Skipping
// a tap that misses in every row of the tile is exact: the products skipped
// are (+0) * w, and fmaf(+0 * w, acc) leaves a finite acc unchanged (the one
// difference: a NaN or inf in a skipped W[k] no longer reaches the output).
// On SECOND's B2 books 14-31% of the (tile, tap) pairs are skipped, 54-57%
// on the transposed books of the strided convs.
//
// B (f32): bounded by FFMA operations.  Its sums keep the order of the
// first version of this file, one FFMA template for both kernels (per
// output element: taps 0..K-1, channels 0..Cin-1 inside each tap, one
// __fmaf_rn each, from +0), so it is bitwise equal to that kernel, to its
// plain version where that sums in the same order, and to kernels E / E'
// f32.  No TF32.  Each thread keeps RT rows x CT columns of sums (CT 4 or
// 8 columns as float4s interleaved over the column groups, rows rg + RG i).
// Gathered rows stay row-major in shared memory (cp.async cannot transpose),
// padded to an odd number of 16-byte units where a quarter-warp reads
// several rows; per 4 channels a thread reads each of its rows once as a
// float4 (4 channels) and each channel's weight columns as float4s: RT + CT
// shared loads for 4 RT CT FMAs (8 to 10.7 FMAs a load at Cout >= 32, 1.3 in
// the first version), without bank conflicts.  It still multiplies the missed
// rows of every tap it does not skip, so its rate over all taps is what
// bounds it: at conv2_1 it matches cuBLAS's f32 product on the pre-gathered
// rows of all 27 taps (the math without the gather).
//
// C (bf16): bounded by bytes.  Tensor cores: mma.sync m16n8k16 bf16 x bf16 ->
// f32, fed by ldmatrix (rows) and ldmatrix.trans (W[k], stored (Cin, Cout)
// row-major); each warp owns 16 rows x Cout.  A tap's product (Cin / 16
// mma steps) is summed in a fresh fragment and added to the f32 sums with
// one rounding, so the tensor cores' internal sums span one tap only.  Cin =
// 4 is padded to 16 with zeros in shared memory (8-byte copies).  The sum
// order is the tensor cores', so C is not bitwise equal to its plain version
// (E / E' bf16 sum each tap as C does and give its bits); it is bitwise
// repeatable (no atomics, no split over taps).  mma.sync and not wgmma: a
// tap is only 16-128 deep and the kernel is bound by its gathers, so
// wgmma's 64-row warpgroup tiles and shared-memory descriptors would buy no
// time.  What holds it above its bound is the per-tap work of a block (a
// barrier, a cp.async per 16 bytes of every row, zero-filled or not), not
// the tensor cores.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py S2, device
// time, SECOND's conv2_1 at B2, 66k live rows, K = 27, 32 -> 32): B 0.117 ms
// (the first version 0.229; bound 0.0185, operations), C 0.043 ms (0.230;
// bound 0.0067, bytes).  Per B2 train step B takes 2.98 ms (5.14 before)
// and per B2 detect batch C 0.48 ms (2.55); PERF.md section 6.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gather_ptx.cuh"

namespace {

using gather_ptx::cp_async;
using gather_ptx::cp_async_commit;
using gather_ptx::cp_async_wait;
using gather_ptx::ldsm_x4;
using gather_ptx::ldsm_x4_trans;
using gather_ptx::mma_bf16;
using gather_ptx::smem_u32;

constexpr int kMaxTaps = 64;
constexpr int kSmemLimit = 232448;       // a block's shared memory on sm_90
constexpr int kHeader = 16;              // the found-tap mask, 16-byte aligned

__host__ __device__ constexpr int rules_stride(int k) { return k | 1; }

// Whether an NS-stage ring of TR-row tiles (rows of row_bytes, W[k] of
// w_bytes) and the rules of K = 64 fit in a block's shared memory.
__host__ __device__ constexpr bool ring_fits(int tr, int ns, int row_bytes, int w_bytes) {
  return kHeader + ns * (tr * row_bytes + w_bytes) + 4 * tr * rules_stride(kMaxTaps) <=
         kSmemLimit;
}

__host__ __device__ constexpr int row_bytes(int raw, bool pad) {
  return pad && raw > 16 ? raw + 16 : raw;
}

// Shared layout of one instance: T = float (B) or __nv_bfloat16 (C), TR
// rows per tile, NS stages, NT threads.  PAD pads each staged row to an odd
// number of 16-byte units, for readers whose quarter-warps (or ldmatrix
// phases) span several rows.
template <typename T, int CIN, int COUT, int TR, int NS, int NT, bool PAD>
struct Ring {
  static constexpr int kCin = CIN, kCout = COUT, kRows = TR, kStages = NS, kThreads = NT;
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kCinS = kBf16 && CIN < 16 ? 16 : CIN;  // staged channels
  static constexpr int kRowBytes = row_bytes(kCinS * static_cast<int>(sizeof(T)), PAD);
  static constexpr int kWRowBytes = COUT * static_cast<int>(sizeof(T)) + (kBf16 ? 16 : 0);
  static constexpr int kWBytes = kCinS * kWRowBytes;
  static constexpr int kCopyBytes = CIN * static_cast<int>(sizeof(T)) < 16 ? 8 : 16;
  static constexpr int kRowCopies = CIN * static_cast<int>(sizeof(T)) / kCopyBytes;
  static constexpr int kWCopies = CIN * COUT * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kStageBytes = TR * kRowBytes + kWBytes;
  static_assert(ring_fits(TR, NS, kRowBytes, kWBytes), "the ring does not fit");

  static size_t smem_bytes(int k_taps) {
    return kHeader + NS * kStageBytes + 4 * TR * rules_stride(k_taps);
  }
};

// Kernel B's tiles: RT rows x CT columns of sums a thread, CG = Cout / CT
// column groups x RG = TR / RT row groups of threads.
template <int CIN, int COUT, int TR, int NS, int RT, int CT>
struct TileB : Ring<float, CIN, COUT, TR, NS, COUT / CT * (TR / RT), (COUT / CT < 8)> {
  static constexpr int kRT = RT, kCT = CT, kCG = COUT / CT, kRG = TR / RT;
};

// Kernel C's tiles: one warp per 16 rows, TR 128 unless three stages would
// not fit.
template <int CIN, int COUT,
          int TR = ring_fits(128, 3, row_bytes((CIN < 16 ? 16 : CIN) * 2, true),
                             (CIN < 16 ? 16 : CIN) * (2 * COUT + 16))
                       ? 128
                       : 64>
struct TileC : Ring<__nv_bfloat16, CIN, COUT, TR, 3, TR / 16 * 32, true> {};

// The tiles of B (f32): 256 threads, 4 x 4 (Cout < 64) or 4 x 8 sums a
// thread, 128 rows and three stages where they fit; on five instances of
// SECOND's convs, the tiles that timed fastest among those tried on the H100
// (PERF.md section 6).
template <int CIN, int COUT>
struct PickB {
  static constexpr int kCT = COUT >= 64 ? 8 : 4;
  static constexpr int kRawRow = row_bytes(4 * CIN, COUT / kCT < 8);
  static constexpr int kTR = ring_fits(128, 3, kRawRow, 4 * CIN * COUT) ? 128 : 64;
  static constexpr int kNS = ring_fits(kTR, 3, kRawRow, 4 * CIN * COUT) ? 3 : 2;
  using type = TileB<CIN, COUT, kTR, kNS, kTR / (256 / (COUT / kCT)), kCT>;
};
template <> struct PickB<16, 32> { using type = TileB<16, 32, 128, 3, 4, 8>; };
template <> struct PickB<32, 32> { using type = TileB<32, 32, 256, 2, 8, 4>; };
template <> struct PickB<32, 64> { using type = TileB<32, 64, 64, 3, 4, 8>; };
template <> struct PickB<64, 32> { using type = TileB<64, 32, 128, 2, 4, 8>; };
template <> struct PickB<64, 64> { using type = TileB<64, 64, 128, 3, 8, 8>; };

// Writes zeros to rows [row0, min(row0 + TR, v_out)) of out_b.
template <int TR, int COUT, int NT>
__device__ __forceinline__ void zero_tile(float* out_b, int row0, int v_out) {
  for (int e = threadIdx.x; e < TR * COUT / 4; e += NT) {
    const int r = row0 + e / (COUT / 4);
    if (r < v_out) {
      reinterpret_cast<float4*>(out_b + static_cast<long long>(r) * COUT)[e % (COUT / 4)] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Stages the tile's rules as s_rules[r * rules_stride(K) + k]: the table row
// of tap k of tile row r, or -1 for a miss (a rule outside [0, v_in), a row
// at or past `live`).  Returns the mask of taps found in some row; ends with
// a barrier.  *s_mask is 0 and the block has synchronised since.
template <int TR, int NT>
__device__ __forceinline__ unsigned long long stage_rules(
    const int* __restrict__ rules_b, int n_rows, int v_in, int k_taps, int* s_rules,
    unsigned long long* s_mask) {
  const int ks = rules_stride(k_taps);
  const int n = n_rows * k_taps;
  unsigned long long found = 0;
  for (int e = threadIdx.x; e < TR * k_taps; e += NT) {
    const int r = e / k_taps;
    const int k = e - r * k_taps;
    int x = -1;
    if (e < n) {
      const int y = rules_b[e];
      if (static_cast<unsigned>(y) < static_cast<unsigned>(v_in)) {
        x = y;
        found |= 1ULL << k;
      }
    }
    s_rules[r * ks + k] = x;
  }
  if (found) atomicOr(s_mask, found);
  __syncthreads();
  return *s_mask;
}

// Starts the copies of tap k (the gathered rows and W[k]) into one stage.
template <typename C, typename T>
__device__ __forceinline__ void fetch_tap(const T* __restrict__ feats_b,
                                          const T* __restrict__ w, int k,
                                          const int* s_rules, int ks,
                                          unsigned char* s_rows,
                                          unsigned char* s_w) {
  constexpr int CIN = C::kCin, COUT = C::kCout, NT = C::kThreads;
  constexpr int kElems = C::kCopyBytes / static_cast<int>(sizeof(T));
  for (int e = threadIdx.x; e < C::kRows * C::kRowCopies; e += NT) {
    const int r = e / C::kRowCopies;
    const int q = e % C::kRowCopies;
    const int src = s_rules[r * ks + k];
    const T* g = feats_b + (src < 0 ? 0 : static_cast<long long>(src) * CIN + q * kElems);
    cp_async<C::kCopyBytes>(s_rows + r * C::kRowBytes + q * C::kCopyBytes, g,
                            src < 0 ? 0 : C::kCopyBytes);
  }
  constexpr int kWq = COUT * static_cast<int>(sizeof(T)) / 16;   // copies per W row
  const T* wk = w + static_cast<long long>(k) * CIN * COUT;
  for (int e = threadIdx.x; e < C::kWCopies; e += NT) {
    const int c = e / kWq;
    const int q = e % kWq;
    cp_async<16>(s_w + c * C::kWRowBytes + q * 16, wk + c * COUT + q * (16 / sizeof(T)), 16);
  }
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------- B, f32 --
template <typename C>
__global__ void __launch_bounds__(C::kThreads)
gather_gemm_kernel_f32(const float* __restrict__ feats, const int* __restrict__ rules,
                       const float* __restrict__ w, const int* __restrict__ n_live,
                       float* __restrict__ out, int v_in1, int v_out, int k_taps) {
  constexpr int CIN = C::kCin, COUT = C::kCout;
  constexpr int TR = C::kRows, NS = C::kStages, NT = C::kThreads;
  constexpr int CT = C::kCT, CG = C::kCG, RG = C::kRG, RT = C::kRT;
  constexpr int ROW = C::kRowBytes / 4;                  // floats per staged row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_mask = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* s_rows = smem + kHeader;                          // [NS][TR][ROW]
  unsigned char* s_w = s_rows + NS * TR * C::kRowBytes;            // [NS][CIN][COUT]
  int* s_rules = reinterpret_cast<int*>(s_w + NS * CIN * C::kWRowBytes);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TR;
  const int tid = threadIdx.x;
  const int live = min(max(n_live[b], 0), v_out);
  float* out_b = out + static_cast<long long>(b) * v_out * COUT;
  if (row0 >= live) {                                    // dead tile: zeros only
    zero_tile<TR, COUT, NT>(out_b, row0, v_out);
    return;
  }
  if (tid == 0) *s_mask = 0;
  __syncthreads();
  const int ks = rules_stride(k_taps);
  unsigned long long pend = stage_rules<TR, NT>(
      rules + (static_cast<long long>(b) * v_out + row0) * k_taps, min(TR, live - row0),
      v_in1 - 1, k_taps, s_rules, s_mask);
  const int n_taps = __popcll(pend);

  const float* feats_b = feats + static_cast<long long>(b) * v_in1 * CIN;
  auto fetch = [&](int stage) {
    const int k = __ffsll(static_cast<long long>(pend)) - 1;
    pend &= pend - 1;
    fetch_tap<C>(feats_b, w, k, s_rules, ks, s_rows + stage * TR * C::kRowBytes,
                 s_w + stage * CIN * C::kWRowBytes);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (pend) fetch(s);
    cp_async_commit();
  }

  const int cg = tid % CG;
  const int rg = tid / CG;
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < n_taps; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();              // tap t landed; the stage of tap t - 1 is free
    if (pend) fetch((t + NS - 1) % NS);
    cp_async_commit();
    const int st = t % NS;
    const float* sr = reinterpret_cast<const float*>(s_rows + st * TR * C::kRowBytes);
    const float* sw = reinterpret_cast<const float*>(s_w + st * CIN * C::kWRowBytes);
#pragma unroll 2
    for (int q = 0; q < CIN / 4; ++q) {
      float4 a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        a[i] = *reinterpret_cast<const float4*>(sr + (rg + RG * i) * ROW + 4 * q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float bw[CT];
#pragma unroll
        for (int j = 0; j < CT / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              sw + (4 * q + u) * COUT + 4 * (cg + CG * j));
          bw[4 * j] = v.x;
          bw[4 * j + 1] = v.y;
          bw[4 * j + 2] = v.z;
          bw[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float x = part(a[i], u);
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[i][j] = __fmaf_rn(x, bw[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + rg + RG * i;
    if (row >= v_out) continue;
    float4* o = reinterpret_cast<float4*>(out_b + static_cast<long long>(row) * COUT);
    const bool on = row < live;
#pragma unroll
    for (int j = 0; j < CT / 4; ++j) {
      o[cg + CG * j] = on ? make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                                        acc[i][4 * j + 3])
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// --------------------------------------------------------------- C, bf16 --
// (minimum one block an SM: ptxas otherwise holds the Cout = 128 and Cin = 4
// instances to 128 / 64 registers and spills)
template <typename C>
__global__ void __launch_bounds__(C::kThreads, 1)
gather_gemm_kernel_bf16(const __nv_bfloat16* __restrict__ feats, const int* __restrict__ rules,
                        const __nv_bfloat16* __restrict__ w, const int* __restrict__ n_live,
                        float* __restrict__ out, int v_in1, int v_out, int k_taps) {
  constexpr int CIN = C::kCin, COUT = C::kCout;
  constexpr int TR = C::kRows, NS = C::kStages, NT = C::kThreads;
  constexpr int NB = COUT / 8;                          // n8 blocks per warp
  constexpr int NC = NB < 4 ? NB : 4;                   // summed per tap at once
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_mask = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* s_rows = smem + kHeader;                          // [NS][TR][row]
  unsigned char* s_w = s_rows + NS * TR * C::kRowBytes;            // [NS][CinS][Cout]
  int* s_rules = reinterpret_cast<int*>(s_w + NS * C::kCinS * C::kWRowBytes);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TR;
  const int tid = threadIdx.x;
  const int live = min(max(n_live[b], 0), v_out);
  float* out_b = out + static_cast<long long>(b) * v_out * COUT;
  if (row0 >= live) {                                    // dead tile: zeros only
    zero_tile<TR, COUT, NT>(out_b, row0, v_out);
    return;
  }
  if (CIN < 16) {           // the pad channels (and W's pad rows) stay zero
    uint4* z = reinterpret_cast<uint4*>(s_rows);
    for (int e = tid; e < NS * (TR * C::kRowBytes + C::kCinS * C::kWRowBytes) / 16; e += NT)
      z[e] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) *s_mask = 0;
  __syncthreads();
  const int ks = rules_stride(k_taps);
  unsigned long long pend = stage_rules<TR, NT>(
      rules + (static_cast<long long>(b) * v_out + row0) * k_taps, min(TR, live - row0),
      v_in1 - 1, k_taps, s_rules, s_mask);
  const int n_taps = __popcll(pend);

  const __nv_bfloat16* feats_b = feats + static_cast<long long>(b) * v_in1 * CIN;
  auto fetch = [&](int stage) {
    const int k = __ffsll(static_cast<long long>(pend)) - 1;
    pend &= pend - 1;
    fetch_tap<C>(feats_b, w, k, s_rules, ks, s_rows + stage * TR * C::kRowBytes,
                 s_w + stage * C::kCinS * C::kWRowBytes);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (pend) fetch(s);
    cp_async_commit();
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // ldmatrix addresses: lane l names row l % 16, 8 columns from (l / 16) * 8
  const int a_off = (warp * 16 + lane % 16) * C::kRowBytes + (lane / 16) * 16;
  const int b_off = (lane % 16) * C::kWRowBytes + (lane / 16) * 16;
  for (int t = 0; t < n_taps; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();              // tap t landed; the stage of tap t - 1 is free
    if (pend) fetch((t + NS - 1) % NS);
    cp_async_commit();
    const int st = t % NS;
    const unsigned sa = smem_u32(s_rows + st * TR * C::kRowBytes + a_off);
    const unsigned sb = smem_u32(s_w + st * C::kCinS * C::kWRowBytes + b_off);
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += NC) {     // NC n8 blocks at a time
      float tap[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tap[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < C::kCinS / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, sa + kk * 32);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          unsigned bf[4];
          ldsm_x4_trans(bf, sb + kk * 16 * C::kWRowBytes + (n0 / 2 + np) * 32);
          mma_bf16(tap[2 * np], a, bf[0], bf[1]);
          mma_bf16(tap[2 * np + 1], a, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + j][e] += tap[j][e];
    }
  }

  // fragment layout: acc[j][0..1] at (row lane / 4, cols 8 j + 2 (lane % 4)
  // + 0..1), acc[j][2..3] eight rows below
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * h;
    if (row >= v_out) continue;
    const bool on = row < live;
    float* o = out_b + static_cast<long long>(row) * COUT + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      *reinterpret_cast<float2*>(o + 8 * j) =
          on ? make_float2(acc[j][2 * h], acc[j][2 * h + 1]) : make_float2(0.0f, 0.0f);
    }
  }
}

// ------------------------------------------------------------------ host --
template <typename C>
int launch(const void* feats, const int* rules, const void* w, const int* n_live,
           float* out, int b, int v_in1, int v_out, int k_taps, cudaStream_t stream) {
  using T = typename std::conditional<C::kBf16, __nv_bfloat16, float>::type;
  void (*kernel)(const T*, const int*, const T*, const int*, float*, int, int, int);
  if constexpr (C::kBf16) {
    kernel = gather_gemm_kernel_bf16<C>;
  } else {
    kernel = gather_gemm_kernel_f32<C>;
  }
  const size_t smem = C::smem_bytes(k_taps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((v_out + C::kRows - 1) / C::kRows, b);
  kernel<<<grid, C::kThreads, smem, stream>>>(
      static_cast<const T*>(feats), rules, static_cast<const T*>(w), n_live, out, v_in1,
      v_out, k_taps);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(integral_constant<Cin>, integral_constant<Cout>) for a supported
// instance; `otherwise` for any other pair.
template <int CIN, typename F>
int with_cout(int cout, int otherwise, F&& f) {
  switch (cout) {
    case 16: return f(std::integral_constant<int, CIN>{}, std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, CIN>{}, std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, CIN>{}, std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, CIN>{}, std::integral_constant<int, 128>{});
    default: return otherwise;
  }
}

template <typename F>
int with_instance(int cin, int cout, int otherwise, F&& f) {
  switch (cin) {
    case 4: return with_cout<4>(cout, otherwise, f);
    case 16: return with_cout<16>(cout, otherwise, f);
    case 32: return with_cout<32>(cout, otherwise, f);
    case 64: return with_cout<64>(cout, otherwise, f);
    case 128: return with_cout<128>(cout, otherwise, f);
    default: return otherwise;
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  `bf16`
// selects kernel C (feats and w are __nv_bfloat16) over kernel B (float).
// Returns the cudaError_t of the launch (0 on success); an unsupported
// Cin (4, 16, 32, 64, 128), Cout (16, 32, 64, 128) or K (1..64) returns
// cudaErrorInvalidValue.  The caller checks shapes, dtypes, contiguity and
// alignment (feats to 16 bytes, or 8 for bf16 Cin = 4; w to 16); b <= 65535.
extern "C" int pcdet_gather_gemm(int bf16, const void* feats, const int* rules,
                                 const void* w, const int* n_live, float* out,
                                 int b, int v_in1, int v_out, int k_taps,
                                 int cin, int cout, void* stream) {
  if (k_taps < 1 || k_taps > kMaxTaps || v_in1 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || v_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(cin, cout, static_cast<int>(cudaErrorInvalidValue),
                       [&](auto ci, auto co) {
                         constexpr int CI = decltype(ci)::value;
                         constexpr int CO = decltype(co)::value;
                         return bf16 ? launch<TileC<CI, CO>>(feats, rules, w, n_live,
                                                             out, b, v_in1, v_out,
                                                             k_taps, s)
                                     : launch<typename PickB<CI, CO>::type>(
                                           feats, rules, w, n_live, out, b, v_in1, v_out,
                                           k_taps, s);
                       });
}

// The output rows per block (TR) of an instance, 0 if there is none.
extern "C" int pcdet_gather_gemm_tile_rows(int bf16, int cin, int cout) {
  return with_instance(cin, cout, 0, [&](auto ci, auto co) {
    constexpr int CI = decltype(ci)::value;
    constexpr int CO = decltype(co)::value;
    return bf16 ? TileC<CI, CO>::kRows : PickB<CI, CO>::type::kRows;
  });
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
