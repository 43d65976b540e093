// The weight-gradient core of kernels D (gather_dw.cu), D'' and D'
// (gather_dw_xwin.cu), for sm_90a.
//
//   dW[k, i, o] = sum_b sum_{v < n_live[b]} feats[b, row(b, v, k), i] * g[b, v, o]
//
// over the taps k that row v finds.  Pass 1 runs one block per (row chunk,
// tap block, sample); a tap block is three taps: taps 3j .. 3j + 2 of a
// rulebook (D) or the three x-taps of tap group j (D'', D').  A chunk is
// walked in 64-row sub-tiles aligned to the book's 64-row tiles, through a
// two-stage cp.async pipeline with one __syncthreads per sub-tile: while
// the block multiplies sub-tile t, the copies of t + 1's table rows and g
// rows and of t + 2's rules or selectors are in flight (at Cin 128, whose
// rows fit one stage only, t + 1's table rows follow t's multiply: Cfg).
//   Staging of t + 1, from its rules / selectors already in shared memory:
//   D copies each found (row, tap)'s table row to slot 64 d + r; D'' each
//   row's selected window rows to slots 3 r .. 3 r + 2; D' the span of the
//   tile's window starts (its rows each copied once, to slots 0 .. span - 1)
//   where it is at most S rows and the windows of D'' where it is not (span
//   and anchor reduced by every warp alike from the selectors of every tile
//   row below V_out; the branch counted per (tile, group) in tally[0]
//   segment / tally[1] window).  16-byte copies; a miss is neither copied
//   nor read, nor is a table row at or past V_in + 1.  The g rows below
//   n_live are copied once for the three taps.
//   Lists: per tap, the live rows that find it, in row order, built by one
//   warp with a ballot and a popcount prefix (no atomics): entries
//   (staged slot << 8 | row).  The multiply runs over a tap's list only; a
//   tap no row of the sub-tile finds is skipped whole.  Skipping a miss is
//   exact for a dW: it would add (+0) * g.
// Each warp owns output tiles of one tap's Cin x Cout slab and sums them
// over every listed row of its sub-tiles in registers; no shared-memory
// reduction.  Two cores, CoreFfma and CoreTf32x3; PickCore holds the faster
// per instance on the H100 (gather_dw_ab.py times both).  The block writes
// one partial slab per (sample, chunk, tap), (B, n_chunks, K, Cin, Cout),
// and pass 2 (sum_partials) sums them per element in a fixed order.  No
// atomics in any sum: two launches on the same inputs give the same bits.
// The sums run in another order than the plain version's: 1e-4 of max
// |plain| holds them.
//
// What bounds them: the FFMA bound (2 Cin Cout operations per found tap of
// a live row at 67 TFLOP/s) is a small part of their time.  Per sub-tile a
// block waits on its copies, builds its lists and meets one barrier, and
// the multiply runs from shared memory with 6-12 warps an SM (the span
// staging of S = 256 rows, twice, holds most instances to one or two blocks
// an SM); chunks of uneven found work are evened out by four waves of
// blocks (ops/gather_dw.py:chunk_rows).  Measured: PERF.md section 6.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "gather_common.cuh"

namespace dw_common {

using gather_common::kNoTap;

constexpr int kRows = gather_common::kTileRows;   // rows per sub-tile
constexpr int kTaps = 3;                          // taps per block
enum Mode { kRules = 0, kWindow = 1, kSegment = 2 };
enum Core { kFfma = 0, kTf32x3 = 1 };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// (a) FFMA: each thread keeps TI x TO sums of one tap, its channels and
// columns as float4s interleaved over the tap's NIB x NOB thread tiles (a
// quarter-warp reads 128 contiguous bytes of a g row and one address of a
// table row), one __fmaf_rn per product in list order.  Where a tap has
// fewer than 32 tiles, RG = 32 / tiles row groups of one warp take every
// RG-th listed row and are summed by shuffles in a fixed order.
template <int CIN, int COUT>
struct CoreFfma {
  static constexpr int TI = CIN * COUT >= 8192 ? 8 : 4;
  static constexpr int TO = COUT >= 64 ? 8 : 4;
  static constexpr int NIB = CIN / TI, NOB = COUT / TO;
  static constexpr int kTiles = NIB * NOB;              // per tap
  static constexpr int kLanes = kTiles < 32 ? 32 : kTiles;
  static constexpr int RG = kLanes / kTiles;
  static constexpr int kThreads = kTaps * kLanes;
  static constexpr bool kPad8 = false;
  static_assert(CIN % TI == 0 && COUT % TO == 0, "tile");
  static_assert(kTiles % 32 == 0 || 32 % kTiles == 0, "warps");

  int tap, rg, ib, ob;
  float acc[TI][TO];

  __device__ __forceinline__ void init(int tid) {
    tap = tid / kLanes;
    const int l = tid % kLanes;
    rg = l / kTiles;
    ib = (l % kTiles) / NOB;
    ob = (l % kTiles) % NOB;
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TO; ++j) acc[i][j] = 0.0f;
  }

  template <int RS, int GS>
  __device__ __forceinline__ void run(const int* list, int cnt, const float* rows,
                                      const float* g) {
#pragma unroll 4
    for (int p = rg; p < cnt; p += RG) {
      const int e = list[p];
      const float* a = rows + (e >> 8) * RS;
      const float* w = g + (e & 0xff) * GS;
      float av[TI], gv[TO];
#pragma unroll
      for (int q = 0; q < TI / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(a + 4 * (ib + NIB * q));
        av[4 * q] = v.x;
        av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z;
        av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TO / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(w + 4 * (ob + NOB * q));
        gv[4 * q] = v.x;
        gv[4 * q + 1] = v.y;
        gv[4 * q + 2] = v.z;
        gv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] = __fmaf_rn(av[i], gv[j], acc[i][j]);
    }
  }

  // Sums the row groups (every thread calls it), then writes this thread's
  // tile of the tap's Cin x Cout slab when `write`.
  __device__ __forceinline__ void store(float* slab, bool write) {
#pragma unroll
    for (int s = RG / 2; s >= 1; s /= 2)
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j)
          acc[i][j] += __shfl_down_sync(0xffffffffu, acc[i][j], s * kTiles);
    if (!write || rg != 0) return;
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      float* o = slab + (4 * (ib + NIB * (i / 4)) + i % 4) * COUT;
#pragma unroll
      for (int q = 0; q < TO / 4; ++q)
        *reinterpret_cast<float4*>(o + 4 * (ob + NOB * q)) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
  }
};

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 operands: hi = x rounded to TF32, lo = the rest
// rounded again.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8) * b (8 x 8), TF32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (b) 3xTF32 on mma.sync m16n8k8: M = Cin of the tap (padded to 16 with
// zeros at Cin 4), N = Cout, K = the listed rows, padded to 8 with an
// all-zero staged row and g row.  Each operand is split into TF32 hi + lo
// and a product summed as lo*hi + hi*lo + hi*hi (plain TF32 would keep
// about three digits).  A sub-tile's products are summed in a fresh
// fragment and added to the f32 sums with one rounding (FADD), so the
// tensor cores' own accumulation, which does not round to nearest, spans
// one sub-tile only (run over a whole chunk it drifted to 2.7e-5 of max
// |plain| at conv3.1 on SECOND's B8 books on the H100, 2.8e-6 with the
// flush, as FFMA).  Each warp owns a WM x WN tile of one tap; the A
// fragment reads the staged rows transposed (Cin along M).
template <int CIN, int COUT>
struct CoreTf32x3 {
  static constexpr int CINP = CIN < 16 ? 16 : CIN;
  static constexpr int WM = CINP < 32 ? CINP : 32;
  static constexpr int WN = COUT < 32 ? COUT : COUT < 128 ? 32 : 64;
  static constexpr int MT = WM / 16, NTL = WN / 8;
  static constexpr int kWarps = (CINP / WM) * (COUT / WN);   // per tap
  static constexpr int kThreads = kTaps * kWarps * 32;
  static constexpr bool kPad8 = true;

  int tap, lane, m0, n0;
  float acc[MT][NTL][4];

  __device__ __forceinline__ void init(int tid) {
    const int warp = tid / 32;
    lane = tid % 32;
    tap = warp / kWarps;
    m0 = (warp % kWarps) / (COUT / WN) * WM;
    n0 = (warp % kWarps) % (COUT / WN) * WN;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  template <int RS, int GS>
  __device__ __forceinline__ void run(const int* list, int cnt, const float* rows,
                                      const float* g) {
    const int gr = lane / 4, kq = lane % 4;
    float part[MT][NTL][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
    for (int p = 0; p < cnt; p += 8) {
      const int e0 = list[p + kq];
      const int e1 = list[p + kq + 4];
      const float* a0 = rows + (e0 >> 8) * RS;
      const float* a1 = rows + (e1 >> 8) * RS;
      const float* g0 = g + (e0 & 0xff) * GS;
      const float* g1 = g + (e1 & 0xff) * GS;
      unsigned ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = m0 + 16 * mt + gr;
        const float x[4] = {m < CIN ? a0[m] : 0.0f, m + 8 < CIN ? a0[m + 8] : 0.0f,
                            m < CIN ? a1[m] : 0.0f, m + 8 < CIN ? a1[m + 8] : 0.0f};
#pragma unroll
        for (int u = 0; u < 4; ++u) split_tf32(x[u], ahi[mt][u], alo[mt][u]);
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int n = n0 + 8 * nt + gr;
        unsigned bhi0, blo0, bhi1, blo1;
        split_tf32(g0[n], bhi0, blo0);
        split_tf32(g1[n], bhi1, blo1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(part[mt][nt], alo[mt], bhi0, bhi1);
          mma_tf32(part[mt][nt], ahi[mt], blo0, blo1);
          mma_tf32(part[mt][nt], ahi[mt], bhi0, bhi1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // fragment layout: acc[mt][nt][0..1] at (row gr, cols 2 (lane % 4) + 0..1),
  // [2..3] eight rows below
  __device__ __forceinline__ void store(float* slab, bool write) {
    if (!write) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * mt + lane / 4 + 8 * h;
        if (m >= CIN) continue;
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
          *reinterpret_cast<float2*>(slab + m * COUT + n0 + 8 * nt + 2 * (lane % 4)) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  }
};

// The core of an instance: the faster of the two on the H100 at SECOND's
// shapes (gather_dw_ab.py; PERF.md section 6), except 64 -> 128, whose
// 3xTF32 instance spills (168 registers at 384 threads).  -DPCDET_DW_CORE=0
// or 1 builds every instance with one core, for that comparison.
template <int CIN, int COUT, int MODE>
struct PickCore {
#ifdef PCDET_DW_CORE
  static constexpr int value = PCDET_DW_CORE;
#else
  static constexpr int value = (CIN == 64 && COUT == 64) ||
                                       (MODE == kRules && CIN == 32 && COUT == 64)
                                   ? kTf32x3
                                   : kFfma;
#endif
};

// Shared layout of an instance, per stage (two stages): the rules or
// selectors [3][64] ints, the lists [3][64], the counts [4]; the g rows
// [65][GS] floats (row 64 zeros); the staged table rows [slots][RS] (the
// last slot zeros), in kRowStages stages.  Strides keep every row 16-byte
// aligned.  Two row stages where they fit a block with D''s staging at S
// = 256 (ops/gather_xwin.py SEG_S): every instance but (128, 64), whose
// 528-byte rows take one; it stages sub-tile t + 1's rows after the
// barrier that ends t's multiply instead of during it.
// ops/gather_dw.py:smem_bytes mirrors it.
constexpr long long kSmemLimit = 232448;   // a block's shared memory on sm_90
constexpr int kSegS = 256;

template <int CIN, int COUT, int MODE>
struct Cfg {
  static constexpr int kCore = PickCore<CIN, COUT, MODE>::value;
  using CoreT = typename std::conditional<kCore == kTf32x3, CoreTf32x3<CIN, COUT>,
                                          CoreFfma<CIN, COUT>>::type;
  static constexpr int kThreads = CoreT::kThreads;
  static constexpr int RS = CIN < 32 ? CIN : CIN + 4;
  static constexpr int GS = COUT + 4;
  static constexpr int kInts = 2 * (2 * kTaps * kRows + 4);
  static constexpr int kRowStages =
      4LL * kInts + 8LL * ((kRows + 1) * GS + gather_common::staged_rows(kSegS) * RS) <=
              kSmemLimit
          ? 2
          : 1;
  __host__ __device__ static int slots(int seg_rows) {
    return MODE == kRules ? kTaps * kRows + 1
                          : gather_common::staged_rows(MODE == kSegment ? seg_rows : 0);
  }
  static size_t smem_bytes(int seg_rows) {
    return sizeof(int) * kInts +
           sizeof(float) * (2 * (kRows + 1) * GS + kRowStages * slots(seg_rows) * RS);
  }
};

// Pass 1 of D (MODE kRules: idx = rules (B, V_out, K), n_idx = K, tap
// block j = blockIdx.y) or of D'' / D' (kWindow / kSegment: idx = base,
// sel (B, V_out, G), n_idx = G, tap group j = blockIdx.y).  The block's
// kernel is launched with Cfg::kThreads threads and Cfg::smem_bytes(S)
// bytes of dynamic shared memory; grid (n_chunks, blocks, B).
template <int CIN, int COUT, int MODE>
__device__ __forceinline__ void partial_body(
    const float* __restrict__ feats, const int* __restrict__ idx, const int* __restrict__ sel,
    const float* __restrict__ g, const int* __restrict__ n_live, float* __restrict__ partial,
    unsigned long long* __restrict__ tally, int v_in1, int v_out, int n_idx, int chunk_rows,
    int seg_rows) {
  using C = Cfg<CIN, COUT, MODE>;
  using CoreT = typename C::CoreT;
  constexpr int NT = C::kThreads, RS = C::RS, GS = C::GS;
  constexpr int QF = CIN / 4, QG = COUT / 4;            // 16-byte copies a row
  constexpr int kStageInts = kTaps * kRows;
  extern __shared__ __align__(16) float smem[];
  const int n_slots = C::slots(seg_rows);
  int* s_meta = reinterpret_cast<int*>(smem);            // [2][3][64]
  int* s_list = s_meta + 2 * kStageInts;                 // [2][3][64]
  int* s_cnt = s_list + 2 * kStageInts;                  // [2][4]
  float* s_g = smem + C::kInts;                          // [2][65][GS]
  float* s_rows = s_g + 2 * (kRows + 1) * GS;            // [kRowStages][slots][RS]

  const int chunk = blockIdx.x;
  const int blk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int live = min(max(n_live[b], 0), v_out);
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(row_begin + chunk_rows, live);
  const int n_tiles = row_end > row_begin ? (row_end - row_begin + kRows - 1) / kRows : 0;
  const int taps = MODE == kRules ? min(kTaps, n_idx - kTaps * blk) : kTaps;
  const float* feats_b = feats + static_cast<long long>(b) * v_in1 * CIN;
  const float* g_b = g + static_cast<long long>(b) * v_out * COUT;
  const long long idx_b = static_cast<long long>(b) * v_out * n_idx;
  const int zero_entry = ((n_slots - 1) << 8) | kRows;

  // the zero rows of every row stage (read only by padded list entries)
  for (int e = tid; e < C::kRowStages * RS; e += NT)
    s_rows[(e / RS) * n_slots * RS + (n_slots - 1) * RS + e % RS] = 0.0f;
  for (int e = tid; e < 2 * GS; e += NT) s_g[(e / GS) * (kRows + 1) * GS + kRows * GS + e % GS] = 0.0f;

  CoreT core;
  core.init(tid);

  // sub-tile t's rules or selectors into meta slot t % 2 (selectors of rows
  // at or past V_out as kNoTap)
  auto fetch_meta = [&](int t) {
    int* m = s_meta + (t & 1) * kStageInts;
    const int row0 = row_begin + t * kRows;
    if (MODE == kRules) {
      const int n = min(kRows, row_end - row0);
      for (int e = tid; e < n * taps; e += NT) {
        const int r = e / taps;
        const int d = e - r * taps;
        cp_async4(m + d * kRows + r,
                  idx + idx_b + static_cast<long long>(row0 + r) * n_idx + kTaps * blk + d);
      }
    } else {
      for (int r = tid; r < kRows; r += NT) {
        if (row0 + r < v_out) {
          const long long o = idx_b + static_cast<long long>(row0 + r) * n_idx + blk;
          cp_async4(m + r, idx + o);
          cp_async4(m + kRows + r, sel + o);
        } else {
          m[r] = 0;
          m[kRows + r] = kNoTap;
        }
      }
    }
  };

  // sub-tile t's table rows into row stage t % kRowStages, its g rows into
  // stage t % 2 and its lists, from its rules or selectors in meta slot t % 2
  auto stage = [&](int t) {
    const int* m = s_meta + (t & 1) * kStageInts;
    int* list = s_list + (t & 1) * kStageInts;
    float* rows = s_rows + (C::kRowStages == 2 ? t & 1 : 0) * n_slots * RS;
    float* gs = s_g + (t & 1) * (kRows + 1) * GS;
    const int row0 = row_begin + t * kRows;
    const int n = min(kRows, row_end - row0);
    bool covered = false;
    int anchor = 0;
    if (MODE == kSegment) {      // the descriptors: every row below V_out
      int lo = INT_MAX, hi = -1;
      for (int r = lane; r < kRows; r += 32) {
        if (m[kRows + r] != kNoTap) {
          lo = min(lo, m[r]);
          hi = max(hi, m[r] + 3);
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      anchor = lo == INT_MAX ? 0 : lo;
      covered = hi - anchor <= seg_rows;
      if (tid == 0) atomicAdd(&tally[covered ? 0 : 1], 1ULL);
      if (covered) {
        for (int e = tid; e < (hi - anchor) * QF; e += NT) {
          const int src = anchor + e / QF;
          if (src < v_in1)
            cp_async16(rows + (e / QF) * RS + 4 * (e % QF),
                       feats_b + static_cast<long long>(src) * CIN + 4 * (e % QF));
        }
      }
    }
    if (MODE == kRules) {
      for (int e = tid; e < taps * kRows * QF; e += NT) {
        const int slot = e / QF;
        const int r = slot % kRows;
        const int x = m[slot];
        if (r < n && static_cast<unsigned>(x) < static_cast<unsigned>(v_in1 - 1))
          cp_async16(rows + slot * RS + 4 * (e % QF),
                     feats_b + static_cast<long long>(x) * CIN + 4 * (e % QF));
      }
    } else if (!covered) {
      for (int e = tid; e < kTaps * kRows * QF; e += NT) {
        const int slot = e / QF;
        const int r = slot / 3;
        const int j = slot - 3 * r;
        if (r >= n) continue;
        const int sl = m[kRows + r];
        const int src = m[r] + j;
        if (((sl & 3) == j || ((sl >> 2) & 3) == j || ((sl >> 4) & 3) == j) && src < v_in1)
          cp_async16(rows + slot * RS + 4 * (e % QF),
                     feats_b + static_cast<long long>(src) * CIN + 4 * (e % QF));
      }
    }
    for (int e = tid; e < n * QG; e += NT)
      cp_async16(gs + (e / QG) * GS + 4 * (e % QG),
                 g_b + static_cast<long long>(row0 + e / QG) * COUT + 4 * (e % QG));
    if (warp < kTaps) {          // warp d lists tap d: ballot, popcount prefix
      const int d = warp;
      int count = 0;
#pragma unroll
      for (int h = 0; h < kRows; h += 32) {
        const int r = h + lane;
        bool found = false;
        int slot = 0;
        if (r < n && d < taps) {
          if (MODE == kRules) {
            found = static_cast<unsigned>(m[d * kRows + r]) < static_cast<unsigned>(v_in1 - 1);
            slot = d * kRows + r;
          } else {
            const int off = (m[kRows + r] >> (2 * d)) & 3;
            found = off != 3;
            slot = (covered ? m[r] - anchor : 3 * r) + off;
          }
        }
        const unsigned ball = __ballot_sync(0xffffffffu, found);
        if (found) list[d * kRows + count + __popc(ball & ((1u << lane) - 1u))] = (slot << 8) | r;
        count += __popc(ball);
      }
      if (CoreT::kPad8) {
        const int padded = (count + 7) & ~7;
        if (lane < padded - count) list[d * kRows + count + lane] = zero_entry;
        count = padded;
      }
      if (lane == 0) s_cnt[(t & 1) * 4 + d] = count;
    }
  };

  if (n_tiles > 0) {
    fetch_meta(0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    stage(0);
    if (n_tiles > 1) fetch_meta(1);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // t's rows, g rows, lists and t + 1's meta are in; t - 1 is consumed
    if (C::kRowStages == 2 && t + 1 < n_tiles) stage(t + 1);
    if (t + 2 < n_tiles) fetch_meta(t + 2);
    cp_async_commit();
    const int s = t & 1;
    if (core.tap < taps)
      core.template run<RS, GS>(s_list + s * kStageInts + core.tap * kRows,
                                s_cnt[s * 4 + core.tap],
                                s_rows + (C::kRowStages == 2 ? s : 0) * n_slots * RS,
                                s_g + s * (kRows + 1) * GS);
    if (C::kRowStages == 1 && t + 1 < n_tiles) {
      __syncthreads();   // t's rows are consumed: the one row stage takes t + 1's
      stage(t + 1);
      cp_async_commit();
    }
  }

  const int k_total = MODE == kRules ? n_idx : kTaps * n_idx;
  const int k = kTaps * blk + core.tap;
  core.store(partial + ((static_cast<long long>(b) * gridDim.x + chunk) * k_total + k) *
                           (CIN * COUT),
             core.tap < taps);
}

// out[e] = sum_p partial[p, e] in a fixed order: a block takes
// kReduceThreads / kSplit consecutive elements, its thread (j, e) sums
// parts j, j + kSplit, j + 2 kSplit, ... in order, and the kSplit sums are
// added in order of j (kSplit loads of each element in flight, not one).
constexpr int kReduceThreads = 256;
constexpr int kSplit = 8;
constexpr int kReduceElems = kReduceThreads / kSplit;

__global__ void __launch_bounds__(kReduceThreads)
sum_partials(const float* __restrict__ partial, float* __restrict__ out,
             int n_parts, int n_elems) {
  __shared__ float s_sum[kSplit][kReduceElems];
  const int el = threadIdx.x % kReduceElems;
  const int j = threadIdx.x / kReduceElems;
  const int e = blockIdx.x * kReduceElems + el;
  float s = 0.0f;
  if (e < n_elems)
    for (int p = j; p < n_parts; p += kSplit) s += partial[static_cast<long long>(p) * n_elems + e];
  s_sum[j][el] = s;
  __syncthreads();
  if (j != 0 || e >= n_elems) return;
  for (int q = 1; q < kSplit; ++q) s += s_sum[q][el];
  out[e] = s;
}

inline int launch_sum_partials(const float* partial, float* out, int n_parts,
                               int n_elems, cudaStream_t stream) {
  sum_partials<<<(n_elems + kReduceElems - 1) / kReduceElems, kReduceThreads, 0,
                 stream>>>(partial, out, n_parts, n_elems);
  return static_cast<int>(cudaGetLastError());
}


// Sets the kernel's dynamic shared memory; launches pass 1 on grid
// (n_chunks, blocks, b), then pass 2 over b * n_chunks partials of
// k_total * Cin * Cout floats.  Returns a cudaError_t.
template <int CIN, int COUT, int MODE, typename Kernel, typename... Args>
int launch_two_pass(Kernel kernel, int seg_rows, int n_chunks, int blocks, int b, int k_total,
                    const float* partial, float* out, cudaStream_t stream, Args... args) {
  using C = Cfg<CIN, COUT, MODE>;
  const size_t smem = C::smem_bytes(seg_rows);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_chunks, blocks, b), C::kThreads, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partial, out, b * n_chunks,
                                            k_total * CIN * COUT, stream);
}

// Blocks of the kernel resident on the current device at once (SMs times
// blocks per SM), or minus a cudaError_t.
template <int CIN, int COUT, int MODE, typename Kernel>
int resident_blocks(Kernel kernel, int seg_rows) {
  using C = Cfg<CIN, COUT, MODE>;
  const size_t smem = C::smem_bytes(seg_rows);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

}  // namespace dw_common
