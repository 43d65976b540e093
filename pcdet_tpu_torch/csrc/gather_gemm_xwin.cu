// Gather-GEMM of the kw=3 sparse convolutions by x-window and segment
// loads (kernels E and E'), for sm_90a.
//
// Replaces two TPU kernels of pcdet_tpu/ops/pallas/gather_gemm.py:
//   E   _gather_matmul_xwin_call (:272, pallas_call :287; bodies _kernel_xwin,
//       _kernel_xwin_packed): one (3, Cin) window load per (output row, tap
//       group), 2-bit selects;
//   E'  _gather_matmul_seg_call (:493, pallas_call :507; body _kernel_seg):
//       one (S, Cin) segment load per (64-row tile, tap group), 10-bit
//       offsets into it, and E's per-row windows where the tile's span
//       exceeds S.
// Both compute kernel B's / C's function (csrc/gather_gemm.cu) over a kw=3
// book given as selectors instead of rules.  A tap group g is the three
// x-taps 3g, 3g+1, 3g+2 of one (dz, dy): its found rows lie in three
// consecutive rows of the sorted table, base[b, v, g] .. base + 2, and bits
// 2dx..2dx+1 of sel[b, v, g] give the window row of x-tap dx (3: a miss;
// 0x3f: a row with no tap of the group).
//
// Contract, per sample b of a batch of B:
//   out[b, v, :] = sum_g sum_dx feats[b, base + off_dx, :] @ W[3g + dx]  (f32)
// feats (B, V_in + 1, Cin), row V_in all zeros; base, sel (B, V_out, G)
// int32; W (3G, Cin, Cout); n_live (B,) int32 on the device.  Rows at or
// past n_live are written as zeros and read nothing.  A window row at or
// past V_in is a miss: the table is not padded.
//
// One core for both, the staging step its only difference.  A block owns
// a tile of 64 rows (the unit of pcdet_tpu's segment descriptors) of one
// sample.  It stages the selectors of every group of its rows at once, and
// one warp per group reduces them with warp reductions to the
// group's anchor (the least base over the tile's rows below V_out with a
// tap of the group), its span (the greatest base + 3, less the anchor) and
// whether a live row finds the group.  Then it walks the found groups'
// x-taps, in increasing order, through a cp.async pipeline with one
// __syncthreads per x-tap: W[k] in a three-stage ring of its own, and the
// rows a group reads in a two-stage ring, fetched two x-taps ahead with the
// group's first x-tap, so that the next group's rows and W land while the
// block computes.  Per (tile, group) the rows are staged once for its
// three x-taps:
//   E   per live row, the window rows one of its taps selects (slots
//       3 r .. 3 r + 2 of the tile);
//   E'  where the span is at most S, the span's rows, each copied once
//       (slots 0 .. span - 1); else E's windows.  The branch is counted per
//       (tile, group) of every tile below n_live in tally[0] (segment) /
//       tally[1] (window), as pcdet_tpu's segment_desc decides it.  S is
//       at most the instance's max_seg_rows (two stages of S rows and the
//       W ring fit a block's 227 KB; 336 to 1022 rows).
// 16-byte copies (8 for bf16 Cin = 4); a miss, a row at or past V_in, is
// neither copied nor read: it is routed to one all-zero row.  Staged rows
// keep their type, row-major, padded to an odd number of 16-byte units
// where readers span several rows.  A group no live row of the block
// finds is skipped, and an x-tap no row of a warp finds is skipped by the
// warp: both are exact, by kernel B's argument (the products skipped are
// (+0) * w; gather_gemm.cu).
//   f32: kernel B's arithmetic.  Each thread keeps 4 rows x 4 columns of
//       sums and reads rows and W as float4s from shared memory; per x-tap
//       its rows are routed once to a staged row.  The order is B's: taps
//       k = 3g + dx increasing, channels increasing inside a tap, one
//       __fmaf_rn each from +0, so E and E' f32 give kernel B's bits on the
//       same book.
//   bf16: kernel C's arithmetic.  A warp owns 16 rows; mma.sync m16n8k16
//       bf16 -> f32, the rows through ldmatrix (lane l points at the staged
//       row that x-tap dx of row l % 16 selects, or at the zero row, so the
//       gather out of the segment costs nothing), W through ldmatrix.trans.
//       Per x-tap a fresh fragment sums the Cin / 16 k-steps in increasing
//       order and is added to the f32 sums with one rounding; Cin = 4 is
//       padded to 16 with zeros.  So E and E' bf16 give kernel C's bits.
// No atomics in any sum: two launches give the same bits.
//
// What bounds it: per x-tap a block meets one barrier and waits on its
// copies; f32 issues 8 FMAs per shared load, as kernel B at Cout < 64.
// E' reads each table row of a span once per three x-taps, where B and C
// read it once per tap; E reads as many rows as B and C less the zero
// rows.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (gather_gemm_ab.py
// --xwin, device time, SECOND's conv2_1 at B2 on the train book, 32 -> 32):
// E' f32 0.114 ms (0.182 before; B 0.116), E f32 0.127 (0.222); on the eval
// book E' bf16 0.042 (0.210; C 0.043), E bf16 0.051 (0.253).  Over the 11
// kw=3 convs at B2: E' bf16 0.43 ms per detect batch (C 0.47), E' f32 2.68
// ms per train step's forward and feature gradient (B 2.90); PERF.md
// section 6.
//
// xwin_selectors_kernel builds a book's selectors from its rules on the
// card, in one pass (one thread per (row, group)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "gather_common.cuh"
#include "gather_ptx.cuh"

namespace {

using gather_common::kNoTap;
using gather_common::kTileRows;
using gather_common::kWindowRows;
using gather_ptx::cp_async;
using gather_ptx::cp_async_commit;
using gather_ptx::cp_async_wait;
using gather_ptx::ldsm_x4;
using gather_ptx::ldsm_x4_trans;
using gather_ptx::mma_bf16;
using gather_ptx::smem_u32;

constexpr int kThreads = 256;            // the selector kernel's block
constexpr long long kSmemLimit = 232448; // a block's shared memory on sm_90
constexpr int kMaxGroups = 21;
constexpr int kMaxSegRows = 1022;        // 10-bit offsets, 1023 a miss
constexpr int kSegS = 256;               // ops/gather_xwin.py SEG_S: every instance takes it
constexpr int kHeader = 16;              // the found-group mask, 16-byte aligned

// Shared layout of an instance, T = float (f32) or __nv_bfloat16 (bf16);
// ops/gather_xwin.py:smem_bytes mirrors it.
//   header 16 | W ring [WS][CinS][W row] | zero row | rows [RS][slots][row]
//   | base, sel [64][G] ints | anchor, span [G] ints
// WS = 3 W stages and RS = 2 row stages where they fit a block at S = 256
// and 21 groups: every instance but f32 (128, 64) and (64, 128), whose 32
// KB of W an x-tap (and 512- or 256-byte rows) do not; they take WS = 2
// and RS = 1, and stage a group's rows after the barrier of the group's
// first x-tap instead of two x-taps ahead.
// One 64-row tile a block: blocks of two or four tiles (more threads, more
// shared memory, fewer blocks an SM) timed slower on SECOND's shapes.
template <typename T, int CIN, int COUT>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kCin = CIN, kCout = COUT;
  static constexpr int kCinS = kBf16 && CIN < 16 ? 16 : CIN;      // staged channels
  // f32: a thread's sums, 4 rows x 4 columns (8 at Cout 128, so that a
  // block stays at 256 threads)
  static constexpr int kRT = 4, kCT = COUT >= 128 ? 8 : 4;
  static constexpr int kCG = COUT / kCT, kRG = kTileRows / kRT;
  static constexpr int kThreads = kBf16 ? kTileRows / 16 * 32 : kCG * kRG;
  static constexpr bool kPad = kBf16 || kCG < 8;                  // readers span rows
  static constexpr int kRowRaw = kCinS * static_cast<int>(sizeof(T));
  static constexpr int kRowBytes = kPad && kRowRaw > 16 ? kRowRaw + 16 : kRowRaw;
  static constexpr int kWRowBytes = COUT * static_cast<int>(sizeof(T)) + (kBf16 ? 16 : 0);
  static constexpr int kWBytes = kCinS * kWRowBytes;
  static constexpr bool kTwoRowStages =
      kHeader + 3LL * kWBytes + kRowBytes + 4LL * kMaxGroups * (2 * kTileRows + 2) +
          2LL * kSegS * kRowBytes <=
      kSmemLimit;
  static constexpr int kWStages = kTwoRowStages ? 3 : 2;    // W ring, in x-taps
  static constexpr int kRowStages = kTwoRowStages ? 2 : 1;
  static constexpr int kCopyBytes = CIN * static_cast<int>(sizeof(T)) < 16 ? 8 : 16;
  static constexpr int kRowCopies = CIN * static_cast<int>(sizeof(T)) / kCopyBytes;
  static constexpr int kWRowCopies = COUT * static_cast<int>(sizeof(T)) / 16;

  __host__ __device__ static constexpr int slots(int seg_rows) {
    return seg_rows > kWindowRows ? seg_rows : kWindowRows;
  }
  __host__ __device__ static constexpr long long fixed_bytes(int groups) {
    return kHeader + kWStages * kWBytes + kRowBytes + 4LL * groups * (2 * kTileRows + 2);
  }
  __host__ __device__ static constexpr long long smem_bytes(int seg_rows, int groups) {
    return fixed_bytes(groups) + 1LL * kRowStages * slots(seg_rows) * kRowBytes;
  }
  // the most segment rows the instance stages at any G
  __host__ __device__ static constexpr int max_seg_rows() {
    return (kSmemLimit - fixed_bytes(kMaxGroups)) / (1LL * kRowStages * kRowBytes) > kMaxSegRows
               ? kMaxSegRows
               : static_cast<int>((kSmemLimit - fixed_bytes(kMaxGroups)) /
                                  (1LL * kRowStages * kRowBytes));
  }
  static_assert(kThreads <= 256 && kThreads % 32 == 0, "threads");
};

// Writes zeros to rows [row0, min(row0 + rows, v_out)) of out_b.
template <int COUT>
__device__ __forceinline__ void zero_rows(float* out_b, int row0, int rows, int v_out) {
  for (int e = threadIdx.x; e < rows * COUT / 4; e += blockDim.x) {
    const int r = row0 + e / (COUT / 4);
    if (r < v_out) {
      reinterpret_cast<float4*>(out_b + static_cast<long long>(r) * COUT)[e % (COUT / 4)] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The f32 core, kernel B's arithmetic: each thread keeps RT rows x CT
// columns of sums (rows RT rg .. RT rg + RT - 1, columns as float4s
// interleaved over the CG column groups) and reads its rows and W as
// float4s, one __fmaf_rn per product, channels increasing inside an x-tap.
template <typename L>
struct CoreF32 {
  static constexpr int CIN = L::kCin, COUT = L::kCout;
  static constexpr int RT = L::kRT, CT = L::kCT, CG = L::kCG;
  int cg, rg;
  float acc[RT][CT];
  int idx[3][RT];       // per x-tap, the byte offset of each row's staged row
  bool any[3];          // whether a row of the warp finds the x-tap

  __device__ __forceinline__ void init(int tid) {
    cg = tid % CG;
    rg = tid / CG;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
  }

  // route(r, off, hit) gives tile row r's staged rows of the group
  template <typename Route>
  __device__ __forceinline__ void route_group(Route&& route) {
    bool mine[3] = {false, false, false};
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      int off[3];
      bool hit[3];
      route(rg * RT + i, off, hit);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        idx[d][i] = off[d];
        mine[d] |= hit[d];
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) any[d] = __any_sync(0xffffffffu, mine[d]);
  }

  // x-tap dx of the group, W[3g + dx] at w
  __device__ __forceinline__ void step(int dx, const unsigned char* smem, const unsigned char* w) {
    if (!(dx == 0 ? any[0] : dx == 1 ? any[1] : any[2])) return;
    int cur[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) cur[i] = dx == 0 ? idx[0][i] : dx == 1 ? idx[1][i] : idx[2][i];
    const float* sw = reinterpret_cast<const float*>(w);
#pragma unroll 2
    for (int q = 0; q < CIN / 4; ++q) {
      float4 a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = *reinterpret_cast<const float4*>(smem + cur[i] + 16 * q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float bw[CT];
#pragma unroll
        for (int j = 0; j < CT / 4; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(sw + (4 * q + u) * COUT + 4 * (cg + CG * j));
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

  __device__ __forceinline__ void store(float* out_b, int row0, int live, int v_out) const {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = row0 + rg * RT + i;
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
};

// The bf16 core, kernel C's arithmetic: a warp owns 16 rows x Cout; per
// x-tap a fresh fragment sums the CinS / 16 k-steps (mma.sync m16n8k16,
// rows through ldmatrix, W through ldmatrix.trans) and is added to the f32
// sums with one rounding.
template <typename L>
struct CoreBf16 {
  static constexpr int COUT = L::kCout, CINS = L::kCinS;
  static constexpr int NB = COUT / 8;                   // n8 blocks per warp
  static constexpr int NC = NB < 4 ? NB : 4;            // summed per x-tap at once
  int warp, lane;
  float acc[NB][4];
  int idx[3];           // per x-tap, the byte offset of this lane's row's staged row
  bool any[3];

  __device__ __forceinline__ void init(int tid) {
    warp = tid / 32;
    lane = tid % 32;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }

  // lane l points at row l % 16 of the warp's 16 rows
  template <typename Route>
  __device__ __forceinline__ void route_group(Route&& route) {
    bool hit[3];
    route(warp * 16 + lane % 16, idx, hit);
#pragma unroll
    for (int d = 0; d < 3; ++d) any[d] = __any_sync(0xffffffffu, hit[d]);
  }

  __device__ __forceinline__ void step(int dx, const unsigned char* smem, const unsigned char* w) {
    if (!(dx == 0 ? any[0] : dx == 1 ? any[1] : any[2])) return;
    const unsigned sa =
        smem_u32(smem) + (dx == 0 ? idx[0] : dx == 1 ? idx[1] : idx[2]) + (lane / 16) * 16;
    const unsigned sb = smem_u32(w) + (lane % 16) * L::kWRowBytes + (lane / 16) * 16;
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += NC) {
      float tap[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tap[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < CINS / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, sa + kk * 32);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          unsigned bf[4];
          ldsm_x4_trans(bf, sb + kk * 16 * L::kWRowBytes + (n0 / 2 + np) * 32);
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

  // fragment layout: acc[j][0..1] at (row lane / 4, cols 8 j + 2 (lane %
  // 4) + 0..1), acc[j][2..3] eight rows below
  __device__ __forceinline__ void store(float* out_b, int row0, int live, int v_out) const {
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
};

template <typename L, typename T, bool SEG>
__global__ void __launch_bounds__(L::kThreads, 1)
gather_gemm_xwin_kernel(const T* __restrict__ feats, const int* __restrict__ base,
                        const int* __restrict__ sel, const T* __restrict__ w,
                        const int* __restrict__ n_live, float* __restrict__ out,
                        unsigned long long* __restrict__ tally, int v_in1, int v_out,
                        int groups, int seg_rows) {
  constexpr int CIN = L::kCin, COUT = L::kCout;
  constexpr int NT = L::kThreads, ROWS = kTileRows;
  constexpr int RB = L::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slots = L::slots(SEG ? seg_rows : 0);
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem);
  unsigned char* s_w = smem + kHeader;                               // [3][CinS][W row]
  unsigned char* s_zero = s_w + L::kWStages * L::kWBytes;            // one row
  unsigned char* s_rows = s_zero + RB;                               // [2][slots][RB]
  int* s_base = reinterpret_cast<int*>(s_rows + L::kRowStages * slots * RB);  // [64][G]
  int* s_sel = s_base + ROWS * groups;                               // [64][G]
  int* s_anc = s_sel + ROWS * groups;                                // [G]
  int* s_spn = s_anc + groups;                                       // [G]
  const int stage_bytes = slots * RB;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int live = min(max(n_live[b], 0), v_out);
  const int v_in = v_in1 - 1;
  float* out_b = out + static_cast<long long>(b) * v_out * COUT;
  if (row0 >= live) {                                    // dead tile: zeros only
    zero_rows<COUT>(out_b, row0, ROWS, v_out);
    return;
  }

  // the zero row; for bf16 Cin = 4 every staged row's pad channels and W's
  // pad rows, which the copies never write
  if (L::kBf16 && L::kCinS != CIN) {
    uint4* z = reinterpret_cast<uint4*>(s_w);
    for (int e = tid; e < (L::kWStages * L::kWBytes + RB + L::kRowStages * stage_bytes) / 16;
         e += NT)
      z[e] = make_uint4(0, 0, 0, 0);
  } else {
    for (int e = tid; e < RB / 16; e += NT)
      reinterpret_cast<uint4*>(s_zero)[e] = make_uint4(0, 0, 0, 0);
  }
  // the selectors of every group of the tile's rows (rows at or past
  // V_out: no tap)
  {
    const long long o = (static_cast<long long>(b) * v_out + row0) * groups;
    const int n = (min(v_out - row0, ROWS)) * groups;
    for (int e = tid; e < ROWS * groups; e += NT) {
      const bool in = e < n;
      s_base[e] = in ? base[o + e] : 0;
      s_sel[e] = in ? sel[o + e] : kNoTap;
    }
  }
  if (tid == 0) *s_mask = 0;
  __syncthreads();

  // per group: anchor and span over the tile's rows below V_out with a
  // tap, whether a live row finds the group, the branch
  {
    unsigned long long n_seg = 0, n_win = 0;
    for (int g = warp; g < groups; g += NT / 32) {
      int lo = INT_MAX, hi = -1;
      bool act = false;
#pragma unroll
      for (int h = 0; h < ROWS; h += 32) {
        const int r = h + lane;
        const int sl = s_sel[r * groups + g];
        if (sl != kNoTap) {
          const int bs = s_base[r * groups + g];
          lo = min(lo, bs);
          hi = max(hi, bs + 3);
          act |= row0 + r < live;
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      act = __any_sync(0xffffffffu, act);
      const int anchor = lo == INT_MAX ? 0 : lo;
      const bool covered = SEG && hi - anchor <= seg_rows;
      if (lane == 0) {
        s_anc[g] = covered ? anchor : -1;
        s_spn[g] = hi - anchor;
        if (act) atomicOr(s_mask, 1u << g);
        if (SEG) (covered ? n_seg : n_win) += 1;
      }
    }
    if (SEG && lane == 0) {
      if (n_seg) atomicAdd(&tally[0], n_seg);
      if (n_win) atomicAdd(&tally[1], n_win);
    }
  }
  __syncthreads();
  const unsigned found = *s_mask;
  const int n_steps = 3 * __popc(found);

  const T* feats_b = feats + static_cast<long long>(b) * v_in1 * CIN;
  // the rows group g reads, into a row stage
  auto fetch_rows = [&](int g, unsigned char* stage) {
    constexpr int RC = L::kRowCopies, CB = L::kCopyBytes;
    constexpr int kElems = CB / static_cast<int>(sizeof(T));
    const int anc = s_anc[g];
    if (SEG && anc >= 0) {                               // the span, once
      const int span = s_spn[g];
      for (int e = tid; e < span * RC; e += NT) {
        const int r = e / RC;
        const int q = e - r * RC;
        const int src = anc + r;
        if (src < v_in)
          cp_async<CB>(stage + r * RB + q * CB,
                       feats_b + static_cast<long long>(src) * CIN + q * kElems, CB);
      }
    } else {                                             // per row, its window
      for (int e = tid; e < kWindowRows * RC; e += NT) {
        const int slot = e / RC;
        const int q = e - slot * RC;
        const int r = slot / 3;
        const int j = slot - 3 * r;
        if (row0 + r >= live) continue;
        const int sl = s_sel[r * groups + g];
        const int src = s_base[r * groups + g] + j;
        if (((sl & 3) == j || ((sl >> 2) & 3) == j || ((sl >> 4) & 3) == j) && src < v_in)
          cp_async<CB>(stage + slot * RB + q * CB,
                       feats_b + static_cast<long long>(src) * CIN + q * kElems, CB);
      }
    }
  };
  // step u: W[3g + dx] into W stage u % WS and, with the group's first
  // x-tap, the rows group g reads into row stage (u / 3) % 2 (RS = 2)
  unsigned fetch_pend = found;
  int fetch_g = 0;
  auto fetch = [&](int u) {
    const int dx = u % 3;
    if (dx == 0) {
      fetch_g = __ffs(fetch_pend) - 1;
      fetch_pend &= fetch_pend - 1;
      if (L::kRowStages == 2) fetch_rows(fetch_g, s_rows + ((u / 3) & 1) * stage_bytes);
    }
    const T* wk = w + static_cast<long long>(3 * fetch_g + dx) * CIN * COUT;
    unsigned char* dst = s_w + (u % L::kWStages) * L::kWBytes;
    constexpr int WQ = L::kWRowCopies;
    for (int e = tid; e < CIN * WQ; e += NT) {
      const int c = e / WQ;
      const int q = e - c * WQ;
      cp_async<16>(dst + c * L::kWRowBytes + q * 16,
                   wk + c * COUT + q * (16 / static_cast<int>(sizeof(T))), 16);
    }
  };
#pragma unroll
  for (int u = 0; u < L::kWStages - 1; ++u) {
    if (u < n_steps) fetch(u);
    cp_async_commit();
  }

  // routing of tile row r for group g: the byte offset of the staged row
  // x-tap dx reads (row stage st), or of the zero row
  const int zero_off = static_cast<int>(s_zero - smem);
  auto route = [&](int r, int g, int st, int (&off)[3], bool (&hit)[3]) {
    const int sl = row0 + r < live ? s_sel[r * groups + g] : kNoTap;
    const int bs = s_base[r * groups + g];
    const int anc = SEG ? s_anc[g] : -1;
    const int first = anc >= 0 ? bs - anc : 3 * r;
    const int rows_off = static_cast<int>(s_rows - smem) + st * stage_bytes;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int o = (sl >> (2 * dx)) & 3;
      hit[dx] = o != 3 && bs + o < v_in;
      off[dx] = hit[dx] ? rows_off + (first + o) * RB : zero_off;
    }
  };

  using Core = typename std::conditional<L::kBf16, CoreBf16<L>, CoreF32<L>>::type;
  Core core;
  core.init(tid);
  unsigned comp_pend = found;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<L::kWStages - 2>();
    __syncthreads();              // step s landed; the stages of step s - 1 are free
    if (L::kRowStages == 1 && s % 3 == 0) {  // the one row stage is free: fill it
      fetch_rows(__ffs(comp_pend) - 1, s_rows);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (s + L::kWStages - 1 < n_steps) fetch(s + L::kWStages - 1);
    cp_async_commit();
    const int dx = s % 3;
    if (dx == 0) {
      const int g = __ffs(comp_pend) - 1;
      comp_pend &= comp_pend - 1;
      core.route_group([&](int r, int (&off)[3], bool (&hit)[3]) {
        route(r, g, L::kRowStages == 2 ? (s / 3) & 1 : 0, off, hit);
      });
    }
    core.step(dx, smem, s_w + (s % L::kWStages) * L::kWBytes);
  }
  core.store(out_b, row0, live, v_out);
}

template <typename T, int CIN, int COUT, bool SEG>
int launch(const void* feats, const int* base, const int* sel, const void* w,
           const int* n_live, float* out, unsigned long long* tally, int b, int v_in1,
           int v_out, int groups, int seg_rows, cudaStream_t stream) {
  using L = Layout<T, CIN, COUT>;
  static_assert(L::max_seg_rows() >= kSegS, "the instance does not stage S = 256 rows");
  if (SEG && seg_rows > L::max_seg_rows()) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gather_gemm_xwin_kernel<L, T, SEG>;
  const size_t smem = static_cast<size_t>(L::smem_bytes(SEG ? seg_rows : 0, groups));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((v_out + kTileRows - 1) / kTileRows, b);
  kernel<<<grid, L::kThreads, smem, stream>>>(
      static_cast<const T*>(feats), base, sel, static_cast<const T*>(w), n_live, out, tally,
      v_in1, v_out, groups, seg_rows);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(integral_constant<Cin>, integral_constant<Cout>) for an instance
// (ops/gather_xwin.py PAIRS); `otherwise` for any other pair.
template <typename F>
int with_instance(int cin, int cout, int otherwise, F&& f) {
#define PCDET_XWIN_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                                    \
    return f(std::integral_constant<int, CI>{}, std::integral_constant<int, CO>{});
  PCDET_XWIN_CASE(4, 16)
  PCDET_XWIN_CASE(16, 16)
  PCDET_XWIN_CASE(16, 32)
  PCDET_XWIN_CASE(32, 32)
  PCDET_XWIN_CASE(32, 64)
  PCDET_XWIN_CASE(64, 64)
  PCDET_XWIN_CASE(32, 16)
  PCDET_XWIN_CASE(64, 32)
  PCDET_XWIN_CASE(128, 64)
  PCDET_XWIN_CASE(64, 128)
#undef PCDET_XWIN_CASE
  return otherwise;
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

// The most segment rows (S) the (bf16, Cin, Cout) instance of E' stages, 0
// if there is no instance (ops/gather_xwin.py:max_seg_rows computes the same).
extern "C" int pcdet_gather_gemm_xwin_max_seg_rows(int bf16, int cin, int cout) {
  return with_instance(cin, cout, 0, [&](auto ci, auto co) {
    constexpr int CI = decltype(ci)::value;
    constexpr int CO = decltype(co)::value;
    return bf16 ? Layout<__nv_bfloat16, CI, CO>::max_seg_rows()
                : Layout<float, CI, CO>::max_seg_rows();
  });
}

// Launches on `stream`, does not synchronise, allocates nothing.  `seg`
// selects E' (segment rows `seg_rows`, 1 .. the instance's
// pcdet_gather_gemm_xwin_max_seg_rows; `tally` two counters it adds to)
// over E (`seg_rows` and `tally` unused).  `bf16` selects the
// __nv_bfloat16 instances.  Returns the cudaError_t of the launch (0 on
// success); a (Cin, Cout) pair without an instance, groups outside 1..21 or
// seg_rows outside its range returns cudaErrorInvalidValue.  The caller
// checks shapes, dtypes, contiguity and alignment (feats to 16 bytes, or 8
// for bf16 Cin = 4; w to 16); b <= 65535.
extern "C" int pcdet_gather_gemm_xwin(int seg, int bf16, const void* feats,
                                      const int* base, const int* sel,
                                      const void* w, const int* n_live,
                                      float* out, unsigned long long* tally,
                                      int b, int v_in1, int v_out, int groups,
                                      int cin, int cout, int seg_rows,
                                      void* stream) {
  if (groups < 1 || groups > kMaxGroups || v_in1 < 1 || (seg && seg_rows < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || v_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(cin, cout, static_cast<int>(cudaErrorInvalidValue),
                       [&](auto ci, auto co) {
                         constexpr int CI = decltype(ci)::value;
                         constexpr int CO = decltype(co)::value;
                         if (seg) {
                           return bf16 ? launch<__nv_bfloat16, CI, CO, true>(
                                             feats, base, sel, w, n_live, out, tally, b,
                                             v_in1, v_out, groups, seg_rows, s)
                                       : launch<float, CI, CO, true>(
                                             feats, base, sel, w, n_live, out, tally, b,
                                             v_in1, v_out, groups, seg_rows, s);
                         }
                         return bf16 ? launch<__nv_bfloat16, CI, CO, false>(
                                           feats, base, sel, w, n_live, out, tally, b,
                                           v_in1, v_out, groups, 0, s)
                                     : launch<float, CI, CO, false>(
                                           feats, base, sel, w, n_live, out, tally, b,
                                           v_in1, v_out, groups, 0, s);
                       });
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
