// Device code of the selector kernels E and E' (gather_gemm_xwin.cu): the
// x-window / segment staging of a tap group.  (The weight-gradient kernels
// D'' and D' read the same selectors through gather_dw_common.cuh, which
// takes kTileRows, kNoTap and staged_rows from here.)
// A tap group's found rows of one output row lie in the table's rows
// base .. base + 2; bits 2dx..2dx+1 of sel give the window row of x-tap dx
// (3: a miss; kNoTap: no tap of the group found).  A block handles a tile of
// kTileRows output rows and stages the rows its group reads as f32 rows of
// stride CIN + 1 in shared memory, the last staged row all zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace gather_common {

constexpr int kTileRows = 64;
constexpr int kWindowRows = 3 * kTileRows;   // staged window rows
constexpr int kNoTap = 0x3f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Staged rows: rows [0, span) for a segment or [0, 3 * kTileRows) for
// windows; the last row stays zero and takes every miss.
__host__ __device__ constexpr int staged_rows(int seg_rows) {
  return (seg_rows > kWindowRows ? seg_rows : kWindowRows) + 1;
}

// Thread 0 resets s_span (two ints of scratch) before the block
// synchronises for stage_group.
__device__ __forceinline__ void reset_span(int* s_span) {
  s_span[0] = INT_MAX;
  s_span[1] = -1;
}

// Stages the rows tap group g of a tile reads into s_rows and returns
// whether it took the segment branch (then `anchor` is the segment's first
// table row).  Called by every thread of the block, after s_base (window
// starts), s_sel (routing selectors: kNoTap on rows that read nothing) and
// s_raw (descriptor selectors: every tile row below V_out) are written, for
// SEG s_span reset, and the block has synchronised.
//   SEG false (E, D''): per tile row, the window rows that one of its taps
//     selects, at staged rows 3 r .. 3 r + 2.
//   SEG true (E', D'): the anchor is the least base over the tile rows with
//     a tap, the span the greatest base + 3 less the anchor.  Span <=
//     seg_rows: the span's rows, each loaded once, at staged rows
//     0 .. span - 1; else the windows.  The branch is counted per
//     (tile, group) in tally[0] (segment) / tally[1] (window).
// Table rows at or past v_in1 are staged as zeros: the table is not padded.
template <typename T, int CIN, int NT, bool SEG>
__device__ __forceinline__ bool stage_group(
    const T* __restrict__ feats_b, int v_in1, int seg_rows, const int* s_base,
    const int* s_sel, const int* s_raw, int* s_span, float* s_rows,
    unsigned long long* __restrict__ tally, int& anchor) {
  constexpr int RS = CIN + 1;
  const int tid = threadIdx.x;
  bool covered = false;
  anchor = 0;
  if (SEG) {
    if (tid < kTileRows && s_raw[tid] != kNoTap) {
      atomicMin(&s_span[0], s_base[tid]);
      atomicMax(&s_span[1], s_base[tid] + 3);
    }
    __syncthreads();
    const int lo = s_span[0];
    const int hi = s_span[1];
    anchor = lo == INT_MAX ? 0 : lo;
    covered = hi - anchor <= seg_rows;
    if (tid == 0) atomicAdd(&tally[covered ? 0 : 1], 1ULL);
    if (covered) {
      const int span = hi - anchor;
      for (int e = tid; e < span * CIN; e += NT) {
        const int src = anchor + e / CIN;
        s_rows[(e / CIN) * RS + e % CIN] =
            src < v_in1 ? to_f32(feats_b[static_cast<long long>(src) * CIN + e % CIN])
                        : 0.0f;
      }
    }
  }
  if (!covered) {
    for (int e = tid; e < kWindowRows * CIN; e += NT) {
      const int slot = e / CIN;
      const int r = slot / 3;
      const int j = slot % 3;
      const int sl = s_sel[r];
      if (((sl & 3) == j) || (((sl >> 2) & 3) == j) || (((sl >> 4) & 3) == j)) {
        const int src = s_base[r] + j;
        s_rows[slot * RS + e % CIN] =
            src < v_in1 ? to_f32(feats_b[static_cast<long long>(src) * CIN + e % CIN])
                        : 0.0f;
      }
    }
  }
  return covered;
}

// The staged row that x-tap dx of tile row r reads after stage_group, its
// selectors sl and window start bs (`zero`: the all-zero row).
__device__ __forceinline__ int staged_row(int sl, int bs, int r, int dx,
                                          bool covered, int anchor, int zero) {
  const int off = (sl >> (2 * dx)) & 3;
  return off == 3 ? zero : (covered ? bs - anchor : 3 * r) + off;
}

}  // namespace gather_common
