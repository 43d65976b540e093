// Constants of the x-window selectors that the kernels E, E'
// (gather_gemm_xwin.cu) and D'', D' (gather_dw_xwin.cu, through
// gather_dw_common.cuh) read.
// A tap group's found rows of one output row lie in the table's rows
// base .. base + 2; bits 2dx..2dx+1 of sel give the window row of x-tap dx
// (3: a miss; kNoTap: no tap of the group found).  A block stages the rows
// a group of its kTileRows-row tile reads: per tile row its window rows
// (slots 3 r .. 3 r + 2), or the span of the tile's windows (slots
// 0 .. span - 1) where it is at most S rows.
#pragma once

#include <cuda_runtime.h>

namespace gather_common {

constexpr int kTileRows = 64;
constexpr int kWindowRows = 3 * kTileRows;   // staged window rows
constexpr int kNoTap = 0x3f;

// Staged rows of D'' / D': rows [0, span) for a segment or
// [0, 3 * kTileRows) for windows; the last row stays zero and takes every
// miss.
__host__ __device__ constexpr int staged_rows(int seg_rows) {
  return (seg_rows > kWindowRows ? seg_rows : kWindowRows) + 1;
}

}  // namespace gather_common
