// Rotated-rectangle intersection areas by candidate vertices, for sm_90a.
//
// Replaces the TPU kernel pcdet_tpu/ops/pallas/rotated_overlap.py:
// pair_overlap_sorted (pallas_call body _overlap_kernel).  Given corners A
// (G, M, 4, 2) and B (G, N, 4, 2), f32, CCW, it writes out (G, M, N) f32:
// the area of A[g, m] ∩ B[g, n].  It computes the same function as kernel A
// (csrc/rotated_overlap.cu, Green's-theorem edge clipping) by another
// method, and exists as A's cross-check: the evaluation checks A's recall
// overlaps against it.
//
// Method, per pair, in the order of the Pallas kernel:
//   1. 24 candidate vertices in slot order: A's corners inside B, B's
//      corners inside A (cross >= -1e-6), then the 16 edge crossings
//      (|denom| > 1e-8, t and u in [0, 1]);
//   2. sequential dedup: candidate j (1..23) is dropped when a candidate
//      i < j still valid lies within 1e-6 in x and y;
//   3. the centroid of the valid candidates (sums over slots 0..23 in
//      order) and each one's diamond pseudo-angle around it;
//   4. for each valid candidate i its successor: the valid j != i with the
//      least positive angular gap (a gap <= 0 gets +4), j ascending with a
//      strict `<`, so the first minimal gap wins, as in the Pallas j-outer
//      scan; the shoelace term of (i, successor), summed over i in order;
//      the area is 0 unless at least 3 candidates are valid.
// The plain PyTorch version is pcdet_tpu_torch/ops/rotated_overlap.py:
// pair_overlap_sorted_plain.  Built with --fmad=false (no --use_fast_math,
// IEEE division) every operation here rounds as that version's separate
// tensor ops do, in the same order.
//
// Layout: one thread per (g, m, n) pair, n fastest, so the output stores of
// a warp are coalesced; a block covers kRowsM rows of A (in shared memory)
// and kThreadsN columns of B.  Every loop over the 24 candidates is
// unrolled, so the candidates (x, y, angle) and the 24-bit valid mask sit
// in registers with static indices.
//
// What bounds it: operations.  About 9000 per pair (the dedup's 276 and the
// successor scan's 576 candidate pairs dominate), 15-20x kernel A's ~490,
// against 32 bytes of B read and 4 bytes written.  It is not on the hot
// path: the evaluation launches it once per batch beside A.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsN = 64;  // threads along n per block
constexpr int kRowsM = 4;      // rows of A per block
constexpr int kCand = 24;
constexpr float kEps = 1e-8f;
constexpr float kInsideEps = 1e-6f;
constexpr float kDupTol = 1e-6f;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float cross(float ox, float oy, float px, float py,
                                       float qx, float qy) {
  return (px - ox) * (qy - oy) - (qx - ox) * (py - oy);
}

// (px, py) inside the CCW quad (qx, qy), boundary included within 1e-6.
__device__ __forceinline__ bool inside(const float qx[4], const float qy[4],
                                       float px, float py) {
  bool ok = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int e1 = (e + 1) & 3;
    ok = ok && cross(qx[e], qy[e], qx[e1], qy[e1], px, py) >= -kInsideEps;
  }
  return ok;
}

// Monotonic-in-angle pseudo-angle in [0, 4), no transcendentals.
__device__ __forceinline__ float diamond_angle(float dx, float dy) {
  const float adx = fabsf(dx);
  const float ady = fabsf(dy);
  const float denom = fmaxf(adx + ady, kEps);
  const bool pos_x = dx >= 0.0f;
  const bool pos_y = dy >= 0.0f;
  if (pos_x && pos_y) return dy / denom;
  if (!pos_x && pos_y) return 1.0f + adx / denom;
  if (!pos_x && !pos_y) return 2.0f + ady / denom;
  return 3.0f + dx / denom;
}

__device__ float overlap_sorted(const float ax[4], const float ay[4],
                                const float bx[4], const float by[4]) {
  float px[kCand], py[kCand];
  uint32_t valid = 0;

  // 1. candidates
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = ax[k];
    py[k] = ay[k];
    if (inside(bx, by, ax[k], ay[k])) valid |= 1u << k;
    px[4 + k] = bx[k];
    py[4 + k] = by[k];
    if (inside(ax, ay, bx[k], by[k])) valid |= 1u << (4 + k);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int i1 = (i + 1) & 3;
    const float p0x = ax[i];
    const float p0y = ay[i];
    const float rx = ax[i1] - ax[i];
    const float ry = ay[i1] - ay[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int j1 = (j + 1) & 3;
      const int slot = 8 + 4 * i + j;
      const float sx = bx[j1] - bx[j];
      const float sy = by[j1] - by[j];
      const float denom = rx * sy - ry * sx;
      const bool nonpar = fabsf(denom) > kEps;
      const float safe = nonpar ? denom : 1.0f;
      const float qpx = bx[j] - p0x;
      const float qpy = by[j] - p0y;
      const float t = (qpx * sy - qpy * sx) / safe;
      const float u = (qpx * ry - qpy * rx) / safe;
      px[slot] = p0x + t * rx;
      py[slot] = p0y + t * ry;
      if (nonpar && t >= 0.0f && t <= 1.0f && u >= 0.0f && u <= 1.0f)
        valid |= 1u << slot;
    }
  }

  // 2. sequential dedup: keep the first of coincident candidates
#pragma unroll
  for (int j = 1; j < kCand; ++j) {
    bool dup = false;
#pragma unroll
    for (int i = 0; i < j; ++i) {
      dup = dup || (((valid >> i) & 1u) && fabsf(px[i] - px[j]) < kDupTol &&
                    fabsf(py[i] - py[j]) < kDupTol);
    }
    if (dup) valid &= ~(1u << j);
  }

  // 3. centroid and pseudo-angles
  float count = 0.0f;
  float sx = 0.0f;
  float sy = 0.0f;
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    const bool v = (valid >> k) & 1u;
    count = count + (v ? 1.0f : 0.0f);
    sx = sx + (v ? px[k] : 0.0f);
    sy = sy + (v ? py[k] : 0.0f);
  }
  const float denom_c = fmaxf(count, 1.0f);
  const float cx = sx / denom_c;
  const float cy = sy / denom_c;
  float ang[kCand];
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    ang[k] = ((valid >> k) & 1u) ? diamond_angle(px[k] - cx, py[k] - cy)
                                 : kBig;
  }

  // 4. successor of each candidate by the least positive gap; shoelace
  float area2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kCand; ++i) {
    float best = kBig;
    float nx = px[i];
    float ny = py[i];
#pragma unroll
    for (int j = 0; j < kCand; ++j) {
      float gap = ang[j] - ang[i];
      gap = gap <= 0.0f ? gap + 4.0f : gap;
      const bool ok = ((valid >> j) & 1u) && ((valid >> i) & 1u) && i != j;
      gap = ok ? gap : kBig;
      if (gap < best) {
        best = gap;
        nx = px[j];
        ny = py[j];
      }
    }
    const float term = px[i] * ny - nx * py[i];
    const bool live = ((valid >> i) & 1u) && best < kBig / 2.0f;
    area2 = area2 + (live ? term : 0.0f);
  }
  const float area = 0.5f * fabsf(area2);
  return count >= 3.0f ? area : 0.0f;
}

__global__ void __launch_bounds__(kThreadsN * kRowsM)
rotated_overlap_sorted_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ out, int m, int n) {
  __shared__ float sa[kRowsM][8];
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kRowsM;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  if (tx < 8 && row0 + ty < m) {
    sa[ty][tx] = a[(static_cast<long long>(g) * m + row0 + ty) * 8 + tx];
  }
  __syncthreads();

  const int row = row0 + ty;
  const int col = blockIdx.x * kThreadsN + tx;
  if (row >= m || col >= n) return;

  const float* bb = b + (static_cast<long long>(g) * n + col) * 8;
  float ax[4], ay[4], bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] = sa[ty][2 * k];
    ay[k] = sa[ty][2 * k + 1];
    bx[k] = bb[2 * k];
    by[k] = bb[2 * k + 1];
  }
  out[(static_cast<long long>(g) * m + row) * n + col] =
      overlap_sorted(ax, ay, bx, by);
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes,
// contiguity and grid limits (g <= 65535, ceil(m / 4) <= 65535).
extern "C" int pcdet_rotated_overlap_sorted_batched(const float* a,
                                                    const float* b, float* out,
                                                    int g, int m, int n,
                                                    void* stream) {
  if (g == 0 || m == 0 || n == 0) return 0;
  const dim3 block(kThreadsN, kRowsM);
  const dim3 grid((n + kThreadsN - 1) / kThreadsN, (m + kRowsM - 1) / kRowsM, g);
  rotated_overlap_sorted_kernel<<<grid, block, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      a, b, out, m, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
