// Kernel A's device functions (csrc/rotated_overlap.cu, whose header holds
// the method, the cull and the argument that a culled pair's area is +0.0),
// shared with kernel F (csrc/nms_fused.cu), which computes the same areas
// inside its greedy rounds.  Built with --fmad=false: every operation rounds
// as the plain version's separate tensor ops do.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kCullGap = 0x1p-6f;       // delta (m)
constexpr float kCullCoordMax = 256.0f;   // W (m)
constexpr float kCullMinEdge2 = 0x1p-20f; // tau (m^2)

// The clipping, in the op order of the plain version.  point_b_area below
// reproduces its result on a one-point q op for op: a change here must be
// made there too.  tests/test_torch_port_overlap_cull.py::
// test_one_point_quads_closed_form pins that closed form against the plain
// version on the CPU, and tests/test_torch_port_gpu.py::
// test_kernel_on_recall_grid_with_zero_rows and chip_smoke.py's degenerate
// quad grid pin the kernel against it on the card.
__device__ __forceinline__ void edge_clip_contrib(
    const float px[4], const float py[4], const float qx[4], const float qy[4],
    float eps_side, float* acc_out, float* narc_out) {
  const float tiny = 1e-12f;
  float acc = 0.0f;
  float narc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int i1 = (i + 1) & 3;
    const float p0x = px[i];
    const float p0y = py[i];
    const float dx = px[i1] - px[i];
    const float dy = py[i1] - py[i];
    float s_lo = 0.0f;
    float s_hi = 1.0f;
    bool ok = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int j1 = (j + 1) & 3;
      const float ex = qx[j1] - qx[j];
      const float ey = qy[j1] - qy[j];
      const float f0 = ex * (p0y - qy[j]) - ey * (p0x - qx[j]);
      const float fd = ex * dy - ey * dx;
      const bool is_par = fabsf(fd) <= tiny;
      const float bound = (-eps_side - f0) / (is_par ? 1.0f : fd);
      if (fd > tiny) s_lo = fmaxf(s_lo, bound);
      if (fd < -tiny) s_hi = fminf(s_hi, bound);
      ok = ok && (!is_par || f0 >= -eps_side);
    }
    s_lo = fminf(fmaxf(s_lo, 0.0f), 1.0f);
    s_hi = fminf(fmaxf(s_hi, 0.0f), 1.0f);
    const float ds = fmaxf(s_hi - s_lo, 0.0f);
    const bool live = ok && ds > 1e-6f;
    const float integral = dy * (p0x * ds + 0.5f * dx * (s_hi + s_lo) * ds);
    acc = acc + (live ? integral : 0.0f);
    narc = narc + (live ? 1.0f : 0.0f);
  }
  *acc_out = acc;
  *narc_out = narc;
}

// (min x, max x, min y, max y) of a cullable quad, else (-inf, inf, -inf,
// inf); c holds x0, y0, ..., x3, y3.
__device__ __forceinline__ float4 cull_box(const float* c) {
  bool ok = true;
  float ex[4], ey[4], l2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    ok = ok && fabsf(c[2 * k]) <= kCullCoordMax
         && fabsf(c[2 * k + 1]) <= kCullCoordMax;
    ex[k] = c[2 * k1] - c[2 * k];
    ey[k] = c[2 * k1 + 1] - c[2 * k + 1];
    l2[k] = ex[k] * ex[k] + ey[k] * ey[k];
    ok = ok && l2[k] > kCullMinEdge2;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kp = (k + 3) & 3;
    const float cross = ex[kp] * ey[k] - ey[kp] * ex[k];
    ok = ok && cross > 0.0f && cross * cross > 0.25f * l2[kp] * l2[k];
  }
  const float inf = __int_as_float(0x7f800000);
  if (!ok) return make_float4(-inf, inf, -inf, inf);
  return make_float4(fminf(fminf(c[0], c[2]), fminf(c[4], c[6])),
                     fmaxf(fmaxf(c[0], c[2]), fmaxf(c[4], c[6])),
                     fminf(fminf(c[1], c[3]), fminf(c[5], c[7])),
                     fmaxf(fmaxf(c[1], c[3]), fmaxf(c[5], c[7])));
}

// edge_clip_contrib(px, py, q) when q is one finite point and p is finite:
// every half-plane of q is parallel to every edge (fd = 0) and passed
// (f0 = 0 >= -1e-7), so each edge is live with s_lo = 0, s_hi = 1, ds = 1.
__device__ __forceinline__ float point_b_area(const float px[4],
                                              const float py[4]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int i1 = (i + 1) & 3;
    const float dx = px[i1] - px[i];
    const float dy = py[i1] - py[i];
    acc = acc + dy * (px[i] * 1.0f + 0.5f * dx * (1.0f + 0.0f) * 1.0f);
  }
  return acc;
}

// False only when the cull proves the pair's area +0.0.
__device__ __forceinline__ bool maybe_nonzero(float4 a, float4 b) {
  return !(a.y + kCullGap < b.x || b.y + kCullGap < a.x
           || a.w + kCullGap < b.z || b.w + kCullGap < a.z);
}

// Bit 0: all 8 coordinates finite; bit 1: the four corners one point.
__device__ __forceinline__ int quad_kind(const float* c) {
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) finite = finite && isfinite(c[k]);
  const bool point = c[0] == c[2] && c[0] == c[4] && c[0] == c[6]
                     && c[1] == c[3] && c[1] == c[5] && c[1] == c[7];
  return (finite ? 1 : 0) | (point ? 2 : 0);
}

// The intersection area of quads A and B that the cull kept, A the row and B
// the column (the clipping's rounding is not symmetric in them); ka, kb their
// quad_kind.  A finite pair with a one-point quad is given in closed form
// (the header of rotated_overlap.cu says why it is bit for bit the clipping).
__device__ __forceinline__ float pair_area(const float ax[4],
                                           const float ay[4],
                                           const float bx[4],
                                           const float by[4], int ka,
                                           int kb) {
  if ((ka & kb & 1) && (ka & 2)) return 0.0f;   // A one point: +0.0
  if ((ka & kb & 1) && (kb & 2))                // B one point: A's whole area
    return fmaxf(point_b_area(ax, ay) + 0.0f, 0.0f);
  float a1, n1, a2, n2;
  edge_clip_contrib(ax, ay, bx, by, 1e-7f, &a1, &n1);
  edge_clip_contrib(bx, by, ax, ay, -1e-7f, &a2, &n2);
  return (n1 + n2 >= 3.0f) ? fmaxf(a1 + a2, 0.0f) : 0.0f;
}

}  // namespace
