// Rotated-rectangle intersection areas over a batched pair grid, for sm_90a.
//
// Replaces the TPU kernel pcdet_tpu/ops/pallas/rotated_overlap.py:
// pair_overlap_batched (pallas_call body _edgeclip_kernel_grouped ->
// _edgeclip_compute).  Given corners A (G, M, 4, 2) and B (G, N, 4, 2), f32,
// CCW, it writes out (G, M, N) f32: the area of A[g, m] ∩ B[g, n].
//
// Method (Green's theorem): each edge of A is clipped to a parameter
// interval against B's four half-planes with eps = +1e-7, each edge of B
// against A's with eps = -1e-7, and every live arc adds
// dy * (x0 * ds + 0.5 * dx * (s_hi + s_lo) * ds).  The area is 0 unless at
// least 3 arcs are live.  The plain PyTorch version is
// pcdet_tpu_torch/ops/rotated_iou.py:_edge_clip_contrib; built with
// --fmad=false (and without --use_fast_math) every multiply, add and divide
// here rounds exactly as that version's separate tensor ops do, so greedy
// NMS on thresholded IoUs gives the same indices with either.
//
// Layout: one thread per (g, m, n) pair, n fastest, so the output stores of
// a warp are coalesced.  A block covers kRowsM rows of A and kThreadsN
// columns of B; the block's A corners sit in shared memory, each thread
// reads its own B box.  Ragged edges are masked; nothing is padded.
//
// What bounds it: arithmetic, about 460 flops per pair against 32 bytes of
// B read (mostly from L2) and 4 bytes written.  On the NMS path
// (G = batch, M = 64, N = 4096) it is a few microseconds of work, so the
// launch dominates; making it fast is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsN = 64;  // threads along n per block
constexpr int kRowsM = 4;      // rows of A per block

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

__global__ void __launch_bounds__(kThreadsN * kRowsM)
rotated_overlap_kernel(const float* __restrict__ a, const float* __restrict__ b,
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
  float a1, n1, a2, n2;
  edge_clip_contrib(ax, ay, bx, by, 1e-7f, &a1, &n1);
  edge_clip_contrib(bx, by, ax, ay, -1e-7f, &a2, &n2);
  out[(static_cast<long long>(g) * m + row) * n + col] =
      (n1 + n2 >= 3.0f) ? fmaxf(a1 + a2, 0.0f) : 0.0f;
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes,
// contiguity and grid limits (g <= 65535, ceil(m / 4) <= 65535).
extern "C" int pcdet_rotated_overlap_batched(const float* a, const float* b,
                                             float* out, int g, int m, int n,
                                             void* stream) {
  if (g == 0 || m == 0 || n == 0) return 0;
  const dim3 block(kThreadsN, kRowsM);
  const dim3 grid((n + kThreadsN - 1) / kThreadsN, (m + kRowsM - 1) / kRowsM, g);
  rotated_overlap_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, m, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
