// Rotated-rectangle intersection areas by candidate vertices, for sm_90a
// (kernel A″).
//
// Replaces the TPU kernel pcdet_tpu/ops/pallas/rotated_overlap.py:
// pair_overlap_sorted (pallas_call body _overlap_kernel).  Given corners A
// (G, M, 4, 2) and B (G, N, 4, 2), f32, CCW, it writes out (G, M, N) f32:
// the area of A[g, m] ∩ B[g, n].  It computes the same function as kernel A
// (csrc/rotated_overlap.cu, Green's-theorem edge clipping) by another
// method, and exists as A's cross-check: the evaluation checks A's recall
// overlaps against it.
//
// Method, per pair, as the Pallas kernel and the plain PyTorch version
// (pcdet_tpu_torch/ops/rotated_overlap.py:pair_overlap_sorted_plain) state
// it over 24 candidate slots:
//   1. 24 candidate vertices in slot order: A's corners inside B (slots
//      0-3), B's corners inside A (4-7; cross >= -1e-6), then the 16 edge
//      crossings, slot 8 + 4i + j for A's edge i and B's edge j
//      (|denom| > 1e-8, t and u in [0, 1]);
//   2. sequential dedup: candidate j is dropped when a candidate i < j
//      still valid lies within 1e-6 in x and in y;
//   3. the centroid of the valid candidates (count, x and y summed over the
//      slots in order) and each one's diamond pseudo-angle around it;
//   4. for each valid candidate i its successor: the valid j != i with the
//      least positive angular gap (a gap <= 0 gets +4), j ascending with a
//      strict `<`; the shoelace term of (i, successor), summed over i in
//      order; the area is 0 unless at least 3 candidates are valid.
// Built with --fmad=false (no --use_fast_math, IEEE division) every
// operation here rounds as that version's separate tensor ops do.
//
// This kernel does that work on the valid candidates only.  Step 1 runs in
// slot order; a crossing whose denominator fails skips both divisions, one
// whose t fails skips u, and a candidate's point is computed only once it
// is valid.  Each valid candidate is checked against the list of those
// accepted so far (steps 1 and 2 in one pass) and appended unless it lies
// within 1e-6 of one.  Steps 3 and 4 walk that list, in list order, which
// is slot order; with fewer than 3 entries the area is +0.0 at once.  The
// result is the plain version's bit for bit:
//   (a) every validity predicate (inside, |denom|, t, u, the dedup's
//       < 1e-6 tests) is the same computation on the same operands; the
//       skips only leave out operations whose result cannot change a
//       predicate that has already failed;
//   (b) an invalid candidate's coordinates never reach the output: the
//       dedup gates on valid_i, and the centroid, the angles, the successor
//       and the shoelace all mask it, so the list, which holds exactly the
//       candidates i < j still valid when j is tested, is all they read;
//   (c) what the plain version adds for an invalid candidate, or for a
//       valid one with no successor, is + 0.0 into a sum (count, x, y,
//       area2) that starts at +0.0.  In round-to-nearest a sum is -0.0 only
//       when both addends are, so these sums are never -0.0, and
//       x + (+0.0) == x for every other x, NaN included (a NaN stays a
//       NaN): dropping those additions changes no bit.  The count is an
//       exact small integer, so it is the list's length; with at least 3
//       entries fmaxf(count, 1) is the count;
//   (d) an invalid j has gap BIG and never beats best (which starts at
//       BIG) under `<`, so the first minimal gap over the valid j, in
//       ascending order, is the same j.
// tests/test_torch_port_overlap_sorted.py holds a per-pair numpy version
// of this compacted order bit for bit to the plain version.
//
// What bounds it: operations, and their latency.  A pair's work follows
// its list's length L (at most 24; two quads meet in at most 8 vertices,
// more only where the 1e-6 tolerances leave near-coincident points): the
// 8 inside tests and 16 denominators always, divisions only for the
// crossings that get that far, L (L - 1) / 2 dedup tests, L angles and
// L (L - 1) successor gaps (chip_smoke.py:a2_ops_per_pair counts it).  On
// the evaluation's recall grid most pairs end with 0, 1, 4 or 5 entries:
// a zero-padded row is one point, every crossing against it has
// denom == 0, and all 4 of the other quad's corners are inside it.
//
// Layout: one thread per (g, m, n) pair, n fastest, a warp over 32
// columns of one row of A, so the output stores of a warp are coalesced and
// a warp over zero-padded columns runs one path; a block covers kRowsM rows
// of A (staged in shared memory) and kThreadsN columns of B.  The list
// (x, y, angle; 24 slots) lies in shared memory as [slot][thread], so a
// warp's accesses to one slot fall in 32 banks: 288 B a thread, 36 KB a
// block of 128.  The launch bound caps the registers so that kMinBlocks
// blocks fit an SM (the list's shared memory allows 6), and the launch
// asks for the shared-memory carve-out that holds them.
//
// On an H100 80GB HBM3 at 700 W, on the B8 recall grid (8 x 500 x 128
// pairs): this kernel, 38 registers and 6 blocks an SM, 0.0340 ms; the
// 24-slot kernel before it, 255 registers, 0.6381 ms (device time,
// rotated_overlap_ab.py --sorted).
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreadsN = 32;  // threads along n per block (a warp a row)
constexpr int kRowsM = 4;      // rows of A per block
constexpr int kThreads = kThreadsN * kRowsM;
constexpr int kMinBlocks = 6;
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

// Calls f(x, y) for each valid candidate in slot order (step 1).
template <typename F>
__device__ __forceinline__ void for_each_candidate(const float ax[4],
                                                   const float ay[4],
                                                   const float bx[4],
                                                   const float by[4], F f) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (inside(bx, by, ax[k], ay[k])) f(ax[k], ay[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (inside(ax, ay, bx[k], by[k])) f(bx[k], by[k]);
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
      const float sx = bx[j1] - bx[j];
      const float sy = by[j1] - by[j];
      const float denom = rx * sy - ry * sx;
      if (!(fabsf(denom) > kEps)) continue;
      const float qpx = bx[j] - p0x;
      const float qpy = by[j] - p0y;
      const float t = (qpx * sy - qpy * sx) / denom;
      if (!(t >= 0.0f && t <= 1.0f)) continue;
      const float u = (qpx * ry - qpy * rx) / denom;
      if (!(u >= 0.0f && u <= 1.0f)) continue;
      f(p0x + t * rx, p0y + t * ry);
    }
  }
}

// One thread's accepted list: slot k of x, y, angle at x[k * kThreads] ...
struct List {
  float* x;
  float* y;
  float* a;
};

__device__ float overlap_sorted(const float ax[4], const float ay[4],
                                const float bx[4], const float by[4],
                                List l) {
  // 1. and 2. the valid candidates, each appended unless an accepted one
  // lies within 1e-6 of it
  int len = 0;
  for_each_candidate(ax, ay, bx, by, [&](float x, float y) {
    for (int k = 0; k < len; ++k) {
      if (fabsf(l.x[k * kThreads] - x) < kDupTol &&
          fabsf(l.y[k * kThreads] - y) < kDupTol)
        return;
    }
    l.x[len * kThreads] = x;
    l.y[len * kThreads] = y;
    ++len;
  });
  if (len < 3) return 0.0f;

  // 3. centroid and pseudo-angles
  const float count = static_cast<float>(len);
  float sx = 0.0f;
  float sy = 0.0f;
  for (int k = 0; k < len; ++k) {
    sx = sx + l.x[k * kThreads];
    sy = sy + l.y[k * kThreads];
  }
  const float cx = sx / count;
  const float cy = sy / count;
  for (int k = 0; k < len; ++k) {
    l.a[k * kThreads] =
        diamond_angle(l.x[k * kThreads] - cx, l.y[k * kThreads] - cy);
  }

  // 4. successor of each entry by the least positive gap; shoelace
  float area2 = 0.0f;
  for (int i = 0; i < len; ++i) {
    const float xi = l.x[i * kThreads];
    const float yi = l.y[i * kThreads];
    const float ai = l.a[i * kThreads];
    float best = kBig;
    float nx = xi;
    float ny = yi;
    for (int j = 0; j < len; ++j) {
      if (j == i) continue;
      float gap = l.a[j * kThreads] - ai;
      gap = gap <= 0.0f ? gap + 4.0f : gap;
      if (gap < best) {
        best = gap;
        nx = l.x[j * kThreads];
        ny = l.y[j * kThreads];
      }
    }
    if (best < kBig / 2.0f) area2 = area2 + (xi * ny - nx * yi);
  }
  return 0.5f * fabsf(area2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rotated_overlap_sorted_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ out, int m, int n) {
  __shared__ float sa[kRowsM][8];
  __shared__ float list[3][kCand][kThreads];
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
  const int tid = ty * kThreadsN + tx;
  const List l{&list[0][0][tid], &list[1][0][tid], &list[2][0][tid]};
  out[(static_cast<long long>(g) * m + row) * n + col] =
      overlap_sorted(ax, ay, bx, by, l);
}

// Asks for the shared-memory carve-out that holds kMinBlocks blocks' lists,
// until the first call that succeeds; later calls return at once.
cudaError_t set_carveout() {
  static std::atomic<bool> done{false};
  if (done.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      rotated_overlap_sorted_kernel,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.store(true, std::memory_order_relaxed);
  return err;
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
  const cudaError_t err = set_carveout();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreadsN, kRowsM);
  const dim3 grid((n + kThreadsN - 1) / kThreadsN, (m + kRowsM - 1) / kRowsM, g);
  rotated_overlap_sorted_kernel<<<grid, block, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      a, b, out, m, n);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel an SM of the current device holds at once, or minus a
// cudaError_t.
extern "C" int pcdet_rotated_overlap_sorted_blocks_per_sm() {
  int per_sm = 0;
  cudaError_t err = set_carveout();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rotated_overlap_sorted_kernel, kThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
