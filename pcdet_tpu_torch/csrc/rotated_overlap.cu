// Rotated-rectangle intersection areas over a batched pair grid, for sm_90a
// (kernel A).
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
// What bounds it: the clipping, about 460 flops and 32 IEEE divisions a
// pair, against 64 bytes of corners per (row, column) staged once per
// block and 4 bytes written.  On the NMS path (G = batch, M = 64,
// N = 4096) 1-7% of the pairs are two boxes that can meet (PointPillar's
// B2 rounds), and the columns come in score order, not in space, so a warp
// of neighbouring pairs almost always holds one pair that needs the
// clipping: an early return saves nothing.  The pairs that need it are
// compacted first; what is left is the launch and one block's latency
// (staging, three barriers, one pair clipped).
//
// Design: a block of 256 threads owns a tile of 32 (16, 8) rows x 32
// columns of one group: 32 where that gives at least two blocks per SM,
// fewer on small grids (a recall group).  It stages the tile's corners in
// shared memory (9 floats a quad, so a warp reading 32 quads hits 32
// banks) with each quad's cull box and kind (below, one thread per quad);
// each thread tests TM / 8 pairs (one row of the tile per warp and step,
// so the zeros it writes for a culled pair are coalesced); the pairs that
// survive go into a list in shared memory (warp ballot and popcount
// prefix: warp, step, lane order, no atomics); then all 256 threads walk
// the list.  A surviving pair is clipped with edge_clip_contrib,
// unchanged, unless both quads are finite and one is a single point (the
// zero-padded rows of the recall grid, 80-90% of its pairs): then the
// clipping's result is known in closed form, bit for bit.  When A is the
// point, each of its arcs adds dy * (...) = 0 * finite, so a1 = +0.0, and
// no edge of B passes A's half-planes (f0 = 0 < 1e-7), so a2 = +0.0: the
// area is +0.0.  When B is, every edge of A is live over [0, 1] (each
// half-plane of B is parallel to it, fd = 0, and passed, f0 = 0 >= -1e-7),
// n1 = 4, and B's arcs add +0.0: the area is fmaxf(a1 + 0.0f, 0.0f) with
// a1 A's four edge integrals at ds = 1 summed in the same order
// (point_b_area).  A culled pair's area is
// +0.0 bit for bit (the argument below), so the output equals the plain
// version's on every pair.  `survivors`, when not null, gets the block's
// list length added once (one atomic per block); the plain predicate is
// pcdet_tpu_torch/ops/rotated_overlap.py:overlap_maybe_nonzero_plain.
//
// The cull.  A quad is cullable when every corner has |x|, |y| <= W = 256,
// every edge has a computed squared length above tau = 2^-20 (1 mm), and
// every corner turns left with sin(angle) >= 1/2 (computed cross product
// > 0 and cross^2 > len^2 * len'^2 / 4): a convex CCW quad with angles in
// [30, 150] degrees.  Its cull box is its axis-aligned bounding box; any
// other quad (a zero-padded row whose corners are one point, a zero-length
// side, a clockwise quad, NaN or Inf anywhere) gets [-inf, inf]^2, so no
// comparison can separate it.  A pair is culled only when both quads are
// cullable and a comparison proves their boxes apart by more than
// delta = 2^-6 m on x or on y (max_a + delta < min_b, either way), so a
// NaN keeps the pair.
//
// Why a culled pair gives +0.0.  Let the boxes be apart on x, A left of B:
// every point of A has x <= X, every point of B has x >= X + delta.  Take
// an edge P(s) = p0 + s d of A and B's half-planes f_j(P) >= -eps (f_j is
// |e_j| times the signed distance from B's edge line j).  The computed
// bound for j turns into "s >= bound" or "s <= bound" (or, parallel, all
// s or none), and for every s in [0, 1] it admits, the exact f_j(P(s))
// >= -eps - |eps + f0| 2.0001u - |err f0| - |err fd|, u = 2^-24: with
// |p0 - q_j|, |d| <= 2 sqrt(2) W, the errors of f0 and fd are each at most
// 5.25u |e_j| 2 sqrt(2) W, so every admitted point lies within
// R = eps / 1mm + 35.4 u W = 1.0e-4 + 5.4e-4 < 6.5e-4 m of each of B's
// edge lines.  Those points lie in B grown by R on every side, whose
// corners move out by R / sin(angle / 2) <= 3.87 R < 2.6e-3 m < delta, so
// none has x <= X: no s in [0, 1] passes every half-plane.  When the
// clamped s_hi > s_lo, any s between them would pass every half-plane, so
// s_hi <= s_lo and ds = max(s_hi - s_lo, 0) = 0 on every edge: no arc is
// live (ds > 1e-6 fails), n1 = n2 = 0 (B's edges against A the same way,
// with eps = -1e-7), and the result is the literal 0.0f, not -0.0f.
// tests/test_torch_port_overlap_cull.py holds this against the plain
// version on over 10^6 pairs, near misses just past delta included.
#include <cuda_runtime.h>

#include "rotated_overlap.cuh"

namespace {

constexpr int kTileN = 32;     // columns of B per block (= warp width)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 9;        // floats a staged quad takes: conflict-free
constexpr int kMinBlocks = 2 * 132;   // two blocks per SM of an H100

template <int kTileM>
__global__ void __launch_bounds__(kThreads)
rotated_overlap_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int* __restrict__ survivors,
                       int m, int n) {
  constexpr int kSteps = kTileM / kWarps;   // rows each warp tests
  __shared__ float sa[kTileM][kPad];
  __shared__ float sb[kTileN][kPad];
  __shared__ float4 box_a[kTileM];
  __shared__ float4 box_b[kTileN];
  __shared__ int kind_a[kTileM];
  __shared__ int kind_b[kTileN];
  __shared__ unsigned short list[kTileM * kTileN];
  __shared__ int warp_total[kWarps];

  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // stage: 8 floats a quad, rows then columns, ragged edges left unread
  for (int i = t; i < (kTileM + kTileN) * 8; i += kThreads) {
    const int q = i >> 3;
    const int k = i & 7;
    if (q < kTileM) {
      if (row0 + q < m)
        sa[q][k] = a[(static_cast<long long>(g) * m + row0 + q) * 8 + k];
    } else if (col0 + q - kTileM < n) {
      sb[q - kTileM][k] =
          b[(static_cast<long long>(g) * n + col0 + q - kTileM) * 8 + k];
    }
  }
  __syncthreads();
  if (t < kTileM) {
    if (row0 + t < m) {
      box_a[t] = cull_box(sa[t]);
      kind_a[t] = quad_kind(sa[t]);
    }
  } else if (t < kTileM + kTileN) {
    const int q = t - kTileM;
    if (col0 + q < n) {
      box_b[q] = cull_box(sb[q]);
      kind_b[q] = quad_kind(sb[q]);
    }
  }
  __syncthreads();

  // cull: at column `lane`, warp w tests rows w, w + 8, ...
  const int col = col0 + lane;
  const bool col_in = col < n;
  const float4 bq = col_in ? box_b[lane] : make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned ball[kSteps];
  int total = 0;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int r = warp + k * kWarps;
    const bool in = col_in && row0 + r < m;
    const bool keep = in && maybe_nonzero(box_a[r], bq);
    if (in && !keep)
      out[(static_cast<long long>(g) * m + row0 + r) * n + col] = 0.0f;
    ball[k] = __ballot_sync(0xffffffffu, keep);
    total += __popc(ball[k]);
  }
  if (lane == 0) warp_total[warp] = total;
  __syncthreads();
  int base = 0;
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? warp_total[w] : 0;
    count += warp_total[w];
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    if (ball[k] >> lane & 1u)
      list[base + __popc(ball[k] & below)] =
          static_cast<unsigned short>((warp + k * kWarps) * kTileN + lane);
    base += __popc(ball[k]);
  }
  __syncthreads();
  if (survivors != nullptr && t == 0 && count > 0) atomicAdd(survivors, count);

  // dense pass: every thread takes list entries t, t + 256, ...
  for (int i = t; i < count; i += kThreads) {
    const int r = list[i] / kTileN;
    const int c = list[i] % kTileN;
    float ax[4], ay[4], bx[4], by[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ax[k] = sa[r][2 * k];
      ay[k] = sa[r][2 * k + 1];
      bx[k] = sb[c][2 * k];
      by[k] = sb[c][2 * k + 1];
    }
    const int ka = kind_a[r];
    const int kb = kind_b[c];
    const float area = pair_area(ax, ay, bx, by, ka, kb);
    out[(static_cast<long long>(g) * m + row0 + r) * n + col0 + c] = area;
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (0 on success).  `survivors` is null or one int
// on the device to which the count of pairs not culled is added.  The tile
// has 32 rows where that gives at least two blocks per SM, else 16, else 8.
// The caller checks shapes, contiguity and grid limits (g <= 65535,
// ceil(m / 8) <= 65535).
extern "C" int pcdet_rotated_overlap_batched(const float* a, const float* b,
                                             float* out, int* survivors, int g,
                                             int m, int n, void* stream) {
  if (g == 0 || m == 0 || n == 0) return 0;
  const long long cols = (n + kTileN - 1) / kTileN;
  const auto blocks = [&](int rows) {
    return static_cast<long long>(g) * ((m + rows - 1) / rows) * cols;
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile_m = blocks(32) >= kMinBlocks ? 32
                     : blocks(16) >= kMinBlocks ? 16 : 8;
  const dim3 grid(cols, (m + tile_m - 1) / tile_m, g);
  if (tile_m == 32)
    rotated_overlap_kernel<32><<<grid, kThreads, 0, s>>>(a, b, out, survivors,
                                                         m, n);
  else if (tile_m == 16)
    rotated_overlap_kernel<16><<<grid, kThreads, 0, s>>>(a, b, out, survivors,
                                                         m, n);
  else
    rotated_overlap_kernel<8><<<grid, kThreads, 0, s>>>(a, b, out, survivors,
                                                        m, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
