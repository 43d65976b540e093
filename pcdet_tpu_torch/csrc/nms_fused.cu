// Exact greedy NMS with every round on the card, one launch a call, for
// sm_90a (kernel F).
//
// Replaces no TPU kernel.  It fuses kernel A (csrc/rotated_overlap.cu) with
// the greedy that ops/nms.py:_lazy_greedy_batched runs around A's launches:
// there every round, and every frontier step inside a round, reads a flag on
// the host, so the card idles while Python launches the next few ATen ops.
// Here the round loop runs on the card and the host reads nothing back.
//
// Inputs, per group g of G (each a sample, or a sample and class), in
// descending score order: `geo` (G, pre, 4, 2) CCW corners (rotated) or
// (G, pre, 5) boxes [x1, y1, x2, y2, ry] (axis-aligned, ry unread), `area`
// (G, pre) the boxes' (x2 - x1) * (y2 - y1), `valid` (G, pre) bool.
// Outputs: `keep` (G, pre) bool and `rounds` (G,) int32, the rounds the group
// ran.  The greedy is _lazy_greedy_batched's, decision for decision: a round
// takes the first kBlock (64) alive boxes in rank order (the block), computes
// their IoU with every alive box, resolves greedy exactly inside the block,
// keeps the block's keepers, kills what a keeper overlaps above `thresh` and
// retires the block; it runs while a box is alive and fewer than `post_max`
// were kept (a round that crosses post_max keeps all of its keepers; the
// caller's sort truncates).  The IoU of row i (a block box) and column j is
// inter / max(area_i + area_j - inter, 1e-8) in f32, with inter from kernel
// A's device functions (rotated_overlap.cuh: the exact cull, the clipping,
// the one-point quads) or the axis-aligned overlap, in the ATen expression's
// operations and order; built with --fmad=false, every decision is the eager
// loop's bit for bit.  Only the columns still alive are computed: a dead
// column's IoU changes nothing.
//
// What bounds it: latency.  A round's arithmetic is at most kernel A's on
// the same rows (the alive columns only); what the fusion buys is the
// rounds' host syncs and the ~40 small ATen launches around each.
//
// Design: one thread-block cluster a group, C CTAs (1, 2, 4, 8 or 16; 16 is
// a non-portable size) that split the pre columns into slices of `cols` (a
// multiple of 32).  The launch plan (C, cols) comes from the wrapper
// (ops/nms_fused.py:plan): the most CTAs that keep 128 columns each.  C is
// compiled into each instance (__cluster_dims__): the loops over the
// cluster's CTAs unroll.  Each CTA keeps its slice in shared memory:
// corners (9 floats a quad, so a warp reading 32 quads hits 32 banks), cull
// boxes, quad kinds, areas, alive and keep bits.  A round:
//   1. each CTA lists its alive columns in rank order (popcount prefix over
//      the alive words) and pushes its count to every CTA over distributed
//      shared memory (DSMEM); cluster barrier;
//   2. from the counts each CTA knows its offset in the global rank; the
//      owners of the first 64 alive push those boxes' records (corners, cull
//      box, area, kind) to every CTA; cluster barrier;
//   3. each CTA computes the block's rows against its alive columns, 256
//      columns at a time: warps test the cull on 64 x 256 pairs and list the
//      survivors in shared memory, each warp in a region of its own (ballot
//      and popcount, no atomics), then all 512 threads walk the lists
//      (kernel A's two passes), and every IoU above thresh sets bit i of the
//      column's 64-bit mask; a block box's mask below its own slot
//      (the rows that can suppress it) goes to every CTA; cluster barrier;
//   4. every CTA resolves the block's greedy from those 64 masks in rank
//      order with 64-bit masks (the fixed point _greedy_suppress_batched
//      reaches), keeps its keepers, and drops the columns a keeper's mask
//      hits and the block's own.
// Every CTA computes the same keepers from the same masks, so all of them
// count the same n and leave the loop in the same round, right after the
// barrier of step 1: no DSMEM access follows it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "rotated_overlap.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 64;      // boxes a round resolves (ops/nms.py:BLOCK)
constexpr int kChunk = 256;     // alive columns a pair pass covers
constexpr int kRec = 16;        // floats of a block box's record
constexpr int kMaxCluster = 16;

// Shared memory of one CTA with a slice of `cols` columns, in bytes, each
// region 16-aligned; ops/nms_fused.py:smem_bytes mirrors it: edit both.
struct Layout {
  int geo, cbox, kind, area, over, list, alive, keepb, wpre, blk, sup, counts,
      pairs, misc, total;
};

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

__host__ __device__ inline Layout layout(int cols, bool rotated) {
  const int words = cols / 32;
  Layout l;
  l.geo = 0;
  l.cbox = l.geo + align16(cols * (rotated ? 9 : 5) * 4);
  l.kind = l.cbox + align16(rotated ? cols * 16 : 0);
  l.area = l.kind + align16(rotated ? cols * 4 : 0);
  l.over = l.area + align16(cols * 4);
  l.list = l.over + align16(cols * 8);
  l.alive = l.list + align16(cols * 2);
  l.keepb = l.alive + align16(words * 4);
  l.wpre = l.keepb + align16(words * 4);
  l.blk = l.wpre + align16(words * 4);
  l.sup = l.blk + align16(kBlock * kRec * 4);
  l.counts = l.sup + align16(kBlock * 8);
  l.pairs = l.counts + align16(kMaxCluster * 4);
  l.misc = l.pairs + align16(rotated ? kBlock * kChunk * 2 : 0);
  l.total = l.misc + align16(32 * 4);
  return l;
}

// torch.clamp(d, min=1e-8) (NaN stays NaN), then the division
__device__ __forceinline__ float iou_of(float inter, float area_row,
                                        float area_col) {
  float d = area_row + area_col - inter;
  d = d < 1e-8f ? 1e-8f : d;
  return inter / d;
}

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// _lazy_greedy_batched's axis-aligned overlap: clamp(min(x2) - max(x1),
// min=0) * clamp(min(y2) - max(y1), min=0)
__device__ __forceinline__ float axis_inter(const float* a, const float* b) {
  float iw = nan_min(a[2], b[2]) - nan_max(a[0], b[0]);
  float ih = nan_min(a[3], b[3]) - nan_max(a[1], b[1]);
  iw = iw < 0.0f ? 0.0f : iw;
  ih = ih < 0.0f ? 0.0f : ih;
  return iw * ih;
}

template <bool kRotated, int kCluster>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
nms_fused_kernel(const float* __restrict__ geo_in,
                 const float* __restrict__ area_in,
                 const unsigned char* __restrict__ valid_in,
                 unsigned char* __restrict__ keep_out,
                 int* __restrict__ rounds_out, int pre, int cols,
                 float thresh, int post_max) {
  constexpr int kIn = kRotated ? 8 : 5;   // floats a box takes in geo_in
  constexpr int kG = kRotated ? 9 : 5;    // floats a column takes staged
  constexpr int kRowStep = kWarps / (kChunk / 32);   // rows between a
                                                     // warp's pair tests
  constexpr int kWarpPairs = kBlock / kRowStep * 32;  // its list region
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int col0 = rank * cols;
  const int words = cols / 32;
  const long long gbase = static_cast<long long>(g) * pre;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(cols, kRotated);
  float* geo = reinterpret_cast<float*>(smem + L.geo);
  float4* cbox = reinterpret_cast<float4*>(smem + L.cbox);
  int* kind = reinterpret_cast<int*>(smem + L.kind);
  float* area = reinterpret_cast<float*>(smem + L.area);
  unsigned long long* over = reinterpret_cast<unsigned long long*>(
      smem + L.over);                      // by alive index: rows above
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + L.list);
  unsigned* alive = reinterpret_cast<unsigned*>(smem + L.alive);
  unsigned* keepb = reinterpret_cast<unsigned*>(smem + L.keepb);
  int* wpre = reinterpret_cast<int*>(smem + L.wpre);
  float* blk = reinterpret_cast<float*>(smem + L.blk);
  unsigned long long* sup = reinterpret_cast<unsigned long long*>(
      smem + L.sup);
  int* counts = reinterpret_cast<int*>(smem + L.counts);
  unsigned short* pairs = reinterpret_cast<unsigned short*>(smem + L.pairs);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  // misc[0]: alive count; misc[2..3]: the block's keepers; misc[4..19]:
  // each warp's pairs in its list region

  // stage the slice; columns past pre are zeros and never alive
  for (int i = t; i < cols * kIn; i += kThreads) {
    const int c = i / kIn;
    const int k = i - c * kIn;
    const int gc = col0 + c;
    geo[c * kG + k] = gc < pre ? geo_in[(gbase + gc) * kIn + k] : 0.0f;
  }
  for (int c = t; c < cols; c += kThreads) {   // a warp: one alive word
    const int gc = col0 + c;
    const bool v = gc < pre && valid_in[gbase + gc] != 0;
    area[c] = gc < pre ? area_in[gbase + gc] : 0.0f;
    const unsigned b = __ballot_sync(0xffffffffu, v);
    if (lane == 0) {
      alive[c >> 5] = b;
      keepb[c >> 5] = 0u;
    }
  }
  __syncthreads();
  if constexpr (kRotated) {
    for (int c = t; c < cols; c += kThreads) {
      cbox[c] = cull_box(geo + c * kG);
      kind[c] = quad_kind(geo + c * kG);
    }
  }

  int n = 0;
  int rounds = 0;
  for (;;) {
    // 1. the alive columns in rank order, and their count to every CTA
    __syncthreads();
    if (warp == 0) {
      int carry = 0;
      for (int w0 = 0; w0 < words; w0 += 32) {
        const int w = w0 + lane;
        const int p = w < words ? __popc(alive[w]) : 0;
        int incl = p;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += y;
        }
        if (w < words) wpre[w] = carry + incl - p;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) misc[0] = carry;
    }
    __syncthreads();
    const int na = misc[0];
    for (int c = t; c < cols; c += kThreads) {
      const unsigned wd = alive[c >> 5];
      const unsigned bit = 1u << (c & 31);
      if (wd & bit)
        list[wpre[c >> 5] + __popc(wd & (bit - 1u))] =
            static_cast<unsigned short>(c);
    }
    if (t < kCluster) *cluster.map_shared_rank(counts + rank, t) = na;
    cluster.sync();

    int total = 0;
    int offset = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      total += counts[r];
      offset += r < rank ? counts[r] : 0;
    }
    if (total == 0 || n >= post_max) break;
    const int nblk = min(kBlock, total);
    const int nmem = max(0, min(na, nblk - offset));   // my block boxes

    // 2. the block's records to every CTA, at their global rank
    for (int i = t; i < nmem * kCluster * 4; i += kThreads) {
      const int a = i / (kCluster * 4);
      const int d = (i >> 2) % kCluster;
      const int q = i & 3;
      const int c = list[a];
      const float* src = geo + c * kG;
      float4 v;
      if (q == 0) {
        v = make_float4(src[0], src[1], src[2], src[3]);
      } else if (q == 1) {
        v = kRotated ? make_float4(src[4], src[5], src[6], src[7])
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (q == 2) {
        v = kRotated ? cbox[c] : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        v = make_float4(area[c], __int_as_float(kRotated ? kind[c] : 0), 0.f,
                        0.f);
      }
      float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(blk, d));
      dst[(offset + a) * 4 + q] = v;
    }
    for (int a = t; a < na; a += kThreads) over[a] = 0ull;
    cluster.sync();

    // 3. the block's rows against my alive columns, kChunk at a time; a
    // warp tests one group of 32 columns at rows warp / 8, + 2, ...
    for (int c0 = 0; c0 < na; c0 += kChunk) {
      const int cc = (warp % (kChunk / 32)) * 32 + lane;  // column of chunk
      const bool col_in = c0 + cc < na;
      const int c = col_in ? list[c0 + cc] : 0;
      const float ac = area[c];
      unsigned long long bits = 0ull;
      if constexpr (kRotated) {
        const float4 bq = cbox[c];
        unsigned short* mine = pairs + warp * kWarpPairs;
        int listed = 0;
        for (int r = warp / (kChunk / 32); r < nblk; r += kRowStep) {
          const float* rec = blk + r * kRec;
          const float4 ba = make_float4(rec[8], rec[9], rec[10], rec[11]);
          const bool keep = col_in && maybe_nonzero(ba, bq);
          // a culled pair's area is +0.0; its IoU matters only below 0
          if (col_in && !keep && thresh < 0.0f
              && iou_of(0.0f, rec[12], ac) > thresh)
            bits |= 1ull << r;
          const unsigned b = __ballot_sync(0xffffffffu, keep);
          if (keep)
            mine[listed + __popc(b & below)] =
                static_cast<unsigned short>((r << 8) | cc);
          listed += __popc(b);
        }
        if (lane == 0) misc[4 + warp] = listed;
      } else {
        if (col_in) {
          for (int r = warp / (kChunk / 32); r < nblk; r += kRowStep) {
            const float* rec = blk + r * kRec;
            if (iou_of(axis_inter(rec, geo + c * kG), rec[12], ac) > thresh)
              bits |= 1ull << r;
          }
        }
      }
      if (bits != 0ull) atomicOr(&over[c0 + cc], bits);
      if constexpr (kRotated) {
        __syncthreads();
        // the warps' lists end to end: start[w] is warp w's first entry
        int start[kWarps];
        int count = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          start[w] = count;
          count += misc[4 + w];
        }
        for (int i = t; i < count; i += kThreads) {
          int w = 0;
          int base = 0;
#pragma unroll
          for (int k = 1; k < kWarps; ++k) {
            if (i >= start[k]) {
              w = k;
              base = start[k];
            }
          }
          const int e = pairs[w * kWarpPairs + i - base];
          const int r = e >> 8;
          const int a = c0 + (e & 255);
          const int c2 = list[a];
          const float* rec = blk + r * kRec;
          const float* q = geo + c2 * kG;
          float ax[4], ay[4], bx[4], by[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ax[k] = rec[2 * k];
            ay[k] = rec[2 * k + 1];
            bx[k] = q[2 * k];
            by[k] = q[2 * k + 1];
          }
          const float inter = pair_area(ax, ay, bx, by,
                                        __float_as_int(rec[13]), kind[c2]);
          if (iou_of(inter, rec[12], area[c2]) > thresh)
            atomicOr(&over[a], 1ull << r);
        }
      }
      __syncthreads();
    }

    // the rows that can suppress each block box, to every CTA
    for (int i = t; i < nmem * kCluster; i += kThreads) {
      const int a = i / kCluster;
      const int s = offset + a;
      *cluster.map_shared_rank(sup + s, i - a * kCluster) =
          over[a] & ((1ull << s) - 1ull);
    }
    cluster.sync();

    // 4. greedy inside the block, in rank order
    if (t == 0) {
      unsigned long long k = 0ull;
      for (int s = 0; s < nblk; ++s)
        if ((sup[s] & k) == 0ull) k |= 1ull << s;
      *reinterpret_cast<unsigned long long*>(misc + 2) = k;
    }
    __syncthreads();
    const unsigned long long kept =
        *reinterpret_cast<const unsigned long long*>(misc + 2);
    for (int c = t; c < cols; c += kThreads) {   // a warp: one alive word
      const unsigned wd = alive[c >> 5];
      bool dead = false;
      bool keeper = false;
      if (wd >> lane & 1u) {
        const int a = wpre[c >> 5] + __popc(wd & below);
        if (a < nmem) {
          dead = true;
          keeper = kept >> (offset + a) & 1ull;
        } else {
          dead = (over[a] & kept) != 0ull;
        }
      }
      const unsigned dm = __ballot_sync(0xffffffffu, dead);
      const unsigned km = __ballot_sync(0xffffffffu, keeper);
      if (lane == 0) {
        alive[c >> 5] = wd & ~dm;
        keepb[c >> 5] |= km;
      }
    }
    n += __popcll(kept);
    ++rounds;
  }

  for (int c = t; c < cols; c += kThreads) {
    const int gc = col0 + c;
    if (gc < pre) keep_out[gbase + gc] = (keepb[c >> 5] >> (c & 31)) & 1u;
  }
  if (rank == 0 && t == 0) rounds_out[g] = rounds;
}

template <bool kRotated, int kCluster>
cudaError_t configure(int smem) {
  const auto kernel = nms_fused_kernel<kRotated, kCluster>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && kCluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <bool kRotated, int kCluster>
int launch(const float* geo, const float* area, const unsigned char* valid,
           unsigned char* keep, int* rounds, int g, int pre, int cols,
           float thresh, int post_max, cudaStream_t stream) {
  const int smem = layout(cols, kRotated).total;
  const cudaError_t e = configure<kRotated, kCluster>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_fused_kernel<kRotated, kCluster>
      <<<dim3(kCluster, g, 1), kThreads, smem, stream>>>(
          geo, area, valid, keep, rounds, pre, cols, thresh, post_max);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, C>) for the cluster sizes the plan takes
template <typename F>
int by_cluster(int cluster, F f) {
  switch (cluster) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches kernel F on `stream` over G groups, one cluster of `cluster` CTAs
// a group (1, 2, 4, 8 or 16), `cols` columns a CTA (a multiple of 32,
// cluster * cols >= pre); does not synchronise, allocates nothing.  Returns
// the cudaError_t of the launch (0 on success).  The caller checks shapes,
// types, contiguity, the grid (g <= 65535) and that the shared memory fits.
extern "C" int pcdet_nms_fused(const float* geo, const float* area,
                               const unsigned char* valid,
                               unsigned char* keep, int* rounds, int g,
                               int pre, int cluster, int cols, float thresh,
                               int post_max, int rotated, void* stream) {
  if (g == 0 || pre == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_cluster(cluster, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    return rotated ? launch<true, kC>(geo, area, valid, keep, rounds, g, pre,
                                      cols, thresh, post_max, s)
                   : launch<false, kC>(geo, area, valid, keep, rounds, g, pre,
                                       cols, thresh, post_max, s);
  });
}

// Kernel F's shared memory a CTA with `cols` columns, in bytes.
extern "C" int pcdet_nms_fused_smem_bytes(int rotated, int cols) {
  return layout(cols, rotated != 0).total;
}

extern "C" const char* pcdet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
