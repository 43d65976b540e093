// Host-side sparse-conv rulebook builders (OpenMP), for pcdet_tpu_torch.
//
// A copy of pcdet_tpu/native/host_books_native.cpp with the same C symbols
// and signatures, so the port's books are bit-identical to pcdet_tpu's.
// Built with g++ at first use by pcdet_tpu_torch/ops/host_books.py into
// build/pcdet_tpu_torch/ and bound with ctypes.  The voxel coords come to
// the host once per batch; the books are built here and uploaded in one
// copy.
//
// Wire format:
//   rows  : uint16 (N, K)   — input row per (output, tap); K <= 32
//   found : uint32 (N,)     — bit t set iff tap t has a contributor
//
// Algorithms:
//   subm    : per lex-positive tap, ONE two-pointer merge of the sorted id
//             list against itself shifted by the tap's linear offset; the
//             negative half mirrors by rulebook antisymmetry
//             (rows[i][t]=j  <=>  rows[j][K-1-t]=i for odd kernels).
//   strided : the candidate stream of each (dz,dy,dx) offset is already
//             sorted (inputs are lex-sorted and o = floor((c+p-d)/s) is
//             monotone), so the output set is a K-way MERGE of <= 8
//             cursor streams — no candidate materialisation, no sort.
//
// Semantics bit-match the numpy builders of ops/host_books.py
// (tests/test_torch_port_imports.py holds both against pcdet_tpu's).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int64_t linearize(const int32_t* c, int H, int W) {
    return ((int64_t)c[0] * H + c[1]) * W + c[2];
}

}  // namespace

extern "C" {

// Subm (output sites == input sites) k=(kd,kh,kw) odd-kernel rulebook.
// coords (B, V, 3) int32 ZYX sorted by linear id with a valid prefix of
// length n_valid[b]; rows (B, V, K) uint16; found (B, V) uint32 bitpack.
void subm_books_batch(const int32_t* coords, const int32_t* n_valid,
                      int B, int V, int D, int H, int W,
                      int kd, int kh, int kw,
                      uint16_t* rows, uint32_t* found) {
    const int K = kd * kh * kw;
    std::memset(rows, 0, (size_t)B * V * K * sizeof(uint16_t));
    std::memset(found, 0, (size_t)B * V * sizeof(uint32_t));

#pragma omp parallel for schedule(dynamic, 1)
    for (int b = 0; b < B; ++b) {
        const int n = n_valid[b];
        const int32_t* cs = coords + (size_t)b * V * 3;
        std::vector<int64_t> ids(n);
        for (int i = 0; i < n; ++i) ids[i] = linearize(cs + i * 3, H, W);
        uint16_t* rb = rows + (size_t)b * V * K;
        uint32_t* fb = found + (size_t)b * V;
        // center tap: identity
        const int tc = K / 2;
        for (int i = 0; i < n; ++i) {
            rb[(size_t)i * K + tc] = (uint16_t)i;
            fb[i] |= (1u << tc);
        }
        // lex-positive taps; the negative half mirrors (offs[K-1-t] =
        // -offs[t] for odd kernels, and the mirrored site is always in
        // bounds because it IS an existing voxel's coordinate)
        for (int t = tc + 1; t < K; ++t) {
            const int ez = t / (kh * kw) - kd / 2;
            const int ey = (t / kw) % kh - kh / 2;
            const int ex = t % kw - kw / 2;
            const int64_t off = ((int64_t)ez * H + ey) * W + ex;
            const int tm = K - 1 - t;
            int j = 0;
            for (int i = 0; i < n; ++i) {
                const int64_t q = ids[i] + off;
                while (j < n && ids[j] < q) ++j;
                if (j >= n) break;
                if (ids[j] != q) continue;
                const int32_t* ci = cs + i * 3;
                if (ci[0] + ez < 0 || ci[0] + ez >= D ||
                    ci[1] + ey < 0 || ci[1] + ey >= H ||
                    ci[2] + ex < 0 || ci[2] + ex >= W)
                    continue;
                rb[(size_t)i * K + t] = (uint16_t)j;
                fb[i] |= (1u << t);
                rb[(size_t)j * K + tm] = (uint16_t)i;
                fb[j] |= (1u << tm);
            }
        }
    }
}

// Strided conv/pool output set + forward rulebook.
// Candidates pack to (out_id << 24 | tap*V + in_row) uint64 (origin < 2^24
// since V*K <= 65536*32; out grids < 2^40) and one LSD radix sort (16-bit
// digits over the out_id bits only — the origin bits don't affect the
// result, (out, tap) pairs being unique) replaces std::sort.
// out_ids (B, O) int32 INT32_MAX-padded; out_coords (B, O, 3) int32 (-1
// pad); out_n (B,) valid output count (prefix); dropped (B,) int32;
// rows (B, O, K) uint16; found (B, O) uint32 bitpack.
void strided_books_batch(const int32_t* coords, const int32_t* n_valid,
                         int B, int V, int D, int H, int W,
                         int kd, int kh, int kw,
                         int sd, int sh, int sw,
                         int pd, int ph, int pw, int out_cap,
                         int32_t* out_ids, int32_t* out_coords,
                         int32_t* out_n, int32_t* dropped,
                         uint16_t* rows, uint32_t* found) {
    const int K = kd * kh * kw;
    const int OD = (D + 2 * pd - kd) / sd + 1;
    const int OH = (H + 2 * ph - kh) / sh + 1;
    const int OW = (W + 2 * pw - kw) / sw + 1;
    const int ncd = (kd + sd - 1) / sd, nch = (kh + sh - 1) / sh,
              ncw = (kw + sw - 1) / sw;
    const int32_t I32MAX = 2147483647;
    // radix digits needed to cover the out_id bits (origin bits skipped)
    int oid_bits = 0;
    while ((1LL << oid_bits) < (int64_t)OD * OH * OW) ++oid_bits;

    std::memset(rows, 0, (size_t)B * out_cap * K * sizeof(uint16_t));
    std::memset(found, 0, (size_t)B * out_cap * sizeof(uint32_t));

#pragma omp parallel for schedule(dynamic, 1)
    for (int b = 0; b < B; ++b) {
        const int n = n_valid[b];
        const int32_t* cs = coords + (size_t)b * V * 3;
        std::vector<uint64_t> cand;
        cand.reserve((size_t)n * ncd * nch * ncw);
        for (int i = 0; i < n; ++i) {
            const int z = cs[i * 3], y = cs[i * 3 + 1], x = cs[i * 3 + 2];
            // o in [ceil((c+p-k+1)/s), floor((c+p)/s)] ∩ [0, O)
            const int zl = z + pd - kd + 1, yl = y + ph - kh + 1,
                      xl = x + pw - kw + 1;
            int oz0 = zl > 0 ? (zl + sd - 1) / sd : zl / sd;
            int oy0 = yl > 0 ? (yl + sh - 1) / sh : yl / sh;
            int ox0 = xl > 0 ? (xl + sw - 1) / sw : xl / sw;
            if (oz0 < 0) oz0 = 0;
            if (oy0 < 0) oy0 = 0;
            if (ox0 < 0) ox0 = 0;
            const int oz1 = (z + pd) / sd, oy1 = (y + ph) / sh,
                      ox1 = (x + pw) / sw;
            for (int oz = oz0; oz <= oz1 && oz < OD; ++oz)
                for (int oy = oy0; oy <= oy1 && oy < OH; ++oy)
                    for (int ox = ox0; ox <= ox1 && ox < OW; ++ox) {
                        const int tz = z + pd - oz * sd;
                        const int ty = y + ph - oy * sh;
                        const int tx = x + pw - ox * sw;
                        const int t = (tz * kh + ty) * kw + tx;
                        const uint64_t oid =
                            ((uint64_t)oz * OH + oy) * OW + ox;
                        cand.push_back((oid << 24) |
                                       ((uint64_t)t * V + i));
                    }
        }
        // LSD radix over the out_id bits (16-bit digits)
        {
            std::vector<uint64_t> tmp(cand.size());
            uint64_t* src = cand.data();
            uint64_t* dst = tmp.data();
            size_t cnt[65536];
            for (int shift = 24; shift < 24 + oid_bits; shift += 16) {
                std::memset(cnt, 0, sizeof(cnt));
                const size_t m = cand.size();
                for (size_t c = 0; c < m; ++c)
                    ++cnt[(src[c] >> shift) & 0xffff];
                size_t acc = 0;
                for (int d = 0; d < 65536; ++d) {
                    const size_t v = cnt[d];
                    cnt[d] = acc;
                    acc += v;
                }
                for (size_t c = 0; c < m; ++c)
                    dst[cnt[(src[c] >> shift) & 0xffff]++] = src[c];
                std::swap(src, dst);
            }
            if (src != cand.data())
                std::memcpy(cand.data(), src,
                            cand.size() * sizeof(uint64_t));
        }

        int32_t* oi = out_ids + (size_t)b * out_cap;
        int32_t* oc = out_coords + (size_t)b * out_cap * 3;
        uint16_t* rb = rows + (size_t)b * out_cap * K;
        uint32_t* fb = found + (size_t)b * out_cap;
        for (int r = 0; r < out_cap; ++r) {
            oi[r] = I32MAX;
            oc[r * 3] = oc[r * 3 + 1] = oc[r * 3 + 2] = -1;
        }
        int rank = -1;
        uint64_t prev = ~0ull;
        int n_unique = 0;
        for (size_t c = 0; c < cand.size(); ++c) {
            const uint64_t oid = cand[c] >> 24;
            if (oid != prev) {
                prev = oid;
                ++n_unique;
                ++rank;
                if (rank < out_cap) {
                    oi[rank] = (int32_t)oid;
                    oc[rank * 3] = (int32_t)(oid / ((uint64_t)OH * OW));
                    oc[rank * 3 + 1] = (int32_t)((oid / OW) % OH);
                    oc[rank * 3 + 2] = (int32_t)(oid % OW);
                }
            }
            if (rank >= out_cap) continue;
            const uint32_t origin = (uint32_t)(cand[c] & 0xffffffu);
            const int t = (int)(origin / V);
            const int in_row = (int)(origin % V);
            rb[(size_t)rank * K + t] = (uint16_t)in_row;
            fb[rank] |= (1u << t);
        }
        out_n[b] = n_unique < out_cap ? n_unique : out_cap;
        dropped[b] = n_unique > out_cap ? n_unique - out_cap : 0;
    }
}

}  // extern "C"
