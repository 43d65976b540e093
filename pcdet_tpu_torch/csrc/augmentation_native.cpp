// Native (C++) per-object noise search for the host augmentation pipeline.
//
// Replaces the numba-JIT noise_per_box retry loop of the reference
// (pcdet/datasets/data_augmentation/augmentation_utils.py:148-174): for each
// GT box, try up to `num_try` (loc, rot) perturbations and accept the first
// that collides with no other box.  The Python/numpy port pays ~100 ms per
// sample for its per-candidate vectorised collision call; here the whole
// search is a few microseconds.
//
// Semantics mirror the numpy twin exactly (strict CCW segment crossings,
// standup-bbox prefilter, mutual containment, first-success update of the
// live corner set) so the two paths are interchangeable.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct P2 {
  float x, y;
};

// (c.y - a.y) * (b.x - a.x) > (b.y - a.y) * (c.x - a.x)
inline bool ccw(P2 a, P2 b, P2 c) {
  return (c.y - a.y) * (b.x - a.x) > (b.y - a.y) * (c.x - a.x);
}

// box: [x, y, dx, dy, rot] -> 4 corners, same winding as the numpy twin
inline void box_to_corners(const float* b, P2* out) {
  static const float cn[4][2] = {
      {-0.5f, -0.5f}, {-0.5f, 0.5f}, {0.5f, 0.5f}, {0.5f, -0.5f}};
  float c = std::cos(b[4]), s = std::sin(b[4]);
  for (int k = 0; k < 4; ++k) {
    float cx = b[2] * cn[k][0];
    float cy = b[3] * cn[k][1];
    out[k].x = cx * c + cy * s + b[0];
    out[k].y = -cx * s + cy * c + b[1];
  }
}

inline bool contains_all(const P2* outer, const P2* inner) {
  for (int k = 0; k < 4; ++k) {
    P2 v{outer[(k + 1) & 3].x - outer[k].x,
         outer[(k + 1) & 3].y - outer[k].y};
    for (int l = 0; l < 4; ++l) {
      float cross = v.y * (outer[k].x - inner[l].x)
                    - v.x * (outer[k].y - inner[l].y);
      if (!(cross < 0.0f)) return false;
    }
  }
  return true;
}

inline bool rect_collide(const P2* A, const P2* B) {
  float minax = A[0].x, maxax = A[0].x, minay = A[0].y, maxay = A[0].y;
  float minbx = B[0].x, maxbx = B[0].x, minby = B[0].y, maxby = B[0].y;
  for (int k = 1; k < 4; ++k) {
    minax = std::fmin(minax, A[k].x); maxax = std::fmax(maxax, A[k].x);
    minay = std::fmin(minay, A[k].y); maxay = std::fmax(maxay, A[k].y);
    minbx = std::fmin(minbx, B[k].x); maxbx = std::fmax(maxbx, B[k].x);
    minby = std::fmin(minby, B[k].y); maxby = std::fmax(maxby, B[k].y);
  }
  if (std::fmin(maxax, maxbx) - std::fmax(minax, minbx) <= 0.0f) return false;
  if (std::fmin(maxay, maxby) - std::fmax(minay, minby) <= 0.0f) return false;

  for (int i = 0; i < 4; ++i) {
    P2 a = A[i], b = A[(i + 1) & 3];
    for (int j = 0; j < 4; ++j) {
      P2 cp = B[j], d = B[(j + 1) & 3];
      bool acd = ccw(a, d, cp);
      bool bcd = ccw(b, d, cp);
      bool abc = ccw(a, b, cp);
      bool abd = ccw(a, b, d);
      if (acd != bcd && abc != abd) return true;
    }
  }
  return contains_all(A, B) || contains_all(B, A);
}

}  // namespace

extern "C" {

// boxes: (N, 5) f32 [x, y, dx, dy, rot]; valid: (N,) u8;
// loc_noises: (N, T, 3) f32; rot_noises: (N, T) f32;
// selected: (N,) i64 out (first accepted try per box, or -1).
void noise_per_box_native(const float* boxes, const uint8_t* valid,
                          const float* loc_noises, const float* rot_noises,
                          int64_t n, int64_t t, int64_t* selected) {
  std::vector<P2> corners(static_cast<size_t>(n) * 4);
  for (int64_t i = 0; i < n; ++i) {
    box_to_corners(boxes + i * 5, &corners[i * 4]);
    selected[i] = -1;
  }
  P2 cand[4];
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    const float* box = boxes + i * 5;
    for (int64_t j = 0; j < t; ++j) {
      float rot = rot_noises[i * t + j];
      float c = std::cos(rot), s = std::sin(rot);
      const float* loc = loc_noises + (i * t + j) * 3;
      for (int k = 0; k < 4; ++k) {
        float bx = corners[i * 4 + k].x - box[0];
        float by = corners[i * 4 + k].y - box[1];
        cand[k].x = bx * c + by * s + box[0] + loc[0];
        cand[k].y = -bx * s + by * c + box[1] + loc[1];
      }
      bool coll = false;
      for (int64_t m = 0; m < n && !coll; ++m) {
        if (m == i) continue;
        coll = rect_collide(cand, &corners[m * 4]);
      }
      if (!coll) {
        selected[i] = j;
        for (int k = 0; k < 4; ++k) corners[i * 4 + k] = cand[k];
        break;
      }
    }
  }
}

// points: (P, stride) f32 xyz first; boxes: (N, 7) f32 [x,y,z,w,l,h,rz]
// (z = bottom face); mask: (N, P) u8 out.
void points_in_rbboxes_native(const float* points, int64_t p, int64_t stride,
                              const float* boxes, int64_t n, uint8_t* mask) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float* b = boxes + i * 7;
    float c = std::cos(-b[6]), s = std::sin(-b[6]);
    float hw = b[3] * 0.5f, hl = b[4] * 0.5f, h = b[5];
    uint8_t* row = mask + i * p;
    for (int64_t j = 0; j < p; ++j) {
      const float* pt = points + j * stride;
      float dx = pt[0] - b[0], dy = pt[1] - b[1], dz = pt[2] - b[2];
      float lx = dx * c + dy * s;
      float ly = -dx * s + dy * c;
      row[j] = (std::fabs(lx) <= hw) & (std::fabs(ly) <= hl)
               & (dz >= 0.0f) & (dz <= h);
    }
  }
}

}  // extern "C"
