// Native (C++) kernels of the KITTI offline evaluator, on the host in f64.
//
// The port's copy of the four evaluator functions of
// pcdet_tpu/native/kitti_eval_native.cpp (which replace the PCDet
// reference's numba-JIT / numba-CUDA eval loops): rotated-box IoU by polygon
// clipping, axis-aligned image IoU, and the sequential TP/FP matching
// statistics.  Bound through ctypes by
// pcdet_tpu_torch/datasets/kitti/kitti_eval/native.py, built with g++ at
// first use into build/pcdet_tpu_torch/.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (b.x - o.x) * (a.y - o.y);
}

// corners of [cx, cy, dx, dy, angle] rotated rect; row-vector convention
// p' = [px*c + py*s, -px*s + py*c] matching the rest of the framework.
inline void rect_corners(const double* b, Pt* out) {
  const double c = std::cos(b[4]), s = std::sin(b[4]);
  const double hx = b[2] / 2.0, hy = b[3] / 2.0;
  const double sx[4] = {-hx, -hx, hx, hx};
  const double sy[4] = {-hy, hy, hy, -hy};
  for (int i = 0; i < 4; ++i) {
    out[i].x = sx[i] * c + sy[i] * s + b[0];
    out[i].y = -sx[i] * s + sy[i] * c + b[1];
  }
}

inline double polygon_area(const Pt* pts, int n) {
  if (n < 3) return 0.0;
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = pts[i];
    const Pt& q = pts[(i + 1) % n];
    s += p.x * q.y - q.x * p.y;
  }
  return std::fabs(s) / 2.0;
}

// Sutherland–Hodgman clip of convex `subject` by convex CCW `clip`.
int clip_polygon(const Pt* subject, int n_subj, const Pt* clip, Pt* out) {
  Pt buf_a[16], buf_b[16];
  int n = n_subj;
  std::memcpy(buf_a, subject, sizeof(Pt) * n_subj);
  Pt* in = buf_a;
  Pt* outp = buf_b;
  for (int e = 0; e < 4 && n > 0; ++e) {
    const Pt& a = clip[e];
    const Pt& b = clip[(e + 1) % 4];
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const Pt& cur = in[i];
      const Pt& prev = in[(i + n - 1) % n];
      const bool cur_in = cross(a, b, cur) >= -1e-12;
      const bool prev_in = cross(a, b, prev) >= -1e-12;
      if (cur_in != prev_in) {
        // intersection of segment prev->cur with line a->b
        const double dx = cur.x - prev.x, dy = cur.y - prev.y;
        const double ex = b.x - a.x, ey = b.y - a.y;
        const double denom = dx * ey - dy * ex;
        if (std::fabs(denom) > 1e-16) {
          const double t = ((a.x - prev.x) * ey - (a.y - prev.y) * ex) / denom;
          outp[m].x = prev.x + t * dx;
          outp[m].y = prev.y + t * dy;
          ++m;
        }
      }
      if (cur_in) outp[m++] = cur;
    }
    std::swap(in, outp);
    n = m;
  }
  std::memcpy(out, in, sizeof(Pt) * n);
  return n;
}

// ensure CCW winding so the clipper's inside test is consistent
inline void make_ccw(Pt* c) {
  double s = 0;
  for (int i = 0; i < 4; ++i)
    s += c[i].x * c[(i + 1) % 4].y - c[(i + 1) % 4].x * c[i].y;
  if (s < 0) std::swap(c[1], c[3]);
}

double rotated_inter_area(const double* box_a, const double* box_b) {
  Pt ca[4], cb[4], clipped[16];
  rect_corners(box_a, ca);
  rect_corners(box_b, cb);
  make_ccw(ca);
  make_ccw(cb);
  const int n = clip_polygon(ca, 4, cb, clipped);
  return polygon_area(clipped, n);
}

}  // namespace

extern "C" {

// boxes: (n, 5)[x, y, dx, dy, angle], qboxes: (k, 5) -> out (n, k)
// criterion: -1 IoU, 0 inter/area_a, 1 inter/area_b, 2 raw intersection area
void rotate_iou_eval(const double* boxes, long n, const double* qboxes, long k,
                     int criterion, double* out) {
#pragma omp parallel for schedule(dynamic, 8)
  for (long i = 0; i < n; ++i) {
    const double* a = boxes + i * 5;
    const double area_a = a[2] * a[3];
    for (long j = 0; j < k; ++j) {
      const double* b = qboxes + j * 5;
      const double inter = rotated_inter_area(a, b);
      double denom;
      switch (criterion) {
        case -1: denom = area_a + b[2] * b[3] - inter; break;
        case 0: denom = area_a; break;
        case 1: denom = b[2] * b[3]; break;
        default: out[i * k + j] = inter; continue;
      }
      out[i * k + j] = denom > 0 ? inter / denom : 0.0;
    }
  }
}

// axis-aligned image-plane overlap (eval.py image_box_overlap semantics)
void image_box_overlap(const double* boxes, long n, const double* qboxes,
                       long k, int criterion, double* out) {
  for (long kk = 0; kk < k; ++kk) {
    const double* q = qboxes + kk * 4;
    const double qarea = (q[2] - q[0]) * (q[3] - q[1]);
    for (long nn = 0; nn < n; ++nn) {
      const double* b = boxes + nn * 4;
      const double iw = std::min(b[2], q[2]) - std::max(b[0], q[0]);
      double val = 0.0;
      if (iw > 0) {
        const double ih = std::min(b[3], q[3]) - std::max(b[1], q[1]);
        if (ih > 0) {
          double ua;
          if (criterion == -1)
            ua = (b[2] - b[0]) * (b[3] - b[1]) + qarea - iw * ih;
          else if (criterion == 0)
            ua = (b[2] - b[0]) * (b[3] - b[1]);
          else if (criterion == 1)
            ua = qarea;
          else
            ua = 1.0;
          val = iw * ih / ua;
        }
      }
      out[nn * k + kk] = val;
    }
  }
}

// Sequential TP/FP matching for one frame (eval.py compute_statistics_jit).
// overlaps: (det_size, gt_size) row-major [j, i] = det j vs gt i.
// gt_datas: (gt_size, 5) [bbox4, alpha]; dt_datas: (det_size, 6)
// [bbox4, alpha, score]. Returns tp, fp, fn, similarity in out4 and match
// thresholds (scores of TPs) in out_thresholds (size gt_size), count in
// out_n_thresh.
void compute_statistics(const double* overlaps, long det_size, long gt_size,
                        const double* gt_datas, const double* dt_datas,
                        const long* ignored_gt, const long* ignored_det,
                        const double* dc_bboxes, long dc_size, int metric,
                        double min_overlap, double thresh, int compute_fp,
                        int compute_aos, double* out4, double* out_thresholds,
                        long* out_n_thresh) {
  const double NO_DETECTION = -10000000.0;
  std::vector<char> assigned(det_size, 0);
  std::vector<char> ignored_threshold(det_size, 0);
  if (compute_fp) {
    for (long i = 0; i < det_size; ++i)
      if (dt_datas[i * 6 + 5] < thresh) ignored_threshold[i] = 1;
  }
  long tp = 0, fp = 0, fn = 0;
  double similarity = 0.0;
  long thresh_idx = 0;
  std::vector<double> delta(gt_size, 0.0);
  long delta_idx = 0;

  for (long i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    long det_idx = -1;
    double valid_detection = NO_DETECTION;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;

    for (long j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1) continue;
      if (assigned[j]) continue;
      if (ignored_threshold[j]) continue;
      const double overlap = overlaps[j * gt_size + i];
      const double dt_score = dt_datas[j * 6 + 5];
      if (!compute_fp && overlap > min_overlap && dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == NO_DETECTION && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
      fn += 1;
    } else if (valid_detection != NO_DETECTION &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != NO_DETECTION) {
      tp += 1;
      out_thresholds[thresh_idx++] = dt_datas[det_idx * 6 + 5];
      if (compute_aos) {
        delta[delta_idx++] = gt_datas[i * 5 + 4] - dt_datas[det_idx * 6 + 4];
      }
      assigned[det_idx] = 1;
    }
  }

  if (compute_fp) {
    for (long j = 0; j < det_size; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_threshold[j]))
        fp += 1;
    }
    long nstuff = 0;
    if (metric == 0 && dc_size > 0) {
      // overlap of dets against DontCare regions, criterion 0
      for (long i = 0; i < dc_size; ++i) {
        const double* q = dc_bboxes + i * 4;
        for (long j = 0; j < det_size; ++j) {
          if (assigned[j]) continue;
          if (ignored_det[j] == -1 || ignored_det[j] == 1) continue;
          if (ignored_threshold[j]) continue;
          const double* b = dt_datas + j * 6;
          const double iw = std::min(b[2], q[2]) - std::max(b[0], q[0]);
          double ov = 0.0;
          if (iw > 0) {
            const double ih = std::min(b[3], q[3]) - std::max(b[1], q[1]);
            if (ih > 0) {
              const double ua = (b[2] - b[0]) * (b[3] - b[1]);
              ov = ua > 0 ? iw * ih / ua : 0.0;
            }
          }
          if (ov > min_overlap) {
            assigned[j] = 1;
            nstuff += 1;
          }
        }
      }
    }
    fp -= nstuff;
    if (compute_aos) {
      if (tp > 0 || fp > 0) {
        similarity = 0.0;
        for (long i = 0; i < delta_idx; ++i)
          similarity += (1.0 + std::cos(delta[i])) / 2.0;
      } else {
        similarity = -1.0;
      }
    }
  }

  out4[0] = static_cast<double>(tp);
  out4[1] = static_cast<double>(fp);
  out4[2] = static_cast<double>(fn);
  out4[3] = similarity;
  *out_n_thresh = thresh_idx;
}

// Accumulate PR curves over frames x thresholds
// (eval.py fused_compute_statistics).
// overlaps: part matrix (total_dt, total_gt) row-major.
void fused_compute_statistics(
    const double* overlaps, long total_gt, double* pr /* (T, 4) */,
    const long* gt_nums, const long* dt_nums, const long* dc_nums,
    long num_frames, const double* gt_datas, const double* dt_datas,
    const double* dontcares, const long* ignored_gts, const long* ignored_dets,
    int metric, double min_overlap, const double* thresholds, long num_thresh,
    int compute_aos) {
  long gt_num = 0, dt_num = 0, dc_num = 0;
  std::vector<double> frame_overlap;
  std::vector<double> tmp_thresh;
  for (long f = 0; f < num_frames; ++f) {
    const long ng = gt_nums[f], nd = dt_nums[f], ndc = dc_nums[f];
    // contiguous (nd, ng) slice of the part matrix
    frame_overlap.resize(static_cast<size_t>(nd) * ng);
    for (long j = 0; j < nd; ++j)
      std::memcpy(frame_overlap.data() + j * ng,
                  overlaps + (dt_num + j) * total_gt + gt_num,
                  sizeof(double) * ng);
    tmp_thresh.resize(std::max<long>(ng, 1));
    for (long t = 0; t < num_thresh; ++t) {
      double out4[4];
      long n_thresh = 0;
      compute_statistics(frame_overlap.data(), nd, ng,
                         gt_datas + gt_num * 5, dt_datas + dt_num * 6,
                         ignored_gts + gt_num, ignored_dets + dt_num,
                         dontcares + dc_num * 4, ndc, metric, min_overlap,
                         thresholds[t], 1, compute_aos, out4,
                         tmp_thresh.data(), &n_thresh);
      pr[t * 4 + 0] += out4[0];
      pr[t * 4 + 1] += out4[1];
      pr[t * 4 + 2] += out4[2];
      if (out4[3] != -1.0) pr[t * 4 + 3] += out4[3];
    }
    gt_num += ng;
    dt_num += nd;
    dc_num += ndc;
  }
}

}  // extern "C"
