// Greedy mAP detection<->ground-truth matcher (native hot path): the port's
// copy of podtpu/native/map_matcher.cpp.
//
// The matching stage of VOC mAP is inherently sequential (one detection may
// consume a ground truth, changing the outcome for every later detection),
// so it stays on the host; there it dominates large validation runs when
// implemented in Python (the reference loops per detection per GT:
// utils/yolo_utils.py:404-430 of the reference). This is the same algorithm
// in C++: detections must arrive sorted by descending confidence; ground
// truths are grouped per image once; each detection takes the best-IoU GT of
// its image and claims it if IoU > threshold and it is unclaimed.
//
// Row formats (float32):
//   dets: [n_det, 7]  (img_idx, cx, cy, w, h, conf, cls) — already one class
//   gts:  [n_gt, 7]   same layout
// Outputs tp/fp: float32[n_det], aligned with the input detection order.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

inline float iou_center(const float* a, const float* b) {
  // a, b point at (cx, cy, w, h)
  const float ax1 = a[0] - a[2] * 0.5f, ay1 = a[1] - a[3] * 0.5f;
  const float ax2 = a[0] + a[2] * 0.5f, ay2 = a[1] + a[3] * 0.5f;
  const float bx1 = b[0] - b[2] * 0.5f, by1 = b[1] - b[3] * 0.5f;
  const float bx2 = b[0] + b[2] * 0.5f, by2 = b[1] + b[3] * 0.5f;
  const float iw = std::min(ax2, bx2) - std::max(ax1, bx1);
  const float ih = std::min(ay2, by2) - std::max(ay1, by1);
  if (iw <= 0.f || ih <= 0.f) return 0.f;
  const float inter = iw * ih;
  const float area_a = (ax2 - ax1) * (ay2 - ay1);
  const float area_b = (bx2 - bx1) * (by2 - by1);
  const float ua = area_a + area_b - inter + 1e-6f;
  return inter / ua;
}

}  // namespace

extern "C" {

// Returns 0 on success.
int class_tp_fp(const float* dets, int64_t n_det, const float* gts,
                int64_t n_gt, float iou_threshold, float* tp, float* fp) {
  // Group ground truths by image index.
  std::unordered_map<int64_t, std::vector<int64_t>> gt_by_img;
  gt_by_img.reserve(static_cast<size_t>(n_gt));
  for (int64_t g = 0; g < n_gt; ++g) {
    gt_by_img[static_cast<int64_t>(gts[g * 7])].push_back(g);
  }
  std::vector<uint8_t> used(static_cast<size_t>(n_gt), 0);

  for (int64_t d = 0; d < n_det; ++d) {
    tp[d] = 0.f;
    fp[d] = 0.f;
    const float* det = dets + d * 7;
    auto it = gt_by_img.find(static_cast<int64_t>(det[0]));
    if (it == gt_by_img.end() || it->second.empty()) {
      fp[d] = 1.f;
      continue;
    }
    float best_iou = 0.f;
    int64_t best_g = -1;
    for (int64_t g : it->second) {
      const float v = iou_center(det + 1, gts + g * 7 + 1);
      if (v > best_iou) {  // strict >, first-wins on ties (reference quirk)
        best_iou = v;
        best_g = g;
      }
    }
    if (best_iou > iou_threshold && best_g >= 0 && !used[best_g]) {
      tp[d] = 1.f;
      used[best_g] = 1;
    } else {
      fp[d] = 1.f;
    }
  }
  return 0;
}

}  // extern "C"
