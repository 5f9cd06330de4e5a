// codetr_torch native host library: the host work around the exported
// forward, in C++ with a plain C ABI (ctypes in utils/native.py, linked by
// the runner csrc/codetr_aoti_runner.cpp).  A copy of the JAX package's
// csrc/codetr_host.cpp with the same ABI; the port keeps its own copy.
//
//   * codetr_preprocess: keep-ratio bilinear resize (OpenCV INTER_LINEAR
//     sampling semantics), mean/std normalize, corner zero-pad to the static
//     network shape, and the padding mask.
//   * codetr_batched_nms: greedy per-class NMS with score threshold.
//
// Built at first use by ops/_build.py:build_host (g++ -O3 -shared -fPIC,
// C++17) into codetr_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// RGB uint8 HWC input -> float32 HWC output (out_h, out_w, 3), normalized and
// corner-padded with zeros; mask (out_h, out_w) gets 1.0 in padding.
// Returns 0 on success.  scale_out[2] = (w_scale, h_scale); resized_out[2] =
// (resized_h, resized_w).
int codetr_preprocess(const uint8_t* rgb, int in_h, int in_w, int out_h,
                      int out_w, const float* mean, const float* std_,
                      int keep_ratio, float* out, float* mask,
                      float* scale_out, int* resized_out) {
  if (!rgb || !out || !mask || in_h <= 0 || in_w <= 0 || out_h <= 0 ||
      out_w <= 0)
    return -1;
  int th = out_h, tw = out_w;
  if (keep_ratio) {
    // mmcv rescale: scale = min(new/old); size = round(old * scale + 0.5)
    const double scale =
        std::min(static_cast<double>(out_w) / in_w,
                 static_cast<double>(out_h) / in_h);
    tw = static_cast<int>(in_w * scale + 0.5);
    th = static_cast<int>(in_h * scale + 0.5);
  }
  tw = std::min(tw, out_w);
  th = std::min(th, out_h);

  const double sx = static_cast<double>(in_w) / tw;
  const double sy = static_cast<double>(in_h) / th;
  const float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};

  std::memset(out, 0, sizeof(float) * out_h * out_w * 3);
  for (int y = 0; y < th; ++y) {
    // OpenCV INTER_LINEAR: src = (dst + 0.5) * scale - 0.5, edge-clamped
    double fy = (y + 0.5) * sy - 0.5;
    int y0 = static_cast<int>(std::floor(fy));
    double wy = fy - y0;
    int y0c = std::clamp(y0, 0, in_h - 1);
    int y1c = std::clamp(y0 + 1, 0, in_h - 1);
    if (fy < 0) { wy = 0.0; }
    float* dst_row = out + static_cast<size_t>(y) * out_w * 3;
    const uint8_t* r0 = rgb + static_cast<size_t>(y0c) * in_w * 3;
    const uint8_t* r1 = rgb + static_cast<size_t>(y1c) * in_w * 3;
    for (int x = 0; x < tw; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      int x0 = static_cast<int>(std::floor(fx));
      double wx = fx - x0;
      int x0c = std::clamp(x0, 0, in_w - 1);
      int x1c = std::clamp(x0 + 1, 0, in_w - 1);
      if (fx < 0) { wx = 0.0; }
      const double w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const double w10 = wy * (1 - wx), w11 = wy * wx;
      for (int c = 0; c < 3; ++c) {
        const double v = w00 * r0[x0c * 3 + c] + w01 * r0[x1c * 3 + c] +
                         w10 * r1[x0c * 3 + c] + w11 * r1[x1c * 3 + c];
        dst_row[x * 3 + c] =
            (static_cast<float>(v) - mean[c]) * inv_std[c];
      }
    }
  }
  for (int y = 0; y < out_h; ++y)
    for (int x = 0; x < out_w; ++x)
      mask[static_cast<size_t>(y) * out_w + x] =
          (y < th && x < tw) ? 0.0f : 1.0f;
  if (scale_out) {
    scale_out[0] = static_cast<float>(tw) / in_w;
    scale_out[1] = static_cast<float>(th) / in_h;
  }
  if (resized_out) {
    resized_out[0] = th;
    resized_out[1] = tw;
  }
  return 0;
}

// Greedy per-class NMS on xyxy boxes.  keep[i] set to 1 for surviving boxes.
// Returns number kept, or -1 on error.
int codetr_batched_nms(const float* boxes, const float* scores,
                       const int32_t* labels, int n, float iou_threshold,
                       float score_threshold, uint8_t* keep) {
  if (!boxes || !scores || !labels || !keep || n < 0) return -1;
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<float> area(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    area[i] = std::max(b[2] - b[0], 0.0f) * std::max(b[3] - b[1], 0.0f);
  }
  std::memset(keep, 0, n);
  std::vector<int> kept;
  kept.reserve(n);
  int count = 0;
  for (int oi : order) {
    if (scores[oi] < score_threshold || !std::isfinite(scores[oi])) continue;
    const float* bi = boxes + 4 * oi;
    bool suppressed = false;
    for (int kj : kept) {
      if (labels[kj] != labels[oi]) continue;
      const float* bj = boxes + 4 * kj;
      const float ix1 = std::max(bi[0], bj[0]);
      const float iy1 = std::max(bi[1], bj[1]);
      const float ix2 = std::min(bi[2], bj[2]);
      const float iy2 = std::min(bi[3], bj[3]);
      const float inter =
          std::max(ix2 - ix1, 0.0f) * std::max(iy2 - iy1, 0.0f);
      const float uni = area[oi] + area[kj] - inter;
      if (uni > 0 && inter / uni > iou_threshold) {
        suppressed = true;
        break;
      }
    }
    if (!suppressed) {
      kept.push_back(oi);
      keep[oi] = 1;
      ++count;
    }
  }
  return count;
}

// Library identification for loader smoke tests.
const char* codetr_host_version() { return "codetr-torch-host-0.1.0"; }

}  // extern "C"
