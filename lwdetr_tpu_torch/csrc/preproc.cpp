// Host image preprocessing of the PyTorch/CUDA port's data loader.
//
// The port's own copy of the resize and normalize of `native/preproc.cpp`,
// the JAX package's native preprocessing: a PIL-compatible antialiased
// bilinear resize (triangle filter with support scaled by the downsampling
// ratio, separable horizontal and vertical passes, float32 taps) and the fused
// ImageNet normalization to float32, one C call per image. The JPEG decode is
// not here: the loader hands in the RGB8 pixels that Pillow's libjpeg decoded
// (`lwdetr_tpu_torch/data/native.py`), so the library needs no libjpeg
// headers to build.
//
// Plain C ABI, loaded through ctypes; built with g++ at first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

namespace {

// PIL-style antialiased triangle (bilinear) resampling coefficients:
// support = 1.0 * max(in/out, 1); weights normalized to sum 1.
struct Coeffs {
  std::vector<int> bounds;   // first source index per output pixel
  std::vector<int> counts;   // number of taps per output pixel
  std::vector<float> weights;  // taps, k_max per pixel stride
  int kmax;
};

Coeffs make_coeffs(int in_size, int out_size) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support
  const int kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.kmax = kmax;
  c.bounds.resize(out_size);
  c.counts.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * kmax, 0.f);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double total = 0.0;
    std::vector<double> ww(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      double t = (x + 0.5 - center) / filterscale;
      double wgt = (t < 0 ? -t : t) < 1.0 ? 1.0 - std::fabs(t) : 0.0;
      ww[x - xmin] = wgt;
      total += wgt;
    }
    if (total <= 0.0) total = 1.0;
    c.bounds[i] = xmin;
    c.counts[i] = xmax - xmin;
    for (int k = 0; k < xmax - xmin; ++k)
      c.weights[static_cast<size_t>(i) * kmax + k] =
          static_cast<float>(ww[k] / total);
  }
  return c;
}

}  // namespace

// Antialiased bilinear resize of an RGB8 HWC image to float32 HWC in [0,255].
void resize_bilinear_f32(const uint8_t* src, int sh, int sw, float* dst,
                         int dh, int dw) {
  Coeffs cx = make_coeffs(sw, dw);
  Coeffs cy = make_coeffs(sh, dh);
  // horizontal pass: (sh, sw, 3) u8 -> (sh, dw, 3) f32
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int x0 = cx.bounds[x], n = cx.counts[x];
      const float* wgt = &cx.weights[static_cast<size_t>(x) * cx.kmax];
      float r = 0, g = 0, b = 0;
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = srow + static_cast<size_t>(x0 + k) * 3;
        const float wk = wgt[k];
        r += wk * p[0];
        g += wk * p[1];
        b += wk * p[2];
      }
      trow[x * 3 + 0] = r;
      trow[x * 3 + 1] = g;
      trow[x * 3 + 2] = b;
    }
  }
  // vertical pass: (sh, dw, 3) -> (dh, dw, 3)
  for (int y = 0; y < dh; ++y) {
    const int y0 = cy.bounds[y], n = cy.counts[y];
    const float* wgt = &cy.weights[static_cast<size_t>(y) * cy.kmax];
    float* drow = dst + static_cast<size_t>(y) * dw * 3;
    std::memset(drow, 0, sizeof(float) * dw * 3);
    for (int k = 0; k < n; ++k) {
      const float wk = wgt[k];
      const float* trow = tmp.data() + static_cast<size_t>(y0 + k) * dw * 3;
      for (int i = 0; i < dw * 3; ++i) drow[i] += wk * trow[i];
    }
  }
}

// Fused: RGB8 HWC pixels -> square-resized, ImageNet-normalized float32 HWC.
void resize_normalize(const uint8_t* rgb, int h, int w, int size, float* out,
                      const float* mean, const float* stdv) {
  std::vector<float> resized(static_cast<size_t>(size) * size * 3);
  resize_bilinear_f32(rgb, h, w, resized.data(), size, size);
  const float inv255 = 1.0f / 255.0f;
  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  const float i0 = inv255 / stdv[0], i1 = inv255 / stdv[1], i2 = inv255 / stdv[2];
  const float o0 = m0 / stdv[0], o1 = m1 / stdv[1], o2 = m2 / stdv[2];
  const size_t n = static_cast<size_t>(size) * size;
  for (size_t i = 0; i < n; ++i) {
    out[i * 3 + 0] = resized[i * 3 + 0] * i0 - o0;
    out[i * 3 + 1] = resized[i * 3 + 1] * i1 - o1;
    out[i * 3 + 2] = resized[i * 3 + 2] * i2 - o2;
  }
}

}  // extern "C"
