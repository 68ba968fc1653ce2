// Native host-side image preprocessing: PIL-compatible bicubic resize +
// center crop on uint8 HWC images.
//
// The benchmark's input pipeline (reference feature.py:534-549) is
// Resize(shorter->224, bicubic) + CenterCrop(224).  PIL-bicubic differs from
// jax.image/tf bicubic (SURVEY.md §7.3 item 6), so decode-side resizing must
// reproduce PIL's separable convolution: the cubic filter with a=-0.5,
// support widened by the scale factor when downsampling, and per-output-pixel
// weight normalisation.  This library is the fast path used by
// pevit_tpu/data/transforms.py (ctypes); PIL remains the fallback.
//
// Build: g++ -O3 -shared -fPIC -o _image_ops.so image_ops.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kA = -0.5;  // PIL bicubic a-parameter

inline double bicubic_filter(double x) {
  x = std::abs(x);
  if (x < 1.0) return ((kA + 2.0) * x - (kA + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * kA;
  return 0.0;
}

struct Coeffs {
  std::vector<int> bounds;     // (out, 2): start index, count
  std::vector<double> values;  // (out, kmax)
  int kmax;
};

// Precompute normalized filter coefficients for one axis (PIL scheme).
Coeffs precompute(int in_size, int out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2
  const int kmax = static_cast<int>(std::ceil(support)) * 2 + 1;

  Coeffs c;
  c.kmax = kmax;
  c.bounds.resize(out_size * 2);
  c.values.assign(static_cast<size_t>(out_size) * kmax, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;

    double* k = &c.values[static_cast<size_t>(xx) * kmax];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic_filter((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(double v) {
  long r = std::lround(v);
  if (r < 0) return 0;
  if (r > 255) return 255;
  return static_cast<uint8_t>(r);
}

inline uint8_t clip8(float v) {
  int r = static_cast<int>(v + (v >= 0.f ? 0.5f : -0.5f));
  if (r < 0) return 0;
  if (r > 255) return 255;
  return static_cast<uint8_t>(r);
}

}  // namespace

extern "C" {

// Resize uint8 HWC -> uint8 HWC with PIL-compatible bicubic.
void resize_bicubic_u8(const uint8_t* src, int in_h, int in_w, int channels,
                       uint8_t* dst, int out_h, int out_w) {
  Coeffs ch = precompute(in_w, out_w);
  Coeffs cv = precompute(in_h, out_h);

  const int kmax_h = ch.kmax, kmax_v = cv.kmax;
  std::vector<float> kh(ch.values.begin(), ch.values.end());
  std::vector<float> kv(cv.values.begin(), cv.values.end());

  // horizontal pass; PIL quantises the intermediate to uint8 between passes
  // (ImagingResampleHorizontal_8bpc) — match that for bit-level parity
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * channels);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* __restrict row = src + static_cast<size_t>(y) * in_w * channels;
    uint8_t* __restrict trow = tmp.data() + static_cast<size_t>(y) * out_w * channels;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = ch.bounds[xx * 2];
      const int xcount = ch.bounds[xx * 2 + 1];
      const float* __restrict k = &kh[static_cast<size_t>(xx) * kmax_h];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      const uint8_t* __restrict p = row + xmin * channels;
      if (channels == 3) {
        for (int x = 0; x < xcount; ++x, p += 3) {
          const float w = k[x];
          acc0 += p[0] * w;
          acc1 += p[1] * w;
          acc2 += p[2] * w;
        }
        trow[xx * 3 + 0] = clip8(acc0);
        trow[xx * 3 + 1] = clip8(acc1);
        trow[xx * 3 + 2] = clip8(acc2);
      } else {
        for (int c = 0; c < channels; ++c) {
          float acc = 0.f;
          for (int x = 0; x < xcount; ++x) acc += row[(xmin + x) * channels + c] * k[x];
          trow[xx * channels + c] = clip8(acc);
        }
      }
    }
  }
  // vertical pass: accumulate whole output rows (contiguous, vectorisable)
  const int row_elems = out_w * channels;
  std::vector<float> accrow(row_elems);
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = cv.bounds[yy * 2];
    const int ycount = cv.bounds[yy * 2 + 1];
    const float* __restrict k = &kv[static_cast<size_t>(yy) * kmax_v];
    std::fill(accrow.begin(), accrow.end(), 0.f);
    for (int y = 0; y < ycount; ++y) {
      const uint8_t* __restrict trow = tmp.data() + static_cast<size_t>(ymin + y) * row_elems;
      const float w = k[y];
      for (int i = 0; i < row_elems; ++i) accrow[i] += trow[i] * w;
    }
    uint8_t* __restrict drow = dst + static_cast<size_t>(yy) * row_elems;
    for (int i = 0; i < row_elems; ++i) drow[i] = clip8(accrow[i]);
  }
}

// torchvision Resize(shorter->size) + CenterCrop(size) on uint8 HWC RGB.
// Geometry matches torchvision exactly: the long side TRUNCATES
// (functional.resize uses int(size * long / short)) and crop offsets use
// round-half-even (Python round()) — nearbyint under the default FP mode.
void resize_center_crop_u8(const uint8_t* src, int in_h, int in_w, int channels,
                           uint8_t* dst, int size) {
  int new_w, new_h;
  if (in_w <= in_h) {
    new_w = size;
    new_h = std::max(size, static_cast<int>(static_cast<double>(in_h) * size / in_w));
  } else {
    new_h = size;
    new_w = std::max(size, static_cast<int>(static_cast<double>(in_w) * size / in_h));
  }
  std::vector<uint8_t> resized(static_cast<size_t>(new_h) * new_w * channels);
  resize_bicubic_u8(src, in_h, in_w, channels, resized.data(), new_h, new_w);

  const int left = static_cast<int>(std::nearbyint((new_w - size) / 2.0));
  const int top = static_cast<int>(std::nearbyint((new_h - size) / 2.0));
  for (int y = 0; y < size; ++y) {
    std::memcpy(dst + static_cast<size_t>(y) * size * channels,
                resized.data() + (static_cast<size_t>(top + y) * new_w + left) * channels,
                static_cast<size_t>(size) * channels);
  }
}

// Batched variant: n images of identical (in_h, in_w, C).
void resize_center_crop_batch_u8(const uint8_t* src, int n, int in_h, int in_w,
                                 int channels, uint8_t* dst, int size) {
  const size_t in_stride = static_cast<size_t>(in_h) * in_w * channels;
  const size_t out_stride = static_cast<size_t>(size) * size * channels;
  for (int i = 0; i < n; ++i)
    resize_center_crop_u8(src + i * in_stride, in_h, in_w, channels,
                          dst + i * out_stride, size);
}

}  // extern "C"
