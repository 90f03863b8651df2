// pil_ops: Pillow's 8-bit image operations in plain C++17 with a C
// interface, for the classification transforms (data/cls_transforms.py,
// data/auto_augment.py). Each function is bit-equal to Pillow's C code
// (libImaging) and to its numpy twin in data/pil_ops.py:
//
//   * mm_pil_resize: Image.resize with BILINEAR, BICUBIC (a = -0.5) or
//     LANCZOS (support 3), the 8-bit path of Resample.c: weights in
//     double, normalised to fixed point with 22 fraction bits, the
//     horizontal pass stored as uint8 before the vertical one, a pass whose
//     axis keeps its size skipped (NEAREST is fastimage.cpp's
//     mm_pil_nearest, Pillow's own path);
//   * mm_pil_affine: Image.transform(AFFINE) with BILINEAR or BICUBIC and
//     a fill colour (Geometry.c ImagingGenericTransform);
//   * mm_pil_gray, mm_pil_smooth, mm_pil_blend: convert("L"),
//     filter(ImageFilter.SMOOTH) and Image.blend, the parts of ImageEnhance.
//
// Built with -ffp-contract=off into the same library as fastimage.cpp
// (native/__init__.py). Images are (H, W, C) uint8, row-major. Return
// codes: 0 on success, negative on bad arguments.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 22;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * 3.14159265358979323846;
  return std::sin(x) / x;
}

double lanczos_filter(double x) {
  // truncated sinc
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

// The filters of mm_pil_resize's codes 0, 1 and 2, and their supports.
struct Filter {
  double (*fn)(double);
  double support;
};
constexpr Filter kFilters[3] = {
    {bilinear_filter, 1.0}, {bicubic_filter, 2.0}, {lanczos_filter, 3.0}};

// Resample.c precompute_coeffs over the whole axis, then
// normalize_coeffs_8bpc: (first, count) per output pixel and `ksize` fixed
// point weights each.
int coeffs_8bpc(int in_size, int out_size, const Filter& f, std::vector<int>& bounds,
                std::vector<int32_t>& kk) {
  double (*filter)(double) = f.fn;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = f.support * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
      kk[static_cast<size_t>(xx) * ksize + x] =
          k[x] < 0 ? static_cast<int32_t>(-0.5 + k[x] * (1 << kPrecisionBits))
                   : static_cast<int32_t>(0.5 + k[x] * (1 << kPrecisionBits));
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// One pass along x (horizontal) or y (vertical): src (h, w, c) -> dst with
// the resized axis of `out` pixels.
void resample_pass(const uint8_t* src, int h, int w, int c, uint8_t* dst, int out,
                   bool horizontal, const Filter& filter) {
  std::vector<int> bounds;
  std::vector<int32_t> kk;
  const int ksize = coeffs_8bpc(horizontal ? w : h, out, filter, bounds, kk);
  const int ow = horizontal ? out : w;
  const int oh = horizontal ? h : out;
  for (int yy = 0; yy < oh; ++yy) {
    for (int xx = 0; xx < ow; ++xx) {
      const int i = horizontal ? xx : yy;
      const int first = bounds[i * 2], count = bounds[i * 2 + 1];
      const int32_t* k = &kk[static_cast<size_t>(i) * ksize];
      for (int ch = 0; ch < c; ++ch) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int t = 0; t < count; ++t) {
          const size_t at = horizontal
                                ? (static_cast<size_t>(yy) * w + first + t) * c + ch
                                : (static_cast<size_t>(first + t) * w + xx) * c + ch;
          ss += static_cast<int32_t>(src[at]) * k[t];
        }
        dst[(static_cast<size_t>(yy) * ow + xx) * c + ch] = clip8(ss);
      }
    }
  }
}

inline int floor_int(double v) {  // Geometry.c FLOOR
  return v < 0.0 ? static_cast<int>(std::floor(v)) : static_cast<int>(v);
}

inline int clampi(int v, int hi) { return v < 0 ? 0 : (v < hi ? v : hi - 1); }

// Geometry.c's BICUBIC macro (a = -1).
inline double cubic(double v1, double v2, double v3, double v4, double d) {
  const double p1 = v2;
  const double p2 = -v1 + v3;
  const double p3 = 2 * (v1 - v2) + v3 - v4;
  const double p4 = -v1 + v2 - v3 + v4;
  return p1 + d * (p2 + d * (p3 + d * p4));
}

}  // namespace

extern "C" {

// Image.resize((dw, dh), BILINEAR (filter 0), BICUBIC (1) or LANCZOS (2))
// of (sh, sw, c) uint8.
int mm_pil_resize(const uint8_t* src, int sh, int sw, int c, uint8_t* dst, int dh, int dw,
                  int filter) {
  if (sh <= 0 || sw <= 0 || c <= 0 || dh <= 0 || dw <= 0 || filter < 0 || filter > 2)
    return -1;
  const Filter& f = kFilters[filter];
  const bool need_h = dw != sw, need_v = dh != sh;
  if (!need_h && !need_v) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * c);
    return 0;
  }
  if (need_h && need_v) {
    std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * c);
    resample_pass(src, sh, sw, c, tmp.data(), dw, true, f);
    resample_pass(tmp.data(), sh, dw, c, dst, dh, false, f);
  } else if (need_h) {
    resample_pass(src, sh, sw, c, dst, dw, true, f);
  } else {
    resample_pass(src, sh, sw, c, dst, dh, false, f);
  }
  return 0;
}

// Image.transform(size, AFFINE, m, BICUBIC or BILINEAR, fillcolor=fill) of
// (h, w, c) uint8 into (h, w, c): output pixel (x, y) samples the source at
// m applied to (x + 0.5, y + 0.5); a point outside the image keeps the fill.
int mm_pil_affine(const uint8_t* src, int h, int w, int c, uint8_t* dst, const double* m,
                  int bicubic, const uint8_t* fill) {
  if (h <= 0 || w <= 0 || c <= 0) return -1;
  const double a0 = m[0], a1 = m[1], a2 = m[2], a3 = m[3], a4 = m[4], a5 = m[5];
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      uint8_t* out = dst + (static_cast<size_t>(y) * w + x) * c;
      const double xo = x + 0.5, yo = y + 0.5;
      double xin = a0 * xo + a1 * yo + a2;
      double yin = a3 * xo + a4 * yo + a5;
      if (xin < 0.0 || xin >= w || yin < 0.0 || yin >= h) {
        std::memcpy(out, fill, c);
        continue;
      }
      xin -= 0.5;
      yin -= 0.5;
      int xi = floor_int(xin), yi = floor_int(yin);
      const double dx = xin - xi, dy = yin - yi;
      auto row = [&](int r) { return src + static_cast<size_t>(r) * w * c; };
      if (!bicubic) {
        const int x0 = clampi(xi, w) * c, x1 = clampi(xi + 1, w) * c;
        const uint8_t* in0 = row(clampi(yi, h));
        const bool has1 = yi + 1 >= 0 && yi + 1 < h;
        const uint8_t* in1 = has1 ? row(yi + 1) : nullptr;
        for (int b = 0; b < c; ++b) {
          double v1 = in0[x0 + b] + (in0[x1 + b] - in0[x0 + b]) * dx;
          double v2 = has1 ? in1[x0 + b] + (in1[x1 + b] - in1[x0 + b]) * dx : v1;
          v1 = v1 + (v2 - v1) * dy;
          out[b] = static_cast<uint8_t>(v1);
        }
      } else {
        xi -= 1;
        yi -= 1;
        int xs[4];
        for (int t = 0; t < 4; ++t) xs[t] = clampi(xi + t, w) * c;
        for (int b = 0; b < c; ++b) {
          double v[4];
          for (int r = 0; r < 4; ++r) {
            const int yr = yi + r;
            if (r > 0 && (yr < 0 || yr >= h)) {
              v[r] = v[r - 1];
              continue;
            }
            const uint8_t* in = row(clampi(yr, h));
            v[r] = cubic(in[xs[0] + b], in[xs[1] + b], in[xs[2] + b], in[xs[3] + b], dx);
          }
          const double v1 = cubic(v[0], v[1], v[2], v[3], dy);
          out[b] = v1 <= 0.0 ? 0 : (v1 >= 255.0 ? 255 : static_cast<uint8_t>(v1));
        }
      }
    }
  }
  return 0;
}

// convert("L") of n RGB pixels.
int mm_pil_gray(const uint8_t* src, long n, uint8_t* dst) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    dst[i] = static_cast<uint8_t>((p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
  }
  return 0;
}

// filter(ImageFilter.SMOOTH) of (h, w, c) uint8 (Filter.c ImagingFilter3x3):
// kernel 1,1,1 / 1,5,1 / 1,1,1 over 13 in float32, rounded by the offset
// 0.5 and truncated; the first and last rows and columns are copied.
int mm_pil_smooth(const uint8_t* src, int h, int w, int c, uint8_t* dst) {
  if (h <= 0 || w <= 0 || c <= 0) return -1;
  std::memcpy(dst, src, static_cast<size_t>(h) * w * c);
  if (h < 3 || w < 3) return 0;
  const float k = 1.0f / 13.0f, k5 = 5.0f / 13.0f;
  const size_t stride = static_cast<size_t>(w) * c;
  for (int y = 1; y < h - 1; ++y) {
    const uint8_t* up = src + (y - 1) * stride;
    const uint8_t* mid = src + y * stride;
    const uint8_t* down = src + (y + 1) * stride;
    uint8_t* out = dst + y * stride;
    for (int x = 1; x < w - 1; ++x) {
      for (int b = 0; b < c; ++b) {
        const size_t l = (x - 1) * c + b, m = x * c + b, r = (x + 1) * c + b;
        float ss = 0.5f;
        ss += static_cast<float>(down[l]) * k + static_cast<float>(down[m]) * k +
              static_cast<float>(down[r]) * k;
        ss += static_cast<float>(mid[l]) * k + static_cast<float>(mid[m]) * k5 +
              static_cast<float>(mid[r]) * k;
        ss += static_cast<float>(up[l]) * k + static_cast<float>(up[m]) * k +
              static_cast<float>(up[r]) * k;
        out[m] = ss <= 0.0f ? 0 : (ss >= 255.0f ? 255 : static_cast<uint8_t>(ss));
      }
    }
  }
  return 0;
}

// Image.blend(a, b, alpha) over n bytes: a + alpha (b - a) in float32,
// truncated; clipped to [0, 255] where alpha lies outside [0, 1].
int mm_pil_blend(const uint8_t* a, const uint8_t* b, long n, float alpha, uint8_t* dst) {
  if (alpha == 0.0f) {
    std::memcpy(dst, a, n);
    return 0;
  }
  if (alpha == 1.0f) {
    std::memcpy(dst, b, n);
    return 0;
  }
  const bool inside = alpha >= 0.0f && alpha <= 1.0f;
  for (long i = 0; i < n; ++i) {
    const float v = static_cast<float>(a[i]) + alpha * static_cast<float>(b[i] - a[i]);
    if (inside)
      dst[i] = static_cast<uint8_t>(v);
    else
      dst[i] = v <= 0.0f ? 0 : (v >= 255.0f ? 255 : static_cast<uint8_t>(v));
  }
  return 0;
}

}  // extern "C"
