// fastimage: the port's host-side image work in plain C++17 with a C
// interface, bound with ctypes by native/__init__.py (no Python headers, no
// library beyond libstdc++). Counterpart of the JAX package's
// multimae_tpu/native/fastimage.cpp and of the cv2 calls of its semantic
// segmentation augmentations:
//
//   * PIL's antialiased separable resampling: the fused crop + resize +
//     flip + normalise of RGB (fastimage's mm_crop_resize_normalize) and its
//     uint8 form, PIL's "I;16" bicubic resize of depth maps, PIL's NEAREST
//     scale of segmentation maps;
//   * PNG row unfiltering (all five filters of PNG spec 9.2) and sample
//     expansion; the inflate stays in Python's zlib;
//   * cv2.resize INTER_LINEAR (uint8 fixed point and float32) and
//     INTER_NEAREST, COLOR_RGB2GRAY, COLOR_RGB2HSV and COLOR_HSV2RGB;
//   * cv2.GaussianBlur(x, (3, 3), sigmaX=1) on float32 (Taskonomy's
//     edge_occlusion maps).
//
// Each function is bit-equal to its numpy twin in data/ (the functions
// named *_twin). Built with -ffp-contract=off: a multiply-add is fused only
// where it is written as std::fma, as cv2 fuses the two in HSV2RGB and in
// its separable filters.
// Return codes: 0 on success, negative on bad arguments.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// --- PIL-style antialiased separable resampling ------------------------------

struct FilterSpec {
  double support;
  double (*fn)(double);
};

double bilinear_filter(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

double bicubic_filter(double x) {  // PIL: Catmull-Rom style a = -0.5
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

FilterSpec filter_spec(int bicubic) {
  return bicubic ? FilterSpec{2.0, bicubic_filter} : FilterSpec{1.0, bilinear_filter};
}

// Contribution windows of one axis (PIL's precompute_coeffs): the window
// [in0, in1) of `in_size` pixels resized to `out_size`, the support scaled by
// the downscale ratio (antialiasing). The filter's argument is
// (x - center + 0.5) / filterscale in fastimage.cpp, and
// (x - center + 0.5) * (1 / filterscale) in PIL's Resample.c (`pil_scale`).
struct Coeffs {
  std::vector<int> first, count;
  std::vector<double> k;
  int ksize = 0;
};

Coeffs build_coeffs(int in_size, double in0, double in1, int out_size, const FilterSpec& f,
                    bool pil_scale) {
  Coeffs c;
  const double scale = (in1 - in0) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double ss = 1.0 / filterscale;
  const double support = f.support * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.first.resize(out_size);
  c.count.resize(out_size);
  c.k.assign(static_cast<size_t>(out_size) * c.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    const int xmin = std::max(0, static_cast<int>(std::floor(center - support + 0.5)));
    const int xmax = std::min(in_size, static_cast<int>(std::floor(center + support + 0.5)));
    double* k = &c.k[static_cast<size_t>(xx) * c.ksize];
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double arg = pil_scale ? (x - center + 0.5) * ss : (x - center + 0.5) / filterscale;
      const double w = f.fn(arg);
      k[x - xmin] = w;
      total += w;
    }
    if (total != 0.0)
      for (int x = 0; x < xmax - xmin; ++x) k[x] /= total;
    c.first[xx] = xmin;
    c.count[xx] = std::max(0, xmax - xmin);
  }
  return c;
}

// PIL's 16-bit store: round half away from zero, then its byte clipping
// (negative -> 0; past 65535 the high byte clips to 255).
inline uint16_t round_u16(double v) {
  const int64_t r = static_cast<int64_t>(v >= 0.0 ? std::floor(v + 0.5) : std::ceil(v - 0.5));
  if (r < 0) return 0;
  const int64_t hi = std::min<int64_t>(r >> 8, 255);
  return static_cast<uint16_t>(hi * 256 + (r & 0xFF));
}

// --- cv2 -------------------------------------------------------------------

constexpr int kCoefBits = 11;      // OpenCV's INTER_RESIZE_COEF_BITS
constexpr int kHsvShift = 12;
constexpr int kHsv2RgbLanes = 32;  // pixels per step of OpenCV's HSV2RGB_b vector loop

// OpenCV's linear taps along one axis: the two source indices and float32
// weights of each output position. `clamp` (the columns) moves a tap that
// falls off either border onto the edge with weight 1; otherwise only the
// indices are clamped (the rows). `exact_float` keeps the positions in
// double (the float32 path); else they are rounded to float32 first.
struct LinearTaps {
  std::vector<int> i0, i1;
  std::vector<float> w0, w1;
};

LinearTaps linear_taps(int src_len, int dst_len, bool clamp, bool exact_float) {
  LinearTaps t;
  t.i0.resize(dst_len);
  t.i1.resize(dst_len);
  t.w0.resize(dst_len);
  t.w1.resize(dst_len);
  const double inv = 1.0 / (static_cast<double>(dst_len) / src_len);
  for (int d = 0; d < dst_len; ++d) {
    const double pos = (d + 0.5) * inv - 0.5;
    int64_t start;
    float frac;
    if (exact_float) {
      const double s = std::floor(pos);
      start = static_cast<int64_t>(s);
      frac = static_cast<float>(pos - s);
    } else {
      const float p = static_cast<float>(pos);
      const float s = std::floor(p);
      start = static_cast<int64_t>(s);
      frac = p - s;
    }
    if (clamp) {
      if (start < 0) {
        frac = 0.0f;
        start = 0;
      } else if (start >= src_len - 1) {
        frac = 0.0f;
        start = src_len - 1;
      }
    }
    t.i0[d] = static_cast<int>(std::clamp<int64_t>(start, 0, src_len - 1));
    t.i1[d] = static_cast<int>(std::clamp<int64_t>(start + 1, 0, src_len - 1));
    t.w0[d] = 1.0f - frac;
    t.w1[d] = frac;
  }
  return t;
}

struct HsvTables {
  int sdiv[256], hdiv[256];
  HsvTables() {
    for (int i = 0; i < 256; ++i) {
      sdiv[i] = i ? static_cast<int>(std::nearbyint((255 << kHsvShift) / static_cast<double>(i))) : 0;
      hdiv[i] = i ? static_cast<int>(std::nearbyint((180 << kHsvShift) / (6.0 * i))) : 0;
    }
  }
};

const HsvTables& hsv_tables() {
  static const HsvTables t;
  return t;
}

// (b, g, r) picks from (v, p, q, t) per hue sector
constexpr int kSectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};

// HSV2RGB per (H, S) byte pair: the hue sector, and the factors of v
// (1 - s, 1 - s*h and 1 - s*(1 - h), the last two as fused multiply-adds)
// with h the hue's fraction within its sector.
struct Hsv2RgbTables {
  uint8_t sector[256];
  float factor[256 * 256][3];
  Hsv2RgbTables() {
    const float hscale = static_cast<float>(6.0 / 180.0);
    const float inv255 = static_cast<float>(1.0 / 255.0);
    for (int hb = 0; hb < 256; ++hb) {
      float h = hb * hscale;
      if (h >= 6.0f) h -= 6.0f;
      const int sec = static_cast<int>(h);  // floor: h >= 0
      h -= static_cast<float>(sec);
      sector[hb] = static_cast<uint8_t>(sec);
      for (int sb = 0; sb < 256; ++sb) {
        const float s = sb * inv255;
        float* f = factor[hb << 8 | sb];
        f[0] = 1.0f - s;
        f[1] = std::fma(-s, h, 1.0f);
        f[2] = std::fma(-s, 1.0f - h, 1.0f);
      }
    }
  }
};

const Hsv2RgbTables& hsv2rgb_tables() {
  static const Hsv2RgbTables t;
  return t;
}

// PNG: the predictor of the Paeth filter (PNG spec 9.4).
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  const int ab = pb < pa ? b : a;  // the first of a, b at the least distance
  return pc < std::min(pa, pb) ? c : ab;
}

// Undo one row's filter (PNG spec 9.2) from `in` into `cur`, given the
// previous unfiltered row; false for an unknown filter type.
bool unfilter_row(int filter, const uint8_t* in, const uint8_t* prev, uint8_t* cur, long stride,
                  int bpp) {
  const long head = std::min<long>(bpp, stride);
  switch (filter) {
    case 0:
      std::memcpy(cur, in, stride);
      return true;
    case 1:  // Sub
      std::memcpy(cur, in, head);
      for (long i = bpp; i < stride; ++i) cur[i] = static_cast<uint8_t>(in[i] + cur[i - bpp]);
      return true;
    case 2:  // Up
      for (long i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(in[i] + prev[i]);
      return true;
    case 3:  // Average
      for (long i = 0; i < head; ++i) cur[i] = static_cast<uint8_t>(in[i] + (prev[i] >> 1));
      for (long i = bpp; i < stride; ++i)
        cur[i] = static_cast<uint8_t>(in[i] + ((cur[i - bpp] + prev[i]) >> 1));
      return true;
    case 4:  // Paeth: the predictor of a = 0, c = 0 is b
      for (long i = 0; i < head; ++i) cur[i] = static_cast<uint8_t>(in[i] + prev[i]);
      for (long i = bpp; i < stride; ++i)
        cur[i] = static_cast<uint8_t>(in[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
      return true;
    default:
      return false;
  }
}

inline void copy_pixel(uint8_t* dst, const uint8_t* src, int bytes) {
  switch (bytes) {
    case 1: *dst = *src; break;
    case 2: std::memcpy(dst, src, 2); break;
    case 4: std::memcpy(dst, src, 4); break;
    default: std::memcpy(dst, src, bytes);
  }
}

}  // namespace

extern "C" {

// Crop src[crop_y:crop_y+crop_h, crop_x:crop_x+crop_w] of (sh, sw, channels)
// uint8, resize to (dh, dw) with PIL-style antialiased bilinear or bicubic
// weights centred in the crop box over the whole image, flip horizontally if
// `hflip`, and write (x / 255 - mean) / stddev as float32 HWC. The sums run
// in double with the horizontal pass stored as float32, as in fastimage.cpp.
int mm_crop_resize_normalize(const uint8_t* src, int sh, int sw, int channels, int crop_y,
                             int crop_x, int crop_h, int crop_w, float* dst, int dh, int dw,
                             const float* mean, const float* stddev, int bicubic, int hflip) {
  if (crop_y < 0 || crop_x < 0 || crop_h <= 0 || crop_w <= 0 || crop_y + crop_h > sh ||
      crop_x + crop_w > sw || dh <= 0 || dw <= 0 || channels <= 0)
    return -1;
  const FilterSpec f = filter_spec(bicubic);
  const Coeffs xc = build_coeffs(sw, crop_x, crop_x + crop_w, dw, f, false);
  const Coeffs yc = build_coeffs(sh, crop_y, crop_y + crop_h, dh, f, false);
  int y_lo = sh, y_hi = 0;
  for (int yy = 0; yy < dh; ++yy) {
    y_lo = std::min(y_lo, yc.first[yy]);
    y_hi = std::max(y_hi, yc.first[yy] + yc.count[yy]);
  }
  if (y_hi <= y_lo) y_hi = y_lo;
  const size_t row = static_cast<size_t>(dw) * channels;
  std::vector<float> temp((y_hi - y_lo) * row);
  for (int y = y_lo; y < y_hi; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * channels;
    float* trow = &temp[(y - y_lo) * row];
    for (int xx = 0; xx < dw; ++xx) {
      const double* k = &xc.k[static_cast<size_t>(xx) * xc.ksize];
      const uint8_t* s = srow + static_cast<size_t>(xc.first[xx]) * channels;
      const int n = xc.count[xx];
      if (channels == 3) {  // the three sums side by side, each in tap order
        double a0 = 0.0, a1 = 0.0, a2 = 0.0;
        for (int i = 0; i < n; ++i) {
          a0 += s[i * 3] * k[i];
          a1 += s[i * 3 + 1] * k[i];
          a2 += s[i * 3 + 2] * k[i];
        }
        trow[xx * 3] = static_cast<float>(a0);
        trow[xx * 3 + 1] = static_cast<float>(a1);
        trow[xx * 3 + 2] = static_cast<float>(a2);
        continue;
      }
      for (int c = 0; c < channels; ++c) {
        double acc = 0.0;
        for (int i = 0; i < n; ++i) acc += s[i * channels + c] * k[i];
        trow[xx * channels + c] = static_cast<float>(acc);
      }
    }
  }
  std::vector<double> acc(row);
  std::vector<float> mean_row(row), std_row(row);  // per element, for a vector loop
  for (size_t e = 0; e < row; ++e) {
    mean_row[e] = mean[e % channels];
    std_row[e] = stddev[e % channels];
  }
  for (int yy = 0; yy < dh; ++yy) {
    const double* k = &yc.k[static_cast<size_t>(yy) * yc.ksize];
    std::fill(acc.begin(), acc.end(), 0.0);
    for (int i = 0; i < yc.count[yy]; ++i) {
      const float* trow = &temp[(yc.first[yy] + i - y_lo) * row];
      const double ki = k[i];
      for (size_t e = 0; e < row; ++e) acc[e] += trow[e] * ki;
    }
    float* drow = dst + static_cast<size_t>(yy) * row;
    for (size_t e = 0; e < row; ++e)
      drow[e] = (static_cast<float>(acc[e]) / 255.0f - mean_row[e]) / std_row[e];
    if (hflip)
      for (int xx = 0; xx < dw / 2; ++xx)
        for (int c = 0; c < channels; ++c)
          std::swap(drow[xx * channels + c], drow[(dw - 1 - xx) * channels + c]);
  }
  return 0;
}

// The same resample, uint8 -> uint8: mm_crop_resize_normalize with mean 0
// and stddev 1/255, rounded half away from zero and clamped to [0, 255].
int mm_crop_resize_u8(const uint8_t* src, int sh, int sw, int channels, int crop_y, int crop_x,
                      int crop_h, int crop_w, uint8_t* dst, int dh, int dw, int bicubic,
                      int hflip) {
  if (channels <= 0 || channels > 16) return -1;
  std::vector<float> tmp(static_cast<size_t>(dh > 0 ? dh : 0) * (dw > 0 ? dw : 0) * channels);
  float zeros[16] = {0}, scale[16];
  for (int i = 0; i < 16; ++i) scale[i] = 1.0f / 255.0f;
  const int rc = mm_crop_resize_normalize(src, sh, sw, channels, crop_y, crop_x, crop_h, crop_w,
                                          tmp.data(), dh, dw, zeros, scale, bicubic, hflip);
  if (rc != 0) return rc;
  for (size_t i = 0; i < tmp.size(); ++i)
    dst[i] = static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, std::round(tmp[i]))));
  return 0;
}

// PIL's bicubic resize of an "I;16" image (Resample.c, 16-bit path) applied
// to the crop of (sh, sw) uint16, to (dh, dw), flipped if `hflip`: each pass
// sums in double and rounds half away from zero to 16 bits (round_u16).
int mm_crop_resize_u16(const uint16_t* src, int sh, int sw, int crop_y, int crop_x, int crop_h,
                       int crop_w, uint16_t* dst, int dh, int dw, int hflip) {
  if (crop_y < 0 || crop_x < 0 || crop_h <= 0 || crop_w <= 0 || crop_y + crop_h > sh ||
      crop_x + crop_w > sw || dh <= 0 || dw <= 0)
    return -1;
  const FilterSpec f = filter_spec(1);
  const Coeffs xc = build_coeffs(crop_w, 0.0, crop_w, dw, f, true);
  const Coeffs yc = build_coeffs(crop_h, 0.0, crop_h, dh, f, true);
  int y_lo = crop_h, y_hi = 0;
  for (int yy = 0; yy < dh; ++yy) {
    y_lo = std::min(y_lo, yc.first[yy]);
    y_hi = std::max(y_hi, yc.first[yy] + yc.count[yy]);
  }
  if (y_hi <= y_lo) y_hi = y_lo;
  std::vector<uint16_t> temp(static_cast<size_t>(y_hi - y_lo) * dw);
  for (int y = y_lo; y < y_hi; ++y) {
    const uint16_t* srow = src + static_cast<size_t>(crop_y + y) * sw + crop_x;
    uint16_t* trow = &temp[static_cast<size_t>(y - y_lo) * dw];
    for (int xx = 0; xx < dw; ++xx) {
      const double* k = &xc.k[static_cast<size_t>(xx) * xc.ksize];
      const uint16_t* s = srow + xc.first[xx];
      double acc = 0.0;
      for (int i = 0; i < xc.count[xx]; ++i) acc += s[i] * k[i];
      trow[xx] = round_u16(acc);
    }
  }
  std::vector<double> acc(dw);
  for (int yy = 0; yy < dh; ++yy) {
    const double* k = &yc.k[static_cast<size_t>(yy) * yc.ksize];
    std::fill(acc.begin(), acc.end(), 0.0);
    for (int i = 0; i < yc.count[yy]; ++i) {
      const uint16_t* trow = &temp[static_cast<size_t>(yc.first[yy] + i - y_lo) * dw];
      const double ki = k[i];
      for (int xx = 0; xx < dw; ++xx) acc[xx] += trow[xx] * ki;
    }
    uint16_t* drow = dst + static_cast<size_t>(yy) * dw;
    for (int xx = 0; xx < dw; ++xx) drow[hflip ? dw - 1 - xx : xx] = round_u16(acc[xx]);
  }
  return 0;
}

// PIL's NEAREST resize of a 16-bit gray ("I;16") image, whose special type
// sends it down Geometry.c's ImagingGenericTransform (ImagingScaleAffine
// takes the 8-bit and 32-bit modes): source index = int(step * (i + 0.5)),
// the affine map of each output pixel's centre in double.
int mm_pil_nearest_i16(const uint16_t* src, int sh, int sw, uint16_t* dst, int dh, int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0) return -1;
  auto index = [](int in_size, int out_size) {
    std::vector<int> idx(out_size);
    const double step = static_cast<double>(in_size) / out_size;
    for (int i = 0; i < out_size; ++i) idx[i] = static_cast<int>(step * (i + 0.5));
    return idx;
  };
  const std::vector<int> ys = index(sh, dh), xs = index(sw, dw);
  for (int yy = 0; yy < dh; ++yy) {
    const uint16_t* srow = src + static_cast<size_t>(ys[yy]) * sw;
    uint16_t* drow = dst + static_cast<size_t>(yy) * dw;
    for (int xx = 0; xx < dw; ++xx) drow[xx] = srow[xs[xx]];
  }
  return 0;
}

// PIL's NEAREST resize (Geometry.c ImagingScaleAffine) of the crop of a
// (sh, sw) image of `pixel_bytes`-byte pixels to (dh, dw), flipped if
// `hflip`: source index = int of the pixel centre, the centre starting at
// step / 2 and advanced by step, summed step by step as PIL does.
int mm_pil_nearest(const uint8_t* src, int sh, int sw, int pixel_bytes, int crop_y, int crop_x,
                   int crop_h, int crop_w, uint8_t* dst, int dh, int dw, int hflip) {
  if (crop_y < 0 || crop_x < 0 || crop_h <= 0 || crop_w <= 0 || crop_y + crop_h > sh ||
      crop_x + crop_w > sw || dh <= 0 || dw <= 0 || pixel_bytes <= 0)
    return -1;
  auto index = [](int in_size, int out_size) {
    std::vector<int> idx(out_size);
    const double step = static_cast<double>(in_size) / out_size;
    double c = step * 0.5;
    for (int i = 0; i < out_size; ++i, c += step)
      idx[i] = static_cast<int>(std::min<int64_t>(static_cast<int64_t>(c), in_size - 1));
    return idx;
  };
  const std::vector<int> ys = index(crop_h, dh), xs = index(crop_w, dw);
  for (int yy = 0; yy < dh; ++yy) {
    const uint8_t* srow =
        src + (static_cast<size_t>(crop_y + ys[yy]) * sw + crop_x) * pixel_bytes;
    uint8_t* drow = dst + static_cast<size_t>(yy) * dw * pixel_bytes;
    for (int xx = 0; xx < dw; ++xx)
      copy_pixel(drow + static_cast<size_t>(hflip ? dw - 1 - xx : xx) * pixel_bytes,
                 srow + static_cast<size_t>(xs[xx]) * pixel_bytes, pixel_bytes);
  }
  return 0;
}

// PNG image data after inflate -> samples. `raw` holds `height` rows of a
// filter byte and `stride` = ceil(width * channels * depth / 8) bytes.
// mode 0: every sample (gray of 1/2/4 bits scaled to 0-255, palette indices
// one byte each, 16-bit samples in native byte order);
// mode 1: the same with alpha dropped;
// mode 2: RGB uint8 (palette entries past `palette_len` black, gray
// repeated, alpha dropped; 8-bit images only).
// Returns 0, -1 for bad arguments or a size mismatch, or y + 1 where row y
// has an unknown filter type.
int mm_png_decode(const uint8_t* raw, long raw_len, int width, int height, int depth,
                  int color_type, const uint8_t* palette, int palette_len, int mode,
                  uint8_t* out) {
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  if (width <= 0 || height <= 0 || color_type < 0 || color_type > 6 ||
      kChannels[color_type] == 0 || mode < 0 || mode > 2)
    return -1;
  const int channels = kChannels[color_type];
  const long bits = static_cast<long>(channels) * depth;
  const long stride = (width * bits + 7) / 8;
  if (raw_len != height * (stride + 1)) return -1;
  if (mode == 2 && depth == 16) return -1;
  const int bpp = std::max<int>(1, static_cast<int>(bits / 8));
  const int keep = mode == 0 ? channels : (color_type == 4 ? 1 : (color_type == 6 ? 3 : channels));
  uint8_t pal[256 * 3] = {0};
  if (color_type == 3) std::memcpy(pal, palette, std::min(palette_len, 256) * 3);
  // Rows are unfiltered straight into `out` where it holds them unchanged.
  const bool in_place = depth == 8 && mode != 2 && keep == channels;
  std::vector<uint8_t> zero(stride, 0), rows(in_place ? 0 : 2 * stride);
  const uint8_t* prev = zero.data();
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = raw + static_cast<long>(y) * (stride + 1);
    uint8_t* cur = in_place ? out + static_cast<size_t>(y) * stride
                            : rows.data() + (y % 2) * stride;
    if (!unfilter_row(line[0], line + 1, prev, cur, stride, bpp)) return y + 1;
    prev = cur;
    if (in_place) continue;
    if (depth == 16) {
      uint16_t* o = reinterpret_cast<uint16_t*>(out) + static_cast<size_t>(y) * width * keep;
      if (keep == channels) {
        for (long i = 0; i < static_cast<long>(width) * channels; ++i)
          o[i] = static_cast<uint16_t>(cur[2 * i] << 8 | cur[2 * i + 1]);
      } else {
        for (int x = 0; x < width; ++x)
          for (int c = 0; c < keep; ++c) {
            const uint8_t* s = &cur[(static_cast<size_t>(x) * channels + c) * 2];
            o[x * keep + c] = static_cast<uint16_t>(s[0] << 8 | s[1]);
          }
      }
      continue;
    }
    const int out_c = mode == 2 ? 3 : keep;
    uint8_t* o = out + static_cast<size_t>(y) * width * out_c;
    if (depth < 8) {  // one channel: gray or palette indices, most significant bits first
      const int mask = (1 << depth) - 1, per_byte = 8 / depth;
      const int gray_scale = color_type == 0 ? 255 / mask : 1;
      for (int x = 0; x < width; ++x) {
        const int shift = 8 - depth * (x % per_byte + 1);
        const int v = (cur[x / per_byte] >> shift) & mask;
        if (mode == 2) {
          if (color_type == 3) {
            std::memcpy(o + x * 3, pal + v * 3, 3);
          } else {
            o[x * 3] = o[x * 3 + 1] = o[x * 3 + 2] = static_cast<uint8_t>(v * gray_scale);
          }
        } else {
          o[x] = static_cast<uint8_t>(v * gray_scale);
        }
      }
    } else if (mode == 2) {
      for (int x = 0; x < width; ++x) {
        const uint8_t* s = &cur[static_cast<size_t>(x) * channels];
        if (color_type == 3) {
          std::memcpy(o + x * 3, pal + s[0] * 3, 3);
        } else if (color_type == 0 || color_type == 4) {
          o[x * 3] = o[x * 3 + 1] = o[x * 3 + 2] = s[0];
        } else {
          o[x * 3] = s[0];
          o[x * 3 + 1] = s[1];
          o[x * 3 + 2] = s[2];
        }
      }
    } else {
      for (int x = 0; x < width; ++x)
        for (int c = 0; c < keep; ++c) o[x * keep + c] = cur[static_cast<size_t>(x) * channels + c];
    }
  }
  return 0;
}

// cv2.resize(src, (dw, dh), interpolation=INTER_LINEAR) of (sh, sw, channels)
// uint8: OpenCV's fixed-point path. 11-bit coefficients rounded from float32
// positions, a horizontal pass in integers, and the vectorised vertical pass
// that shifts each row sum right by 4, keeps the high 16 bits of its product
// with the coefficient and rounds the sum of the two by 2 bits.
int mm_cv_resize_linear_u8(const uint8_t* src, int sh, int sw, int channels, uint8_t* dst,
                           int dh, int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || channels <= 0) return -1;
  const LinearTaps xt = linear_taps(sw, dw, true, false);
  const LinearTaps yt = linear_taps(sh, dh, false, false);
  const float one = static_cast<float>(1 << kCoefBits);
  std::vector<int> ax0(dw), ax1(dw), by0(dh), by1(dh);
  for (int x = 0; x < dw; ++x) {
    ax0[x] = static_cast<int>(std::nearbyint(xt.w0[x] * one));
    ax1[x] = static_cast<int>(std::nearbyint(xt.w1[x] * one));
  }
  for (int y = 0; y < dh; ++y) {
    by0[y] = static_cast<int>(std::nearbyint(yt.w0[y] * one));
    by1[y] = static_cast<int>(std::nearbyint(yt.w1[y] * one));
  }
  const size_t row = static_cast<size_t>(dw) * channels;
  // The horizontal rows of the two source rows the output row reads, each
  // shifted right by 4 (at most 255 * 2048 >> 4 = 32640: int16, as in
  // OpenCV's vertical pass), kept while the next output rows read them.
  std::vector<int16_t> rows(2 * row);
  int16_t* slot[2] = {rows.data(), rows.data() + row};
  int held[2] = {-1, -1};
  auto horizontal = [&](int y, int16_t* h) {
    const uint8_t* s = src + static_cast<size_t>(y) * sw * channels;
    if (channels == 3) {
      for (int x = 0; x < dw; ++x) {
        const uint8_t* p0 = s + xt.i0[x] * 3;
        const uint8_t* p1 = s + xt.i1[x] * 3;
        const int a0 = ax0[x], a1 = ax1[x];
        h[x * 3] = static_cast<int16_t>((p0[0] * a0 + p1[0] * a1) >> 4);
        h[x * 3 + 1] = static_cast<int16_t>((p0[1] * a0 + p1[1] * a1) >> 4);
        h[x * 3 + 2] = static_cast<int16_t>((p0[2] * a0 + p1[2] * a1) >> 4);
      }
    } else {
      for (int x = 0; x < dw; ++x) {
        const uint8_t* p0 = s + static_cast<size_t>(xt.i0[x]) * channels;
        const uint8_t* p1 = s + static_cast<size_t>(xt.i1[x]) * channels;
        for (int c = 0; c < channels; ++c)
          h[x * channels + c] = static_cast<int16_t>((p0[c] * ax0[x] + p1[c] * ax1[x]) >> 4);
      }
    }
  };
  for (int y = 0; y < dh; ++y) {
    const int need[2] = {yt.i0[y], yt.i1[y]};
    if (held[1] == need[0] || held[0] == need[1]) {  // keep what is held, in order
      std::swap(slot[0], slot[1]);
      std::swap(held[0], held[1]);
    }
    for (int k = 0; k < 2; ++k)
      if (held[k] != need[k]) {
        horizontal(need[k], slot[k]);
        held[k] = need[k];
      }
    const int16_t* top = slot[0];
    const int16_t* bottom = slot[1];
    const int16_t b0 = static_cast<int16_t>(by0[y]), b1 = static_cast<int16_t>(by1[y]);
    uint8_t* d = dst + static_cast<size_t>(y) * row;
    for (size_t e = 0; e < row; ++e) {
      const int16_t hi0 = static_cast<int16_t>((static_cast<int32_t>(top[e]) * b0) >> 16);
      const int16_t hi1 = static_cast<int16_t>((static_cast<int32_t>(bottom[e]) * b1) >> 16);
      const int v = (hi0 + hi1 + 2) >> 2;
      d[e] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  return 0;
}

// The same for float32: coefficients from double positions, each pass a
// float32 sum of two float32 products.
int mm_cv_resize_linear_f32(const float* src, int sh, int sw, int channels, float* dst, int dh,
                            int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || channels <= 0) return -1;
  const LinearTaps xt = linear_taps(sw, dw, true, true);
  const LinearTaps yt = linear_taps(sh, dh, false, true);
  const size_t row = static_cast<size_t>(dw) * channels;
  std::vector<float> hor(static_cast<size_t>(sh) * row);
  std::vector<char> done(sh, 0);
  auto horizontal = [&](int y) {
    float* h = &hor[static_cast<size_t>(y) * row];
    if (done[y]) return h;
    const float* s = src + static_cast<size_t>(y) * sw * channels;
    for (int x = 0; x < dw; ++x) {
      const float* p0 = s + static_cast<size_t>(xt.i0[x]) * channels;
      const float* p1 = s + static_cast<size_t>(xt.i1[x]) * channels;
      for (int c = 0; c < channels; ++c) h[x * channels + c] = p0[c] * xt.w0[x] + p1[c] * xt.w1[x];
    }
    done[y] = 1;
    return h;
  };
  for (int y = 0; y < dh; ++y) {
    const float* top = horizontal(yt.i0[y]);
    const float* bottom = horizontal(yt.i1[y]);
    const float b0 = yt.w0[y], b1 = yt.w1[y];
    float* d = dst + static_cast<size_t>(y) * row;
    for (size_t e = 0; e < row; ++e) d[e] = top[e] * b0 + bottom[e] * b1;
  }
  return 0;
}

// cv2.resize(src, (dw, dh), interpolation=INTER_NEAREST) of (sh, sw) pixels
// of `pixel_bytes` bytes: source index floor(dst * (1 / (dst_len /
// src_len))), clamped.
int mm_cv_resize_nearest(const uint8_t* src, int sh, int sw, int pixel_bytes, uint8_t* dst,
                         int dh, int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || pixel_bytes <= 0) return -1;
  auto index = [](int src_len, int dst_len) {
    std::vector<int> idx(dst_len);
    const double inv = 1.0 / (static_cast<double>(dst_len) / src_len);
    for (int i = 0; i < dst_len; ++i)
      idx[i] = std::min(static_cast<int>(std::floor(i * inv)), src_len - 1);
    return idx;
  };
  const std::vector<int> ys = index(sh, dh), xs = index(sw, dw);
  for (int y = 0; y < dh; ++y) {
    const uint8_t* s = src + static_cast<size_t>(ys[y]) * sw * pixel_bytes;
    uint8_t* d = dst + static_cast<size_t>(y) * dw * pixel_bytes;
    for (int x = 0; x < dw; ++x)
      copy_pixel(d + static_cast<size_t>(x) * pixel_bytes,
                 s + static_cast<size_t>(xs[x]) * pixel_bytes, pixel_bytes);
  }
  return 0;
}

// cv2.cvtColor(rgb, COLOR_RGB2GRAY) of n uint8 RGB pixels: 15-bit fixed point.
int mm_rgb_to_gray(const uint8_t* rgb, long n, uint8_t* gray) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = rgb + i * 3;
    gray[i] = static_cast<uint8_t>((p[0] * 9798 + p[1] * 19235 + p[2] * 3735 + (1 << 14)) >> 15);
  }
  return 0;
}

// cv2.cvtColor(rgb, COLOR_RGB2HSV) of n uint8 RGB pixels: H in [0, 180), S
// and H from OpenCV's 12-bit division tables.
int mm_rgb_to_hsv(const uint8_t* rgb, long n, uint8_t* hsv) {
  const HsvTables& t = hsv_tables();
  const int half = 1 << (kHsvShift - 1);
  for (long i = 0; i < n; ++i) {
    const int r = rgb[i * 3], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
    const int v = std::max(std::max(b, g), r);
    const int diff = v - std::min(std::min(b, g), r);
    const int s = (diff * t.sdiv[v] + half) >> kHsvShift;
    int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * t.hdiv[diff] + half) >> kHsvShift;
    if (h < 0) h += 180;
    hsv[i * 3] = static_cast<uint8_t>(h);
    hsv[i * 3 + 1] = static_cast<uint8_t>(s);
    hsv[i * 3 + 2] = static_cast<uint8_t>(v);
  }
  return 0;
}

// cv2.cvtColor(hsv, COLOR_HSV2RGB) of `rows` rows of `width` uint8 HSV
// pixels (H in [0, 180)): float32 with 1 - s*h and 1 - s*(1 - h) as fused
// multiply-adds, truncated to uint8 within the first width / 32 * 32 pixels
// of each row (OpenCV's vector loop) and rounded half to even in the rest
// (its scalar tail). The factors of v are tabled per (H, S) byte pair.
int mm_hsv_to_rgb(const uint8_t* hsv, long rows, int width, uint8_t* rgb) {
  const Hsv2RgbTables& t = hsv2rgb_tables();
  const float inv255 = static_cast<float>(1.0 / 255.0);
  const int vector = width / kHsv2RgbLanes * kHsv2RgbLanes;
  for (long y = 0; y < rows; ++y) {
    for (int x = 0; x < width; ++x) {
      const long i = y * width + x;
      const int hs = hsv[i * 3] << 8 | hsv[i * 3 + 1];
      const float v = hsv[i * 3 + 2] * inv255;
      const float tab[4] = {v, v * t.factor[hs][0], v * t.factor[hs][1], v * t.factor[hs][2]};
      const int* pick = kSectors[t.sector[hsv[i * 3]]];
      for (int c = 0; c < 3; ++c) {
        // s == 0 gives factors of 1, so every pick is v
        const float o = std::min(tab[pick[2 - c]] * 255.0f, 255.0f);  // >= 0
        rgb[i * 3 + c] = static_cast<uint8_t>(x < vector ? static_cast<int>(o)  // trunc
                                                         : static_cast<int>(std::nearbyint(o)));
      }
    }
  }
  return 0;
}

// cv2.GaussianBlur(src, (3, 3), sigmaX=1.0) of an (h, w) float32 image
// with BORDER_REFLECT_101, as OpenCV's separable filter engine runs it on
// x86 (SymmRowSmallVec_32f, SymmColumnSmallVec_32f): the taps of
// getGaussianKernel(3, 1, CV_32F); each row pixel fma(c, k0, (l + r) * k1),
// but for the last pixel of an odd-width row, which the compiled scalar
// tail gives as fma(l + r, k1, c * k0); each output fma(up + down, k1,
// centre * k0). Checked bit for bit against cv2 5.0's x86 wheel.
int mm_gaussian_blur_3x3(const float* src, int h, int w, float* dst) {
  if (h <= 0 || w <= 0) return -1;
  const float k0 = 0x1.ceb51cp-2f, k1 = 0x1.18a572p-2f;  // centre, sides
  auto reflect = [](int p, int len) {
    if (len == 1) return 0;
    return p < 0 ? -p : (p >= len ? 2 * len - 2 - p : p);
  };
  std::vector<float> rows(static_cast<size_t>(h) * w);
  for (int y = 0; y < h; ++y) {
    const float* s = src + static_cast<size_t>(y) * w;
    float* r = rows.data() + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const float c = s[x], sides = s[reflect(x - 1, w)] + s[reflect(x + 1, w)];
      r[x] = (x == w - 1 && (w & 1)) ? std::fma(sides, k1, c * k0)
                                      : std::fma(c, k0, sides * k1);
    }
  }
  for (int y = 0; y < h; ++y) {
    const float* up = rows.data() + static_cast<size_t>(reflect(y - 1, h)) * w;
    const float* mid = rows.data() + static_cast<size_t>(y) * w;
    const float* down = rows.data() + static_cast<size_t>(reflect(y + 1, h)) * w;
    float* d = dst + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) d[x] = std::fma(up[x] + down[x], k1, mid[x] * k0);
  }
  return 0;
}

// PIL's BmpRleDecoder (BmpImagePlugin.py), byte for byte: BI_RLE8 (rle4 0)
// or BI_RLE4 (rle4 1) pixels from data[start, len) into out (xsize *
// ysize bytes, the rows in file order). An encoded run stops at the row's
// end; an absolute run does not, and an odd RLE4 one drops its last pixel;
// end of line pads with zeros to the next row; delta skips right + up *
// xsize pixels (PIL reads two bytes more before the pair it uses); an
// absolute run is followed by a pad byte where the file position, counted
// from `file_offset` at data[0], is odd. Returns the pixels PIL would have
// produced (at least xsize * ysize when the bitmap is whole; only the
// first xsize * ysize are written), or -1 where PIL raises (a delta cut
// short after its first two bytes).
long mm_bmp_rle(const uint8_t* data, long len, long start, long file_offset, int rle4,
                int xsize, int ysize, uint8_t* out) {
  const long dest = long(xsize) * ysize;
  long n = 0, pos = start, x = 0;
  auto put = [&](uint8_t v) {
    if (n < dest) out[n] = v;
    ++n;
  };
  while (n < dest) {
    if (pos + 2 > len) break;
    const int num = data[pos], byte = data[pos + 1];
    pos += 2;
    if (num) {
      long count = num;
      if (x + count > xsize) count = std::max(0L, long(xsize) - x);
      for (long i = 0; i < count; ++i)
        put(rle4 ? uint8_t(i % 2 == 0 ? byte >> 4 : byte & 15) : uint8_t(byte));
      x += count;
    } else if (byte == 0) {  // end of line
      while (n % xsize) put(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta
      if (pos + 2 > len) break;
      pos += 2;
      if (pos + 2 > len) return -1;
      const long right = data[pos], up = data[pos + 1];
      pos += 2;
      const long skip = right + up * xsize;
      for (long i = 0; i < skip; ++i) put(0);
      x = n % xsize;
    } else {  // absolute run
      const long count = rle4 ? byte / 2 : byte;
      const long got = std::min(count, std::max(0L, len - pos));
      for (long i = 0; i < got; ++i) {
        const uint8_t b = data[pos + i];
        if (rle4) {
          put(uint8_t(b >> 4));
          put(uint8_t(b & 15));
        } else {
          put(b);
        }
      }
      pos += got;
      if (got < count) break;
      x += byte;
      if ((file_offset + pos) % 2) ++pos;
    }
  }
  return n;
}

}  // extern "C"
