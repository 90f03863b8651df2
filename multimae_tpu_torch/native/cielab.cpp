// cielab: PIL's convert("RGB") of an image in mode "LAB" (a CIELab TIFF),
// in plain C++17 with a C interface, bound with ctypes by
// native/__init__.py; its numpy twin is image_io.lab_to_rgb_twin.
//
// Pillow converts through LittleCMS: ImageCms.buildTransform from
// createProfile("LAB") (cmsCreateLab2Profile, D50) to createProfile("sRGB")
// (cmsCreate_sRGBProfile), "LAB" in and "RGB" out, perceptual intent. lcms2
// 2.17 optimises that 8-bit transform by resampling (OptimizeByResampling):
// the pipeline it keeps after PreOptimize (Lab to XYZ, the sRGB profile's
// inverse matrix scaled to the XYZ encoding, the inverse of its parametric
// type-4 curves; the profiles' V2/V4 Lab stages cancel, and black point
// compensation, on for a V4 profile under the perceptual intent, finds both
// black points at zero) is sampled at 33 x 33 x 33 nodes in float
// (XFormSampler16), each output rounded to 16 bits, and every pixel is then
// the tetrahedral interpolation of that table in 16-bit fixed point
// (TetrahedralInterp16), its input the byte times 257 and its output cut
// back to 8 bits (FROM_16_TO_8). White is left as the table gives it: the
// Lab white (0xffff, 0x8080, 0x8080) is not on a node, so lcms2 cannot
// patch it. Every step here is lcms2's own arithmetic, in its order and
// precision (float32 between stages, doubles inside them, its magic-number
// floor), so all 2^24 inputs match Pillow's.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kGrid = 33;

// _cmsQuickFloor: val + 1.5 * 2^36 in double keeps 16 fraction bits; the low
// word's upper half is the floor.
int quick_floor(double val) {
  double t = val + 68719476736.0 * 1.5;
  uint64_t bits;
  std::memcpy(&bits, &t, sizeof bits);
  return int32_t(uint32_t(bits)) >> 16;
}

// _cmsQuickSaturateWord
uint16_t saturate_word(double d) {
  d = d + 0.5;
  if (d <= 0) return 0;
  if (d >= 65535.0) return 0xffff;
  return uint16_t(quick_floor(d - 32767.0) + 32767);
}

struct Mat3 {
  double v[3][3];
};

Mat3 inverse(const Mat3& a) {  // _cmsMAT3inverse
  double c0 = a.v[1][1] * a.v[2][2] - a.v[1][2] * a.v[2][1];
  double c1 = -a.v[1][0] * a.v[2][2] + a.v[1][2] * a.v[2][0];
  double c2 = a.v[1][0] * a.v[2][1] - a.v[1][1] * a.v[2][0];
  double det = a.v[0][0] * c0 + a.v[0][1] * c1 + a.v[0][2] * c2;
  Mat3 b;
  b.v[0][0] = c0 / det;
  b.v[0][1] = (a.v[0][2] * a.v[2][1] - a.v[0][1] * a.v[2][2]) / det;
  b.v[0][2] = (a.v[0][1] * a.v[1][2] - a.v[0][2] * a.v[1][1]) / det;
  b.v[1][0] = c1 / det;
  b.v[1][1] = (a.v[0][0] * a.v[2][2] - a.v[0][2] * a.v[2][0]) / det;
  b.v[1][2] = (a.v[0][2] * a.v[1][0] - a.v[0][0] * a.v[1][2]) / det;
  b.v[2][0] = c2 / det;
  b.v[2][1] = (a.v[0][1] * a.v[2][0] - a.v[0][0] * a.v[2][1]) / det;
  b.v[2][2] = (a.v[0][0] * a.v[1][1] - a.v[0][1] * a.v[1][0]) / det;
  return b;
}

Mat3 product(const Mat3& a, const Mat3& b) {  // _cmsMAT3per
  Mat3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.v[i][j] = a.v[i][0] * b.v[0][j] + a.v[i][1] * b.v[1][j] + a.v[i][2] * b.v[2][j];
  return r;
}

void apply(const Mat3& a, const double* x, double* r) {  // _cmsMAT3eval
  for (int i = 0; i < 3; ++i) r[i] = a.v[i][0] * x[0] + a.v[i][1] * x[1] + a.v[i][2] * x[2];
}

const double kD50[3] = {0.9642, 1.0, 0.8249};

// _cmsAdaptationMatrix with Bradford's cone matrix (ComputeChromaticAdaptation).
Mat3 bradford(const double* from, const double* to) {
  Mat3 chad = {{{0.8951, 0.2664, -0.1614}, {-0.7502, 1.7135, 0.0367}, {0.0389, -0.0685, 1.0296}}};
  Mat3 inv = inverse(chad);
  double s[3], d[3];
  apply(chad, from, s);
  apply(chad, to, d);
  Mat3 cone = {{{d[0] / s[0], 0.0, 0.0}, {0.0, d[1] / s[1], 0.0}, {0.0, 0.0, d[2] / s[2]}}};
  return product(inv, product(cone, chad));
}

// cmsCreate_sRGBProfile's colorants: _cmsBuildRGB2XYZtransferMatrix for the
// Rec. 709 primaries and D65, adapted to D50.
Mat3 srgb_to_xyz() {
  const double xn = 0.3127, yn = 0.3290;
  const double xr = 0.6400, yr = 0.3300, xg = 0.3000, yg = 0.6000, xb = 0.1500, yb = 0.0600;
  Mat3 prim = {{{xr, xg, xb}, {yr, yg, yb}, {(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)}}};
  Mat3 res = inverse(prim);
  double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn}, coef[3];
  apply(res, white, coef);
  Mat3 r = {{{coef[0] * xr, coef[1] * xg, coef[2] * xb},
             {coef[0] * yr, coef[1] * yg, coef[2] * yb},
             {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)}}};
  double dn[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};  // cmsxyY2XYZ
  return product(bradford(dn, kD50), r);
}

double f_1(double t) {  // cmsLab2XYZ's inverse of f
  const double limit = 24.0 / 116.0;
  if (t <= limit) return (108.0 / 841.0) * (t - (16.0 / 116.0));
  return t * t * t;
}

struct Table {
  uint16_t t[kGrid * kGrid * kGrid * 3];
  Table() {
    const double adj = 1.0 + 32767.0 / 32768.0;  // MAX_ENCODEABLE_XYZ
    Mat3 inv = inverse(srgb_to_xyz());
    for (auto& row : inv.v)
      for (double& x : row) x *= adj;
    const double P[5] = {2.4, 1. / 1.055, 0.055 / 1.055, 1. / 12.92, 0.04045};
    const double e = P[1] * P[4] + P[2];
    const double disc = e < 0 ? 0 : std::pow(e, P[0]);
    int at = 0;
    for (int i = 0; i < kGrid; ++i)
      for (int j = 0; j < kGrid; ++j)
        for (int k = 0; k < kGrid; ++k) {
          const int node[3] = {i, j, k};
          float in[3];
          for (int c = 0; c < 3; ++c)  // _cmsQuantizeVal, then In / 65535.0 as float
            in[c] = float(saturate_word(double(node[c]) * 65535. / double(kGrid - 1)) / 65535.0);
          // EvaluateLab2XYZ (V4 rules), cmsLab2XYZ at D50
          double L = in[0] * 100.0, a = in[1] * 255.0 - 128.0, b = in[2] * 255.0 - 128.0;
          double y = (L + 16.0) / 116.0, x = y + 0.002 * a, z = y - 0.005 * b;
          float xyz[3] = {float(f_1(x) * kD50[0] / adj), float(f_1(y) * kD50[1] / adj),
                          float(f_1(z) * kD50[2] / adj)};
          for (int r = 0; r < 3; ++r) {
            double acc = 0;  // EvaluateMatrix
            for (int c = 0; c < 3; ++c) acc += xyz[c] * inv.v[r][c];
            double R = float(acc);
            double val;  // the parametric curve of type -4
            if (R >= disc)
              val = (std::pow(R, 1.0 / P[0]) - P[2]) / P[1];
            else
              val = R / P[3];
            t[at++] = saturate_word(double(float(val)) * 65535.0);
          }
        }
  }
};

const Table& table() {
  static const Table t;
  return t;
}

}  // namespace

extern "C" {

// `n` pixels of Pillow's "LAB" storage (L, a + 128, b + 128) -> RGB.
int mm_lab_to_rgb(const uint8_t* lab, long n, uint8_t* rgb) {
  const uint16_t* T = table().t;
  const int o0 = 3, o1 = 3 * kGrid, o2 = 3 * kGrid * kGrid;
  int x0[256], rest[256];
  for (int v = 0; v < 256; ++v) {
    int a = v * 257 * (kGrid - 1);
    int fx = a + (a + 0x7fff) / 0xffff;  // _cmsToFixedDomain
    x0[v] = fx >> 16;
    rest[v] = fx & 0xffff;
  }
  for (long p = 0; p < n; ++p, lab += 3, rgb += 3) {
    const int L = lab[0], A = lab[1], B = lab[2];
    const int rx = rest[L], ry = rest[A], rz = rest[B];
    const int X1 = L == 255 ? 0 : o2, Y1 = A == 255 ? 0 : o1, Z1 = B == 255 ? 0 : o0;
    const uint16_t* c = T + x0[L] * o2 + x0[A] * o1 + x0[B] * o0;
    for (int ch = 0; ch < 3; ++ch, ++c) {  // TetrahedralInterp16
      int c0 = c[0], c1, c2, c3;
      if (rx >= ry) {
        if (ry >= rz) {
          c1 = c[X1] - c0;
          c2 = c[X1 + Y1] - c[X1];
          c3 = c[X1 + Y1 + Z1] - c[X1 + Y1];
        } else if (rz >= rx) {
          c1 = c[X1 + Z1] - c[Z1];
          c2 = c[X1 + Y1 + Z1] - c[X1 + Z1];
          c3 = c[Z1] - c0;
        } else {
          c1 = c[X1] - c0;
          c2 = c[X1 + Y1 + Z1] - c[X1 + Z1];
          c3 = c[X1 + Z1] - c[X1];
        }
      } else {
        if (rx >= rz) {
          c1 = c[X1 + Y1] - c[Y1];
          c2 = c[Y1] - c0;
          c3 = c[X1 + Y1 + Z1] - c[X1 + Y1];
        } else if (ry >= rz) {
          c1 = c[X1 + Y1 + Z1] - c[Y1 + Z1];
          c2 = c[Y1] - c0;
          c3 = c[Y1 + Z1] - c[Y1];
        } else {
          c1 = c[X1 + Y1 + Z1] - c[Y1 + Z1];
          c2 = c[Y1 + Z1] - c[Z1];
          c3 = c[Z1] - c0;
        }
      }
      int64_t r = int64_t(c1) * rx + int64_t(c2) * ry + int64_t(c3) * rz + 0x8001;
      uint32_t out = uint16_t(c0 + ((r + (r >> 16)) >> 16));
      rgb[ch] = uint8_t((out * 65281u + 8388608u) >> 24);  // FROM_16_TO_8
    }
  }
  return 0;
}

}  // extern "C"
