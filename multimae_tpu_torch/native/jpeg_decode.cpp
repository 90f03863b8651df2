// JPEG decoder of the port's native library, in plain C++17 (libstdc++
// only). multimae_tpu_torch/native/__init__.py compiles it into one
// library with fastimage.cpp:
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off fastimage.cpp jpeg_decode.cpp
// and multimae_tpu_torch/native/__init__.py binds `mm_decode_jpeg` and
// `mm_decode_jpeg_tiff` with ctypes.
//
// What it returns is what the JAX package's loader returns for a JPEG file:
// PIL's Image.open(f).convert("RGB"), i.e. libjpeg-turbo with its default
// decompression parameters, then PIL's own conversion. Each stage follows
// the libjpeg-turbo source it stands for:
//   * markers and headers: jdmarker.c (JFIF and Adobe APPn read, the rest
//     skipped), jdinput.c (frame and scan geometry);
//   * entropy decoding: jdhuff.c (sequential) and jdphuff.c (progressive
//     DC first/refine, AC first with EOBRUN, AC refinement), 8-bit lookahead
//     tables as in jpeg_make_d_derived_tbl, and the standard's tables
//     (jstdhuff.c) for a table 0 or 1 the file never defines; jdarith.c
//     (arithmetic coding: the Q-coder of jaricom.c, the DC and AC
//     statistics bins with the DAC marker's conditioning, reset at every
//     scan and restart marker, the four progressive passes);
//   * lossless frames (SOF3): jdlhuff.c's difference decoding, jdlossls.c's
//     seven predictors with their first-row and first-column rules (reset
//     at restart markers) and the point transform;
//   * block smoothing of a progressive file whose scans leave one of the
//     first nine AC coefficients unrefined: jdcoefct.c's
//     decompress_smooth_data of libjpeg-turbo 3.1 (the 5 x 5 DC
//     neighbourhood, DC interpolation where no AC coefficient was sent,
//     smoothing_ok's quantiser and coef_bits_latch checks);
//   * coefficients in natural order, latched quantisation tables, a
//     whole-image coefficient buffer for every file;
//   * the islow IDCT (jidctint.c) as libjpeg-turbo's x86-64 SIMD version
//     computes it (16-bit dequantisation and sums, saturated passes), which
//     is the C code to the bit until a coefficient leaves 16 bits;
//   * fancy upsampling (jdsample.c h2v1, h2v2, h1v2), plain replication
//     for downsampled widths <= 2 and other integral factors, with the
//     context rows of jdmainct.c (row 0 above the top, the last real row
//     below the bottom);
//   * colour (jdcolor.c): YCbCr->RGB tables, RGB copy, gray, YCCK->CMYK;
//     then PIL's "CMYK;I" unpacking and cmyk2rgb for 4-component files.
//   * JPEG-in-TIFF (`mm_decode_jpeg_tiff`, libtiff's tif_jpeg.c and
//     tif_ojpeg.c): a tables-only stream read first as
//     jpeg_read_header(require_image=FALSE) reads it, the tables kept for
//     the abbreviated stream after it (its SOI resets what get_soi resets),
//     an EOI supplied where either runs out; the colour handling forced by
//     the caller: YCbCr to RGB, the samples as they are, or each
//     component's plane without upsampling (raw_data_out).
//
// Supported: SOF0, SOF1, SOF2 and SOF3 (Huffman), SOF9 and SOF10
// (arithmetic), 8-bit samples, 1, 3 or 4 components, sampling factors 1-4
// with integral ratios, 8- and 16-bit quantisation tables, DRI and RSTn,
// several non-interleaved scans. Raised as errors, naming what was met:
// what PIL 12.1 (libjpeg-turbo 3.1) refuses as well: hierarchical frames,
// lossless arithmetic-coded frames (SOF11), precisions other than 8 (PIL
// opens none), a height given by a DNL marker; and any damage: a
// truncated file, a bad Huffman or arithmetic code, Huffman data that runs
// out before the scan's last MCU. Every header field is checked before
// use; nothing reads past the input or writes past the output.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMaxComponents = 10;  // jmorecfg.h MAX_COMPONENTS

struct Failure {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{buf};
}

// jutils.c jpeg_natural_order, with 16 extra entries so a corrupt run
// length past the block's end lands on coefficient 63.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// --- entropy-coded data -----------------------------------------------------

// Bits of one scan: FF 00 is a data FF, fill FFs are swallowed, and at a
// marker (or the end of the input) the reader stops and feeds zero bits,
// counting them: consuming one of them is an overrun.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;   // next bits at the top
  int count = 0;      // valid bits in buf
  int pad = 0;        // of which zero fill at the tail
  bool stopped = false;
  bool overrun = false;

  BitReader(const uint8_t* data, size_t len, size_t start) : d(data), n(len), pos(start) {}

  void fill() {
    while (count <= 56) {
      unsigned c = 0;
      if (!stopped) {
        if (pos >= n) {
          stopped = true;
        } else if (d[pos] != 0xFF) {
          c = d[pos++];
        } else {
          size_t p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;
          if (p < n && d[p] == 0) {
            c = 0xFF;
            pos = p + 1;
          } else {
            stopped = true;  // a marker: pos stays on its first FF
          }
        }
      }
      if (stopped) pad += 8;
      buf |= uint64_t(c) << (56 - count);
      count += 8;
    }
  }
  void need(int k) {
    if (count < k) fill();
  }
  unsigned peek(int k) const { return unsigned(buf >> (64 - k)); }
  void skip(int k) {
    buf <<= k;
    count -= k;
    if (count < pad) {
      overrun = true;
      pad = count;
    }
  }
  int bits(int k) {  // k in 0..16
    if (k == 0) return 0;
    need(k);
    int v = int(peek(k));
    skip(k);
    return v;
  }
  void reset() {  // a restart marker: the buffered bits are dropped
    buf = 0;
    count = pad = 0;
    stopped = overrun = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (int(~0u << s) + 1) : v; }

struct HuffTable {
  bool defined = false;
  uint8_t counts[17] = {};
  uint8_t vals[256] = {};
};

// jstdhuff.c: the tables of the JPEG standard's Annex K.3, which libjpeg-turbo
// takes for a table 0 or 1 that the file never defines (motion-JPEG frames).
// counts[1..16], then the symbols.
const uint8_t kStdDc0[] = {
    0x00, 0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08,
    0x09, 0x0a, 0x0b};
const uint8_t kStdDc1[] = {
    0x00, 0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08,
    0x09, 0x0a, 0x0b};
const uint8_t kStdAc0[] = {
    0x00, 0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04,
    0x00, 0x00, 0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21,
    0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62,
    0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46,
    0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94,
    0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8,
    0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7,
    0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAc1[] = {
    0x00, 0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04,
    0x00, 0x01, 0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31,
    0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72,
    0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a,
    0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77,
    0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6,
    0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5,
    0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Derived {  // jdhuff.c d_derived_tbl
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[256];  // (length << 8) | symbol for codes of <= 8 bits, else 0
  uint8_t vals[256];
};

HuffTable standard_table(bool dc, int id) {
  if (id > 1) fail("no %s Huffman table %d", dc ? "DC" : "AC", id);
  const uint8_t* src = dc ? (id ? kStdDc1 : kStdDc0) : (id ? kStdAc1 : kStdAc0);
  HuffTable t;
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += t.counts[l] = src[l];
  std::memcpy(t.vals, src + 17, count);
  t.defined = true;
  return t;
}

void derive(const HuffTable& defined, bool dc, int id, Derived* out) {
  const HuffTable& t = defined.defined ? defined : standard_table(dc, id);
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t.counts[l]; ++i) size[p++] = uint8_t(l);
  size[p] = 0;
  const int nsym = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) fail("bad Huffman table");
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.counts[l]) {
      out->valoffset[l] = p - int32_t(code[p]);
      p += t.counts[l];
      out->maxcode[l] = int32_t(code[p - 1]);
    } else {
      out->maxcode[l] = -1;
    }
  }
  out->valoffset[17] = 0;
  out->maxcode[17] = 0xFFFFF;
  std::memset(out->look, 0, sizeof out->look);
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < t.counts[l]; ++i, ++p) {
      uint32_t look = code[p] << (8 - l);
      for (int k = 1 << (8 - l); k > 0; --k) out->look[look++] = uint16_t((l << 8) | t.vals[p]);
    }
  }
  std::memcpy(out->vals, t.vals, 256);
  if (dc)
    for (int i = 0; i < nsym; ++i)
      if (t.vals[i] > 15) fail("bad Huffman table: DC symbol %d", t.vals[i]);
}

inline int decode_symbol(BitReader& br, const Derived& t) {
  br.need(16);
  unsigned e = t.look[br.peek(8)];
  if (e) {
    br.skip(int(e >> 8));
    return int(e & 0xFF);
  }
  const int32_t code = int32_t(br.peek(16));
  for (int l = 9; l <= 16; ++l) {
    const int32_t c = code >> (16 - l);
    if (c <= t.maxcode[l]) {
      br.skip(l);
      const int32_t i = t.valoffset[l] + c;
      if (i < 0 || i > 255) fail("corrupt data: bad Huffman code");
      return t.vals[i];
    }
  }
  fail("corrupt data: bad Huffman code");
}


// --- arithmetic-coded data (jdarith.c) --------------------------------------

// jaricom.c jpeg_aritab: per state, Qe_Value << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS (ITU-T T.81 Table D.2); state 113 is the
// fixed probability 0.5 of T.851.
#define V(qe, lps, mps, sw) ((int32_t(qe) << 16) | (int32_t(mps) << 8) | (int32_t(sw) << 7) | (lps))
const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// The decoder's registers (jdarith.c arith_entropy_decoder). At a marker
// (or the end of the input) the reader stops, pos on the marker's first
// FF, and feeds zero bytes: legal in arithmetic coding, where the coder
// reads ahead of the last symbol.
struct ArithReader {
  const uint8_t* d;
  size_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to fetch first
  bool stopped = false;

  ArithReader(const uint8_t* data, size_t len, size_t start) : d(data), n(len), pos(start) {}

  int get_byte() {
    if (stopped) return 0;
    if (pos >= n) {
      stopped = true;
      return 0;
    }
    if (d[pos] != 0xFF) return d[pos++];
    size_t p = pos + 1;
    while (p < n && d[p] == 0xFF) ++p;
    if (p < n && d[p] == 0) {
      pos = p + 1;
      return 0xFF;
    }
    stopped = true;  // a marker: pos stays on its first FF
    return 0;
  }

  void reset() {  // a restart marker: registers as at a scan's start
    c = a = 0;
    ct = -16;
    stopped = false;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and input (T.81 D.2.6)
      if (--ct < 0) {
        c = (c << 8) | get_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two first bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const uint8_t nl = uint8_t(qe & 0xFF);
    qe >>= 8;
    const uint8_t nm = uint8_t(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS after all
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct ArithState {  // per scan: statistics bins, DC predictions and contexts
  uint8_t dc_stats[16][64];
  uint8_t ac_stats[16][256];
  uint8_t fixed_bin = 113;
  int last_dc[4] = {}, dc_context[4] = {};
};

// --- the frame ----------------------------------------------------------------

struct Component {
  int id, h, v, tq;
  int wib, hib;      // width/height_in_blocks (the blocks that are shown)
  int bw, bh;        // the block grid of interleaved MCUs (padding included)
  int dw, dh;        // downsampled_width/height
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
  int16_t q[64];     // latched quantisation table, natural order
  uint16_t qraw[64]; // the same as the file gives it (block smoothing reads it)
  bool latched = false, scanned = false;
  int coef_bits[64];
  int dc_pred = 0;
  // Lossless frames: a block is one sample; the differences of the bh x bw
  // grid, and which sample rows start a restart interval.
  std::vector<int32_t> diff;
  std::vector<uint8_t> first_row;
  std::vector<uint8_t> plane;  // hib*8 rows of stride samples (hib x wib when lossless)
  int stride = 0;
  int16_t* block(int by, int bx) { return coef.data() + (size_t(by) * bw + bx) * 64; }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int height = 0, width = 0;
  bool frame = false, progressive = false, arithmetic = false, lossless = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int restart_interval = 0;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  HuffTable dc_tables[4], ac_tables[4];
  // DAC conditioning (jdmarker.c get_soi's defaults: L 0, U 1, K 5).
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  int eobrun = 0;
  // A JPEG-in-TIFF stream. libtiff's source supplies an EOI marker where
  // the data runs out (std_fill_input_buffer), so a stream that ends where
  // a marker is due ends as if it held one; and libjpeg takes any count of
  // components up to kMaxComponents, as libtiff passes one per sample.
  bool in_tiff = false;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) { reset_for_soi(); }

  // jdmarker.c get_soi: what an SOI marker resets. The quantisation and
  // Huffman tables stay, as an abbreviated stream after a tables-only one
  // needs them to.
  void reset_for_soi() {
    std::memset(arith_dc_L, 0, sizeof arith_dc_L);
    std::memset(arith_dc_U, 1, sizeof arith_dc_U);
    std::memset(arith_ac_K, 5, sizeof arith_ac_K);
    restart_interval = 0;
    jfif = adobe = false;
    adobe_transform = 0;
  }

  int u16(size_t p) const { return (d[p] << 8) | d[p + 1]; }

  // jdmarker.c next_marker: skip to FF, swallow fill FFs, skip FF 00.
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) {
        if (in_tiff) return 0xD9;
        fail("truncated file: no EOI marker");
      }
      const int c = d[pos++];
      if (c != 0) return c;
    }
  }

  // A marker segment's body [pos, end); pos moves past it.
  size_t segment(size_t* end) {
    if (pos + 2 > n) fail("truncated file in a marker segment");
    const int len = u16(pos);
    if (len < 2 || pos + len > n) fail("truncated file in a marker segment");
    *end = pos + len;
    const size_t body = pos + 2;
    pos += len;
    return body;
  }

  void read_sof(int marker) {
    if (frame) fail("two SOF markers");
    size_t end, p = segment(&end);
    if (end - p < 6) fail("bad SOF length");
    const int precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    const int nc = d[p + 5];
    p += 6;
    if (precision != 8) fail("%d-bit precision (PIL reads 8-bit JPEG files only)", precision);
    if (end - p != size_t(nc) * 3) fail("bad SOF length");
    if (height == 0) fail("a height given by a DNL marker (libjpeg-turbo refuses it too)");
    if (width == 0) fail("width 0");
    if (in_tiff ? nc < 1 || nc > kMaxComponents : nc != 1 && nc != 3 && nc != 4)
      fail("%d components are not supported", nc);
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker >= 0xC9;
    lossless = marker == 0xC3;
    const int bs = lossless ? 1 : 8;  // a block's side
    comps.resize(nc);
    for (int i = 0; i < nc; ++i, p += 3) {
      Component& c = comps[i];
      c.id = d[p];
      c.h = d[p + 1] >> 4;
      c.v = d[p + 1] & 15;
      c.tq = d[p + 2];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("bad sampling factors %dx%d", c.h, c.v);
      if (c.tq > 3) fail("bad quantisation table id %d", c.tq);
      for (int j = 0; j < i; ++j)
        if (comps[j].id == c.id) fail("duplicate component id %d", c.id);
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcux = (width + bs * max_h - 1) / (bs * max_h);
    mcuy = (height + bs * max_v - 1) / (bs * max_v);
    long long shown_blocks = 0;
    for (Component& c : comps) {
      if (max_h % c.h || max_v % c.v)
        fail("sampling factors %dx%d against %dx%d are not integral", c.h, c.v, max_h, max_v);
      c.dw = int((long long)width * c.h / max_h + (width * c.h % max_h != 0));
      c.dh = int((long long)height * c.v / max_v + (height * c.v % max_v != 0));
      c.wib = (c.dw + bs - 1) / bs;
      c.hib = (c.dh + bs - 1) / bs;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      shown_blocks += (long long)c.wib * c.hib;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    // Every block (every sample of a lossless frame) of every component
    // codes its DC at least once, in at least one bit of Huffman code: a
    // header promising more blocks than the file has bits is damaged, and
    // is refused before anything is allocated. (The arithmetic coder can
    // take less than a bit a block.)
    if (!arithmetic && shown_blocks > (long long)n * 8)
      fail("truncated file: %dx%d needs more data than %zu bytes", width, height, n);
    frame = true;
  }

  void read_dht() {
    size_t end, p = segment(&end);
    while (p < end) {
      if (end - p < 17) fail("bad DHT length");
      int index = d[p];
      HuffTable t;
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += t.counts[l] = d[p + l];
      p += 17;
      if (count > 256 || size_t(count) > end - p) fail("bad Huffman table");
      std::memcpy(t.vals, d + p, count);
      p += count;
      t.defined = true;
      const bool ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index > 3) fail("bad Huffman table id %d", index);
      (ac ? ac_tables : dc_tables)[index] = t;
    }
  }

  void read_dqt() {
    size_t end, p = segment(&end);
    while (p < end) {
      const int pq = d[p] >> 4, id = d[p] & 15;
      ++p;
      if (id > 3) fail("bad quantisation table id %d", id);
      if (pq > 1) fail("bad quantisation table precision %d", pq);
      if (end - p < size_t(64 << pq)) fail("bad DQT length");
      for (int i = 0; i < 64; ++i) {
        qt[id][kNatural[i]] = uint16_t(pq ? u16(p + 2 * i) : d[p + i]);
      }
      p += 64 << pq;
      qt_defined[id] = true;
    }
  }

  void read_app(int marker) {
    size_t end, p = segment(&end);
    const size_t len = end - p;
    if (marker == 0xE0 && len >= 14 && std::memcmp(d + p, "JFIF", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(d + p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[p + 11];
    }
  }

  void read_dac() {  // jdmarker.c get_dac
    size_t end, p = segment(&end);
    if ((end - p) % 2) fail("bad DAC length");
    for (; p < end; p += 2) {
      const int index = d[p], val = d[p + 1];
      if (index >= 32) fail("bad DAC table index %d", index);
      if (index >= 16) {
        arith_ac_K[index - 16] = uint8_t(val);
      } else {
        arith_dc_L[index] = uint8_t(val & 15);
        arith_dc_U[index] = uint8_t(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail("bad DAC value 0x%02X", val);
      }
    }
  }

  void read_dri() {
    size_t end, p = segment(&end);
    if (end - p != 2) fail("bad DRI length");
    restart_interval = u16(p);
  }

  // --- scans ---

  void read_sos() {
    if (!frame) fail("SOS before SOF");
    size_t end, p = segment(&end);
    const int ns = end > p ? d[p] : 0;
    if (ns < 1 || ns > 4 || end - p != size_t(4 + 2 * ns)) fail("bad SOS length");
    ++p;
    int idx[4], td[4], ta[4];
    for (int i = 0; i < ns; ++i, p += 2) {
      idx[i] = -1;
      for (size_t c = 0; c < comps.size(); ++c)
        if (comps[c].id == d[p]) idx[i] = int(c);
      if (idx[i] < 0) fail("SOS names component id %d that the frame lacks", d[p]);
      for (int j = 0; j < i; ++j)
        if (idx[j] == idx[i]) fail("SOS names component id %d twice", d[p]);
      td[i] = d[p + 1] >> 4;
      ta[i] = d[p + 1] & 15;
    }
    const int ss = d[p], se = d[p + 1], ah = d[p + 2] >> 4, al = d[p + 2] & 15;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += comps[idx[i]].h * comps[idx[i]].v;
      if (blocks > 10) fail("an MCU of %d blocks", blocks);
    }
    if (lossless) {
      read_lossless_scan(ns, idx, td, ss, al);
      return;
    }
    for (int i = 0; i < ns; ++i) {  // jdinput.c latch_quant_tables
      Component& c = comps[idx[i]];
      if (c.latched) continue;
      if (!qt_defined[c.tq]) fail("no quantisation table %d", c.tq);
      for (int k = 0; k < 64; ++k) {
        c.q[k] = int16_t(qt[c.tq][k]);  // ISLOW_MULT_TYPE short
        c.qraw[k] = qt[c.tq][k];
      }
      c.latched = true;
    }
    Derived dc[4], ac[4];
    if (progressive) {
      const bool dc_band = ss == 0;
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("bad progression: Ss=%d Se=%d Ah=%d Al=%d", ss, se, ah, al);
      for (int i = 0; i < ns; ++i) {
        Component& c = comps[idx[i]];
        for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
        if (arithmetic) {
          if ((dc_band && ah == 0 && td[i] > 15) || (!dc_band && ta[i] > 15))
            fail("bad arithmetic table id %d/%d", td[i], ta[i]);
        } else if (ah == 0) {
          if (td[i] > 3 && dc_band) fail("bad Huffman table id %d", td[i]);
          if (ta[i] > 3 && !dc_band) fail("bad Huffman table id %d", ta[i]);
          if (dc_band) derive(dc_tables[td[i]], true, td[i], &dc[i]);
          else derive(ac_tables[ta[i]], false, ta[i], &ac[i]);
        } else if (!dc_band) {
          if (ta[i] > 3) fail("bad Huffman table id %d", ta[i]);
          derive(ac_tables[ta[i]], false, ta[i], &ac[i]);
        }
      }
    } else {
      for (int i = 0; i < ns; ++i) {
        if (arithmetic) {
          if (td[i] > 15 || ta[i] > 15) fail("bad arithmetic table id %d/%d", td[i], ta[i]);
        } else {
          if (td[i] > 3 || ta[i] > 3) fail("bad Huffman table id %d/%d", td[i], ta[i]);
          derive(dc_tables[td[i]], true, td[i], &dc[i]);
          derive(ac_tables[ta[i]], false, ta[i], &ac[i]);
        }
        Component& c = comps[idx[i]];
        for (int k = 0; k < 64; ++k) c.coef_bits[k] = 0;
      }
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = comps[idx[i]];
      c.scanned = true;
      c.dc_pred = 0;
      if (c.coef.empty()) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    eobrun = 0;

    BitReader br(d, n, pos);
    ArithReader ar(d, n, pos);
    ArithState st;
    const bool dc_stats = !progressive || (ss == 0 && ah == 0);
    const bool ac_stats = !progressive || ss != 0;
    auto reset_stats = [&]() {  // jdarith.c start_pass / process_restart
      for (int i = 0; i < ns; ++i) {
        if (dc_stats) {
          std::memset(st.dc_stats[td[i]], 0, 64);
          st.last_dc[i] = st.dc_context[i] = 0;
        }
        if (ac_stats) std::memset(st.ac_stats[ta[i]], 0, 256);
      }
    };
    if (arithmetic) reset_stats();
    long long mcu = 0;
    auto restart = [&]() {
      if (restart_interval && mcu > 0 && mcu % restart_interval == 0) {
        pos = arithmetic ? ar.pos : (br.reset(), br.pos);
        const int m = next_marker();
        const int want = 0xD0 + int((mcu / restart_interval - 1) & 7);
        if (m != want) fail("corrupt data: marker 0x%02X where RST%d was due", m, want - 0xD0);
        br.pos = ar.pos = pos;
        for (int i = 0; i < ns; ++i) comps[idx[i]].dc_pred = 0;
        eobrun = 0;
        if (arithmetic) {
          ar.reset();
          reset_stats();
        }
      }
      ++mcu;
    };
    auto block = [&](int i, int16_t* blk) {
      if (arithmetic) {
        if (!progressive) arith_sequential(ar, st, i, td[i], ta[i], blk);
        else if (ss == 0 && ah == 0) arith_dc_first(ar, st, i, td[i], blk, al);
        else if (ss == 0) blk[0] = int16_t(blk[0] | (ar.decode(&st.fixed_bin) << al));
        else if (ah == 0) arith_ac(ar, st, ta[i], blk, ss, se, al);
        else arith_ac_refine(ar, st, ta[i], blk, ss, se, al);
      } else if (!progressive) {
        decode_sequential(br, comps[idx[i]], dc[i], ac[i], blk);
      } else if (ss == 0 && ah == 0) {
        decode_dc_first(br, comps[idx[i]], dc[i], blk, al);
      } else if (ss == 0) {
        blk[0] = int16_t(blk[0] | (br.bits(1) << al));
      } else if (ah == 0) {
        decode_ac_first(br, ac[i], blk, ss, se, al);
      } else {
        decode_ac_refine(br, ac[i], blk, ss, se, al);
      }
    };
    if (ns == 1) {
      Component& c = comps[idx[0]];
      for (int by = 0; by < c.hib; ++by) {
        for (int bx = 0; bx < c.wib; ++bx) {
          restart();
          block(0, c.block(by, bx));
          if (br.overrun) fail("corrupt data: the entropy-coded data ends early");
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          restart();
          for (int i = 0; i < ns; ++i) {
            Component& c = comps[idx[i]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) block(i, c.block(my * c.v + y, mx * c.h + x));
          }
          if (br.overrun) fail("corrupt data: the entropy-coded data ends early");
        }
      }
    }
    pos = arithmetic ? ar.pos : br.pos;
  }

  // --- arithmetic decoding (jdarith.c) ---

  // Figures F.19-F.24: a DC difference in the conditioning of Table F.4.
  int arith_dc_diff(ArithReader& ar, ArithState& st, int ci, int tbl) {
    uint8_t* s = st.dc_stats[tbl] + st.dc_context[ci];
    if (ar.decode(s) == 0) {
      st.dc_context[ci] = 0;
      return 0;
    }
    const int sign = ar.decode(s + 1);
    s += 2 + sign;
    int m = ar.decode(s);
    if (m != 0) {
      s = st.dc_stats[tbl] + 20;
      while (ar.decode(s)) {
        if ((m <<= 1) == 0x8000) fail("corrupt data: bad arithmetic code (DC magnitude)");
        s += 1;
      }
    }
    if (m < int((1L << arith_dc_L[tbl]) >> 1)) st.dc_context[ci] = 0;
    else if (m > int((1L << arith_dc_U[tbl]) >> 1)) st.dc_context[ci] = 12 + sign * 4;
    else st.dc_context[ci] = 4 + sign * 4;
    int v = m;
    s += 14;
    while (m >>= 1)
      if (ar.decode(s)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // Figure F.20 from k = kstart: the AC coefficients of one block into
  // blk (natural order), each shifted left by al.
  void arith_ac(ArithReader& ar, ArithState& st, int tbl, int16_t* blk, int kstart, int kend,
                int al) {
    for (int k = kstart; k <= kend; ++k) {
      uint8_t* s = st.ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(s)) break;  // EOB
      while (ar.decode(s + 1) == 0) {
        s += 3;
        if (++k > kend) fail("corrupt data: bad arithmetic code (spectral overflow)");
      }
      const int sign = ar.decode(&st.fixed_bin);
      s += 2;
      int m = ar.decode(s);
      if (m != 0 && ar.decode(s)) {
        m <<= 1;
        s = st.ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
        while (ar.decode(s)) {
          if ((m <<= 1) == 0x8000) fail("corrupt data: bad arithmetic code (AC magnitude)");
          s += 1;
        }
      }
      int v = m;
      s += 14;
      while (m >>= 1)
        if (ar.decode(s)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(unsigned(v) << al);
    }
  }

  void arith_sequential(ArithReader& ar, ArithState& st, int ci, int dct, int act,
                        int16_t* blk) {
    st.last_dc[ci] = (st.last_dc[ci] + arith_dc_diff(ar, st, ci, dct)) & 0xFFFF;
    blk[0] = int16_t(st.last_dc[ci]);
    arith_ac(ar, st, act, blk, 1, 63, 0);
  }

  void arith_dc_first(ArithReader& ar, ArithState& st, int ci, int dct, int16_t* blk, int al) {
    st.last_dc[ci] = (st.last_dc[ci] + arith_dc_diff(ar, st, ci, dct)) & 0xFFFF;
    blk[0] = int16_t(unsigned(st.last_dc[ci]) << al);
  }

  // jdarith.c decode_mcu_AC_refine.
  void arith_ac_refine(ArithReader& ar, ArithState& st, int tbl, int16_t* blk, int ss, int se,
                       int al) {
    const int p1 = 1 << al, m1 = int(~0u << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* s = st.ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(s)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ar.decode(s + 2)) *coef = int16_t(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(s + 1)) {
          *coef = int16_t(ar.decode(&st.fixed_bin) ? m1 : p1);
          break;
        }
        s += 3;
        if (++k > se) fail("corrupt data: bad arithmetic code (spectral overflow)");
      }
    }
  }

  // --- lossless frames (jdlhuff.c, jddiffct.c, jdlossls.c) ---

  void read_lossless_scan(int ns, const int* idx, const int* td, int psv, int pt) {
    if (psv < 1 || psv > 7 || pt > 7)
      fail("bad lossless (SOF3) scan: predictor %d, point transform %d", psv, pt);
    Derived dc[4];
    for (int i = 0; i < ns; ++i) {
      if (td[i] > 3) fail("bad Huffman table id %d", td[i]);
      derive(dc_tables[td[i]], true, td[i], &dc[i]);
      Component& c = comps[idx[i]];
      if (c.scanned) fail("component %d has a second lossless scan", c.id);
      c.scanned = true;
      c.diff.assign(size_t(c.bw) * c.bh, 0);
      c.first_row.assign(size_t(c.bh), 0);
    }
    // MCU rows: the scan's rows of MCUs; a restart interval must be whole
    // rows of them, as libjpeg-turbo requires (jddiffct.c).
    const int per_row = ns == 1 ? comps[idx[0]].wib : mcux;
    const int rows = ns == 1 ? comps[idx[0]].hib : mcuy;
    if (restart_interval && restart_interval % per_row)
      fail("lossless restart interval %d is not whole rows of %d MCUs", restart_interval,
           per_row);
    BitReader br(d, n, pos);
    auto sample = [&](const Derived& t) {
      const int s = decode_symbol(br, t);
      if (s > 16) fail("corrupt data: bad lossless difference category %d", s);
      if (s == 16) return 32768;
      return s ? extend(br.bits(s), s) : 0;
    };
    long long mcu = 0;
    for (int my = 0; my < rows; ++my) {
      const bool restarted = restart_interval ? mcu % restart_interval == 0 : my == 0;
      if (restart_interval && mcu > 0 && mcu % restart_interval == 0) {
        br.reset();
        pos = br.pos;
        const int m = next_marker();
        const int want = 0xD0 + int((mcu / restart_interval - 1) & 7);
        if (m != want) fail("corrupt data: marker 0x%02X where RST%d was due", m, want - 0xD0);
        br.pos = pos;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = comps[idx[i]];
        if (restarted) c.first_row[size_t(ns == 1 ? my : my * c.v)] = 1;
      }
      for (int mx = 0; mx < per_row; ++mx, ++mcu) {
        for (int i = 0; i < ns; ++i) {
          Component& c = comps[idx[i]];
          const int vy = ns == 1 ? 1 : c.v, hx = ns == 1 ? 1 : c.h;
          for (int y = 0; y < vy; ++y)
            for (int x = 0; x < hx; ++x)
              c.diff[size_t(my * vy + y) * c.bw + mx * hx + x] = sample(dc[i]);
        }
        if (br.overrun) fail("corrupt data: the entropy-coded data ends early");
      }
    }
    pos = br.pos;
    for (int i = 0; i < ns; ++i) undifference(comps[idx[i]], psv, pt);
  }

  // jdlossls.c: Rx = (Px + diff) mod 2^16 over the shown samples, row by
  // row; a row that starts a restart interval predicts from the left
  // (its first sample from 2^(P - Pt - 1)), every other row's first sample
  // from above. The output sample is (Rx << Pt), cut to 8 bits.
  static void undifference(Component& c, int psv, int pt) {
    const int w = c.wib, h = c.hib;
    std::vector<int32_t> prev(static_cast<size_t>(w)), cur(static_cast<size_t>(w));
    c.stride = w;
    c.plane.assign(size_t(w) * h, 0);
    for (int y = 0; y < h; ++y) {
      const int32_t* diff = c.diff.data() + size_t(y) * c.bw;
      const bool first = c.first_row[size_t(y)];
      for (int x = 0; x < w; ++x) {
        int32_t pred;
        if (first) {
          pred = x == 0 ? 1 << (8 - pt - 1) : cur[x - 1];
        } else if (x == 0) {
          pred = prev[0];
        } else {
          const int32_t ra = cur[x - 1], rb = prev[x], rc = prev[x - 1];
          switch (psv) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
        }
        cur[x] = (pred + diff[x]) & 0xFFFF;
        c.plane[size_t(y) * w + x] = uint8_t(cur[x] << pt);
      }
      std::swap(prev, cur);
    }
    c.diff = std::vector<int32_t>();
  }

  static int add_dc(Component& c, int s) {
    const long long v = (long long)c.dc_pred + s;
    if (v > INT32_MAX || v < INT32_MIN) fail("corrupt data: DC coefficient overflows");
    c.dc_pred = int(v);
    return c.dc_pred;
  }

  static void decode_sequential(BitReader& br, Component& c, const Derived& dc,
                                const Derived& ac, int16_t* blk) {
    int s = decode_symbol(br, dc);
    if (s) s = extend(br.bits(s), s);
    blk[0] = int16_t(add_dc(c, s));
    for (int k = 1; k < 64; ++k) {
      s = decode_symbol(br, ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void decode_dc_first(BitReader& br, Component& c, const Derived& dc, int16_t* blk,
                              int al) {
    int s = decode_symbol(br, dc);
    if (s) s = extend(br.bits(s), s);
    blk[0] = int16_t(unsigned(add_dc(c, s)) << al);
  }

  void decode_ac_first(BitReader& br, const Derived& ac, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int s = decode_symbol(br, ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(unsigned(extend(br.bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine: correction bits go to every already
  // non-zero coefficient passed over, in the zero run and after the EOB.
  void decode_ac_refine(BitReader& br, const Derived& ac, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = int(~0u << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (br.bits(1) && (*coef & p1) == 0) *coef = int16_t(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int s = decode_symbol(br, ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = br.bits(1) ? p1 : m1;  // a new coefficient has magnitude 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  // Returns false at the end of the headers when only the size is wanted.
  bool run(bool headers_only) {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          read_sof(m);
          if (headers_only) return false;
          break;
        case 0xC5: case 0xC6: case 0xC7:
          fail("hierarchical JPEG (SOF%d; libjpeg-turbo refuses it too)", m - 0xC0);
        case 0xCD: case 0xCE: case 0xCF:
          fail("hierarchical arithmetic-coded JPEG (SOF%d; libjpeg-turbo refuses it too)",
               m - 0xC0);
        case 0xCB:
          fail("lossless arithmetic-coded JPEG (SOF11; libjpeg-turbo refuses it too)");
        case 0xDE: fail("hierarchical JPEG (a DHP marker; libjpeg-turbo refuses it too)");
        case 0xCC: read_dac(); break;
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: read_dri(); break;
        case 0xDA: read_sos(); break;
        case 0xD9: return true;
        case 0xD8: fail("a second SOI marker");
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
        case 0xD7: case 0x01:
          break;  // no segment
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
            if (m >= 0xE0 && m <= 0xEF) {
              read_app(m);
            } else {
              size_t end;
              segment(&end);  // COM, DNL: skipped
            }
            break;
          }
          fail("unknown marker 0x%02X", m);
      }
    }
  }

  // jpeg_read_header(require_image=FALSE) over a tables-only stream (a
  // TIFF's JPEGTables): SOI, then tables and other segments up to EOI. A
  // frame or a scan there is what libtiff calls a bogus JPEGTables field.
  void run_tables() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEGTables: not a JPEG stream");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      switch (m) {
        case 0xD9: return;
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: read_dri(); break;
        case 0xCC: read_dac(); break;
        case 0xD8: fail("JPEGTables: a second SOI marker");
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
        case 0xD7: case 0x01:
          break;
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
            size_t end;
            segment(&end);
            break;
          }
          if (m == 0xDA) fail("JPEGTables holds a scan (a bogus JPEGTables field)");
          if (m >= 0xC0 && m <= 0xCF) fail("JPEGTables holds a frame (SOF%d)", m - 0xC0);
          fail("JPEGTables: unknown marker 0x%02X", m);
      }
    }
  }

  void check_complete() {
    if (!frame) fail("no SOF marker");
    for (size_t i = 0; i < comps.size(); ++i)
      if (!comps[i].scanned) fail("component %zu has no scan", i);
  }

  // jdcoefct.c smoothing_ok, at the output pass (the whole file read):
  // a progressive file, every component's DC at least partly known and
  // its DC and first nine AC quantisers non-zero, and one of those nine AC
  // coefficients of some component not known to full precision.
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const Component& c : comps) {
      for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.qraw[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }
};

// --- samples ----------------------------------------------------------------

// jidctint.c jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) as
// libjpeg-turbo's SIMD version computes it on x86-64 (jidctint-sse2 and
// -avx2, which PIL's libjpeg-turbo runs there): each dequantised
// coefficient is the low 16 bits of its product, the sums in0 + in4,
// in0 - in4, in7 + in3 and in5 + in1 are 16-bit, the products and the rest
// 32-bit (the distributed form of the C code's, equal to it in exact
// arithmetic), each pass's outputs saturate to 16 bits, and the samples
// saturate to -128..127 before the level shift. A block whose rows 1-7
// are all zero takes the first pass's shortcut, its DC times 4 in 16
// bits. On coefficients that stay in range this is the C code to the bit.
// Every sum fits 32 bits: the largest, t11 + o2, is at most
// 2^15 * (8192 + 15137 + 25172 + 16069) < 2^31. With SSE2 the code is
// jidctint-sse2's own instructions; without, the same arithmetic in scalar
// form.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int kShift1 = kConstBits - kPass1Bits, kShift2 = kConstBits + kPass1Bits + 3;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                  F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

#if defined(__SSE2__)

// GCC's vector types and the SSE2 builtins that emmintrin.h wraps.
typedef short v8hi __attribute__((vector_size(16)));
typedef unsigned short v8hu __attribute__((vector_size(16)));
typedef int v4si __attribute__((vector_size(16)));
typedef long long v2di __attribute__((vector_size(16)));
typedef char v16qi __attribute__((vector_size(16)));

// punpcklwd / punpckhwd: the low or high four lanes of a and b, interleaved.
inline v8hi lo16(v8hi a, v8hi b) {
  return __builtin_shuffle(a, b, v8hi{0, 8, 1, 9, 2, 10, 3, 11});
}
inline v8hi hi16(v8hi a, v8hi b) {
  return __builtin_shuffle(a, b, v8hi{4, 12, 5, 13, 6, 14, 7, 15});
}
// (a, b) in every pair of lanes: pmaddwd of lo16 / hi16 (x, y) gives x * a + y * b.
inline v8hi pair16(int32_t a, int32_t b) {
  const short x = short(a), y = short(b);
  return v8hi{x, y, x, y, x, y, x, y};
}

// One 8-point pass down eight columns at once: in[k] holds the k-th input
// of each, out[k] receives its k-th output descaled by kShift and
// saturated to 16 bits (pmaddwd products, paddd sums, packssdw).
template <int kShift>
inline void idct_pass(const v8hi* in, v8hi* out) {
  const v4si round = v4si{} + (1 << (kShift - 1));
  auto madd = [](v8hi x, v8hi y, v8hi k, v4si* lo, v4si* hi) {
    *lo = __builtin_ia32_pmaddwd128(lo16(x, y), k);
    *hi = __builtin_ia32_pmaddwd128(hi16(x, y), k);
  };
  v4si tmp3l, tmp3h, tmp2l, tmp2h;
  madd(in[2], in[6], pair16(F0_541 + F0_765, F0_541), &tmp3l, &tmp3h);
  madd(in[2], in[6], pair16(F0_541, F0_541 - F1_847), &tmp2l, &tmp2h);
  // in0 +- in4 in 16 bits, then times 2^13: the sum in a lane's high half,
  // shifted down by 3.
  const v8hi s = v8hi(v8hu(in[0]) + v8hu(in[4])), d = v8hi(v8hu(in[0]) - v8hu(in[4]));
  constexpr int kUp = 16 - kConstBits;
  const v4si tmp0l = v4si(lo16(v8hi{}, s)) >> kUp, tmp0h = v4si(hi16(v8hi{}, s)) >> kUp;
  const v4si tmp1l = v4si(lo16(v8hi{}, d)) >> kUp, tmp1h = v4si(hi16(v8hi{}, d)) >> kUp;
  const v4si t10l = tmp0l + tmp3l, t10h = tmp0h + tmp3h, t13l = tmp0l - tmp3l, t13h = tmp0h - tmp3h;
  const v4si t11l = tmp1l + tmp2l, t11h = tmp1h + tmp2h, t12l = tmp1l - tmp2l, t12h = tmp1h - tmp2h;
  const v8hi s3 = v8hi(v8hu(in[7]) + v8hu(in[3])), s4 = v8hi(v8hu(in[5]) + v8hu(in[1]));
  v4si z3l, z3h, z4l, z4h, o0l, o0h, o1l, o1h, o2l, o2h, o3l, o3h;
  madd(s3, s4, pair16(F1_175 - F1_961, F1_175), &z3l, &z3h);
  madd(s3, s4, pair16(F1_175, F1_175 - F0_390), &z4l, &z4h);
  madd(in[7], in[1], pair16(F0_298 - F0_899, -F0_899), &o0l, &o0h);
  madd(in[7], in[1], pair16(-F0_899, F1_501 - F0_899), &o3l, &o3h);
  madd(in[5], in[3], pair16(F2_053 - F2_562, -F2_562), &o1l, &o1h);
  madd(in[5], in[3], pair16(-F2_562, F3_072 - F2_562), &o2l, &o2h);
  o0l += z3l, o0h += z3h, o3l += z4l, o3h += z4h, o1l += z4l, o1h += z4h, o2l += z3l, o2h += z3h;
  auto put = [&](v4si l, v4si h) {
    return __builtin_ia32_packssdw128((l + round) >> kShift, (h + round) >> kShift);
  };
  out[0] = put(t10l + o3l, t10h + o3h);
  out[7] = put(t10l - o3l, t10h - o3h);
  out[1] = put(t11l + o2l, t11h + o2h);
  out[6] = put(t11l - o2l, t11h - o2h);
  out[2] = put(t12l + o1l, t12h + o1h);
  out[5] = put(t12l - o1l, t12h - o1h);
  out[3] = put(t13l + o0l, t13h + o0h);
  out[4] = put(t13l - o0l, t13h - o0h);
}

// An 8 x 8 block of 16-bit lanes transposed in place.
inline void transpose8x16(v8hi* a) {
  v4si t[8];
  for (int i = 0; i < 4; ++i) {
    t[2 * i] = v4si(lo16(a[2 * i], a[2 * i + 1]));
    t[2 * i + 1] = v4si(hi16(a[2 * i], a[2 * i + 1]));
  }
  const v4si lo{0, 4, 1, 5}, hi{2, 6, 3, 7};
  v2di u[8];
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 2; ++j) {
      u[4 * i + 2 * j] = v2di(__builtin_shuffle(t[4 * i + j], t[4 * i + j + 2], lo));
      u[4 * i + 2 * j + 1] = v2di(__builtin_shuffle(t[4 * i + j], t[4 * i + j + 2], hi));
    }
  }
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = v8hi(__builtin_shuffle(u[i], u[i + 4], v2di{0, 2}));
    a[2 * i + 1] = v8hi(__builtin_shuffle(u[i], u[i + 4], v2di{1, 3}));
  }
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  v8hi v[8], w[8];
  uint64_t ac = 0;
  for (int k = 8; k < 64; k += 4) {
    uint64_t x;
    std::memcpy(&x, in + k, 8);
    ac |= x;
  }
  if (!ac) {
    v8hi c, k;
    std::memcpy(&c, in, 16);
    std::memcpy(&k, q, 16);
    const v8hi dc = v8hi((v8hu(c) * v8hu(k)) << kPass1Bits);
    for (int r = 0; r < 8; ++r) w[r] = dc;
  } else {
    for (int r = 0; r < 8; ++r) {
      v8hi c, k;
      std::memcpy(&c, in + 8 * r, 16);
      std::memcpy(&k, q + 8 * r, 16);
      v[r] = v8hi(v8hu(c) * v8hu(k));
    }
    idct_pass<kShift1>(v, w);
  }
  transpose8x16(w);
  idct_pass<kShift2>(w, v);
  transpose8x16(v);
  for (int r = 0; r < 8; r += 2) {
    const v16qi b = __builtin_ia32_packsswb128(v[r], v[r + 1]) ^ char(0x80);
    std::memcpy(out + size_t(r) * stride, &b, 8);
    std::memcpy(out + size_t(r + 1) * stride, reinterpret_cast<const char*>(&b) + 8, 8);
  }
}

#else

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }
inline int16_t wrap16(int32_t x) { return int16_t(uint16_t(x & 0xFFFF)); }
inline int16_t sat16(int32_t x) { return int16_t(x < -32768 ? -32768 : x > 32767 ? 32767 : x); }

// One 8-point pass over in[0..7] (16-bit), outputs descaled by kShift and
// saturated to 16 bits.
template <int kShift>
inline void idct_pass(const int16_t* in, int16_t* out) {
  const int32_t z2 = in[2], z3 = in[6];
  const int32_t tmp2 = z2 * F0_541 + z3 * (F0_541 - F1_847);
  const int32_t tmp3 = z2 * (F0_541 + F0_765) + z3 * F0_541;
  const int32_t tmp0 = int32_t(wrap16(int32_t(in[0]) + in[4])) * (1 << kConstBits);
  const int32_t tmp1 = int32_t(wrap16(int32_t(in[0]) - in[4])) * (1 << kConstBits);
  const int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  const int32_t i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
  const int32_t s3 = wrap16(i7 + i3), s4 = wrap16(i5 + i1);
  const int32_t z3o = s3 * (F1_175 - F1_961) + s4 * F1_175;
  const int32_t z4o = s3 * F1_175 + s4 * (F1_175 - F0_390);
  const int32_t o0 = i7 * (F0_298 - F0_899) + i1 * -F0_899 + z3o;
  const int32_t o3 = i7 * -F0_899 + i1 * (F1_501 - F0_899) + z4o;
  const int32_t o1 = i5 * (F2_053 - F2_562) + i3 * -F2_562 + z4o;
  const int32_t o2 = i5 * -F2_562 + i3 * (F3_072 - F2_562) + z3o;
  out[0] = sat16(descale(t10 + o3, kShift));
  out[7] = sat16(descale(t10 - o3, kShift));
  out[1] = sat16(descale(t11 + o2, kShift));
  out[6] = sat16(descale(t11 - o2, kShift));
  out[2] = sat16(descale(t12 + o1, kShift));
  out[5] = sat16(descale(t12 - o1, kShift));
  out[3] = sat16(descale(t13 + o0, kShift));
  out[4] = sat16(descale(t13 - o0, kShift));
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int16_t ws[64], col[8], res[8];
  bool ac_zero = true;
  for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
  for (int c = 0; c < 8; ++c) {
    if (ac_zero) {
      const int16_t dc = wrap16(wrap16(int32_t(in[c]) * q[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
      continue;
    }
    for (int r = 0; r < 8; ++r) col[r] = wrap16(int32_t(in[8 * r + c]) * q[8 * r + c]);
    idct_pass<kShift1>(col, res);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = res[r];
  }
  for (int r = 0; r < 8; ++r) {
    idct_pass<kShift2>(ws + 8 * r, res);
    uint8_t* o = out + size_t(r) * stride;
    for (int c = 0; c < 8; ++c)
      o[c] = uint8_t((res[c] < -128 ? -128 : res[c] > 127 ? 127 : res[c]) + 128);
  }
}

#endif

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1): each block's
// first nine AC coefficients, where still zero and not known to full
// precision, are estimated from the DC values of the 5 x 5 blocks around
// it (and its DC too where no AC coefficient was sent: DC interpolation),
// then the block goes through the IDCT. The rows follow the library's
// iMCU rows, with its choice of neighbours at the image's edges (the last
// iMCU row counts its rows by the remainder, as the library does) and its
// sliding register of DC values across a row (a row two blocks wide
// repeats its second block to the right, as the fixtures show PIL does).
void smooth_idct(int imcu_rows, Component& c) {
  const int* bits = c.coef_bits;  // the latch: the whole file was read
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
  const int64_t Q00 = c.qraw[0], Q01 = c.qraw[1], Q10 = c.qraw[8], Q20 = c.qraw[16],
                Q11 = c.qraw[9], Q02 = c.qraw[2];
  const int64_t Q03 = change_dc ? c.qraw[3] : 0, Q12 = change_dc ? c.qraw[10] : 0,
                Q21 = change_dc ? c.qraw[17] : 0, Q30 = change_dc ? c.qraw[24] : 0;
  const int last = imcu_rows - 1, last_col = c.wib - 1;
  int16_t ws[64];
  auto estimate = [&](int k, int pos, int64_t q, int64_t num) {
    const int al = bits[k];
    if (al == 0 || ws[pos] != 0) return;
    int pred;
    if (num >= 0) {
      pred = int(((q << 7) + num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = int(((q << 7) - num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    ws[pos] = int16_t(pred);
  };
  for (int row = 0; row < imcu_rows; ++row) {
    int block_rows = c.v;
    if (row == last) {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int image_block_rows = block_rows * imcu_rows;
    for (int br = 0; br < block_rows; ++br) {
      const int ibr = row * block_rows + br, cur = row * c.v + br;
      auto at = [&](int r) { return std::clamp(r, 0, c.bh - 1); };
      const int prev = ibr > 0 ? at(cur - 1) : cur;
      const int prev2 = ibr > 1 ? at(cur - 2) : prev;
      const int next = ibr < image_block_rows - 1 ? at(cur + 1) : cur;
      const int next2 = ibr < image_block_rows - 2 ? at(cur + 2) : next;
      const int16_t* rows[5] = {c.block(prev2, 0), c.block(prev, 0), c.block(cur, 0),
                                c.block(next, 0), c.block(next2, 0)};
      int dc[5][5];  // dc[r][x]: DC01..DC25 row by row
      for (int r = 0; r < 5; ++r)
        for (int x = 0; x < 5; ++x) dc[r][x] = rows[r][0];
      for (int col = 0; col <= last_col; ++col) {
        std::memcpy(ws, c.block(cur, col), sizeof ws);
        if (col == 0 && col < last_col)
          for (int r = 0; r < 5; ++r) dc[r][3] = dc[r][4] = rows[r][64 * 1];
        if (col + 1 < last_col)
          for (int r = 0; r < 5; ++r) dc[r][4] = rows[r][64 * size_t(col + 2)];
        const int64_t DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3],
                      DC05 = dc[0][4], DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2],
                      DC09 = dc[1][3], DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
                      DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4], DC16 = dc[3][0],
                      DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4],
                      DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
                      DC25 = dc[4][4];
        estimate(1, 1, Q01, Q00 * (change_dc
            ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
               3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
               13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
            : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)));
        estimate(2, 8, Q10, Q00 * (change_dc
            ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
               38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 +
               DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
            : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)));
        estimate(3, 16, Q20, Q00 * (change_dc
            ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
               2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
            : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)));
        estimate(4, 9, Q11, Q00 * (change_dc
            ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
            : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
               DC06 + 10 * DC07 - 10 * DC09)));
        estimate(5, 2, Q02, Q00 * (change_dc
            ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
               DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
            : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)));
        if (change_dc) {
          estimate(6, 3, Q03, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
          estimate(7, 10, Q12, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
          estimate(8, 17, Q21, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
          estimate(9, 24, Q30, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
          const int64_t num = Q00 *
              (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
               42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
               42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
               6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          const int pred = num >= 0 ? int(((Q00 << 7) + num) / (Q00 << 8))
                                    : -int(((Q00 << 7) - num) / (Q00 << 8));
          ws[0] = int16_t(pred);
        }
        idct_islow(ws, c.q, c.plane.data() + size_t(cur) * 8 * c.stride + col * 8, c.stride);
        for (int r = 0; r < 5; ++r) {  // the register slides one block right
          for (int x = 0; x < 4; ++x) dc[r][x] = dc[r][x + 1];
        }
      }
    }
  }
}

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// jdcolor.c ycc_rgb_convert over one row of w samples.
void ycc_rgb_row(const uint8_t* const* rows, int w, uint8_t* o) {
  const uint8_t *y = rows[0], *cbs = rows[1], *crs = rows[2];
  for (int x = 0; x < w; ++x) {
    const int yv = y[x], cb = cbs[x], cr = crs[x];
    o[3 * x] = clamp255(yv + kYcc.cr_r[cr]);
    o[3 * x + 1] = clamp255(yv + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    o[3 * x + 2] = clamp255(yv + kYcc.cb_b[cb]);
  }
}

// One output row of a component, upsampled to the frame's full width
// (jdsample.c), from its IDCT plane. Rows outside [0, dh) read the
// nearest real row (jdmainct.c context rows).
const uint8_t* upsample_row(const Component& c, int max_h, int max_v, int y, int width,
                            uint8_t* tmp) {
  const int hr = max_h / c.h, vr = max_v / c.v;
  const int stride = c.stride;
  auto row = [&](int r) { return c.plane.data() + size_t(std::clamp(r, 0, c.dh - 1)) * stride; };
  const int dw = c.dw;
  if (hr == 1 && vr == 1) return row(y);
  if (vr == 1 && hr == 2 && dw > 2) {  // h2v1_fancy_upsample
    const uint8_t* in = row(y);
    uint8_t* o = tmp;
    *o++ = in[0];
    *o++ = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      const int v = in[x] * 3;
      *o++ = uint8_t((v + in[x - 1] + 1) >> 2);
      *o++ = uint8_t((v + in[x + 1] + 2) >> 2);
    }
    *o++ = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    *o++ = in[dw - 1];
    return tmp;
  }
  if (vr == 2 && hr == 1) {  // h1v2_fancy_upsample
    const int iy = y >> 1;
    const bool below = y & 1;
    const uint8_t* in0 = row(iy);
    const uint8_t* in1 = row(below ? iy + 1 : iy - 1);
    const int bias = below ? 2 : 1;
    for (int x = 0; x < dw; ++x) tmp[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    return tmp;
  }
  if (vr == 2 && hr == 2 && dw > 2) {  // h2v2_fancy_upsample
    const int iy = y >> 1;
    const uint8_t* in0 = row(iy);
    const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
    uint8_t* o = tmp;
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    *o++ = uint8_t((this_sum * 4 + 8) >> 4);
    *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int x = 2; x < dw; ++x) {
      next_sum = in0[x] * 3 + in1[x];
      *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
    *o++ = uint8_t((this_sum * 4 + 7) >> 4);
    return tmp;
  }
  // h2v1_upsample, h2v2_upsample, int_upsample: replication.
  const uint8_t* in = row(y / vr);
  for (int x = 0; x < width; ++x) tmp[x] = in[x / hr];
  return tmp;
}

// Each component's samples at its own sampling, into c.plane (stride
// c.stride): the IDCT of every block (block smoothing first where
// smoothing_ok), or the lossless frame's samples as they are.
void make_planes(Decoder& dec) {
  const bool smooth = dec.smoothing_ok();
  for (Component& c : dec.comps) {
    if (dec.lossless) continue;  // the planes are the samples already
    const int stride = c.stride = c.wib * 8;
    c.plane.assign(size_t(stride) * c.hib * 8, 0);
    if (smooth) {
      smooth_idct(dec.mcuy, c);
    } else {
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx)
          idct_islow(c.block(by, bx), c.q, c.plane.data() + size_t(by) * 8 * stride + bx * 8,
                     stride);
    }
    c.coef = std::vector<int16_t>();
  }
}

void produce_rgb(Decoder& dec, uint8_t* out) {
  const int w = dec.width, nc = int(dec.comps.size());
  make_planes(dec);
  // jdapimin.c default_decompress_parms
  enum { GRAY, YCC, RGB, CMYK, YCCK } space;
  if (nc == 1) {
    space = GRAY;
  } else if (nc == 3) {
    if (dec.jfif) space = YCC;
    else if (dec.adobe) space = dec.adobe_transform == 0 ? RGB : YCC;
    else if (dec.comps[0].id == 82 && dec.comps[1].id == 71 && dec.comps[2].id == 66) space = RGB;
    else space = dec.lossless ? RGB : YCC;  // libjpeg-turbo 3: no JFIF, lossless: RGB
  } else {
    space = dec.adobe && dec.adobe_transform != 0 ? YCCK : CMYK;
  }
  std::vector<std::vector<uint8_t>> tmp(nc);
  for (int i = 0; i < nc; ++i) tmp[i].resize(size_t(w) + 2 * dec.comps[i].dw + 16);
  const uint8_t* rows[4];
  for (int y = 0; y < dec.height; ++y) {
    for (int i = 0; i < nc; ++i)
      rows[i] = upsample_row(dec.comps[i], dec.max_h, dec.max_v, y, w, tmp[i].data());
    uint8_t* o = out + size_t(y) * w * 3;
    if (space == GRAY) {
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = rows[0][x];
    } else if (space == RGB) {
      for (int x = 0; x < w; ++x)
        for (int k = 0; k < 3; ++k) o[3 * x + k] = rows[k][x];
    } else if (space == YCC) {
      ycc_rgb_row(rows, w, o);
    } else {
      for (int x = 0; x < w; ++x) {
        int cmyk[4];
        if (space == YCCK) {  // jdcolor.c ycck_cmyk_convert
          const int yv = rows[0][x], cb = rows[1][x], cr = rows[2][x];
          cmyk[0] = clamp255(255 - (yv + kYcc.cr_r[cr]));
          cmyk[1] = clamp255(255 - (yv + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
          cmyk[2] = clamp255(255 - (yv + kYcc.cb_b[cb]));
        } else {
          for (int k = 0; k < 3; ++k) cmyk[k] = rows[k][x];
        }
        cmyk[3] = rows[3][x];
        // PIL: "CMYK;I" inverts every sample; cmyk2rgb then gives
        // nk - nk * c / 255 with nk = 255 - k, here nk = the file's K.
        const int nk = cmyk[3];
        for (int k = 0; k < 3; ++k) {
          const int c = 255 - cmyk[k];
          const int t = c * nk + 128;
          o[3 * x + k] = clamp255(nk - (((t >> 8) + t) >> 8));
        }
      }
    }
  }
}

// The output of a JPEG-in-TIFF stream as libtiff asks libjpeg for it:
// `color` 0 (JCS_UNKNOWN both ways) the components upsampled and
// interleaved as they are; 1 (JPEGCOLORMODE_RGB on YCbCr) YCbCr to RGB;
// 2 (raw_data_out, the old-style JPEG codec) each component's plane of
// dh x dw samples, one after another, without upsampling.
void produce_tiff(Decoder& dec, int color, uint8_t* out) {
  const int w = dec.width, nc = int(dec.comps.size());
  make_planes(dec);
  if (color == 2) {
    for (const Component& c : dec.comps) {
      for (int y = 0; y < c.dh; ++y, out += c.dw)
        std::memcpy(out, c.plane.data() + size_t(y) * c.stride, size_t(c.dw));
    }
    return;
  }
  std::vector<std::vector<uint8_t>> tmp(nc);
  for (int i = 0; i < nc; ++i) tmp[i].resize(size_t(w) + 2 * dec.comps[i].dw + 16);
  const uint8_t* rows[kMaxComponents];
  for (int y = 0; y < dec.height; ++y) {
    for (int i = 0; i < nc; ++i)
      rows[i] = upsample_row(dec.comps[i], dec.max_h, dec.max_v, y, w, tmp[i].data());
    if (color == 1) {
      ycc_rgb_row(rows, w, out + size_t(y) * w * 3);
    } else {
      uint8_t* o = out + size_t(y) * w * nc;
      for (int x = 0; x < w; ++x)
        for (int k = 0; k < nc; ++k) o[nc * x + k] = rows[k][x];
    }
  }
}

}  // namespace

extern "C" {

// Decode a JPEG from memory into (H, W, 3) uint8 RGB. `out` holds
// cap_bytes. Returns 0 on success; -3 with *out_h/*out_w set when `out`
// is null or too small (a call with out null reads only the headers);
// -1 with a message in msg (msg_cap bytes, NUL-terminated) otherwise.
int mm_decode_jpeg(const uint8_t* data, long len, uint8_t* out, long cap_bytes, int* out_h,
                   int* out_w, char* msg, long msg_cap) {
  try {
    if (len < 0) fail("negative length");
    Decoder dec(data, size_t(len));
    if (!out) {
      if (dec.run(true)) fail("no SOF marker");
      *out_h = dec.height;
      *out_w = dec.width;
      return -3;
    }
    dec.run(false);
    dec.check_complete();
    *out_h = dec.height;
    *out_w = dec.width;
    if ((long long)dec.height * dec.width * 3 > cap_bytes) return -3;
    produce_rgb(dec, out);
    return 0;
  } catch (const Failure& f) {
    if (msg && msg_cap > 0) snprintf(msg, size_t(msg_cap), "%s", f.msg.c_str());
  } catch (const std::bad_alloc&) {
    if (msg && msg_cap > 0) snprintf(msg, size_t(msg_cap), "out of memory");
  }
  return -1;
}

// Decode one strip or tile of a JPEG-compressed TIFF as libtiff 4.7 hands
// it to Pillow. `tables` (tag 347, JPEGTables; null or tables_len 0 for
// none) is read first as a tables-only stream, then `data`, with the
// tables it defined; where either runs out, an EOI marker ends it, as
// libtiff's source supplies one; any count of components up to 10. `color`
// as produce_tiff takes it. info (3 + 4 * 10 ints) receives the height,
// width and component count, then each component's horizontal and
// vertical sampling factors and its plane's height and width (jdinput.c's
// downsampled sizes). Returns 0; -3 with info set when `out` is null (a
// call that reads only the headers) or holds less than cap_bytes needs;
// -1 with a message in msg.
int mm_decode_jpeg_tiff(const uint8_t* tables, long tables_len, const uint8_t* data, long len,
                        int color, uint8_t* out, long cap_bytes, int* info, char* msg,
                        long msg_cap) {
  try {
    if (len < 0 || tables_len < 0) fail("negative length");
    if (color < 0 || color > 2) fail("unknown colour handling %d", color);
    Decoder dec(tables, size_t(tables_len));
    dec.in_tiff = true;
    if (tables && tables_len > 0) dec.run_tables();
    dec.d = data;
    dec.n = size_t(len);
    dec.pos = 0;
    dec.reset_for_soi();
    if (!out) {
      if (dec.run(true)) fail("no SOF marker");
    } else {
      dec.run(false);
      dec.check_complete();
    }
    const int nc = int(dec.comps.size());
    if (color == 1 && nc != 3) fail("YCbCr to RGB of a stream of %d components", nc);
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = nc;
    long long need = 0;
    for (int i = 0; i < nc; ++i) {
      int* c = info + 3 + 4 * i;
      c[0] = dec.comps[i].h;
      c[1] = dec.comps[i].v;
      c[2] = dec.comps[i].dh;
      c[3] = dec.comps[i].dw;
      need += (long long)dec.comps[i].dw * dec.comps[i].dh;
    }
    if (color != 2) need = (long long)dec.height * dec.width * (color == 1 ? 3 : nc);
    if (!out || need > cap_bytes) return -3;
    produce_tiff(dec, color, out);
    return 0;
  } catch (const Failure& f) {
    if (msg && msg_cap > 0) snprintf(msg, size_t(msg_cap), "%s", f.msg.c_str());
  } catch (const std::bad_alloc&) {
    if (msg && msg_cap > 0) snprintf(msg, size_t(msg_cap), "out of memory");
  }
  return -1;
}

}  // extern "C"
