// WebP decoder of the port's native library, in plain C++17 (libstdc++
// only). multimae_tpu_torch/native/__init__.py compiles it into one
// library with fastimage.cpp, jpeg_decode.cpp, pil_ops.cpp and
// tiff_decode.cpp and binds with ctypes `mm_decode_webp`, and the colour
// and alpha stages alone (`mm_webp_colour`, `mm_webp_unfilter`) that the
// numpy twins of data/image_io.py are tested against.
//
// What it returns is what the JAX package's loader gets for a WebP file:
// PIL 12.1's WebPImagePlugin, which hands the whole file to libwebp 1.6's
// WebPAnimDecoder (RGBA, not premultiplied, default decoder options) and
// takes its first canvas. Each stage follows the libwebp source it stands
// for:
//   * the container: demux.c (ReadHeader, ParseSingleImage, ParseVP8X,
//     ParseVP8XChunks, ParseAnimationFrame, StoreFrame, and the
//     IsValidSimpleFormat / IsValidExtendedFormat checks), then
//     webp_dec.c's ParseHeadersInternal on frame 0's ALPH + VP8/VP8L
//     payload; PIL's mode comes from WebPGetFeatures on the whole file
//     ("RGBA" unless it succeeds and finds no alpha);
//   * VP8 key frames (RFC 6386, vp8_dec.c, tree_dec.c, quant_dec.c,
//     frame_dec.c): libwebp's boolean decoder with its 56-bit loads and
//     end-of-data rule, the frame header, segments, both loop filters,
//     the token partitions, the intra predictors with the 127/129
//     borders, and the transforms as the x86-64 build runs them (the full
//     inverse DCT in 16-bit lanes as dec_sse2.c's Transform, the DC-only
//     and three-coefficient shortcuts and the WHT in int);
//   * the colour stage (io_dec.c EmitFancyRGB, upsampling.c's
//     UpsampleRgbaLinePair, yuv.h's VP8YUVToR/G/B): fancy 4:2:0
//     upsampling and 14-bit fixed-point YUV to RGB, no dithering;
//   * VP8L (RFC 9649, vp8l_dec.c, huffman_utils.c, lossless.c): the bit
//     reader with its end-of-stream rule, the four transforms, the colour
//     cache, meta prefix codes, LZ77 with the distance map; ARGB out as
//     RGBA;
//   * ALPH (alpha_dec.c, filters.c): raw or VP8L-coded alpha (the green of
//     a headerless stream, with vp8l_dec.c's 8-bit path and its own end
//     rule where it applies) and the horizontal, vertical and gradient
//     unfilters;
//   * an animation's first frame (anim_decode.c): a zeroed canvas of the
//     VP8X size with the frame decoded at its offset, no blending.
//
// Raised as errors, naming what was met: whatever libwebp refuses there (a
// RIFF size past the data, a still frame that is not the canvas's size, a
// non-key VP8 frame, a partition or a VP8L stream that runs out, an
// invalid prefix code, ...), and a canvas past PIL's decompression-bomb
// limit. Nothing reads past the input or writes past the output.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

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

uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (uint32_t(p[2]) << 16); }
uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }

// The default coefficient probabilities (RFC 6386 13.5, default_coef_probs).
const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
         {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
         {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
         {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
         {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
         {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
         {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
         {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
         {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
         {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
         {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
         {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
         {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
         {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
         {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
         {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
         {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
         {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
         {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
         {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
         {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
         {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
         {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
         {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
         {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
         {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
         {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
         {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
         {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
         {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
         {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
         {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
         {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
         {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
         {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
         {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
         {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
         {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
         {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
         {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
         {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
         {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
         {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
         {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
         {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
         {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
         {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
         {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
         {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
         {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
         {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
         {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
         {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};

// The probabilities of their updates (RFC 6386 13.4, coeff_update_probs).
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
         {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
         {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
         {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};

// Key-frame sub-block mode probabilities by the modes above and to the left
// (RFC 6386 11.5, kf_bmode_probs).
const uint8_t kBModesProba[10][10][9] = {
    {
        {231, 120, 48, 89, 115, 113, 120, 152, 112},
        {152, 179, 64, 126, 170, 118, 46, 70, 95},
        {175, 69, 143, 80, 85, 82, 72, 155, 103},
        {56, 58, 10, 171, 218, 189, 17, 13, 152},
        {114, 26, 17, 163, 44, 195, 21, 10, 173},
        {121, 24, 80, 195, 26, 62, 44, 64, 85},
        {144, 71, 10, 38, 171, 213, 144, 34, 26},
        {170, 46, 55, 19, 136, 160, 33, 206, 71},
        {63, 20, 8, 114, 114, 208, 12, 9, 226},
        {81, 40, 11, 96, 182, 84, 29, 16, 36},
    },
    {
        {134, 183, 89, 137, 98, 101, 106, 165, 148},
        {72, 187, 100, 130, 157, 111, 32, 75, 80},
        {66, 102, 167, 99, 74, 62, 40, 234, 128},
        {41, 53, 9, 178, 241, 141, 26, 8, 107},
        {74, 43, 26, 146, 73, 166, 49, 23, 157},
        {65, 38, 105, 160, 51, 52, 31, 115, 128},
        {104, 79, 12, 27, 217, 255, 87, 17, 7},
        {87, 68, 71, 44, 114, 51, 15, 186, 23},
        {47, 41, 14, 110, 182, 183, 21, 17, 194},
        {66, 45, 25, 102, 197, 189, 23, 18, 22},
    },
    {
        {88, 88, 147, 150, 42, 46, 45, 196, 205},
        {43, 97, 183, 117, 85, 38, 35, 179, 61},
        {39, 53, 200, 87, 26, 21, 43, 232, 171},
        {56, 34, 51, 104, 114, 102, 29, 93, 77},
        {39, 28, 85, 171, 58, 165, 90, 98, 64},
        {34, 22, 116, 206, 23, 34, 43, 166, 73},
        {107, 54, 32, 26, 51, 1, 81, 43, 31},
        {68, 25, 106, 22, 64, 171, 36, 225, 114},
        {34, 19, 21, 102, 132, 188, 16, 76, 124},
        {62, 18, 78, 95, 85, 57, 50, 48, 51},
    },
    {
        {193, 101, 35, 159, 215, 111, 89, 46, 111},
        {60, 148, 31, 172, 219, 228, 21, 18, 111},
        {112, 113, 77, 85, 179, 255, 38, 120, 114},
        {40, 42, 1, 196, 245, 209, 10, 25, 109},
        {88, 43, 29, 140, 166, 213, 37, 43, 154},
        {61, 63, 30, 155, 67, 45, 68, 1, 209},
        {100, 80, 8, 43, 154, 1, 51, 26, 71},
        {142, 78, 78, 16, 255, 128, 34, 197, 171},
        {41, 40, 5, 102, 211, 183, 4, 1, 221},
        {51, 50, 17, 168, 209, 192, 23, 25, 82},
    },
    {
        {138, 31, 36, 171, 27, 166, 38, 44, 229},
        {67, 87, 58, 169, 82, 115, 26, 59, 179},
        {63, 59, 90, 180, 59, 166, 93, 73, 154},
        {40, 40, 21, 116, 143, 209, 34, 39, 175},
        {47, 15, 16, 183, 34, 223, 49, 45, 183},
        {46, 17, 33, 183, 6, 98, 15, 32, 183},
        {57, 46, 22, 24, 128, 1, 54, 17, 37},
        {65, 32, 73, 115, 28, 128, 23, 128, 205},
        {40, 3, 9, 115, 51, 192, 18, 6, 223},
        {87, 37, 9, 115, 59, 77, 64, 21, 47},
    },
    {
        {104, 55, 44, 218, 9, 54, 53, 130, 226},
        {64, 90, 70, 205, 40, 41, 23, 26, 57},
        {54, 57, 112, 184, 5, 41, 38, 166, 213},
        {30, 34, 26, 133, 152, 116, 10, 32, 134},
        {39, 19, 53, 221, 26, 114, 32, 73, 255},
        {31, 9, 65, 234, 2, 15, 1, 118, 73},
        {75, 32, 12, 51, 192, 255, 160, 43, 51},
        {88, 31, 35, 67, 102, 85, 55, 186, 85},
        {56, 21, 23, 111, 59, 205, 45, 37, 192},
        {55, 38, 70, 124, 73, 102, 1, 34, 98},
    },
    {
        {125, 98, 42, 88, 104, 85, 117, 175, 82},
        {95, 84, 53, 89, 128, 100, 113, 101, 45},
        {75, 79, 123, 47, 51, 128, 81, 171, 1},
        {57, 17, 5, 71, 102, 57, 53, 41, 49},
        {38, 33, 13, 121, 57, 73, 26, 1, 85},
        {41, 10, 67, 138, 77, 110, 90, 47, 114},
        {115, 21, 2, 10, 102, 255, 166, 23, 6},
        {101, 29, 16, 10, 85, 128, 101, 196, 26},
        {57, 18, 10, 102, 102, 213, 34, 20, 43},
        {117, 20, 15, 36, 163, 128, 68, 1, 26},
    },
    {
        {102, 61, 71, 37, 34, 53, 31, 243, 192},
        {69, 60, 71, 38, 73, 119, 28, 222, 37},
        {68, 45, 128, 34, 1, 47, 11, 245, 171},
        {62, 17, 19, 70, 146, 85, 55, 62, 70},
        {37, 43, 37, 154, 100, 163, 85, 160, 1},
        {63, 9, 92, 136, 28, 64, 32, 201, 85},
        {75, 15, 9, 9, 64, 255, 184, 119, 16},
        {86, 6, 28, 5, 64, 255, 25, 248, 1},
        {56, 8, 17, 132, 137, 255, 55, 116, 128},
        {58, 15, 20, 82, 135, 57, 26, 121, 40},
    },
    {
        {164, 50, 31, 137, 154, 133, 25, 35, 218},
        {51, 103, 44, 131, 131, 123, 31, 6, 158},
        {86, 40, 64, 135, 148, 224, 45, 183, 128},
        {22, 26, 17, 131, 240, 154, 14, 1, 209},
        {45, 16, 21, 91, 64, 222, 7, 1, 197},
        {56, 21, 39, 155, 60, 138, 23, 102, 213},
        {83, 12, 13, 54, 192, 255, 68, 47, 28},
        {85, 26, 85, 85, 128, 128, 32, 146, 171},
        {18, 11, 7, 63, 144, 171, 4, 4, 246},
        {35, 27, 10, 146, 174, 171, 12, 26, 128},
    },
    {
        {190, 80, 35, 99, 180, 80, 126, 54, 45},
        {85, 126, 47, 87, 176, 51, 41, 20, 32},
        {101, 75, 128, 139, 118, 146, 116, 128, 85},
        {56, 41, 15, 176, 236, 85, 37, 9, 62},
        {71, 30, 17, 119, 118, 255, 17, 18, 138},
        {101, 38, 60, 138, 55, 70, 43, 26, 142},
        {146, 36, 19, 30, 171, 255, 97, 27, 20},
        {138, 45, 61, 62, 219, 1, 81, 188, 64},
        {32, 41, 20, 117, 151, 142, 20, 21, 163},
        {112, 19, 12, 61, 195, 128, 48, 4, 24},
    },
};

// VP8L's 120 short distance codes, (dy << 4) | (8 - dx) (RFC 9649 4.2.2).
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// --- VP8: the boolean decoder (bit_reader_utils.h, 64-bit build) ------------

struct BoolReader {
  uint64_t value = 0;  // bit_t
  uint32_t range = 255 - 1;  // the range minus one
  int bits = -8;  // valid bits left in `value`
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* max = nullptr;  // the last place a 7-byte load may start
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    value = 0;
    range = 255 - 1;
    bits = -8;
    eof = false;
    buf = start;
    end = start + size;
    max = size >= 8 ? start + size - 8 + 1 : start;
    load();
  }

  void load() {
    if (buf < max) {
      uint64_t in;
      memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else if (buf < end) {  // VP8LoadFinalBytes
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }

  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }

  // VP8GetSigned: a bit at probability 1/2 giving the sign of v.
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }

  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get_bit(0x80)) << n;
    return v;
  }

  int get_signed_value(int n) {
    const int v = int(get_value(n));
    return get_bit(0x80) ? -v : v;
  }
};

// --- VP8: the key frame -------------------------------------------------------

enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED,
  B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// The work buffer of one macroblock (frame_dec.c's yuv_b_): a row above
// and a column left of each plane.
constexpr int BPS = 32;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return (v & ~0xff) == 0 ? uint8_t(v) : v < 0 ? 0 : 255; }

// --- transforms (dec.c; the full one as dec_sse2.c's Transform) ---

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int16_t w16(int v) { return int16_t(v); }  // a 16-bit lane's wrap
inline int16_t mulhi(int16_t a, int k) { return int16_t((int32_t(a) * k) >> 16); }

// Transform_SSE2 for one block: every sum in a 16-bit lane, the products as
// _mm_mulhi_epi16 with 20091 and 35468 - 65536, the result added to dst
// with unsigned saturation.
void transform_full(const int16_t* in, uint8_t* dst) {
  int16_t t[4][4];  // t[k][i]: output k of the vertical pass of column i
  for (int i = 0; i < 4; ++i) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
    t[0][i] = w16(a + d);
    t[1][i] = w16(b + c);
    t[2][i] = w16(b - c);
    t[3][i] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r) {  // output row r: the r-th result of each column
    const int16_t T0 = t[r][0], T1 = t[r][1], T2 = t[r][2], T3 = t[r][3];
    const int16_t dc = w16(T0 + 4);
    const int16_t a = w16(dc + T2), b = w16(dc - T2);
    const int16_t c = w16(w16(T1 - T3) + w16(mulhi(T1, -30068) - mulhi(T3, 20091)));
    const int16_t d = w16(w16(T1 + T3) + w16(mulhi(T1, 20091) + mulhi(T3, -30068)));
    const int16_t o[4] = {int16_t(w16(a + d) >> 3), int16_t(w16(b + c) >> 3),
                          int16_t(w16(b - c) >> 3), int16_t(w16(a - d) >> 3)};
    uint8_t* row = dst + r * BPS;
    for (int x = 0; x < 4; ++x) row[x] = clip8(row[x] + o[x]);
  }
}

void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    uint8_t* row = dst + y * BPS;
    const int dc = dcs[y];
    row[0] = clip8(row[0] + ((dc + d1) >> 3));
    row[1] = clip8(row[1] + ((dc + c1) >> 3));
    row[2] = clip8(row[2] + ((dc - c1) >> 3));
    row[3] = clip8(row[3] + ((dc - d1) >> 3));
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(dst[x + y * BPS] + (dc >> 3));
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// frame_dec.c DoTransform: the 2-bit code of a block (3: more than three
// coefficients, 2: at most three, 1: the DC alone) picks the transform.
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_full(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  if (bits & 0xaa) {  // an AC coefficient somewhere: the full transform on all four
    transform_full(src, dst);
    transform_full(src + 16, dst + 4);
    transform_full(src + 32, dst + 4 * BPS);
    transform_full(src + 48, dst + 4 * BPS + 4);
  } else {
    if (src[0]) transform_dc(src, dst);
    if (src[16]) transform_dc(src + 16, dst + 4);
    if (src[32]) transform_dc(src + 32, dst + 4 * BPS);
    if (src[48]) transform_dc(src + 48, dst + 4 * BPS + 4);
  }
}

// --- intra predictors (dec.c) ---

inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred16(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case B_DC_PRED:
      dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, 16, dc >> 5);
      break;
    case B_TM_PRED: true_motion(dst, 16); break;
    case B_VE_PRED:
      for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case B_HE_PRED:
      for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case B_DC_PRED_NOTOP:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, 16, dc >> 4);
      break;
    case B_DC_PRED_NOLEFT:
      dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill(dst, 16, dc >> 4);
      break;
    default: fill(dst, 16, 0x80); break;
  }
}

void pred8(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case B_DC_PRED:
      dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 8, dc >> 4);
      break;
    case B_TM_PRED: true_motion(dst, 8); break;
    case B_VE_PRED:
      for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case B_HE_PRED:
      for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case B_DC_PRED_NOTOP:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill(dst, 8, dc >> 3);
      break;
    case B_DC_PRED_NOLEFT:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill(dst, 8, dc >> 3);
      break;
    default: fill(dst, 8, 0x80); break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, int(dc >> 3));
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst + 0 * BPS, avg3(X, I, J), 4);
      memset(dst + 1 * BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
  }
}

#undef DST

int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
    return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

// --- loop filters (dec.c) ---

inline int abs0(int v) { return v < 0 ? -v : v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2

void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs0(p1 - p0) > thresh || abs0(q1 - q0) > thresh;
}

bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs0(p0 - q0) + abs0(p1 - q1) <= t;
}

bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t) return false;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it &&
         abs0(q3 - q2) <= it && abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

// The simple filter across one edge of 16 pixels: `step` crosses the edge,
// `along` walks it.
void simple_edge(uint8_t* p, int step, int along, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along)
    if (needs_filter(p, step, thresh2)) filter2(p, step);
}

// FilterLoop26 (macroblock edges) and FilterLoop24 (inner edges).
void edge_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
               int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        filter2(p, hstride);
      } else if (mb_edge) {
        filter6(p, hstride);
      } else {
        filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
};

struct Planes {  // a decoded VP8 frame, cropped: Y (h, w), U and V ((h + 1) / 2, (w + 1) / 2)
  int width = 0, height = 0;
  std::vector<uint8_t> y, u, v;
};

class Vp8Decoder {
 public:
  Planes run(const uint8_t* data, size_t size);

 private:
  void parse_header(const uint8_t* data, size_t size);
  void parse_intra_mode(int mb_x);
  bool decode_mb(int mb_x, BoolReader& token_br, FInfo* finfo);
  int get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out);
  int parse_residuals(int mb_x, BoolReader& token_br);
  void reconstruct_row(int mb_y);
  void filter_frame();

  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_minus_one_ = 0;
  // segment header (ResetSegmentHeader's defaults)
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  int segment_probs_[3] = {255, 255, 255};
  // filter header
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  struct QuantMatrix {
    int y1[2], y2[2], uv[2];
  } dqm_[4];
  uint8_t proba_[4][8][3][11];
  int use_skip_proba_ = 0, skip_p_ = 0;
  FInfo fstrengths_[4][2];
  // per-frame state
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4];
  std::vector<uint8_t> nz_, nz_dc_;  // [0] is the left macroblock, [1 + x] the one above x
  std::vector<MBData> mb_data_;      // the row being decoded
  std::vector<FInfo> f_info_;        // every macroblock's filter strength
  std::vector<uint8_t> top_y_, top_u_, top_v_;  // yuv_t_: each column's unfiltered bottom rows
  uint8_t yuv_b_[YUV_SIZE];
  std::vector<uint8_t> py_, pu_, pv_;  // the whole frame, macroblock-aligned
  int ystride_ = 0, uvstride_ = 0;
};

void Vp8Decoder::parse_header(const uint8_t* buf, size_t size) {
  // vp8_dec.c VP8GetHeaders
  if (size < 4) fail("VP8: truncated header");
  const uint32_t bits = buf[0] | (buf[1] << 8) | (uint32_t(buf[2]) << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) fail("VP8: incorrect keyframe parameters");
  if (!show) fail("VP8: frame not displayable");
  buf += 3;
  size -= 3;
  if (!key_frame) fail("VP8: not a key frame");
  if (size < 7) fail("VP8: cannot parse picture header");
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) fail("VP8: bad code word");
  width_ = ((buf[4] << 8) | buf[3]) & 0x3fff;  // the scale bits are ignored
  height_ = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  size -= 7;
  if (width_ == 0 || height_ == 0) fail("VP8: zero width or height");
  mb_w_ = (width_ + 15) >> 4;
  mb_h_ = (height_ + 15) >> 4;
  memcpy(proba_, kCoeffsProba0, sizeof proba_);  // VP8ResetProba (the segment probabilities: 255)

  if (partition_length > size) fail("VP8: bad partition length");
  br_.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;
  br_.get_value(1);  // colour space
  br_.get_value(1);  // clamping type: libwebp ignores it

  // ParseSegmentHeader
  use_segment_ = br_.get_value(1);
  if (use_segment_) {
    update_map_ = br_.get_value(1);
    if (br_.get_value(1)) {  // update data
      absolute_delta_ = br_.get_value(1);
      for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get_value(1) ? br_.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        filter_strength_[s] = br_.get_value(1) ? br_.get_signed_value(6) : 0;
    }
    if (update_map_)
      for (int s = 0; s < 3; ++s) segment_probs_[s] = br_.get_value(1) ? br_.get_value(8) : 255;
  } else {
    update_map_ = 0;
  }
  if (br_.eof) fail("VP8: cannot parse segment header");

  // ParseFilterHeader
  simple_ = br_.get_value(1);
  level_ = br_.get_value(6);
  sharpness_ = br_.get_value(3);
  use_lf_delta_ = br_.get_value(1);
  if (use_lf_delta_ && br_.get_value(1)) {  // update the deltas
    for (int i = 0; i < 4; ++i)
      if (br_.get_value(1)) ref_lf_delta_[i] = br_.get_signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br_.get_value(1)) mode_lf_delta_[i] = br_.get_signed_value(6);
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  if (br_.eof) fail("VP8: cannot parse filter header");

  // ParsePartitions: the last partition takes the rest of the data.
  num_parts_minus_one_ = (1 << br_.get_value(2)) - 1;
  const size_t last_part = size_t(num_parts_minus_one_);
  if (size < 3 * last_part) fail("VP8: cannot parse partitions");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p, sz += 3) {
    size_t psize = le24(sz);
    if (psize > size_left) psize = size_left;
    parts_[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
  }
  parts_[last_part].init(part_start, size_left);
  if (part_start >= buf + size) fail("VP8: cannot parse partitions (no data for the last)");

  // VP8ParseQuant
  static const uint8_t kDcTable[128] = {
      4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
      18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
      29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
      44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
      59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
      75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
      91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
      122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
  static const uint16_t kAcTable[128] = {
      4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
      20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
      36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
      52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
      78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
      110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
      155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
      213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  const int base_q0 = br_.get_value(7);
  const int dqy1_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  const int dqy2_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  const int dqy2_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  const int dquv_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  const int dquv_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment_) {
      q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
    } else if (i > 0) {
      dqm_[i] = dqm_[0];
      continue;
    } else {
      q = base_q0;
    }
    QuantMatrix& m = dqm_[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }

  br_.get_value(1);  // refresh entropy probs: ignored in a key frame
  // VP8ParseProba
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          if (br_.get_bit(kCoeffsUpdateProba[t][b][c][p])) proba_[t][b][c][p] = br_.get_value(8);
  use_skip_proba_ = br_.get_value(1);
  if (use_skip_proba_) skip_p_ = br_.get_value(8);

  // PrecomputeFilterStrengths
  if (filter_type_ > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment_) {
        base_level = filter_strength_[s];
        if (!absolute_delta_) base_level += level_;
      } else {
        base_level = level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths_[s][i4x4];
        int level = base_level;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;  // no filtering
        }
        info.inner = i4x4;
      }
    }
  }
}

void Vp8Decoder::parse_intra_mode(int mb_x) {
  // tree_dec.c ParseIntraMode
  uint8_t* const top = &intra_t_[4 * mb_x];
  uint8_t* const left = intra_l_;
  MBData& block = mb_data_[mb_x];
  if (update_map_) {
    block.segment = !br_.get_bit(segment_probs_[0]) ? br_.get_bit(segment_probs_[1])
                                                   : br_.get_bit(segment_probs_[2]) + 2;
  } else {
    block.segment = 0;
  }
  block.skip = use_skip_proba_ ? br_.get_bit(skip_p_) : 0;
  block.is_i4x4 = !br_.get_bit(145);
  if (!block.is_i4x4) {
    const int ymode = br_.get_bit(156) ? (br_.get_bit(128) ? TM_PRED : H_PRED)
                                       : (br_.get_bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = uint8_t(ymode);
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = kBModesProba[top[x]][ymode];
        ymode = !br_.get_bit(prob[0])   ? B_DC_PRED
                : !br_.get_bit(prob[1]) ? B_TM_PRED
                : !br_.get_bit(prob[2]) ? B_VE_PRED
                : !br_.get_bit(prob[3])
                    ? (!br_.get_bit(prob[4]) ? B_HE_PRED
                                             : (!br_.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                    : (!br_.get_bit(prob[6])
                           ? B_LD_PRED
                           : (!br_.get_bit(prob[7])
                                  ? B_VL_PRED
                                  : (!br_.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = uint8_t(ymode);
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  block.uvmode = !br_.get_bit(142)   ? DC_PRED
                 : !br_.get_bit(114) ? V_PRED
                 : br_.get_bit(183)  ? TM_PRED
                                     : H_PRED;
}

// vp8_dec.c GetCoeffsFast: the tokens of one block from position n on, of
// coefficient type `type` (0: i16 AC, 1: Y2, 2: chroma, 3: i4); returns
// the position after the last one read (16 where a run of zeros ends it).
int Vp8Decoder::get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n,
                           int16_t* out) {
  const uint8_t* p = proba_[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;  // end of block
    while (!br.get_bit(p[1])) {      // a zero
      p = proba_[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {  // GetLargeValue
      if (!br.get_bit(p[3])) {
        v = !br.get_bit(p[4]) ? 2 : 3 + br.get_bit(p[5]);
      } else if (!br.get_bit(p[6])) {
        if (!br.get_bit(p[7])) {
          v = 5 + br.get_bit(159);
        } else {
          v = 7 + 2 * br.get_bit(165);
          v += br.get_bit(145);
        }
      } else {
        const int bit1 = br.get_bit(p[8]);
        const int bit0 = br.get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
        v += 3 + (8 << cat);
      }
      p = p_ctx[2];
    }
    out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
  return nz_coeffs;
}

int Vp8Decoder::parse_residuals(int mb_x, BoolReader& token_br) {
  MBData& block = mb_data_[mb_x];
  const QuantMatrix& q = dqm_[block.segment];
  int16_t* dst = block.coeffs;
  uint8_t& top_nz = nz_[1 + mb_x];
  uint8_t& left_nz = nz_[0];
  uint8_t& top_nz_dc = nz_dc_[1 + mb_x];
  uint8_t& left_nz_dc = nz_dc_[0];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first, ac_type;
  memset(dst, 0, sizeof block.coeffs);
  if (!block.is_i4x4) {  // the DC of the 16 blocks through the WHT
    int16_t dc[16] = {0};
    const int ctx = top_nz_dc + left_nz_dc;
    const int nz = get_coeffs(token_br, 1, ctx, q.y2, 0, dc);
    top_nz_dc = left_nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }

  uint32_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(token_br, ac_type, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = (tnz >> 1) | (uint32_t(l) << 7);
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (uint32_t(l) << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;

  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = uint32_t(top_nz) >> (4 + ch);
    lnz = uint32_t(left_nz) >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(token_br, 2, ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = (tnz >> 1) | (uint32_t(l) << 3);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (uint32_t(l) << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  top_nz = uint8_t(out_t_nz);
  left_nz = uint8_t(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

bool Vp8Decoder::decode_mb(int mb_x, BoolReader& token_br, FInfo* finfo) {
  MBData& block = mb_data_[mb_x];
  int skip = use_skip_proba_ ? block.skip : 0;
  if (!skip) {
    skip = parse_residuals(mb_x, token_br);
  } else {
    nz_[0] = nz_[1 + mb_x] = 0;
    if (!block.is_i4x4) nz_dc_[0] = nz_dc_[1 + mb_x] = 0;
    block.non_zero_y = 0;
    block.non_zero_uv = 0;
  }
  if (finfo) {
    *finfo = fstrengths_[block.segment][block.is_i4x4];
    finfo->inner |= !skip;
  }
  return !token_br.eof;
}

void Vp8Decoder::reconstruct_row(int mb_y) {
  // frame_dec.c ReconstructRow
  uint8_t* const y_dst = yuv_b_ + Y_OFF;
  uint8_t* const u_dst = yuv_b_ + U_OFF;
  uint8_t* const v_dst = yuv_b_ + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
    const MBData& block = mb_data_[mb_x];
    if (mb_x > 0) {  // the left samples from the block before
      for (int j = -1; j < 16; ++j) memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
      for (int j = -1; j < 8; ++j) {
        memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
        memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
      }
    }
    uint8_t* const top_y = &top_y_[16 * mb_x];
    uint8_t* const top_u = &top_u_[8 * mb_x];
    uint8_t* const top_v = &top_v_[8 * mb_x];
    const int16_t* const coeffs = block.coeffs;
    uint32_t bits = block.non_zero_y;
    if (mb_y > 0) {
      memcpy(y_dst - BPS, top_y, 16);
      memcpy(u_dst - BPS, top_u, 8);
      memcpy(v_dst - BPS, top_v, 8);
    }
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w_ - 1) {
          memset(top_right, top_y[15], 4);
        } else {
          memcpy(top_right, top_y + 16, 4);
        }
      }
      // the same top-right samples for the sub-blocks of the right column
      memcpy(top_right + 4 * BPS, top_right, 4);
      memcpy(top_right + 8 * BPS, top_right, 4);
      memcpy(top_right + 12 * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + kScan[n];
        pred4(block.imodes[n], dst);
        do_transform(bits, coeffs + n * 16, dst);
      }
    } else {
      pred16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
      if (bits != 0)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
    }
    const int pred_uv = check_mode(mb_x, mb_y, block.uvmode);
    pred8(pred_uv, u_dst);
    pred8(pred_uv, v_dst);
    do_uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
    do_uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
    if (mb_y < mb_h_ - 1) {
      memcpy(top_y, y_dst + 15 * BPS, 16);
      memcpy(top_u, u_dst + 7 * BPS, 8);
      memcpy(top_v, v_dst + 7 * BPS, 8);
    }
    uint8_t* const py = &py_[size_t(mb_y) * 16 * ystride_ + mb_x * 16];
    uint8_t* const pu = &pu_[size_t(mb_y) * 8 * uvstride_ + mb_x * 8];
    uint8_t* const pv = &pv_[size_t(mb_y) * 8 * uvstride_ + mb_x * 8];
    for (int j = 0; j < 16; ++j) memcpy(py + size_t(j) * ystride_, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(pu + size_t(j) * uvstride_, u_dst + j * BPS, 8);
      memcpy(pv + size_t(j) * uvstride_, v_dst + j * BPS, 8);
    }
  }
}

void Vp8Decoder::filter_frame() {
  // frame_dec.c DoFilter over every macroblock in raster order
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const FInfo& f = f_info_[size_t(mb_y) * mb_w_ + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* const y = &py_[size_t(mb_y) * 16 * ystride_ + mb_x * 16];
      const int ys = ystride_;
      if (filter_type_ == 1) {  // simple: luma only
        if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, limit);
        if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, limit);
      } else {
        uint8_t* const u = &pu_[size_t(mb_y) * 8 * uvstride_ + mb_x * 8];
        uint8_t* const v = &pv_[size_t(mb_y) * 8 * uvstride_ + mb_x * 8];
        const int us = uvstride_, il = f.ilevel, hv = f.hev_thresh;
        if (mb_x > 0) {
          edge_loop(y, 1, ys, 16, limit + 4, il, hv, true);
          edge_loop(u, 1, us, 8, limit + 4, il, hv, true);
          edge_loop(v, 1, us, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) edge_loop(y + k, 1, ys, 16, limit, il, hv, false);
          edge_loop(u + 4, 1, us, 8, limit, il, hv, false);
          edge_loop(v + 4, 1, us, 8, limit, il, hv, false);
        }
        if (mb_y > 0) {
          edge_loop(y, ys, 1, 16, limit + 4, il, hv, true);
          edge_loop(u, us, 1, 8, limit + 4, il, hv, true);
          edge_loop(v, us, 1, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) edge_loop(y + k * ys, ys, 1, 16, limit, il, hv, false);
          edge_loop(u + 4 * us, us, 1, 8, limit, il, hv, false);
          edge_loop(v + 4 * us, us, 1, 8, limit, il, hv, false);
        }
      }
    }
  }
}

Planes Vp8Decoder::run(const uint8_t* data, size_t size) {
  parse_header(data, size);
  intra_t_.assign(size_t(4) * mb_w_, B_DC_PRED);
  nz_.assign(size_t(mb_w_) + 1, 0);
  nz_dc_.assign(size_t(mb_w_) + 1, 0);
  mb_data_.resize(size_t(mb_w_));
  f_info_.assign(filter_type_ > 0 ? size_t(mb_w_) * mb_h_ : 0, FInfo());
  top_y_.assign(size_t(16) * mb_w_ + 4, 0);
  top_u_.assign(size_t(8) * mb_w_, 0);
  top_v_.assign(size_t(8) * mb_w_, 0);
  memset(yuv_b_, 0, sizeof yuv_b_);
  ystride_ = 16 * mb_w_;
  uvstride_ = 8 * mb_w_;
  py_.assign(size_t(ystride_) * 16 * mb_h_, 0);
  pu_.assign(size_t(uvstride_) * 8 * mb_h_, 0);
  pv_.assign(size_t(uvstride_) * 8 * mb_h_, 0);
  // frame_dec.c ParseFrame
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    BoolReader& token_br = parts_[mb_y & num_parts_minus_one_];
    memset(intra_l_, B_DC_PRED, sizeof intra_l_);
    nz_[0] = nz_dc_[0] = 0;
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(mb_x);
    if (br_.eof) fail("VP8: premature end of partition 0 in macroblock row %d", mb_y);
    FInfo* const row_info = filter_type_ > 0 ? &f_info_[size_t(mb_y) * mb_w_] : nullptr;
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x)
      if (!decode_mb(mb_x, token_br, row_info ? row_info + mb_x : nullptr))
        fail("VP8: premature end of file in macroblock row %d", mb_y);
    reconstruct_row(mb_y);
  }
  if (filter_type_ > 0) filter_frame();
  Planes out;
  out.width = width_;
  out.height = height_;
  const int uw = (width_ + 1) / 2, uh = (height_ + 1) / 2;
  out.y.resize(size_t(width_) * height_);
  out.u.resize(size_t(uw) * uh);
  out.v.resize(size_t(uw) * uh);
  for (int j = 0; j < height_; ++j)
    memcpy(&out.y[size_t(j) * width_], &py_[size_t(j) * ystride_], width_);
  for (int j = 0; j < uh; ++j) {
    memcpy(&out.u[size_t(j) * uw], &pu_[size_t(j) * uvstride_], uw);
    memcpy(&out.v[size_t(j) * uw], &pv_[size_t(j) * uvstride_], uw);
  }
  return out;
}

// --- VP8L: the bit reader (bit_reader_utils.c, 64-bit build) ---------------

struct LBitReader {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  bool eos = false;

  void init(const uint8_t* start, size_t length) {
    len = length;
    val = 0;
    bit_pos = 0;
    eos = false;
    const size_t n = length > 8 ? 8 : length;
    for (size_t i = 0; i < n; ++i) val |= uint64_t(start[i]) << (8 * i);
    pos = n;
    buf = start;
  }
  // VP8LIsEndOfStream: more bits taken than the stream holds (at least 64).
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= uint64_t(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t prefetch() const { return uint32_t(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
  void fill() {
    if (bit_pos < 32) return;
    if (pos + 8 < len) {
      val >>= 32;
      bit_pos -= 32;
      val |= uint64_t(le32(buf + pos)) << 32;
      pos += 4;
      return;
    }
    shift_bytes();
  }
};

// --- VP8L: prefix codes (huffman_utils.c) ---

struct HCode {
  uint8_t bits;    // code length, or for a root entry that points on, its second level's bits + 8
  uint16_t value;  // symbol, or the offset of the second-level table
};

constexpr int kMaxCodeLength = 15;

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// BuildHuffmanTable: the canonical code of `lengths` as a root table of
// 2^root_bits entries and second-level tables; false where the lengths are
// no valid code (none, over-subscribed or incomplete; one symbol alone is
// a code of no bits).
bool build_code(std::vector<HCode>& table, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(size_t(n) + 1);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = uint16_t(s);
  int total_size = 1 << root_bits;
  table.assign(size_t(total_size), HCode{0, 0});
  if (offset[kMaxCodeLength] == 1) {
    replicate(table.data(), 1, total_size, HCode{0, sorted[0]});
    return true;
  }
  int table_off = 0, table_bits = root_bits, table_size = 1 << root_bits;
  uint32_t low = 0xffffffffu, mask = uint32_t(total_size) - 1, key = 0;
  int num_nodes = 1, num_open = 1, symbol = 0, len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, HCode{uint8_t(len), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table_off += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        table.resize(size_t(total_size), HCode{0, 0});
        low = key & mask;
        table[low].bits = uint8_t(table_bits + root_bits);
        table[low].value = uint16_t(table_off - int(low));
      }
      replicate(&table[size_t(table_off) + (key >> root_bits)], step, table_size,
                HCode{uint8_t(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  return num_nodes == 2 * offset[kMaxCodeLength] - 1;
}

constexpr int kTableBits = 8;  // HUFFMAN_TABLE_BITS

// ReadSymbol
int read_symbol(const HCode* table, LBitReader& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kTableBits) - 1);
  const int nbits = table->bits - kTableBits;
  if (nbits > 0) {
    br.bit_pos += kTableBits;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

// --- VP8L: the image streams (vp8l_dec.c) ---

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24, kNumDistanceCodes = 40;
const int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, kNumLiteralCodes,
                              kNumLiteralCodes, kNumLiteralCodes, kNumDistanceCodes};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct HTreeGroup {
  std::vector<HCode> trees[5];
};

struct Meta {  // VP8LMetadata of one image stream
  int cache_bits = 0;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;  // the group of each tile
  std::vector<HTreeGroup> groups;
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// PlaneCodeToDistance
int plane_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

int copy_distance(int symbol, LBitReader& br) {  // GetCopyDistance, GetCopyLength
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + int(br.read(extra_bits)) + 1;
}

class Vp8lDecoder {
 public:
  explicit Vp8lDecoder(const uint8_t* data, size_t size) { br_.init(data, size); }
  // The ARGB pixels of the main image (`has_header`: a VP8L bitstream with
  // its 5-byte header; else ALPH's headerless stream of width x height).
  // `alpha8`: decode as the alpha plane's 8-bit path would where it applies.
  std::vector<uint32_t> decode(bool has_header, int& width, int& height, int* has_alpha,
                               bool alpha8 = false);

 private:
  void read_image_info(int& width, int& height, int* has_alpha);
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool is_level0, Meta* level0 = nullptr,
                                      int* level0_xsize = nullptr);
  void read_transform(int& xsize, int ysize);
  void read_huffman_codes(Meta& meta, int xsize, int ysize, bool allow_recursion);
  void read_huffman_code(int alphabet_size, std::vector<int>& code_lengths,
                         std::vector<HCode>* table);
  void read_code_lengths(const int* code_length_code_lengths, int num_symbols, int* lengths);
  void decode_pixels(const Meta& meta, uint32_t* data, int width, int height, bool alpha8);
  void inverse_transforms(std::vector<uint32_t>& pixels, int height);

  LBitReader br_;
  Transform transforms_[4];
  int num_transforms_ = 0;
  uint32_t transforms_seen_ = 0;
};

void Vp8lDecoder::read_image_info(int& width, int& height, int* has_alpha) {
  if (br_.read(8) != 0x2f) fail("VP8L: bad signature");
  width = int(br_.read(14)) + 1;
  height = int(br_.read(14)) + 1;
  const int a = int(br_.read(1));
  if (has_alpha) *has_alpha = a;
  if (br_.read(3) != 0) fail("VP8L: unknown version");
  if (br_.eos) fail("VP8L: truncated header");
}

void Vp8lDecoder::read_code_lengths(const int* code_length_code_lengths, int num_symbols,
                                    int* lengths) {
  // ReadHuffmanCodeLengths
  std::vector<HCode> table;
  if (!build_code(table, 7, code_length_code_lengths, 19))
    fail("VP8L: invalid code-length code");
  int max_symbol;
  if (br_.read(1)) {
    const int length_nbits = 2 + 2 * int(br_.read(3));
    max_symbol = 2 + int(br_.read(length_nbits));
    if (max_symbol > num_symbols) fail("VP8L: %d code lengths for %d symbols", max_symbol,
                                       num_symbols);
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0, prev_code_len = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br_.fill();
    const HCode& p = table[br_.prefetch() & 127];
    br_.bit_pos += p.bits;
    const int code_len = p.value;
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      static const int kExtraBits[3] = {2, 3, 7}, kRepeatOffsets[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = int(br_.read(kExtraBits[slot])) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) fail("VP8L: code lengths repeat past the alphabet");
      const int length = code_len == 16 ? prev_code_len : 0;
      while (repeat-- > 0) lengths[symbol++] = length;
    }
  }
}

void Vp8lDecoder::read_huffman_code(int alphabet_size, std::vector<int>& code_lengths,
                                    std::vector<HCode>* table) {
  // ReadHuffmanCode; `table` null: check the code and keep nothing
  std::fill(code_lengths.begin(), code_lengths.begin() + alphabet_size, 0);
  if (br_.read(1)) {  // simple code: one or two symbols of length 1
    const int num_symbols = int(br_.read(1)) + 1;
    const int first_symbol_len_code = int(br_.read(1));
    code_lengths[br_.read(first_symbol_len_code == 0 ? 1 : 8)] = 1;
    if (num_symbols == 2) code_lengths[br_.read(8)] = 1;
  } else {
    int code_length_code_lengths[19] = {0};
    const int num_codes = int(br_.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i)
      code_length_code_lengths[kCodeLengthCodeOrder[i]] = int(br_.read(3));
    read_code_lengths(code_length_code_lengths, alphabet_size, code_lengths.data());
  }
  if (br_.eos) fail("VP8L: stream ends inside a prefix code");
  std::vector<HCode> discarded;
  if (!build_code(table ? *table : discarded, kTableBits, code_lengths.data(), alphabet_size))
    fail("VP8L: invalid prefix code");
}

void Vp8lDecoder::read_huffman_codes(Meta& meta, int xsize, int ysize, bool allow_recursion) {
  int num_groups_max = 1;
  if (allow_recursion && br_.read(1)) {  // meta prefix codes
    const int bits = 2 + int(br_.read(3));
    const int hx = sub_sample(xsize, bits), hy = sub_sample(ysize, bits);
    std::vector<uint32_t> image = decode_stream(hx, hy, false);
    meta.huffman_bits = bits;
    meta.huffman_xsize = hx;
    for (uint32_t& v : image) {
      v = (v >> 8) & 0xffff;  // the group is in red and green
      if (int(v) >= num_groups_max) num_groups_max = int(v) + 1;
    }
    meta.huffman_image = std::move(image);
  }
  if (br_.eos) fail("VP8L: stream ends in the entropy image");
  // Every group up to the largest index is read and checked. All are kept,
  // but where ReadHuffmanCodesHelper maps the indices (more than 1000
  // groups, or more than pixels): there only the ones the image uses.
  const bool mapped = num_groups_max > 1000 || num_groups_max > xsize * ysize;
  std::vector<char> used(size_t(num_groups_max), mapped ? 0 : 1);
  if (mapped)
    for (uint32_t v : meta.huffman_image) used[v] = 1;
  const int max_alphabet = kAlphabetSize[0] + (meta.cache_bits > 0 ? 1 << meta.cache_bits : 0);
  std::vector<int> code_lengths(size_t(max_alphabet), 0);
  meta.groups.resize(size_t(num_groups_max));
  for (int i = 0; i < num_groups_max; ++i) {
    for (int j = 0; j < 5; ++j) {
      int alphabet_size = kAlphabetSize[j];
      if (j == 0 && meta.cache_bits > 0) alphabet_size += 1 << meta.cache_bits;
      read_huffman_code(alphabet_size, code_lengths, used[i] ? &meta.groups[i].trees[j] : nullptr);
    }
  }
}

void Vp8lDecoder::read_transform(int& xsize, int ysize) {
  const int type = int(br_.read(2));
  if (transforms_seen_ & (1u << type)) fail("VP8L: transform %d twice", type);
  transforms_seen_ |= 1u << type;
  Transform& t = transforms_[num_transforms_++];
  t.type = type;
  t.xsize = xsize;
  t.ysize = ysize;
  switch (type) {
    case PREDICTOR:
    case CROSS_COLOR:
      t.bits = int(br_.read(3)) + 2;
      t.data = decode_stream(sub_sample(t.xsize, t.bits), sub_sample(t.ysize, t.bits), false);
      break;
    case COLOR_INDEXING: {
      const int num_colors = int(br_.read(8)) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = sub_sample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> map = decode_stream(num_colors, 1, false);
      // ExpandColorMap: the entries are deltas; unused ones are transparent black
      t.data.assign(size_t(1) << (8 >> bits), 0);
      uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* od = reinterpret_cast<const uint8_t*>(map.data());
      t.data[0] = map[0];
      for (int i = 4; i < 4 * num_colors && size_t(i) < 4 * t.data.size(); ++i)
        nd[i] = uint8_t(od[i] + nd[i - 4]);
      break;
    }
    default:  // SUBTRACT_GREEN
      break;
  }
}

std::vector<uint32_t> Vp8lDecoder::decode_stream(int xsize, int ysize, bool is_level0,
                                                 Meta* level0, int* level0_xsize) {
  // DecodeImageStream
  int transform_xsize = xsize;
  if (is_level0)
    while (br_.read(1)) read_transform(transform_xsize, ysize);
  Meta local;
  Meta& meta = level0 ? *level0 : local;
  if (br_.read(1)) {
    meta.cache_bits = int(br_.read(4));
    if (meta.cache_bits < 1 || meta.cache_bits > 11) fail("VP8L: colour cache of %d bits",
                                                          meta.cache_bits);
  }
  read_huffman_codes(meta, transform_xsize, ysize, is_level0);
  if (is_level0) {  // the caller decodes the pixels
    *level0_xsize = transform_xsize;
    return {};
  }
  std::vector<uint32_t> data(size_t(transform_xsize) * ysize);
  decode_pixels(meta, data.data(), transform_xsize, ysize, false);
  return data;
}

// DecodeImageData (and DecodeAlphaData's end rule with alpha8): the
// entropy-coded pixels, every pixel into the colour cache in order.
void Vp8lDecoder::decode_pixels(const Meta& meta, uint32_t* data, int width, int height,
                                bool alpha8) {
  const int cache_size = meta.cache_bits > 0 ? 1 << meta.cache_bits : 0;
  std::vector<uint32_t> cache(size_t(cache_size), 0);
  const int cache_shift = 32 - meta.cache_bits;
  const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
  const int cache_limit = len_code_limit + cache_size;
  const int mask = meta.huffman_bits == 0 ? ~0 : (1 << meta.huffman_bits) - 1;
  const size_t total = size_t(width) * height;
  size_t pos = 0, cached = 0;
  int col = 0, row = 0;
  const HTreeGroup* group = &meta.groups[0];
  auto group_at = [&](int x, int y) {
    if (meta.huffman_bits == 0) return &meta.groups[0];
    return &meta.groups[meta.huffman_image[size_t(meta.huffman_xsize) * (y >> meta.huffman_bits) +
                                           (x >> meta.huffman_bits)]];
  };
  auto insert_cached = [&]() {
    if (cache_size)
      for (; cached < pos; ++cached)
        cache[(data[cached] * 0x1e35a7bdu) >> cache_shift] = data[cached];
  };
  while (pos < total) {
    if ((col & mask) == 0) group = group_at(col, row);
    br_.fill();
    const int code = read_symbol(group->trees[GREEN].data(), br_);
    if (!alpha8 && br_.at_end()) break;
    if (code < kNumLiteralCodes) {
      const int red = read_symbol(group->trees[RED].data(), br_);
      br_.fill();
      const int blue = read_symbol(group->trees[BLUE].data(), br_);
      const int alpha = read_symbol(group->trees[ALPHA].data(), br_);
      if (!alpha8 && br_.at_end()) break;
      data[pos] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) | (uint32_t(code) << 8) |
                  uint32_t(blue);
    } else if (code < len_code_limit) {  // backward reference
      const int length = copy_distance(code - kNumLiteralCodes, br_);
      const int dist_symbol = read_symbol(group->trees[DIST].data(), br_);
      br_.fill();
      const int dist = plane_to_distance(width, copy_distance(dist_symbol, br_));
      if (!alpha8 && br_.at_end()) break;
      if (pos < size_t(dist) || total - pos < size_t(length))
        fail("VP8L: a backward reference outside the image");
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      pos += size_t(length);
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (col & mask) group = group_at(col, row);
      insert_cached();
      if (alpha8 && br_.at_end()) break;
      continue;
    } else if (code < cache_limit) {  // colour cache
      insert_cached();
      data[pos] = cache[size_t(code - len_code_limit)];
    } else {
      fail("VP8L: symbol %d past the alphabet", code);
    }
    ++pos;
    if (++col >= width) {
      col = 0;
      ++row;
      insert_cached();
    }
    if (alpha8 && br_.at_end()) break;
  }
  // Past the stream's end: an error, but for the alpha plane's 8-bit path,
  // which takes a last symbol that ends the image.
  if (br_.at_end() && (!alpha8 || pos < total))
    fail("VP8L: the stream ends before the image does");
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int add_sub_full(int a, int b, int c) { return int(clip255(uint32_t(a + b - c))); }
inline int add_sub_half(int a, int b) { return int(clip255(uint32_t(a + (a - b) / 2))); }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t predict(int mode, const uint32_t* left, const uint32_t* top) {
  const uint32_t L = *left, T = top[0], TR = top[1], TL = top[-1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {  // Select(T, L, TL)
      int d = 0;
      for (int s = 0; s < 32; s += 8)
        d += sub3(int((T >> s) & 0xff), int((L >> s) & 0xff), int((TL >> s) & 0xff));
      return d <= 0 ? T : L;
    }
    case 12: {
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8)
        out |= uint32_t(add_sub_full(int((L >> s) & 0xff), int((T >> s) & 0xff),
                                     int((TL >> s) & 0xff))) << s;
      return out;
    }
    case 13: {
      const uint32_t ave = average2(L, T);
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8)
        out |= uint32_t(add_sub_half(int((ave >> s) & 0xff), int((TL >> s) & 0xff))) << s;
      return out;
    }
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp's sentinels
  }
}

void Vp8lDecoder::inverse_transforms(std::vector<uint32_t>& pixels, int height) {
  for (int n = num_transforms_ - 1; n >= 0; --n) {
    const Transform& t = transforms_[n];
    const int w = t.xsize;
    switch (t.type) {
      case PREDICTOR: {
        uint32_t* out = pixels.data();
        out[0] = add_pixels(out[0], 0xff000000u);  // first row: black, then L
        for (int x = 1; x < w; ++x) out[x] = add_pixels(out[x], out[x - 1]);
        const int tiles = sub_sample(w, t.bits);
        for (int y = 1; y < height; ++y) {
          uint32_t* o = out + size_t(y) * w;
          o[0] = add_pixels(o[0], o[-w]);  // first column: T
          const uint32_t* modes = &t.data[size_t(y >> t.bits) * tiles];
          for (int x = 1; x < w; ++x)
            o[x] = add_pixels(o[x], predict(int((modes[x >> t.bits] >> 8) & 0xf), o + x - 1,
                                            o + x - w));
        }
        break;
      }
      case CROSS_COLOR: {
        const int tiles = sub_sample(w, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* o = pixels.data() + size_t(y) * w;
          const uint32_t* codes = &t.data[size_t(y >> t.bits) * tiles];
          for (int x = 0; x < w; ++x) {
            const uint32_t code = codes[x >> t.bits];
            const int8_t g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff),
                         r2b = int8_t((code >> 16) & 0xff);
            const uint32_t argb = o[x];
            const int8_t green = int8_t(argb >> 8);
            int new_red = int((argb >> 16) & 0xff);
            int new_blue = int(argb & 0xff);
            new_red += (int(g2r) * green) >> 5;
            new_red &= 0xff;
            new_blue += (int(g2b) * green) >> 5;
            new_blue += (int(r2b) * int8_t(new_red)) >> 5;
            new_blue &= 0xff;
            o[x] = (argb & 0xff00ff00u) | (uint32_t(new_red) << 16) | uint32_t(new_blue);
          }
        }
        break;
      }
      case SUBTRACT_GREEN:
        for (size_t i = 0; i < size_t(w) * height; ++i) {
          const uint32_t argb = pixels[i];
          const uint32_t green = (argb >> 8) & 0xff;
          const uint32_t rb = ((argb & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
          pixels[i] = (argb & 0xff00ff00u) | rb;
        }
        break;
      default: {  // COLOR_INDEXING: the packed indices (in green) through the map
        const int packed_w = sub_sample(w, t.bits);
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        std::vector<uint32_t> out(size_t(w) * height);
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = &pixels[size_t(y) * packed_w];
          uint32_t* dst = &out[size_t(y) * w];
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        pixels.swap(out);
        break;
      }
    }
  }
}

std::vector<uint32_t> Vp8lDecoder::decode(bool has_header, int& width, int& height,
                                          int* has_alpha, bool alpha8) {
  if (has_header) read_image_info(width, height, has_alpha);
  Meta meta;
  int xsize = 0;
  decode_stream(width, height, true, &meta, &xsize);
  // DecodeAlphaData runs where the alpha stream has the colour-indexing
  // transform alone and no colour cache, and its red, blue and alpha codes
  // are of one symbol (Is8bOptimizable).
  bool use8 = alpha8 && num_transforms_ == 1 && transforms_[0].type == COLOR_INDEXING &&
              meta.cache_bits == 0;
  if (use8)
    for (const HTreeGroup& g : meta.groups)
      if (!g.trees[GREEN].empty() &&
          (g.trees[RED][0].bits || g.trees[BLUE][0].bits || g.trees[ALPHA][0].bits))
        use8 = false;
  std::vector<uint32_t> pixels(size_t(xsize) * height);
  decode_pixels(meta, pixels.data(), xsize, height, use8);
  inverse_transforms(pixels, height);
  return pixels;
}

// --- ALPH (alpha_dec.c, filters.c) -------------------------------------------

// The alpha plane of a width x height frame from an ALPH chunk's payload:
// `filtered` receives the samples before the unfiltering (raw data, or the
// green of the VP8L stream), *filter the filter (0-3).
void decode_alpha(const uint8_t* data, size_t size, int width, int height,
                  std::vector<uint8_t>& filtered, int* filter) {
  // ALPHInit
  if (size <= 1) fail("ALPH: empty chunk");
  const int method = data[0] & 3, pre_processing = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
  *filter = (data[0] >> 2) & 3;
  if (method > 1 || pre_processing > 1 || rsrv != 0)
    fail("ALPH: compression %d, pre-processing %d, reserved bits %d", method, pre_processing,
         rsrv);
  const size_t n = size_t(width) * height;
  filtered.resize(n);
  if (method == 0) {
    if (size - 1 < n) fail("ALPH: %zu bytes of raw alpha for %zu pixels", size - 1, n);
    memcpy(filtered.data(), data + 1, n);
    return;
  }
  int w = width, h = height;
  Vp8lDecoder dec(data + 1, size - 1);
  const std::vector<uint32_t> argb = dec.decode(false, w, h, nullptr, true);
  for (size_t i = 0; i < n; ++i) filtered[i] = uint8_t(argb[i] >> 8);
}

// WebPUnfilters: horizontal, vertical and gradient, each row from the one
// above (none for the first row, which is filtered horizontally from 0).
void unfilter_alpha(std::vector<uint8_t>& a, int width, int height, int filter) {
  if (filter == 0) return;
  uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    uint8_t* out = &a[size_t(y) * width];
    if (filter == 1 || prev == nullptr) {
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < width; ++i) pred = out[i] = uint8_t(pred + out[i]);
    } else if (filter == 2) {
      for (int i = 0; i < width; ++i) out[i] = uint8_t(prev[i] + out[i]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        left = uint8_t(out[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        out[i] = left;
      }
    }
    prev = out;
  }
}

// --- the colour stage (io_dec.c EmitFancyRGB, upsampling.c, yuv.h) --------

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255; }

inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbaLinePair for one output row: the chroma rows `t` (the nearer)
// and `c` weighted 3:1, each sample pair (9a + 3b + 3c + d + 8) / 16 as
// the packed-pair arithmetic rounds it.
void upsample_row(const uint8_t* y, const uint8_t* tu, const uint8_t* tv, const uint8_t* cu,
                  const uint8_t* cv, uint8_t* dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
  yuv_to_rgba(y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst);
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = tu[x], t_v = tv[x], u = cu[x], v = cv[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgba(y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, dst + (2 * x - 1) * 4);
    yuv_to_rgba(y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, dst + 2 * x * 4);
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1))
    yuv_to_rgba(y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                dst + (len - 1) * 4);
}

// The frame's RGB into (height, width, 4) at `dst` with row stride
// `stride` bytes: output row 0 from chroma row 0 alone, rows 2k - 1 and 2k
// between chroma rows k - 1 and k, an even height's last row from the last
// chroma row alone.
void planes_to_rgb(const Planes& p, uint8_t* dst, size_t stride) {
  const int w = p.width, h = p.height, uw = (w + 1) / 2, uh = (h + 1) / 2;
  for (int r = 0; r < h; ++r) {
    int t, c;
    if (r == 0) {
      t = c = 0;
    } else if (r & 1) {  // the upper row of a pair: nearer chroma row (r - 1) / 2
      t = (r - 1) / 2;
      c = std::min((r + 1) / 2, uh - 1);
    } else {  // the lower row: nearer chroma row r / 2
      t = r / 2;
      c = r / 2 - 1;
    }
    upsample_row(&p.y[size_t(r) * w], &p.u[size_t(t) * uw], &p.v[size_t(t) * uw],
                 &p.u[size_t(c) * uw], &p.v[size_t(c) * uw], dst + r * stride, w);
  }
}

// --- the container (demux.c, webp_dec.c) ----------------------------------

enum Status { ST_OK = 0, ST_BITSTREAM_ERROR, ST_UNSUPPORTED, ST_NOT_ENOUGH_DATA };
constexpr uint32_t kMaxChunkPayload = 0xffffffffu - 8 - 1;
constexpr uint32_t ALPHA_FLAG = 0x10, ANIMATION_FLAG = 0x02, ICCP_FLAG = 0x20, EXIF_FLAG = 0x08,
                   XMP_FLAG = 0x04;
constexpr uint32_t ALL_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | ICCP_FLAG | EXIF_FLAG | XMP_FLAG;

bool tag_is(const uint8_t* p, const char* tag) { return memcmp(p, tag, 4) == 0; }

// VP8GetInfo
bool vp8_get_info(const uint8_t* data, size_t size, size_t chunk_size, int* w, int* h) {
  if (size < 10) return false;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return false;
  const uint32_t bits = data[0] | (data[1] << 8) | (uint32_t(data[2]) << 16);
  const int ww = ((data[7] << 8) | data[6]) & 0x3fff, hh = ((data[9] << 8) | data[8]) & 0x3fff;
  if (bits & 1) return false;  // not a key frame
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size) return false;
  if (ww == 0 || hh == 0) return false;
  *w = ww;
  *h = hh;
  return true;
}

// VP8LGetInfo
bool vp8l_get_info(const uint8_t* data, size_t size, int* w, int* h, int* has_alpha) {
  if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return false;
  LBitReader br;
  br.init(data, size);
  br.read(8);
  const int ww = int(br.read(14)) + 1, hh = int(br.read(14)) + 1, a = int(br.read(1));
  if (br.read(3) != 0 || br.eos) return false;
  *w = ww;
  *h = hh;
  if (has_alpha) *has_alpha = a;
  return true;
}

struct Headers {  // WebPHeaderStructure
  bool have_all_data = false;
  size_t offset = 0;  // of the VP8/VP8L payload
  const uint8_t* alpha_data = nullptr;
  size_t alpha_size = 0;
  size_t compressed_size = 0;
  bool is_lossless = false;
};

// ParseHeadersInternal: WebPGetFeatures where `headers` is null, else the
// parse before a decode (which needs all the data).
Status parse_headers(const uint8_t* data, size_t size, int* width, int* height, int* has_alpha,
                     int* has_animation, Headers* headers) {
  const bool have_all_data = headers && headers->have_all_data;
  int canvas_w = 0, canvas_h = 0, image_w = 0, image_h = 0, alpha = 0;
  bool found_riff = false, found_vp8x = false, animation = false;
  size_t riff_size = 0;
  Headers hdrs;
  const uint8_t* const start = data;
  Status status = ST_OK;
  if (size < 12) return ST_NOT_ENOUGH_DATA;
  // ParseRIFF
  if (tag_is(data, "RIFF")) {
    if (!tag_is(data + 8, "WEBP")) return ST_BITSTREAM_ERROR;
    const uint32_t rs = le32(data + 4);
    if (rs < 12 || rs > kMaxChunkPayload) return ST_BITSTREAM_ERROR;
    if (have_all_data && rs > size - 8) return ST_NOT_ENOUGH_DATA;
    riff_size = rs;
    data += 12;
    size -= 12;
    found_riff = true;
  }
  // ParseVP8X
  if (size < 8) return ST_NOT_ENOUGH_DATA;
  if (tag_is(data, "VP8X")) {
    if (le32(data + 4) != 10) return ST_BITSTREAM_ERROR;
    if (size < 18) return ST_NOT_ENOUGH_DATA;
    const uint32_t flags = le32(data + 8);
    const uint64_t w = 1 + le24(data + 12), h = 1 + le24(data + 15);
    if (w * h >= (uint64_t(1) << 32)) return ST_BITSTREAM_ERROR;
    canvas_w = int(w);
    canvas_h = int(h);
    alpha = !!(flags & ALPHA_FLAG);
    animation = !!(flags & ANIMATION_FLAG);
    data += 18;
    size -= 18;
    found_vp8x = true;
    if (!found_riff) return ST_BITSTREAM_ERROR;
  }
  image_w = canvas_w;
  image_h = canvas_h;
  if (found_vp8x && animation && !headers) goto done;
  if (size < 4) {
    status = ST_NOT_ENOUGH_DATA;
    goto done;
  }
  if ((found_riff && found_vp8x) || (!found_riff && !found_vp8x && tag_is(data, "ALPH"))) {
    // ParseOptionalChunks
    uint32_t total_size = 4 + 8 + 10;
    while (true) {
      if (size < 8) {
        status = ST_NOT_ENOUGH_DATA;
        goto done;
      }
      const uint32_t chunk_size = le32(data + 4);
      if (chunk_size > kMaxChunkPayload) {
        status = ST_BITSTREAM_ERROR;
        goto done;
      }
      const uint32_t disk_chunk_size = (8 + chunk_size + 1) & ~1u;
      total_size += disk_chunk_size;
      if (riff_size > 0 && total_size > riff_size) {
        status = ST_BITSTREAM_ERROR;
        goto done;
      }
      if (tag_is(data, "VP8 ") || tag_is(data, "VP8L")) break;
      if (size < disk_chunk_size) {
        status = ST_NOT_ENOUGH_DATA;
        goto done;
      }
      if (tag_is(data, "ALPH")) {
        hdrs.alpha_data = data + 8;
        hdrs.alpha_size = chunk_size;
      }
      data += disk_chunk_size;
      size -= disk_chunk_size;
    }
  }
  // ParseVP8Header
  if (size < 8) {
    status = ST_NOT_ENOUGH_DATA;
    goto done;
  }
  if (tag_is(data, "VP8 ") || tag_is(data, "VP8L")) {
    const uint32_t cs = le32(data + 4);
    if (riff_size >= 12 && cs > riff_size - 12) {
      status = ST_BITSTREAM_ERROR;
      goto done;
    }
    if (have_all_data && cs > size - 8) {
      status = ST_NOT_ENOUGH_DATA;
      goto done;
    }
    hdrs.compressed_size = cs;
    hdrs.is_lossless = tag_is(data, "VP8L");
    data += 8;
    size -= 8;
  } else {
    hdrs.is_lossless = size >= 5 && data[0] == 0x2f && (data[4] >> 5) == 0;
    hdrs.compressed_size = size;
  }
  if (hdrs.compressed_size > kMaxChunkPayload) return ST_BITSTREAM_ERROR;
  if (!hdrs.is_lossless) {
    if (size < 10) {
      status = ST_NOT_ENOUGH_DATA;
      goto done;
    }
    if (!vp8_get_info(data, size, hdrs.compressed_size, &image_w, &image_h))
      return ST_BITSTREAM_ERROR;
  } else {
    if (size < 5) {
      status = ST_NOT_ENOUGH_DATA;
      goto done;
    }
    if (!vp8l_get_info(data, size, &image_w, &image_h, &alpha)) return ST_BITSTREAM_ERROR;
  }
  if (found_vp8x && (canvas_w != image_w || canvas_h != image_h)) return ST_BITSTREAM_ERROR;
  if (headers) {
    hdrs.have_all_data = have_all_data;
    hdrs.offset = size_t(data - start);
    *headers = hdrs;
  }
done:
  if (status == ST_OK || (status == ST_NOT_ENOUGH_DATA && found_vp8x && !headers)) {
    if (has_alpha) *has_alpha = alpha | (hdrs.alpha_data != nullptr);
    if (width) *width = image_w;
    if (height) *height = image_h;
    if (has_animation) *has_animation = animation;
    return ST_OK;
  }
  return status;
}

struct ChunkRef {
  size_t offset = 0, size = 0;
};

struct Frame {
  int x = 0, y = 0, width = 0, height = 0, has_alpha = 0, frame_num = 0, complete = 0;
  ChunkRef img, alpha;
};

enum ParseStatus { PARSE_OK, PARSE_NEED_MORE_DATA, PARSE_ERROR };
enum { DEMUX_PARSING_HEADER = 0, DEMUX_PARSED_HEADER = 1, DEMUX_DONE = 2 };

// WebPDemux (demux.c) over a whole file.
struct Demux {
  const uint8_t* buf = nullptr;
  size_t end = 0, start = 0, riff_end = 0;
  bool is_ext = false;
  int state = DEMUX_PARSING_HEADER;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0, num_frames = 0;
  std::vector<Frame> frames;

  size_t avail() const { return end - start; }
  bool size_invalid(size_t size) const { return size > riff_end - start; }
  uint32_t read32() {
    const uint32_t v = le32(buf + start);
    start += 4;
    return v;
  }
  int read24() {
    const int v = int(le24(buf + start));
    start += 3;
    return v;
  }

  ParseStatus store_frame(int frame_num, uint32_t min_size, Frame& frame) {
    int alpha_chunks = 0, image_chunks = 0;
    bool done = avail() < 8 || avail() < min_size;
    ParseStatus status = PARSE_OK;
    if (done) return PARSE_NEED_MORE_DATA;
    do {
      const size_t chunk_start = start;
      const uint8_t* const tag = buf + start;
      start += 4;
      const uint32_t payload_size = read32();
      if (payload_size > kMaxChunkPayload) return PARSE_ERROR;
      const uint32_t padded = payload_size + (payload_size & 1);
      const size_t available = padded > avail() ? avail() : padded;
      const size_t chunk_size = 8 + available;
      if (size_invalid(padded)) return PARSE_ERROR;
      if (padded > avail()) status = PARSE_NEED_MORE_DATA;
      bool stop = false;
      if (tag_is(tag, "ALPH")) {
        if (alpha_chunks == 0) {
          ++alpha_chunks;
          frame.alpha = {chunk_start, chunk_size};
          frame.has_alpha = 1;
          frame.frame_num = frame_num;
          start += available;
        } else {
          stop = true;
        }
      } else if (tag_is(tag, "VP8L") || tag_is(tag, "VP8 ")) {
        if (tag_is(tag, "VP8L") && alpha_chunks > 0) return PARSE_ERROR;  // VP8L has its own alpha
        if (image_chunks == 0) {
          int w = 0, h = 0, a = 0, anim = 0;
          const Status st =
              parse_headers(buf + chunk_start, chunk_size, &w, &h, &a, &anim, nullptr);
          if (status == PARSE_NEED_MORE_DATA && st == ST_NOT_ENOUGH_DATA)
            return PARSE_NEED_MORE_DATA;
          if (st != ST_OK) return PARSE_ERROR;
          ++image_chunks;
          frame.img = {chunk_start, chunk_size};
          frame.width = w;
          frame.height = h;
          frame.has_alpha |= a;
          frame.frame_num = frame_num;
          frame.complete = status == PARSE_OK;
          start += available;
        } else {
          stop = true;
        }
      } else {
        stop = true;
      }
      if (stop) {  // not this frame's: leave it to the level above
        start -= 8;
        done = true;
      }
      if (start == riff_end) {
        done = true;
      } else if (avail() < 8) {
        status = PARSE_NEED_MORE_DATA;
      }
    } while (!done && status == PARSE_OK);
    return status;
  }

  bool add_frame(const Frame& frame) {
    if (!frames.empty() && !frames.back().complete) return false;
    frames.push_back(frame);
    return true;
  }

  ParseStatus parse_single_image() {
    if (!frames.empty()) return PARSE_ERROR;
    if (size_invalid(8)) return PARSE_ERROR;
    if (avail() < 8) return PARSE_NEED_MORE_DATA;
    Frame frame;
    ParseStatus status = store_frame(1, 0, frame);
    if (status != PARSE_ERROR) {
      const bool has_alpha = flags & ALPHA_FLAG;
      if (!has_alpha && frame.alpha.size > 0) {  // alpha only with the flag
        frame.alpha = ChunkRef();
        frame.has_alpha = 0;
      }
      if (!is_ext && frame.width > 0 && frame.height > 0) {
        state = DEMUX_PARSED_HEADER;
        canvas_w = frame.width;
        canvas_h = frame.height;
        flags |= frame.has_alpha ? ALPHA_FLAG : 0;
      }
      if (!add_frame(frame)) {
        status = PARSE_ERROR;
      } else {
        num_frames = 1;
      }
    }
    return status;
  }

  ParseStatus parse_animation_frame(uint32_t frame_chunk_size) {
    const bool is_animation = flags & ANIMATION_FLAG;
    const uint32_t anmf_payload_size = frame_chunk_size - 16;
    // NewFrame
    if (size_invalid(16)) return PARSE_ERROR;
    if (frame_chunk_size < 16) return PARSE_ERROR;
    if (avail() < 16) return PARSE_NEED_MORE_DATA;
    Frame frame;
    frame.x = 2 * read24();
    frame.y = 2 * read24();
    frame.width = 1 + read24();
    frame.height = 1 + read24();
    read24();   // duration
    start += 1;  // dispose and blend bits: no blending for the first frame
    if (uint64_t(frame.width) * frame.height >= (uint64_t(1) << 32)) return PARSE_ERROR;
    const size_t start_offset = start;
    ParseStatus status = store_frame(num_frames + 1, anmf_payload_size, frame);
    if (status != PARSE_ERROR && start - start_offset > anmf_payload_size) status = PARSE_ERROR;
    if (status != PARSE_ERROR && is_animation && frame.frame_num > 0) {
      if (add_frame(frame)) {
        ++num_frames;
      } else {
        status = PARSE_ERROR;
      }
    }
    return status;
  }

  ParseStatus parse_vp8x_chunks() {
    const bool is_animation = flags & ANIMATION_FLAG;
    int anim_chunks = 0;
    ParseStatus status = PARSE_OK;
    do {
      const uint8_t* const tag = buf + start;
      start += 4;
      const uint32_t chunk_size = read32();
      if (chunk_size > kMaxChunkPayload) return PARSE_ERROR;
      const uint32_t padded = chunk_size + (chunk_size & 1);
      if (size_invalid(padded)) return PARSE_ERROR;
      if (tag_is(tag, "VP8X")) return PARSE_ERROR;
      if (tag_is(tag, "ALPH") || tag_is(tag, "VP8 ") || tag_is(tag, "VP8L")) {
        if (anim_chunks > 0 || is_animation) return PARSE_ERROR;
        start -= 8;
        status = parse_single_image();
      } else if (tag_is(tag, "ANIM")) {
        if (padded < 6) return PARSE_ERROR;
        if (avail() < padded) {
          status = PARSE_NEED_MORE_DATA;
        } else if (anim_chunks == 0) {
          ++anim_chunks;
          start += padded;  // background colour and loop count: unused
        } else {
          start += padded;  // a second ANIM is skipped
        }
      } else if (tag_is(tag, "ANMF")) {
        if (anim_chunks == 0) return PARSE_ERROR;  // ANIM comes before the frames
        status = parse_animation_frame(padded);
      } else {  // ICCP, EXIF, XMP and unknown chunks: skipped
        if (padded <= avail()) {
          start += padded;
        } else {
          status = PARSE_NEED_MORE_DATA;
        }
      }
      if (start == riff_end) break;
      if (avail() < 8) status = PARSE_NEED_MORE_DATA;
    } while (status == PARSE_OK);
    return status;
  }

  ParseStatus parse_vp8x() {
    if (avail() < 8) return PARSE_NEED_MORE_DATA;
    is_ext = true;
    start += 4;
    uint32_t vp8x_size = read32();
    if (vp8x_size > kMaxChunkPayload) return PARSE_ERROR;
    if (vp8x_size < 10) return PARSE_ERROR;
    vp8x_size += vp8x_size & 1;
    if (size_invalid(vp8x_size)) return PARSE_ERROR;
    if (avail() < vp8x_size) return PARSE_NEED_MORE_DATA;
    flags = buf[start];
    start += 4;
    canvas_w = 1 + read24();
    canvas_h = 1 + read24();
    if (uint64_t(canvas_w) * uint64_t(canvas_h) >= (uint64_t(1) << 32)) return PARSE_ERROR;
    start += vp8x_size - 10;
    state = DEMUX_PARSED_HEADER;
    if (size_invalid(8)) return PARSE_ERROR;
    if (avail() < 8) return PARSE_NEED_MORE_DATA;
    return parse_vp8x_chunks();
  }

  bool valid_simple() const {
    if (state == DEMUX_PARSING_HEADER) return true;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (frames.empty()) return false;
    return frames[0].width > 0 && frames[0].height > 0;
  }

  bool valid_extended() const {
    const bool is_animation = flags & ANIMATION_FLAG;
    if (state == DEMUX_PARSING_HEADER) return true;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (state == DEMUX_DONE && frames.empty()) return false;
    if (flags & ~ALL_VALID_FLAGS) return false;
    for (size_t i = 0; i < frames.size(); ++i) {
      const Frame& f = frames[i];
      if (!is_animation && f.frame_num > 1) return false;
      if (f.complete) {
        if (f.alpha.size == 0 && f.img.size == 0) return false;
        if (f.alpha.size > 0 && f.alpha.offset > f.img.offset) return false;
        if (f.width <= 0 || f.height <= 0) return false;
      } else {
        if (state == DEMUX_DONE) return false;
        if (f.alpha.size > 0 && f.img.size > 0 && f.alpha.offset > f.img.offset) return false;
        if (i + 1 < frames.size()) return false;
      }
      if (f.width > 0 && f.height > 0) {  // CheckFrameBounds
        if (!is_animation) {
          if (f.x != 0 || f.y != 0 || f.width != canvas_w || f.height != canvas_h) return false;
        } else if (f.x < 0 || f.y < 0 || f.width + f.x > canvas_w ||
                   f.height + f.y > canvas_h) {
          return false;
        }
      }
    }
    return true;
  }
};

// The demuxed file, or a message naming why libwebp refuses it.
void demux(const uint8_t* data, size_t size, Demux& d) {
  // ReadHeader
  if (size < 20) fail("WebP: %zu bytes, too short for a RIFF header and a chunk", size);
  if (!tag_is(data, "RIFF") || !tag_is(data + 8, "WEBP")) fail("not a RIFF/WEBP file");
  const uint32_t riff_size = le32(data + 4);
  if (riff_size < 8 || riff_size > kMaxChunkPayload) fail("WebP: bad RIFF size %u", riff_size);
  d.buf = data;
  d.riff_end = size_t(riff_size) + 8;
  d.end = size > d.riff_end ? d.riff_end : size;
  if (size < d.riff_end)
    fail("WebP: the RIFF size (%u) runs past the file's %zu bytes", riff_size, size);
  d.start = 12;
  ParseStatus status = PARSE_ERROR;
  bool simple = false;
  if (tag_is(data + 12, "VP8 ") || tag_is(data + 12, "VP8L")) {
    simple = true;
    status = d.parse_single_image();
  } else if (tag_is(data + 12, "VP8X")) {
    status = d.parse_vp8x();
  } else {
    fail("WebP: first chunk is not VP8, VP8L or VP8X");
  }
  if (status == PARSE_OK) d.state = DEMUX_DONE;
  if (status == PARSE_NEED_MORE_DATA) fail("WebP: a chunk runs past the data");
  if (status == PARSE_ERROR) fail("WebP: invalid container");
  if (!(simple ? d.valid_simple() : d.valid_extended())) fail("WebP: invalid container");
  if (d.frames.empty() || d.frames[0].frame_num != 1) fail("WebP: no first frame");
}

struct Decoded {
  int canvas_w = 0, canvas_h = 0, mode_rgba = 0;
  Frame frame;
  bool lossless = false, alpha = false;
  const uint8_t* payload = nullptr;  // frame 0's ALPH (if any) and VP8/VP8L chunks
  size_t payload_size = 0;
  Headers headers;
};

// WebPAnimDecoderNew, and WebPDecode's header parse of frame 0.
Decoded open_webp(const uint8_t* data, size_t size) {
  if (size < 16 || !tag_is(data, "RIFF") || !tag_is(data + 8, "WEBP"))
    fail("not a RIFF/WEBP file");
  if (!tag_is(data + 12, "VP8 ") && !tag_is(data + 12, "VP8L") && !tag_is(data + 12, "VP8X"))
    fail("WebP: not a VP8, VP8L or VP8X file (PIL cannot identify it)");
  Decoded out;
  int has_alpha = 0;
  // PIL's mode: "RGBA" unless WebPGetFeatures succeeds and finds no alpha.
  out.mode_rgba = parse_headers(data, size, nullptr, nullptr, &has_alpha, nullptr, nullptr) != ST_OK
                  || has_alpha;
  Demux d;
  demux(data, size, d);
  out.canvas_w = d.canvas_w;
  out.canvas_h = d.canvas_h;
  if (uint64_t(d.canvas_w) * d.canvas_h > 178956970u)  // 2 * Image.MAX_IMAGE_PIXELS
    fail("WebP: a canvas of %d x %d pixels is past PIL's decompression-bomb limit", d.canvas_w,
         d.canvas_h);
  out.frame = d.frames[0];
  const Frame& f = out.frame;
  // GetFramePayload: from ALPH (if kept) to the end of the image chunk
  size_t start_offset = f.img.offset, payload_size = f.img.size;
  if (f.alpha.size > 0) {
    const size_t inter_size = f.img.offset > 0 ? f.img.offset - (f.alpha.offset + f.alpha.size) : 0;
    start_offset = f.alpha.offset;
    payload_size += f.alpha.size + inter_size;
  }
  out.payload = data + start_offset;
  out.payload_size = payload_size;
  // WebPDecode: GetFeatures, then the parse with all data
  int w = 0, h = 0, a = 0, anim = 0;
  Status st = parse_headers(out.payload, payload_size, &w, &h, &a, &anim, nullptr);
  if (st != ST_OK) fail("WebP: frame 0 has a bad header");
  out.headers.have_all_data = true;
  st = parse_headers(out.payload, payload_size, nullptr, nullptr, nullptr, &anim, &out.headers);
  if (st == ST_OK && anim) st = ST_UNSUPPORTED;
  if (st != ST_OK) fail("WebP: frame 0 has a bad header");
  out.lossless = out.headers.is_lossless;
  out.alpha = !out.lossless && out.headers.alpha_data != nullptr;
  out.frame.width = w;
  out.frame.height = h;
  return out;
}

}  // namespace

extern "C" {

// Decode a RIFF/WEBP file from memory as PIL 12.1 (libwebp 1.6) gives its
// first frame. info (10 ints) receives the canvas width and height, 1
// where PIL's mode is "RGBA" (0: "RGB"), frame 0's x, y, width and height,
// 1 for a lossless frame, its ALPH filter (-1: no ALPH chunk), and the
// bytes `out` must hold. `planes` 0: out gets the canvas, (height, width,
// 4) RGBA, the frame at its offset on transparent black; `planes` 1: a
// lossless frame's (h, w, 4) RGBA, or a lossy frame's Y (h, w), U and V
// ((h + 1) / 2, (w + 1) / 2) and, with ALPH, its samples before the
// unfiltering (h, w), one after the other. Returns 0; -3 with info set
// when `out` is null or holds less than it needs; -1 with a message in msg
// otherwise.
int mm_decode_webp(const uint8_t* data, long len, int planes, uint8_t* out, long cap_bytes,
                   int* info, char* msg, long msg_cap) {
  try {
    if (len < 0) fail("negative length");
    const Decoded dec = open_webp(data, size_t(len));
    const Frame& f = dec.frame;
    const size_t fw = size_t(f.width), fh = size_t(f.height);
    const size_t uvn = ((fw + 1) / 2) * ((fh + 1) / 2);
    long long need = planes ? (dec.lossless ? (long long)(fw * fh * 4)
                                            : (long long)(fw * fh * (dec.alpha ? 2 : 1) + 2 * uvn))
                            : (long long)dec.canvas_w * dec.canvas_h * 4;
    info[0] = dec.canvas_w;
    info[1] = dec.canvas_h;
    info[2] = dec.mode_rgba;
    info[3] = f.x;
    info[4] = f.y;
    info[5] = f.width;
    info[6] = f.height;
    info[7] = dec.lossless;
    info[8] = -1;
    info[9] = int(need > 0x7fffffff ? 0x7fffffff : need);
    if (!out || need > cap_bytes) return -3;
    const uint8_t* body = dec.payload + dec.headers.offset;
    const size_t body_size = dec.payload_size - dec.headers.offset;
    const size_t canvas_stride = size_t(dec.canvas_w) * 4;
    uint8_t* const frame_out = planes ? out : out + size_t(f.y) * canvas_stride + size_t(f.x) * 4;
    const size_t stride = planes ? fw * 4 : canvas_stride;
    if (!planes) memset(out, 0, size_t(need));
    if (dec.lossless) {
      int w = 0, h = 0;
      Vp8lDecoder vp8l(body, body_size);
      const std::vector<uint32_t> argb = vp8l.decode(true, w, h, nullptr);
      if (size_t(w) != fw || size_t(h) != fh) fail("VP8L: size differs from the header's");
      for (size_t y = 0; y < fh; ++y) {
        uint8_t* row = frame_out + y * stride;
        const uint32_t* src = &argb[y * fw];
        for (size_t x = 0; x < fw; ++x) {
          row[4 * x] = uint8_t(src[x] >> 16);
          row[4 * x + 1] = uint8_t(src[x] >> 8);
          row[4 * x + 2] = uint8_t(src[x]);
          row[4 * x + 3] = uint8_t(src[x] >> 24);
        }
      }
      return 0;
    }
    Vp8Decoder vp8;
    const Planes p = vp8.run(body, body_size);
    if (size_t(p.width) != fw || size_t(p.height) != fh)
      fail("VP8: size differs from the header's");
    std::vector<uint8_t> alpha;
    int filter = -1;
    if (dec.alpha) {
      decode_alpha(dec.headers.alpha_data, dec.headers.alpha_size, p.width, p.height, alpha,
                   &filter);
      info[8] = filter;
    }
    if (planes) {
      uint8_t* o = out;
      memcpy(o, p.y.data(), p.y.size());
      o += p.y.size();
      memcpy(o, p.u.data(), p.u.size());
      o += p.u.size();
      memcpy(o, p.v.data(), p.v.size());
      o += p.v.size();
      if (dec.alpha) memcpy(o, alpha.data(), alpha.size());
      return 0;
    }
    planes_to_rgb(p, frame_out, stride);
    if (dec.alpha) unfilter_alpha(alpha, p.width, p.height, filter);
    for (size_t y = 0; y < fh; ++y) {
      uint8_t* row = frame_out + y * stride;
      for (size_t x = 0; x < fw; ++x) row[4 * x + 3] = dec.alpha ? alpha[y * fw + x] : 255;
    }
    return 0;
  } catch (const Failure& e) {
    if (msg && msg_cap > 0) snprintf(msg, size_t(msg_cap), "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    if (msg && msg_cap > 0) snprintf(msg, size_t(msg_cap), "out of memory");
  }
  return -1;
}

// The colour stage alone: (height, width) luma and ((height + 1) / 2,
// (width + 1) / 2) chroma planes -> (height, width, 4) RGBA, alpha 255.
int mm_webp_colour(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height,
                   uint8_t* out) {
  if (width <= 0 || height <= 0) return -1;
  const size_t n = size_t(width) * height, uvn = size_t((width + 1) / 2) * ((height + 1) / 2);
  Planes p;
  p.width = width;
  p.height = height;
  p.y.assign(y, y + n);
  p.u.assign(u, u + uvn);
  p.v.assign(v, v + uvn);
  planes_to_rgb(p, out, size_t(width) * 4);
  for (size_t i = 0; i < n; ++i) out[4 * i + 3] = 255;
  return 0;
}

// The ALPH unfiltering alone, in place on (height, width) samples.
int mm_webp_unfilter(uint8_t* a, int width, int height, int filter) {
  if (width <= 0 || height <= 0 || filter < 0 || filter > 3) return -1;
  std::vector<uint8_t> v(a, a + size_t(width) * height);
  unfilter_alpha(v, width, height, filter);
  memcpy(a, v.data(), v.size());
  return 0;
}

}  // extern "C"
