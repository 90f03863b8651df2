// JPEG decode for the port's data pipeline: the libjpeg decoder of the
// JAX package's native helper (multimae_tpu/native/fastimage.cpp
// `mm_decode_jpeg`), copied so the port depends on nothing of that
// package. Plain C interface, bound with ctypes by
// multimae_tpu_torch/data/image_io.py, which builds it with g++ at first
// use:  g++ -O2 -shared -fPIC -std=c++17 jpeg_decode.cpp -o <lib> -ljpeg

#include <algorithm>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <vector>

#include <jpeglib.h>

extern "C" {

struct mm_error_mgr {
  struct jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void mm_error_exit(j_common_ptr cinfo) {
  mm_error_mgr* err = reinterpret_cast<mm_error_mgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG from memory into RGB8 (grayscale is expanded). out must
// hold cap_bytes; returns 0 on success, -1 on a decode error, -2 on a bad
// header, -3 when out is too small (out_h/out_w are then set).
int mm_decode_jpeg(const uint8_t* data, long len, uint8_t* out, long cap_bytes,
                   int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  mm_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = mm_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_calc_output_dimensions(&cinfo);
  const long h = cinfo.output_height, w = cinfo.output_width;
  *out_h = static_cast<int>(h);
  *out_w = static_cast<int>(w);
  if (h * w * 3 > cap_bytes) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  jpeg_start_decompress(&cinfo);
  std::vector<uint8_t> gray_row;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<long>(cinfo.output_scanline) * w * 3;
    if (cinfo.output_components == 3) {
      JSAMPROW rows[1] = {row};
      jpeg_read_scanlines(&cinfo, rows, 1);
    } else {  // grayscale: expand to RGB
      gray_row.resize(w);
      JSAMPROW rows[1] = {gray_row.data()};
      jpeg_read_scanlines(&cinfo, rows, 1);
      for (long x = 0; x < w; ++x) row[3 * x] = row[3 * x + 1] = row[3 * x + 2] = gray_row[x];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
