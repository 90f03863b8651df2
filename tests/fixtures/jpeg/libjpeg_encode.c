/* Writes JPEG files that PIL cannot: any sampling factors, YCCK, 16-bit
 * quantisation tables (SOF1), sequential files of several
 * non-interleaved scans and progressive scripts of our choosing. Built
 * and run by make_fixtures.py against the system libjpeg:
 *   cc libjpeg_encode.c -o libjpeg_encode -ljpeg
 *   libjpeg_encode IN.raw W H IN_SPACE JPEG_SPACE QUALITY SAMPLING SCANS RESTART_ROWS OUT.jpg
 * IN.raw holds H*W pixels of IN_SPACE (rgb, gray or cmyk); JPEG_SPACE is
 * ycc, rgb, gray, cmyk or ycck; QUALITY below 25 gives 16-bit tables;
 * SAMPLING lists h x v per component ("2x2,1x1,1x1"); SCANS is
 * "default", "progressive", "noninterleaved" (one sequential scan per
 * component) or "dconly" (a progressive file of DC scans only). */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

static J_COLOR_SPACE space(const char *s) {
  if (!strcmp(s, "rgb")) return JCS_RGB;
  if (!strcmp(s, "gray")) return JCS_GRAYSCALE;
  if (!strcmp(s, "cmyk")) return JCS_CMYK;
  if (!strcmp(s, "ycck")) return JCS_YCCK;
  return JCS_YCbCr;
}

int main(int argc, char **argv) {
  if (argc != 11) { fprintf(stderr, "usage: see the source\n"); return 2; }
  int w = atoi(argv[2]), h = atoi(argv[3]), quality = atoi(argv[6]), rows = atoi(argv[9]);
  J_COLOR_SPACE in_space = space(argv[4]), jpeg_space = space(argv[5]);
  int nin = in_space == JCS_GRAYSCALE ? 1 : in_space == JCS_CMYK ? 4 : 3;
  unsigned char *pixels = malloc((size_t)w * h * nin);
  FILE *f = fopen(argv[1], "rb");
  if (!f || fread(pixels, 1, (size_t)w * h * nin, f) != (size_t)w * h * nin) return 3;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[10], "wb");
  if (!out) return 4;
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nin;
  c.in_color_space = in_space;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, jpeg_space);
  jpeg_set_quality(&c, quality, quality >= 25);
  const char *p = argv[7];
  for (int i = 0; i < c.num_components && *p; i++) {
    c.comp_info[i].h_samp_factor = p[0] - '0';
    c.comp_info[i].v_samp_factor = p[2] - '0';
    p += 3;
    if (*p == ',') p++;
  }
  c.restart_in_rows = rows;
  static jpeg_scan_info scans[10];
  if (!strcmp(argv[8], "progressive")) {
    jpeg_simple_progression(&c);
  } else if (!strcmp(argv[8], "noninterleaved") || !strcmp(argv[8], "dconly")) {
    int dc_only = !strcmp(argv[8], "dconly");
    for (int i = 0; i < c.num_components; i++) {
      scans[i].comps_in_scan = 1;
      scans[i].component_index[0] = i;
      scans[i].Ss = 0;
      scans[i].Se = dc_only ? 0 : 63;
      scans[i].Ah = scans[i].Al = 0;
    }
    c.scan_info = scans;
    c.num_scans = c.num_components;
  }
  jpeg_start_compress(&c, TRUE);
  JSAMPROW row;
  while (c.next_scanline < c.image_height) {
    row = pixels + (size_t)c.next_scanline * w * nin;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(out);
  jpeg_destroy_compress(&c);
  free(pixels);
  return 0;
}
