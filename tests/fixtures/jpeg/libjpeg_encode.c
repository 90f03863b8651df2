/* Writes JPEG files that PIL cannot: any sampling factors, YCCK, 16-bit
 * quantisation tables (SOF1), sequential files of several
 * non-interleaved scans and progressive scripts of our choosing. Built
 * and run by make_fixtures.py against the system libjpeg:
 *   cc libjpeg_encode.c -o libjpeg_encode -ljpeg
 *   libjpeg_encode IN.raw W H IN_SPACE JPEG_SPACE QUALITY SAMPLING SCANS RESTART_ROWS OUT.jpg
 *                  [ARITH L,U,K]
 * IN.raw holds H*W pixels of IN_SPACE (rgb, gray or cmyk); JPEG_SPACE is
 * ycc, rgb, gray, cmyk or ycck; QUALITY below 25 gives 16-bit tables;
 * SAMPLING lists h x v per component ("2x2,1x1,1x1"); SCANS is
 * "default", "progressive", "noninterleaved" (one sequential scan per
 * component), "dconly" (a progressive file of DC scans only), or a
 * progressive file that leaves coefficients unrefined: "ac_approx" (AC 1-5
 * sent to 2 bits short, never refined), "ac_low" (AC 1-2 only, the rest
 * never sent) or "dc_approx" (DC one bit short, never refined; every AC
 * sent in full). ARITH 1 codes the file arithmetically, with the DAC
 * conditioning L, U (DC) and K (AC) for every table. */
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
  if (argc != 11 && argc != 13) { fprintf(stderr, "usage: see the source\n"); return 2; }
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
  if (argc == 13 && atoi(argv[11])) {
    int L, U, K;
    if (sscanf(argv[12], "%d,%d,%d", &L, &U, &K) != 3) return 2;
    c.arith_code = TRUE;
    for (int i = 0; i < NUM_ARITH_TBLS; i++) {
      c.arith_dc_L[i] = (UINT8)L;
      c.arith_dc_U[i] = (UINT8)U;
      c.arith_ac_K[i] = (UINT8)K;
    }
  }
  static jpeg_scan_info scans[10];
  int n = 0;
  const char *script = argv[8];
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
  } else if (!strcmp(script, "ac_approx") || !strcmp(script, "ac_low") ||
             !strcmp(script, "dc_approx")) {
    int dc_al = !strcmp(script, "dc_approx");
    scans[n].comps_in_scan = c.num_components;
    for (int i = 0; i < c.num_components; i++) scans[n].component_index[i] = i;
    scans[n].Ss = scans[n].Se = scans[n].Ah = 0;
    scans[n++].Al = dc_al;
    for (int i = 0; i < c.num_components; i++) {
      int bands[2][3] = {{1, 5, 2}, {6, 63, 0}};
      if (!strcmp(script, "ac_low")) { bands[0][1] = 2; bands[0][2] = 0; bands[1][0] = -1; }
      if (dc_al) { bands[0][1] = 63; bands[0][2] = 0; bands[1][0] = -1; }
      for (int b = 0; b < 2; b++) {
        if (bands[b][0] < 0) continue;
        scans[n].comps_in_scan = 1;
        scans[n].component_index[0] = i;
        scans[n].Ss = bands[b][0];
        scans[n].Se = bands[b][1];
        scans[n].Ah = 0;
        scans[n++].Al = bands[b][2];
      }
    }
    c.scan_info = scans;
    c.num_scans = n;
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
