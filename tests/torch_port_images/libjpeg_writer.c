/* Write a JPEG file with libjpeg's own encoder, for the kinds Pillow does
 * not write: arithmetic coding (SOF9, SOF10), arithmetic conditioning
 * values other than the defaults (DAC), and progressive scan scripts of
 * one's own (bands never refined, a DC scan alone).
 *
 *   libjpeg_writer IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS QUALITY [options]
 *
 * IN.raw holds HEIGHT x WIDTH x COMPONENTS bytes (RGB, or grey with one
 * component).  Options:
 *   -arith              arithmetic coding
 *   -progressive        jpeg_simple_progression's scans
 *   -scans SPEC         these scans: `c,c,..:Ss-Se:Ah,Al` joined by ';'
 *   -restart N          a restart marker every N MCUs
 *   -sample H,V[;..]    each component's sampling factors
 *   -dac L,U,K          arithmetic conditioning of every table
 *
 *   libjpeg_writer -decode IN.jpg OUT.raw
 *
 * decodes as the JAX package's native loader does (aqualora_tpu/native/
 * imageloader.cpp: the stdio source, JCS_RGB, libjpeg's defaults, warnings
 * let through) and writes the RGB bytes, printing WIDTH HEIGHT; a file
 * libjpeg refuses exits with 1.
 *
 * Built by make_fixtures.py with `cc libjpeg_writer.c -ljpeg`.
 */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static void die(const char *what) {
  fprintf(stderr, "libjpeg_writer: %s\n", what);
  exit(2);
}

/* "0,1,2:0-0:0,1;0:1-5:0,2" -> a scan script */
static int parse_scans(const char *spec, jpeg_scan_info *out, int cap) {
  int n = 0;
  const char *p = spec;
  while (*p) {
    jpeg_scan_info *s = &out[n];
    char *end;
    if (n == cap) die("too many scans");
    memset(s, 0, sizeof(*s));
    for (;;) {
      s->component_index[s->comps_in_scan++] = (int)strtol(p, &end, 10);
      p = end;
      if (*p != ',') break;
      ++p;
    }
    if (*p++ != ':') die("bad scan spec");
    s->Ss = (int)strtol(p, &end, 10);
    p = end + 1;
    s->Se = (int)strtol(p, &end, 10);
    p = end + 1;
    s->Ah = (int)strtol(p, &end, 10);
    p = end + 1;
    s->Al = (int)strtol(p, &end, 10);
    p = end;
    ++n;
    if (*p == ';') ++p;
  }
  return n;
}

struct decode_error {
  struct jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void decode_exit(j_common_ptr cinfo) {
  longjmp(((struct decode_error *)cinfo->err)->jb, 1);
}

static int decode(const char *in, const char *out) {
  struct jpeg_decompress_struct cinfo;
  struct decode_error jerr;
  unsigned char *row = NULL;
  FILE *f = fopen(in, "rb"), *o = fopen(out, "wb");
  if (!f || !o) die("cannot open the files");
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = decode_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  row = malloc((size_t)cinfo.output_width * 3);
  if (!row) die("out of memory");
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_scanlines(&cinfo, &row, 1);
    fwrite(row, 1, (size_t)cinfo.output_width * 3, o);
  }
  jpeg_finish_decompress(&cinfo);
  printf("%u %u\n", cinfo.output_width, cinfo.output_height);
  jpeg_destroy_decompress(&cinfo);
  free(row);
  fclose(o);
  fclose(f);
  return 0;
}

int main(int argc, char **argv) {
  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  static jpeg_scan_info scans[64];
  int width, height, comps, quality, i;
  size_t size;
  unsigned char *pixels;
  FILE *f;

  if (argc == 4 && !strcmp(argv[1], "-decode"))
    return decode(argv[2], argv[3]);
  if (argc < 7) die("usage: IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS QUALITY");
  width = atoi(argv[3]);
  height = atoi(argv[4]);
  comps = atoi(argv[5]);
  quality = atoi(argv[6]);
  size = (size_t)width * height * comps;
  pixels = malloc(size);
  if (!pixels) die("out of memory");
  f = fopen(argv[1], "rb");
  if (!f || fread(pixels, 1, size, f) != size) die("cannot read IN.raw");
  fclose(f);

  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  f = fopen(argv[2], "wb");
  if (!f) die("cannot write OUT.jpg");
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = comps;
  cinfo.in_color_space = comps == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  for (i = 7; i < argc; ++i) {
    if (!strcmp(argv[i], "-arith")) {
      cinfo.arith_code = TRUE;
    } else if (!strcmp(argv[i], "-progressive")) {
      jpeg_simple_progression(&cinfo);
    } else if (!strcmp(argv[i], "-scans") && i + 1 < argc) {
      cinfo.num_scans = parse_scans(argv[++i], scans, 64);
      cinfo.scan_info = scans;
    } else if (!strcmp(argv[i], "-restart") && i + 1 < argc) {
      cinfo.restart_interval = (unsigned int)atoi(argv[++i]);
    } else if (!strcmp(argv[i], "-sample") && i + 1 < argc) {
      const char *p = argv[++i];
      int c;
      for (c = 0; c < cinfo.num_components && *p; ++c) {
        char *end;
        cinfo.comp_info[c].h_samp_factor = (int)strtol(p, &end, 10);
        cinfo.comp_info[c].v_samp_factor = (int)strtol(end + 1, &end, 10);
        p = *end ? end + 1 : end;
      }
    } else if (!strcmp(argv[i], "-dac") && i + 1 < argc) {
      int l, u, k, t;
      if (sscanf(argv[++i], "%d,%d,%d", &l, &u, &k) != 3) die("bad -dac");
      for (t = 0; t < NUM_ARITH_TBLS; ++t) {
        cinfo.arith_dc_L[t] = (UINT8)l;
        cinfo.arith_dc_U[t] = (UINT8)u;
        cinfo.arith_ac_K[t] = (UINT8)k;
      }
    } else {
      die("unknown option");
    }
  }
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pixels + (size_t)cinfo.next_scanline * width * comps;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  free(pixels);
  return 0;
}
