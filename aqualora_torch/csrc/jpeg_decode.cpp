// JPEG files decoded on the host for the training data path, without
// libjpeg.
//
// The port's counterpart of the JAX package's native loader
// (aqualora_tpu/native/imageloader.cpp), which reads JPEG with libjpeg
// (`cinfo.out_color_space = JCS_RGB`, everything else at its defaults) and
// resizes with its own float32 bicubic.  The card's machine has no libjpeg
// headers, so the file parser, the Huffman decoder and libjpeg's integer
// back half are written here, to give libjpeg-turbo's pixels bit for bit:
//
//   - markers SOI, APPn (JFIF and Adobe read, the rest skipped), COM, DQT
//     (8- and 16-bit tables), DHT, SOF0, SOF1 (extended, 8-bit), SOF2
//     (progressive), SOS, DRI, RST0-7, EOI;
//   - baseline Huffman decoding (jdhuff.c), and progressive decoding with
//     DC first and refine scans, AC first scans with EOB runs and AC
//     refine scans (jdphuff.c); restart intervals reset the DC predictors
//     and the EOB run; libjpeg-turbo's default tables (jstdhuff.c) stand in
//     for tables 0 and 1 when a file defines none;
//   - the accurate integer inverse DCT with its range limit (jidctint.c,
//     `jpeg_idct_islow`; jdmaster.c, `prepare_range_limit_table`);
//   - fancy upsampling of every component whose sampling factors are at
//     most 2 (jdsample.c: h2v1, h1v2 and h2v2, with plain replication where
//     libjpeg takes it), its context rows replicated at the image's top and
//     bottom (jdmainct.c);
//   - YCbCr -> RGB (jdcolor.c, `build_ycc_rgb_table`); one component is
//     grey, replicated to RGB as PIL's convert("RGB") does; three
//     components are RGB or YCbCr by libjpeg's rule (JFIF, then the Adobe
//     transform, then the component ids);
//   - four components, which the JAX native loader's libjpeg cannot turn
//     into RGB (the JAX dataset then reads the batch with PIL): CMYK or
//     YCCK by libjpeg's rule (`default_decompress_parms`: Adobe transform
//     0 is CMYK, any other YCCK, no Adobe marker CMYK), YCCK -> CMYK as
//     libjpeg's `ycck_cmyk_convert` (the YCbCr tables, then 255 minus each,
//     K as stored), then what PIL's `convert("RGB")` makes of it: Pillow
//     reads a four-component JPEG as "CMYK;I" (every byte inverted, the
//     Adobe convention) and converts CMYK with `cmyk2rgb` (Convert.c):
//     with nk = 255 - K, each of R, G, B = nk - (C * nk) / 255 rounded as
//     its MULDIV255.
//
// Refused with the feature's name: arithmetic coding (SOF9-15, DAC),
// lossless (SOF3), hierarchical (SOF5-7, DHP, EXP), DNL, 12-bit precision,
// two components, sampling factors above 2, and progressive files whose
// scans leave coefficients unfinished (libjpeg would smooth those
// blocks).  Where libjpeg only
// warns and goes on (a bad Huffman code, data past a segment's end, a
// missing restart marker, a file cut before EOI), this decoder fails.
// Every read is bounds-checked; a corrupt file returns an error and never
// reads out of range.  Dequantized coefficients are taken at full
// precision, as libjpeg's C IDCT takes them; every encoder's output fits
// the 16 bits its SIMD IDCT keeps.
//
// The resize is the JAX loader's float32 rule, the same operations in the
// same order (imageloader.cpp:117-190), so it gives the same bits when both
// are built without -ffast-math and without contraction into FMA.
//
// C entry points (ctypes, aqualora_torch/train/image_decode.py):
//   decode_header        geometry of a JPEG in memory
//   decode_coefficients  its quantization tables and quantized blocks
//   decode_rgb           its RGB pixels
//   decode_batch         files -> [n, res, res, 3] float32 in [-1, 1], on
//                        std::threads (0 threads: the hardware's count)
//   resize_normalize     RGB uint8 -> the same float32 rule
// Each returns 0 on success, else writes its reason into `err`.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -ffp-contract=off

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError(what); }

// jpeg_natural_order (jutils.c) with 16 entries past the end, so that a
// run length in corrupt data cannot index past a block (as libjpeg's)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Pillow's decompression-bomb limit, 2 * Image.MAX_IMAGE_PIXELS
constexpr int64_t kMaxPixels = 178956970;

// ---------------------------------------------------------------------------
// Huffman tables (jdhuff.c, jpeg_make_d_derived_tbl)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};    // the largest code of each length, -1 if none
  int32_t valoffset[18] = {};  // vals index = code + valoffset[length]
  uint16_t lookup[1 << kLookBits] = {};  // (length << 8) | value; 0: longer
};

void build_table(HuffTable* t, const uint8_t bits[17], const uint8_t* vals,
                 int nvals, bool dc) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  if (p != nvals) fail("bad Huffman table");
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail("bad Huffman table (codes overflow)");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - int(huffcode[p]);
      p += bits[l];
      t->maxcode[l] = int32_t(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  std::memset(t->vals, 0, sizeof(t->vals));
  std::memcpy(t->vals, vals, size_t(nvals));
  std::memset(t->lookup, 0, sizeof(t->lookup));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      const uint32_t first = huffcode[p] << (kLookBits - l);
      for (uint32_t k = 0; k < (1u << (kLookBits - l)); ++k)
        t->lookup[first + k] = uint16_t((l << 8) | vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) fail("bad Huffman table (DC symbol above 15)");
  t->defined = true;
}

// jstdhuff.c: the tables of Annex K.3, which libjpeg-turbo installs in the
// DC and AC slots 0 and 1 a file leaves empty (motion-JPEG frames)
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------------------
// the entropy-coded segment's bits (jdhuff.c, jpeg_fill_bit_buffer)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data = nullptr;
  size_t len = 0, pos = 0;
  uint64_t buf = 0;
  int count = 0;  // bits in buf
  int fill = 0;   // of which zeros appended past the segment's end
  bool ended = false;

  void start(const uint8_t* d, size_t n, size_t p) {
    data = d;
    len = n;
    pos = p;
    buf = 0;
    count = fill = 0;
    ended = false;
  }

  // Bytes up to the next marker; 0xFF 0x00 is a data 0xFF (padding 0xFFs
  // before it skipped, as libjpeg skips them).  At a marker or the end of
  // the file, zeros, with `pos` left on the marker.
  void refill() {
    while (count <= 56) {
      uint32_t b = 0;
      if (!ended) {
        if (pos >= len) {
          ended = true;
        } else if (data[pos] != 0xFF) {
          b = data[pos++];
        } else {
          size_t q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;
          if (q < len && data[q] == 0x00) {
            b = 0xFF;
            pos = q + 1;
          } else {
            ended = true;
          }
        }
      }
      if (ended) fill += 8;
      buf |= uint64_t(b) << (56 - count);
      count += 8;
    }
  }

  uint32_t peek(int n) {
    if (count < n) refill();
    return uint32_t(buf >> (64 - n));
  }

  void skip(int n) {
    if (n > count - fill)
      fail("corrupt data: the entropy-coded data runs past its segment");
    buf <<= n;
    count -= n;
  }

  int get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return int(v);
  }

  int decode(const HuffTable& t) {
    const uint32_t look = peek(kLookBits);
    const uint16_t e = t.lookup[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    const uint32_t bits16 = peek(16);
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int32_t code = int32_t(bits16 >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        const int idx = code + t.valoffset[l];
        if (idx < 0 || idx > 255) fail("corrupt data: bad Huffman code");
        return t.vals[idx];
      }
    }
    fail("corrupt data: bad Huffman code");
  }
};

// HUFF_EXTEND (jdhuff.h)
inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + int(~0u << s) + 1 : r;
}

// ---------------------------------------------------------------------------
// the frame
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // samples: ceil(W * h / hmax), ceil(H * v / vmax)
  int cbw = 0, cbh = 0;  // blocks a non-interleaved scan codes
  int bw = 0, bh = 0;    // blocks held: the MCU grid's
  int dc_pred = 0;
  bool coded = false;
  int quant[64] = {};    // natural order, latched at its first scan
  int coef_bits[64];     // progressive: the lowest bit known, -1 none
  std::vector<int16_t> coef;  // [bh][bw][64], natural order
};

enum ColorSpace { kGrey = 0, kYCbCr = 1, kRGB = 2, kCMYK = 3, kYCCK = 4 };
constexpr int kMaxComponents = 4;

// The markers of the processes this decoder does not implement.
void refuse_marker(int m) {
  if (m == 0xD8) fail("corrupt file: a second SOI");
  if (m == 0xC3) fail("refused: lossless JPEG (SOF3)");
  if (m >= 0xC5 && m <= 0xC7)
    fail("refused: hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
  if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF))
    fail("refused: arithmetic coding (SOF" + std::to_string(m - 0xC0) + ")");
  if (m == 0xCC) fail("refused: arithmetic coding (DAC)");
  if (m == 0xDE || m == 0xDF) fail("refused: hierarchical JPEG (DHP/EXP)");
  if (m == 0xDC) fail("refused: DNL marker");
}

struct Jpeg {
  const uint8_t* data = nullptr;
  size_t len = 0, pos = 0;

  bool frame = false, progressive = false, scanned = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  Component comp[kMaxComponents];
  int quant[4][64] = {};
  bool quant_defined[4] = {};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int color = kYCbCr;

  // scan state
  BitReader bits;
  int eobrun = 0;

  uint8_t byte() {
    if (pos >= len) fail("truncated file: a marker segment runs past the end");
    return data[pos++];
  }

  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // the next marker's code: non-0xFF bytes and 0xFF 0x00 pairs skipped, as
  // libjpeg's next_marker skips them
  int next_marker() {
    for (;;) {
      while (pos < len && data[pos] != 0xFF) ++pos;
      if (pos >= len) fail("truncated file: no EOI marker");
      while (pos < len && data[pos] == 0xFF) ++pos;
      if (pos >= len) fail("truncated file: no EOI marker");
      const int c = data[pos++];
      if (c != 0) return c;
    }
  }

  // a segment's payload [pos, end)
  size_t segment() {
    const int n = u16();
    if (n < 2) fail("corrupt marker segment length");
    if (pos + size_t(n - 2) > len)
      fail("truncated file: a marker segment runs past the end");
    return pos + size_t(n - 2);
  }

  void read_app(int marker, size_t end) {
    const size_t n = end - pos;
    const uint8_t* d = data + pos;
    if (marker == 0xE0 && n >= 14 && !std::memcmp(d, "JFIF\0", 5))
      jfif = true;
    if (marker == 0xEE && n >= 12 && !std::memcmp(d, "Adobe", 5)) {
      adobe = true;
      adobe_transform = d[11];
    }
    pos = end;
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pt = byte();
      const int pq = pt >> 4, tq = pt & 15;
      if (pq > 1) fail("corrupt DQT: precision " + std::to_string(pq));
      if (tq > 3) fail("corrupt DQT: table " + std::to_string(tq));
      if (pos + size_t(64 * (pq + 1)) > end) fail("corrupt DQT length");
      for (int i = 0; i < 64; ++i)
        quant[tq][kNatural[i]] = pq ? u16() : byte();
      quant_defined[tq] = true;
    }
    if (pos != end) fail("corrupt DQT length");
  }

  void read_dht(size_t end) {
    while (pos < end) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt DHT: table class or index");
      if (pos + 16 > end) fail("corrupt DHT length");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
      if (total > 256 || pos + size_t(total) > end)
        fail("corrupt DHT length");
      build_table(tc ? &ac[th] : &dc[th], counts, data + pos, total, tc == 0);
      pos += size_t(total);
    }
  }

  void read_sof(int marker, size_t end) {
    if (frame) fail("more than one frame (SOF marker)");
    frame = true;
    progressive = marker == 0xC2;
    const int precision = byte();
    height = u16();
    width = u16();
    ncomp = byte();
    if (precision == 12) fail("refused: 12-bit precision");
    if (precision != 8)
      fail("refused: sample precision " + std::to_string(precision));
    if (height == 0) fail("refused: DNL (the height defined after the scan)");
    if (width == 0) fail("corrupt SOF: width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("refused: " + std::to_string(ncomp) + " components");
    if (end - pos != size_t(3 * ncomp)) fail("corrupt SOF length");
    if (int64_t(width) * height > kMaxPixels)
      fail("refused: " + std::to_string(width) + "x" + std::to_string(height) +
           " pixels exceed the decompression-bomb limit");
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = byte();
      const int hv = byte();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = byte();
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4)
        fail("corrupt SOF: sampling factors");
      if (k.h > 2 || k.v > 2) fail("refused: a sampling factor above 2");
      if (k.tq > 3) fail("corrupt SOF: quantization table index");
      for (int j = 0; j < c; ++j)
        if (comp[j].id == k.id) fail("corrupt SOF: duplicate component id");
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.dw = int((int64_t(width) * k.h + hmax - 1) / hmax);
      k.dh = int((int64_t(height) * k.v + vmax - 1) / vmax);
      k.cbw = (k.dw + 7) / 8;
      k.cbh = (k.dh + 7) / 8;
      k.bw = mcus_x * k.h;
      k.bh = mcus_y * k.v;
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
    }
  }

  // default_decompress_parms (jdapimin.c), at the first SOS as libjpeg
  // decides it: JFIF means YCbCr, else the Adobe transform, else the ids;
  // four components are CMYK or YCCK by the Adobe transform alone
  void decide_color() {
    if (ncomp == 1) {
      color = kGrey;
    } else if (ncomp == 4) {
      color = adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    } else if (jfif) {
      color = kYCbCr;
    } else if (adobe) {
      color = adobe_transform == 0 ? kRGB : kYCbCr;
    } else if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) {
      color = kRGB;
    } else {
      color = kYCbCr;
    }
  }

  void allocate() {
    for (int c = 0; c < ncomp; ++c)
      comp[c].coef.assign(size_t(comp[c].bw) * comp[c].bh * 64, 0);
  }

  // ---- the scans ----------------------------------------------------------

  void restart(int n) {
    // the rest of the byte is padding; libjpeg skips anything before the
    // marker
    pos = bits.pos;
    const int m = next_marker();
    if (m != 0xD0 + n)
      fail("corrupt data: missing restart marker RST" + std::to_string(n));
    bits.start(data, len, pos);
    for (int c = 0; c < ncomp; ++c) comp[c].dc_pred = 0;
    eobrun = 0;
  }

  void block_baseline(Component& k, int16_t* blk, const HuffTable& dct,
                      const HuffTable& act) {
    int s = bits.decode(dct);
    if (s) s = extend(bits.get(s), s);
    s = int(unsigned(s) + unsigned(k.dc_pred));
    k.dc_pred = s;
    blk[0] = int16_t(s);
    for (int i = 1; i < 64; ++i) {
      const int rs = bits.decode(act);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = int16_t(extend(bits.get(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void block_dc_first(Component& k, int16_t* blk, const HuffTable& dct,
                      int al) {
    int s = bits.decode(dct);
    if (s) s = extend(bits.get(s), s);
    s = int(unsigned(s) + unsigned(k.dc_pred));
    k.dc_pred = s;
    blk[0] = int16_t(int(unsigned(s) << al));
  }

  void block_dc_refine(int16_t* blk, int al) {
    if (bits.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void block_ac_first(int16_t* blk, const HuffTable& act, int ss, int se,
                      int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int i = ss; i <= se; ++i) {
      const int rs = bits.decode(act);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] =
            int16_t(int(unsigned(extend(bits.get(s), s)) << al));
      } else {
        if (r == 15) {
          i += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += bits.get(r);
          --eobrun;
          break;
        }
      }
    }
  }

  // decode_mcu_AC_refine (jdphuff.c)
  void block_ac_refine(int16_t* blk, const HuffTable& act, int ss, int se,
                       int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun == 0) {
      for (; i <= se; ++i) {
        const int rs = bits.decode(act);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = bits.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            if (bits.get(1) && (*c & p1) == 0)
              *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) blk[kNatural[i]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0 && bits.get(1) && (*c & p1) == 0)
          *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  void read_sos(size_t end) {
    if (!frame) fail("corrupt file: SOS before SOF");
    const int ns = byte();
    if (ns < 1 || ns > ncomp) fail("corrupt SOS: component count");
    if (end - pos != size_t(2 * ns + 3)) fail("corrupt SOS length");
    int idx[kMaxComponents], td[kMaxComponents], ta[kMaxComponents];
    for (int j = 0; j < ns; ++j) {
      const int id = byte();
      const int t = byte();
      idx[j] = -1;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) idx[j] = c;
      if (idx[j] < 0) fail("corrupt SOS: unknown component");
      for (int i = 0; i < j; ++i)
        if (idx[i] == idx[j]) fail("corrupt SOS: a component twice");
      td[j] = t >> 4;
      ta[j] = t & 15;
      if (td[j] > 3 || ta[j] > 3) fail("corrupt SOS: table index");
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("corrupt progressive scan parameters");
    } else if (ss != 0 || se != 63 || a != 0) {
      fail("corrupt sequential scan parameters");
    }
    if (!scanned) {
      decide_color();
      // libjpeg-turbo's default tables where a file defines none
      if (!dc[0].defined) build_table(&dc[0], kDcLumBits, kDcVals, 12, true);
      if (!dc[1].defined) build_table(&dc[1], kDcChromBits, kDcVals, 12, true);
      if (!ac[0].defined) build_table(&ac[0], kAcLumBits, kAcLumVals, 162, false);
      if (!ac[1].defined) build_table(&ac[1], kAcChromBits, kAcChromVals, 162, false);
      allocate();
      scanned = true;
    }
    const bool dc_scan = !progressive || ss == 0;
    const bool ac_scan = !progressive || ss > 0;
    int blocks_in_mcu = 0;
    for (int j = 0; j < ns; ++j) {
      Component& k = comp[idx[j]];
      if (dc_scan && (!progressive || ah == 0) && !dc[td[j]].defined)
        fail("corrupt file: a scan uses an undefined DC table");
      if (ac_scan && !ac[ta[j]].defined)
        fail("corrupt file: a scan uses an undefined AC table");
      if (!k.coded) {
        if (!quant_defined[k.tq])
          fail("corrupt file: a component uses an undefined quantization "
               "table");
        std::memcpy(k.quant, quant[k.tq], sizeof(k.quant));
        k.coded = true;
      }
      k.dc_pred = 0;
      if (progressive)
        for (int i = ss; i <= se; ++i) k.coef_bits[i] = al;
      blocks_in_mcu += k.h * k.v;
    }
    if (ns > 1 && blocks_in_mcu > 10)
      fail("refused: sampling factors too large for an interleaved scan");
    pos = end;
    bits.start(data, len, pos);
    eobrun = 0;

    auto one_block = [&](Component& k, int j, int bx, int by) {
      int16_t* blk = k.coef.data() + (size_t(by) * k.bw + bx) * 64;
      if (!progressive)
        block_baseline(k, blk, dc[td[j]], ac[ta[j]]);
      else if (ss == 0 && ah == 0)
        block_dc_first(k, blk, dc[td[j]], al);
      else if (ss == 0)
        block_dc_refine(blk, al);
      else if (ah == 0)
        block_ac_first(blk, ac[ta[j]], ss, se, al);
      else
        block_ac_refine(blk, ac[ta[j]], ss, se, al);
    };

    const bool single = ns == 1;
    const int64_t mcus = single
        ? int64_t(comp[idx[0]].cbw) * comp[idx[0]].cbh
        : int64_t(mcus_x) * mcus_y;
    int restarts_to_go = restart_interval, next_rst = 0;
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          restarts_to_go = restart_interval;
        }
        --restarts_to_go;
      }
      if (single) {
        Component& k = comp[idx[0]];
        one_block(k, 0, int(m % k.cbw), int(m / k.cbw));
      } else {
        const int mx = int(m % mcus_x), my = int(m / mcus_x);
        for (int j = 0; j < ns; ++j) {
          Component& k = comp[idx[j]];
          for (int y = 0; y < k.v; ++y)
            for (int x = 0; x < k.h; ++x)
              one_block(k, j, mx * k.h + x, my * k.v + y);
        }
      }
    }
    pos = bits.pos;
  }

  // Everything up to EOI: the coefficients of every component.
  void parse(const uint8_t* d, size_t n) {
    data = d;
    len = n;
    pos = 0;
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;                         // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;         // a stray RSTn
      if (m == 0x01) continue;                      // TEM
      refuse_marker(m);
      const size_t end = segment();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m, end);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
        if (end - pos != 2) fail("corrupt DRI length");
        restart_interval = u16();
      } else if (m == 0xDA) {
        read_sos(end);
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
        read_app(m, end);
      } else {
        fail("corrupt file: unknown marker 0x" + [m] {
          char b[8];
          std::snprintf(b, sizeof(b), "%02X", m);
          return std::string(b);
        }());
      }
    }
    if (!frame) fail("corrupt file: no frame (SOF)");
    for (int c = 0; c < ncomp; ++c) {
      if (!comp[c].coded) fail("corrupt file: a component has no scan");
      if (progressive)
        for (int i = 0; i < 64; ++i)
          if (comp[c].coef_bits[i] != 0)
            fail("refused: progressive scans leave coefficients unfinished "
                 "(libjpeg would smooth the blocks)");
    }
  }
};

// Geometry without decoding: the markers up to the first SOS.
void parse_header(Jpeg* j, const uint8_t* d, size_t n) {
  j->data = d;
  j->len = n;
  if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI)");
  j->pos = 2;
  for (;;) {
    const int m = j->next_marker();
    if (m == 0xD9) fail("corrupt file: EOI before a scan");
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    refuse_marker(m);
    const size_t end = j->segment();
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      j->read_sof(m, end);
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
      j->read_app(m, end);
    } else if (m == 0xDA) {
      if (!j->frame) fail("corrupt file: SOS before SOF");
      j->decide_color();
      return;
    } else {
      j->pos = end;
    }
  }
}

// ---------------------------------------------------------------------------
// the back half: jidctint.c, jdsample.c, jdcolor.c
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                  F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                  F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                  F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// prepare_range_limit_table, the part the IDCT reads: (x & 1023) -> sample
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; ++v)
      t[v] = uint8_t(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
  }
};

const RangeLimit& range_limit() {
  static const RangeLimit r;
  return r;
}

// jpeg_idct_islow on one block -> 8x8 samples at out (row stride `stride`)
void idct_islow(const int16_t* coef, const int* q, uint8_t* out,
                size_t stride) {
  const uint8_t* lim = range_limit().t;
  int ws[64];
  for (int c = 0; c < 8; ++c) {  // columns
    int64_t z[8];
    for (int r = 0; r < 8; ++r)
      z[r] = int64_t(coef[r * 8 + c]) * q[r * 8 + c];
    int64_t z1 = (z[2] + z[6]) * F_0_541;
    const int64_t tmp2 = z1 - z[6] * F_1_847;
    const int64_t tmp3 = z1 + z[2] * F_0_765;
    const int64_t tmp0 = (z[0] + z[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp1 = (z[0] - z[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = z[7], t1 = z[5], t2 = z[3], t3 = z[1];
    z1 = t0 + t3;
    int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
    const int64_t z5 = (z3 + z4) * F_1_175;
    t0 *= F_0_298;
    t1 *= F_2_053;
    t2 *= F_3_072;
    t3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 = z3 * -F_1_961 + z5;
    z4 = z4 * -F_0_390 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = int(descale(tmp10 + t3, n));
    ws[7 * 8 + c] = int(descale(tmp10 - t3, n));
    ws[1 * 8 + c] = int(descale(tmp11 + t2, n));
    ws[6 * 8 + c] = int(descale(tmp11 - t2, n));
    ws[2 * 8 + c] = int(descale(tmp12 + t1, n));
    ws[5 * 8 + c] = int(descale(tmp12 - t1, n));
    ws[3 * 8 + c] = int(descale(tmp13 + t0, n));
    ws[4 * 8 + c] = int(descale(tmp13 - t0, n));
  }
  for (int r = 0; r < 8; ++r) {  // rows
    const int* w = ws + r * 8;
    int64_t z1 = (int64_t(w[2]) + w[6]) * F_0_541;
    const int64_t tmp2 = z1 - int64_t(w[6]) * F_1_847;
    const int64_t tmp3 = z1 + int64_t(w[2]) * F_0_765;
    const int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = w[7], t1 = w[5], t2 = w[3], t3 = w[1];
    z1 = t0 + t3;
    int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
    const int64_t z5 = (z3 + z4) * F_1_175;
    t0 *= F_0_298;
    t1 *= F_2_053;
    t2 *= F_3_072;
    t3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 = z3 * -F_1_961 + z5;
    z4 = z4 * -F_0_390 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    uint8_t* o = out + r * stride;
    o[0] = lim[int(descale(tmp10 + t3, n)) & 1023];
    o[7] = lim[int(descale(tmp10 - t3, n)) & 1023];
    o[1] = lim[int(descale(tmp11 + t2, n)) & 1023];
    o[6] = lim[int(descale(tmp11 - t2, n)) & 1023];
    o[2] = lim[int(descale(tmp12 + t1, n)) & 1023];
    o[5] = lim[int(descale(tmp12 - t1, n)) & 1023];
    o[3] = lim[int(descale(tmp13 + t0, n)) & 1023];
    o[4] = lim[int(descale(tmp13 - t0, n)) & 1023];
  }
}

struct Image {
  std::vector<uint8_t> data;  // HWC, RGB
  int h = 0, w = 0;
};

// One component's samples [bh * 8][bw * 8].
std::vector<uint8_t> component_plane(const Component& k) {
  const size_t stride = size_t(k.bw) * 8;
  std::vector<uint8_t> plane(stride * size_t(k.bh) * 8);
  for (int by = 0; by < k.bh; ++by)
    for (int bx = 0; bx < k.bw; ++bx)
      idct_islow(k.coef.data() + (size_t(by) * k.bw + bx) * 64, k.quant,
                 plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8,
                 stride);
  return plane;
}

// The component at full size [H][W]: jdsample.c's method for its ratio,
// over its dw x dh real samples.  Rows above the first and below the last
// are the first and the last (jdmainct.c's context rows).
std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane,
                              size_t stride, const Component& k, int hmax,
                              int vmax, int W, int H) {
  const int rh = hmax / k.h, rv = vmax / k.v;
  const int dw = k.dw, dh = k.dh;
  std::vector<uint8_t> out(size_t(W) * H);
  auto in = [&](int y) { return plane.data() + size_t(y) * stride; };
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(&out[size_t(y) * W], in(y), W);
    return out;
  }
  // one output row pair of columns from a row of column values `cs`
  // (h2: fancy when dw > 2, else replication)
  std::vector<int> colsum(dw);
  std::vector<uint8_t> row(size_t(2) * dw);
  for (int y = 0; y < H; ++y) {
    const int iy = y / rv;
    if (rv == 2) {  // h1v2 / h2v2: 3 x nearer row + farther row
      const int far = (y & 1) ? std::min(iy + 1, dh - 1) : std::max(iy - 1, 0);
      const uint8_t *a = in(iy), *b = in(far);
      for (int x = 0; x < dw; ++x) colsum[x] = 3 * a[x] + b[x];
    }
    uint8_t* o = &out[size_t(y) * W];
    if (rh == 1) {  // h1v2_fancy_upsample
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x) o[x] = uint8_t((colsum[x] + bias) >> 2);
      continue;
    }
    if (rv == 1) {  // h2v1
      const uint8_t* a = in(iy);
      if (dw > 2) {
        row[0] = a[0];
        row[1] = uint8_t((a[0] * 3 + a[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          const int v = a[x] * 3;
          row[2 * x] = uint8_t((v + a[x - 1] + 1) >> 2);
          row[2 * x + 1] = uint8_t((v + a[x + 1] + 2) >> 2);
        }
        row[2 * dw - 2] = uint8_t((a[dw - 1] * 3 + a[dw - 2] + 1) >> 2);
        row[2 * dw - 1] = a[dw - 1];
      } else {
        for (int x = 0; x < dw; ++x) row[2 * x] = row[2 * x + 1] = a[x];
      }
    } else if (dw > 2) {  // h2v2_fancy_upsample
      row[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
      row[1] = uint8_t((colsum[0] * 3 + colsum[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        row[2 * x] = uint8_t((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
        row[2 * x + 1] = uint8_t((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
      }
      row[2 * dw - 2] =
          uint8_t((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
      row[2 * dw - 1] = uint8_t((colsum[dw - 1] * 4 + 7) >> 4);
    } else {  // h2v2_upsample: 2 x 2 boxes
      const uint8_t* a = in(iy);
      for (int x = 0; x < dw; ++x) row[2 * x] = row[2 * x + 1] = a[x];
    }
    std::memcpy(o, row.data(), W);
  }
  return out;
}

// build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
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

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

void to_rgb(Jpeg& j, Image* out) {
  const int W = j.width, H = j.height;
  std::vector<uint8_t> planes[kMaxComponents];
  for (int c = 0; c < j.ncomp; ++c) {
    const std::vector<uint8_t> p = component_plane(j.comp[c]);
    planes[c] = upsample(p, size_t(j.comp[c].bw) * 8, j.comp[c], j.hmax,
                         j.vmax, W, H);
    j.comp[c].coef = std::vector<int16_t>();
  }
  out->h = H;
  out->w = W;
  out->data.resize(size_t(W) * H * 3);
  uint8_t* o = out->data.data();
  const size_t n = size_t(W) * H;
  if (j.color == kGrey) {
    for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = planes[0][i];
  } else if (j.color == kRGB) {
    for (size_t i = 0; i < n; ++i)
      for (int c = 0; c < 3; ++c) o[3 * i + c] = planes[c][i];
  } else if (j.color == kCMYK || j.color == kYCCK) {
    static const YccTables t;
    for (size_t i = 0; i < n; ++i) {
      int cmy[3] = {planes[0][i], planes[1][i], planes[2][i]};
      if (j.color == kYCCK) {  // ycck_cmyk_convert
        const int y = cmy[0], cb = cmy[1], cr = cmy[2];
        cmy[0] = clamp255(255 - (y + t.cr_r[cr]));
        cmy[1] = clamp255(255 - (y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
        cmy[2] = clamp255(255 - (y + t.cb_b[cb]));
      }
      // PIL: "CMYK;I" inverts every byte, then cmyk2rgb with nk = 255 - K'
      const int nk = planes[3][i];
      for (int c = 0; c < 3; ++c) {
        const int tmp = (255 - cmy[c]) * nk + 128;
        o[3 * i + c] = clamp255(nk - (((tmp >> 8) + tmp) >> 8));
      }
    }
  } else {
    static const YccTables t;
    for (size_t i = 0; i < n; ++i) {
      const int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      o[3 * i] = clamp255(y + t.cr_r[cr]);
      o[3 * i + 1] = clamp255(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
  }
}

void decode_jpeg(const uint8_t* d, size_t n, Image* out) {
  Jpeg j;
  j.parse(d, n);
  to_rgb(j, out);
}

bool read_file(const char* path, std::vector<uint8_t>* buf, std::string* why) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    *why = "cannot open the file";
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  bool ok = size >= 0;
  if (ok) {
    buf->resize(size_t(size));
    ok = std::fread(buf->data(), 1, buf->size(), f) == buf->size();
  }
  std::fclose(f);
  if (!ok) *why = "cannot read the file";
  return ok;
}

// ---------------------------------------------------------------------------
// the JAX native loader's resize (imageloader.cpp:117-190), unchanged
// ---------------------------------------------------------------------------

inline float cubic(float x) {
  x = std::fabs(x);
  if (x < 1.0f) return 1.5f * x * x * x - 2.5f * x * x + 1.0f;
  if (x < 2.0f) return -0.5f * x * x * x + 2.5f * x * x - 4.0f * x + 2.0f;
  return 0.0f;
}

struct AxisWeights {
  std::vector<int> start;
  std::vector<int> count;
  std::vector<float> w;
  int max_taps = 0;
};

AxisWeights axis_weights(int in_size, int out_size) {
  AxisWeights aw;
  const float scale = float(in_size) / out_size;
  const float filterscale = std::max(scale, 1.0f);
  const float support = 2.0f * filterscale;
  aw.max_taps = int(std::ceil(support)) * 2 + 1;
  aw.start.resize(out_size);
  aw.count.resize(out_size);
  aw.w.assign(size_t(out_size) * aw.max_taps, 0.0f);
  for (int o = 0; o < out_size; ++o) {
    const float center = (o + 0.5f) * scale;
    int lo = std::max(int(center - support + 0.5f), 0);
    int hi = std::min(int(center + support + 0.5f), in_size);
    aw.start[o] = lo;
    aw.count[o] = hi - lo;
    float wsum = 0;
    for (int x = lo; x < hi; ++x) {
      float v = cubic((x + 0.5f - center) / filterscale);
      aw.w[size_t(o) * aw.max_taps + (x - lo)] = v;
      wsum += v;
    }
    if (wsum != 0)
      for (int k = 0; k < hi - lo; ++k)
        aw.w[size_t(o) * aw.max_taps + k] /= wsum;
  }
  return aw;
}

void resize_bicubic_normalize(const uint8_t* img, int h, int w, int out_size,
                              float* out) {
  const AxisWeights ax = axis_weights(w, out_size);
  const AxisWeights ay = axis_weights(h, out_size);
  std::vector<float> tmp(size_t(h) * out_size * 3);  // horizontal pass
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = img + size_t(y) * w * 3;
    for (int ox = 0; ox < out_size; ++ox) {
      float acc[3] = {0, 0, 0};
      const float* wt = ax.w.data() + size_t(ox) * ax.max_taps;
      for (int k = 0; k < ax.count[ox]; ++k) {
        const uint8_t* p = row + size_t(ax.start[ox] + k) * 3;
        for (int c = 0; c < 3; ++c) acc[c] += wt[k] * p[c];
      }
      float* q = tmp.data() + (size_t(y) * out_size + ox) * 3;
      for (int c = 0; c < 3; ++c) q[c] = acc[c];
    }
  }
  for (int oy = 0; oy < out_size; ++oy) {
    const float* wt = ay.w.data() + size_t(oy) * ay.max_taps;
    for (int ox = 0; ox < out_size; ++ox) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < ay.count[oy]; ++k) {
        const float* p =
            tmp.data() + (size_t(ay.start[oy] + k) * out_size + ox) * 3;
        for (int c = 0; c < 3; ++c) acc[c] += wt[k] * p[c];
      }
      float* q = out + (size_t(oy) * out_size + ox) * 3;
      for (int c = 0; c < 3; ++c)
        q[c] = std::min(std::max(acc[c], 0.0f), 255.0f) / 127.5f - 1.0f;
    }
  }
}

void set_error(char* err, int errlen, const std::string& what) {
  if (err && errlen > 0) {
    std::snprintf(err, size_t(errlen), "%s", what.c_str());
  }
}

// Run `body`, turning any exception into a return code and a message.
template <typename F>
int guarded(char* err, int errlen, F body) {
  try {
    body();
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.what());
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return 1;
}

}  // namespace

extern "C" {

// info[0..7]: width, height, components, colour space (0 grey, 1 YCbCr,
// 2 RGB, 3 CMYK, 4 YCCK), progressive, hmax, vmax, 0; then for each component c at 8 + 6c:
// h, v, blocks across and down (the MCU grid's), samples across and down.
int decode_header(const uint8_t* data, size_t len, int32_t* info, char* err,
                  int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j;
    parse_header(&j, data, len);
    const int32_t head[8] = {j.width, j.height, j.ncomp, j.color,
                             j.progressive, j.hmax, j.vmax, 0};
    std::memcpy(info, head, sizeof(head));
    for (int c = 0; c < j.ncomp; ++c) {
      const Component& k = j.comp[c];
      const int32_t v[6] = {k.h, k.v, k.bw, k.bh, k.dw, k.dh};
      std::memcpy(info + 8 + 6 * c, v, sizeof(v));
    }
  });
}

// quant: [components][64] natural order; coef: every component's blocks
// [bh][bw][64] in turn, natural order (`cap` int16 values at most).
int decode_coefficients(const uint8_t* data, size_t len, int32_t* quant,
                        int16_t* coef, size_t cap, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j;
    j.parse(data, len);
    size_t total = 0;
    for (int c = 0; c < j.ncomp; ++c) total += j.comp[c].coef.size();
    if (total > cap) fail("coefficient buffer too small");
    for (int c = 0; c < j.ncomp; ++c) {
      std::memcpy(quant + 64 * c, j.comp[c].quant, 64 * sizeof(int32_t));
      std::memcpy(coef, j.comp[c].coef.data(),
                  j.comp[c].coef.size() * sizeof(int16_t));
      coef += j.comp[c].coef.size();
    }
  });
}

// out: [height][width][3] uint8 RGB (`cap` bytes at most).
int decode_rgb(const uint8_t* data, size_t len, uint8_t* out, size_t cap,
               char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Image img;
    decode_jpeg(data, len, &img);
    if (img.data.size() > cap) fail("pixel buffer too small");
    std::memcpy(out, img.data.data(), img.data.size());
  });
}

// RGB uint8 [h][w][3] -> out [out_size][out_size][3] float32 in [-1, 1].
int resize_normalize(const uint8_t* img, int h, int w, int out_size,
                     float* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    if (h <= 0 || w <= 0 || out_size <= 0) fail("empty image or size");
    resize_bicubic_normalize(img, h, w, out_size, out);
  });
}

// Decode and resize n JPEG files into out [n][res][res][3] float32, on
// nthreads threads that take the files in turn from a shared counter.  status[i] is 0 or 1 (failed); err names the first file that
// failed and why.  Returns the number of failures.
int decode_batch(const char** paths, int n, int out_size, float* out,
                 int nthreads, int32_t* status, char* err, int errlen) {
  if (nthreads <= 0) nthreads = int(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, n));
  std::vector<std::string> why(size_t(std::max(n, 0)));
  const size_t stride = size_t(out_size) * out_size * 3;
  std::atomic<int> next{0};
  auto work = [&] {
    for (int i; (i = next++) < n;) {
      std::vector<uint8_t> buf;
      std::string reason;
      if (!read_file(paths[i], &buf, &reason)) {
        why[i] = reason;
        continue;
      }
      char msg[512] = {0};
      const int rc = guarded(msg, sizeof(msg), [&] {
        if (out_size <= 0) fail("output size must be positive");
        Image img;
        decode_jpeg(buf.data(), buf.size(), &img);
        resize_bicubic_normalize(img.data.data(), img.h, img.w, out_size,
                                 out + stride * size_t(i));
      });
      if (rc) why[i] = msg;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < nthreads; ++t) {
    try {
      pool.emplace_back(work);
    } catch (const std::system_error&) {
      break;  // fewer threads; the queue still covers every file
    }
  }
  work();
  for (auto& th : pool) th.join();
  int fails = 0;
  for (int i = 0; i < n; ++i) {
    status[i] = why[i].empty() ? 0 : 1;
    if (!why[i].empty() && fails++ == 0)
      set_error(err, errlen, std::string(paths[i]) + ": " + why[i]);
  }
  return fails;
}

}  // extern "C"
