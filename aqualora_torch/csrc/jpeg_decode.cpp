// JPEG files decoded on the host for the training data path, without
// libjpeg.
//
// The port's counterpart of the JAX package's native loader
// (aqualora_tpu/native/imageloader.cpp), which reads a file with
// libjpeg-turbo 2.1 through its stdio source (`cinfo.out_color_space =
// JCS_RGB`, everything else at its defaults) and resizes with its own
// float32 bicubic.  The card's machine has no libjpeg headers, so the
// marker reader, both entropy decoders and libjpeg's integer back half are
// written here, to give libjpeg-turbo 2.1's pixels bit for bit:
//
//   - the input as libjpeg's stdio source gives it: the file's bytes, then
//     a fake EOI (0xFF 0xD9) for ever, so that a file cut anywhere after
//     its first SOS decodes (jdatasrc.c); markers as jdmarker.c reads them:
//     SOI, APPn (JFIF and Adobe read, the rest skipped), COM, DQT (8- and
//     16-bit tables), DHT, DAC, SOF0, SOF1, SOF2, SOF9, SOF10, SOS, DRI,
//     RST0-7, TEM and DNL (skipped), EOI; a segment's fields are read
//     whatever its length says, and the length is checked after them;
//   - Huffman decoding, sequential (jdhuff.c) and progressive (jdphuff.c:
//     DC first and refine, AC first with EOB runs, AC refine);
//     libjpeg-turbo's default tables (jstdhuff.c) for tables 0 and 1 of a
//     sequential file that defines none (a progressive file must);
//   - arithmetic decoding (T.81 Annexes D, F and G, as jdarith.c): the QM
//     decoder with Table D.2's estimation states (jaricom.c), DC and AC
//     statistics per table under the conditioning of DAC (L, U, Kx) or its
//     defaults (0, 1, 5), sequential (SOF9) and progressive (SOF10) scans;
//   - libjpeg's warnings, on which it goes on: the data of a scan running
//     out (zero bits, then the MCUs left to the next restart keep their
//     zeroed blocks), a bad Huffman code (17 bits, decoded as symbol 0), a
//     bad arithmetic code (the rest of the interval skipped), extraneous
//     bytes before a marker (skipped), a missing or wrong restart marker
//     (`jpeg_resync_to_restart`'s rule), sequential scan parameters out of
//     range; each sets a bit of the result's `warnings`;
//   - block smoothing of progressive files whose scans leave low
//     coefficients unfinished (jdcoefct.c, `smoothing_ok` and
//     `decompress_smooth_data` of libjpeg-turbo 2.1: the first nine AC
//     coefficients, and the DC when no AC is known, estimated from the
//     5 x 5 blocks' DC values; each iMCU row after the last one decoded
//     with data takes the coefficient precision from before its scan);
//   - the accurate integer inverse DCT with its range limit (jidctint.c,
//     `jpeg_idct_islow`; jdmaster.c, `prepare_range_limit_table`);
//   - upsampling of every component whose sampling factors divide the
//     largest (jdsample.c: h2v1, h1v2 and h2v2 fancy, plain replication
//     where libjpeg takes it, and box replication for other integer
//     ratios), the context rows replicated at the image's top and bottom
//     (jdmainct.c);
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
// Refused with the feature's name, as libjpeg refuses them: lossless
// (SOF3, SOF11), hierarchical (SOF5-7, SOF13-15, DHP, EXP), the JPG
// extension (SOF8), 12-bit precision, two components, fractional sampling
// ratios; and files cut before their first scan (no image).  Every read
// is bounds-checked; a corrupt file returns an error and never reads out
// of range.  Dequantized coefficients are taken at full precision, as
// libjpeg's C IDCT takes them; every encoder's output fits the 16 bits its
// SIMD IDCT keeps.
//
// The resize is the JAX loader's float32 rule, the same operations in the
// same order (imageloader.cpp:117-190), so it gives the same bits when both
// are built without -ffast-math and without contraction into FMA.
//
// C entry points (ctypes, aqualora_torch/train/image_decode.py):
//   decode_header        geometry of a JPEG in memory
//   decode_coefficients  its quantization tables, quantized blocks and
//                        progression (coef_bits, smoothing)
//   decode_rgb           its RGB pixels and warnings
//   decode_batch         files -> [n, res, res, 3] float32 in [-1, 1], on
//                        std::threads (0 threads: the hardware's count)
//   resize_normalize     RGB uint8 -> the same float32 rule
// Each returns 0 on success, else writes its reason into `err`.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -ffp-contract=off

#include <algorithm>
#include <array>
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

// libjpeg's warnings (jerror.h), one bit each in a decode's `warnings`
enum Warning : uint32_t {
  kWarnEof = 1,               // JWRN_JPEG_EOF: the file ends before EOI
  kWarnHitMarker = 2,         // JWRN_HIT_MARKER: a scan's data ran out
  kWarnHuffBadCode = 4,       // JWRN_HUFF_BAD_CODE
  kWarnArithBadCode = 8,      // JWRN_ARITH_BAD_CODE
  kWarnExtraneous = 16,       // JWRN_EXTRANEOUS_DATA
  kWarnResync = 32,           // JWRN_MUST_RESYNC
  kWarnNotSequential = 64,    // JWRN_NOT_SEQUENTIAL
  kWarnBogusProgression = 128,  // JWRN_BOGUS_PROGRESSION
  kWarnAdobeTransform = 256,  // JWRN_ADOBE_XFORM
};

// ---------------------------------------------------------------------------
// the input: jdatasrc.c's stdio source
// ---------------------------------------------------------------------------

// The file's bytes, then 0xFF 0xD9 again and again: at the end of its file
// libjpeg's source warns and inserts a fake EOI at every refill.
struct Source {
  const uint8_t* data = nullptr;
  size_t len = 0, pos = 0;  // pos passes len in the fake EOIs
  uint32_t warnings = 0;

  int byte() {
    if (pos < len) return data[pos++];
    warnings |= kWarnEof;
    return ((pos++ - len) & 1) ? 0xD9 : 0xFF;
  }

  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  void skip(int64_t n) {
    if (n <= 0) return;
    if (pos + size_t(n) > len) warnings |= kWarnEof;
    pos += size_t(n);
  }
};

// ---------------------------------------------------------------------------
// Huffman tables (jdhuff.c, jpeg_make_d_derived_tbl)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

// a DHT's table as the file defines it
struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

struct HuffTable {
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};    // the largest code of each length, -1 if none
  int32_t valoffset[18] = {};  // vals index = code + valoffset[length]
  uint16_t lookup[1 << kLookBits] = {};  // (length << 8) | value; 0: longer
};

void build_table(HuffTable* t, const HuffSpec& s, bool dc) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (p + s.bits[l] > 256) fail("corrupt file: bad Huffman table");
    for (int i = 0; i < s.bits[l]; ++i) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int nvals = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail("corrupt file: bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s.bits[l]) {
      t->valoffset[l] = p - int(huffcode[p]);
      p += s.bits[l];
      t->maxcode[l] = int32_t(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0xFFFFF;  // the sentinel: at most 17 bits are read
  std::memcpy(t->vals, s.vals, sizeof(t->vals));
  std::memset(t->lookup, 0, sizeof(t->lookup));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < s.bits[l]; ++i, ++p) {
      const uint32_t first = huffcode[p] << (kLookBits - l);
      for (uint32_t k = 0; k < (1u << (kLookBits - l)); ++k)
        t->lookup[first + k] = uint16_t((l << 8) | s.vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < nvals; ++i)
      if (s.vals[i] > 15) fail("corrupt file: bad Huffman table");
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

void std_spec(HuffSpec* s, const uint8_t bits[17], const uint8_t* vals,
              int n) {
  std::memcpy(s->bits, bits, 17);
  std::memset(s->vals, 0, sizeof(s->vals));
  std::memcpy(s->vals, vals, size_t(n));
  s->defined = true;
}

// HUFF_EXTEND (jdhuff.h)
inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + int(~0u << s) + 1 : r;
}

// ---------------------------------------------------------------------------
// the arithmetic decoder's probability estimation (jaricom.c, Table D.2):
// (Qe << 16) | (Next_Index_MPS << 8) | (Switch_MPS << 7) | Next_Index_LPS;
// the last state is the fixed probability 0.5 (T.851)
// ---------------------------------------------------------------------------

#define V(qe, nl, nm, sw) ((int32_t(qe) << 16) | ((nm) << 8) | ((sw) << 7) | (nl))
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

constexpr int kDcStatBins = 64, kAcStatBins = 256, kArithTables = 16;

// ---------------------------------------------------------------------------
// the frame
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // samples: ceil(W * h / hmax), ceil(H * v / vmax)
  int cbw = 0, cbh = 0;  // blocks a non-interleaved scan codes
  int bw = 0, bh = 0;    // blocks held: the MCU grid's
  bool latched = false;  // its quantization table copied at its first scan
  int quant[64] = {};    // natural order; 0 until latched
  std::vector<int16_t> coef;  // [bh][bw][64], natural order
};

enum ColorSpace { kGrey = 0, kYCbCr = 1, kRGB = 2, kCMYK = 3, kYCCK = 4 };
constexpr int kMaxComponents = 4;
constexpr int kMaxDimension = 65500;  // JPEG_MAX_DIMENSION

std::string hex(int m) {
  char b[8];
  std::snprintf(b, sizeof(b), "%02X", m);
  return b;
}

struct Jpeg {
  Source src;
  int unread_marker = 0;  // a marker read and not yet processed

  bool frame = false, progressive = false, arith = false;
  bool scanned = false, multiple_scans = false;
  int scans = 0;  // SOS markers read
  int precision = 8;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  Component comp[kMaxComponents];
  int quant[4][64] = {};
  bool quant_defined[4] = {};
  HuffSpec dc_spec[4], ac_spec[4];
  uint8_t arith_dc_l[kArithTables], arith_dc_u[kArithTables],
      arith_ac_k[kArithTables];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int color = kYCbCr;

  // progression: coef_bits[c][k] is the lowest bit of coefficient k known
  // (-1: none), prev_bits the same before the component's latest scan
  // (libjpeg-turbo's second half of cinfo->coef_bits)
  int coef_bits[kMaxComponents][64];
  int prev_bits[kMaxComponents][64];
  int last_good_row = 0;  // cinfo->master->last_good_iMCU_row

  // ---- the scan ----------------------------------------------------------
  int ns = 0, scomp[kMaxComponents] = {}, dctbl[kMaxComponents] = {},
      actbl[kMaxComponents] = {};
  int ss = 0, se = 0, ah = 0, al = 0;
  int next_restart = 0, restarts_to_go = 0;
  int dc_pred[kMaxComponents] = {};
  // Huffman
  HuffTable dct[kMaxComponents], act[kMaxComponents];
  uint64_t buf = 0;
  int count = 0;  // bits in buf (its low bits)
  bool insufficient = false;
  int eobrun = 0;
  // arithmetic: the C and A registers and the bit counter (jdarith.c)
  int64_t arith_c = 0, arith_a = 0;
  int arith_ct = 0;
  int dc_context[kMaxComponents] = {};
  uint8_t dc_stats[kArithTables][kDcStatBins];
  uint8_t ac_stats[kArithTables][kAcStatBins];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  Jpeg() {
    for (int t = 0; t < kArithTables; ++t) {
      arith_dc_l[t] = 0;
      arith_dc_u[t] = 1;
      arith_ac_k[t] = 5;
    }
    for (int c = 0; c < kMaxComponents; ++c)
      for (int k = 0; k < 64; ++k) {
        coef_bits[c][k] = -1;
        prev_bits[c][k] = 0;
      }
  }

  void start(const uint8_t* d, size_t n) {
    src.data = d;
    src.len = n;
    src.pos = 0;
    const int c = src.byte(), c2 = src.byte();
    if (c != 0xFF || c2 != 0xD8) fail("not a JPEG file (no SOI)");
  }

  // libjpeg's next_marker: non-0xFF bytes and 0xFF 0x00 pairs skipped
  // (warned), padding 0xFFs swallowed; the fake EOI ends every search
  int next_marker() {
    bool discarded = false;
    for (;;) {
      int c = src.byte();
      while (c != 0xFF) {
        discarded = true;
        c = src.byte();
      }
      do c = src.byte();
      while (c == 0xFF);
      if (c != 0) {
        if (discarded) src.warnings |= kWarnExtraneous;
        return c;
      }
      discarded = true;
    }
  }

  // ---- marker segments (jdmarker.c) --------------------------------------

  void get_app(int marker) {
    int64_t length = src.u16() - 2;
    uint8_t b[14];
    const int numtoread = int(length >= 14 ? 14 : length > 0 ? length : 0);
    for (int i = 0; i < numtoread; ++i) b[i] = uint8_t(src.byte());
    length -= numtoread;
    if (marker == 0xE0 && numtoread >= 14 && !std::memcmp(b, "JFIF\0", 5))
      jfif = true;
    if (marker == 0xEE && numtoread >= 12 && !std::memcmp(b, "Adobe", 5)) {
      adobe = true;
      adobe_transform = b[11];
    }
    src.skip(length);
  }

  void skip_variable() { src.skip(int64_t(src.u16()) - 2); }

  void get_dqt() {
    int64_t length = src.u16() - 2;
    while (length > 0) {
      const int n = src.byte();
      const int prec = n >> 4, t = n & 15;
      if (t > 3) fail("corrupt DQT: table " + std::to_string(t));
      for (int i = 0; i < 64; ++i)
        quant[t][kNatural[i]] = prec ? src.u16() : src.byte();
      quant_defined[t] = true;
      length -= prec ? 129 : 65;
    }
    if (length != 0) fail("corrupt DQT length");
  }

  void get_dht() {
    int64_t length = src.u16() - 2;
    while (length > 16) {
      int index = src.byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = uint8_t(src.byte());
      length -= 17;
      if (count > 256 || count > length) fail("corrupt file: bad Huffman table");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; ++i) vals[i] = uint8_t(src.byte());
      length -= count;
      const bool ac = index & 0x10;
      if (ac) index -= 0x10;
      if (index < 0 || index > 3) fail("corrupt DHT: table index");
      HuffSpec& s = ac ? ac_spec[index] : dc_spec[index];
      std::memcpy(s.bits, bits, sizeof(bits));
      std::memcpy(s.vals, vals, sizeof(vals));
      s.defined = true;
    }
    if (length != 0) fail("corrupt DHT length");
  }

  void get_dac() {
    int64_t length = src.u16() - 2;
    while (length > 0) {
      const int index = src.byte(), val = src.byte();
      length -= 2;
      if (index >= 2 * kArithTables) fail("corrupt DAC: table index");
      if (index >= kArithTables) {
        arith_ac_k[index - kArithTables] = uint8_t(val);
      } else {
        arith_dc_l[index] = uint8_t(val & 15);
        arith_dc_u[index] = uint8_t(val >> 4);
        if (arith_dc_l[index] > arith_dc_u[index])
          fail("corrupt DAC: L above U");
      }
    }
    if (length != 0) fail("corrupt DAC length");
  }

  void get_dri() {
    if (src.u16() != 4) fail("corrupt DRI length");
    restart_interval = src.u16();
  }

  void get_sof(bool prog, bool arithmetic) {
    progressive = prog;
    arith = arithmetic;
    int64_t length = src.u16();
    precision = src.byte();
    height = src.u16();
    width = src.u16();
    ncomp = src.byte();
    length -= 8;
    if (frame) fail("more than one frame (SOF marker)");
    if (height == 0) fail("refused: DNL (the height defined after the scan)");
    if (width == 0 || ncomp == 0) fail("corrupt SOF: an empty image");
    if (length != 3 * ncomp) fail("corrupt SOF length");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("refused: " + std::to_string(ncomp) + " components");
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = src.byte();
      const int hv = src.byte();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = src.byte();
    }
    frame = true;
  }

  // jdinput.c, initial_setup: at the first SOS
  void initial_setup() {
    if (width > kMaxDimension || height > kMaxDimension)
      fail("refused: an image side above 65500");
    if (precision == 12) fail("refused: 12-bit precision");
    if (precision != 8)
      fail("refused: sample precision " + std::to_string(precision));
    if (int64_t(width) * height > kMaxPixels)
      fail("refused: " + std::to_string(width) + "x" + std::to_string(height) +
           " pixels exceed the decompression-bomb limit");
    hmax = vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
      const Component& k = comp[c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4)
        fail("corrupt SOF: sampling factors");
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    for (int c = 0; c < ncomp; ++c)  // jdsample.c's ratios
      if (hmax % comp[c].h || vmax % comp[c].v)
        fail("refused: fractional sampling ratios");
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
    }
    decide_color();
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
      if (adobe_transform > 1) src.warnings |= kWarnAdobeTransform;
      color = adobe_transform == 0 ? kRGB : kYCbCr;
    } else if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) {
      color = kRGB;
    } else {
      color = kYCbCr;
    }
  }

  // get_sos: the scan's header
  void get_sos() {
    if (!frame) fail("corrupt file: SOS before SOF");
    const int length = src.u16();
    ns = src.byte();
    if (length != 2 * ns + 6 || ns < 1 || ns > 4)
      fail("corrupt SOS length");
    bool used[kMaxComponents] = {};
    for (int j = 0; j < ns; ++j) {
      const int id = src.byte();
      const int t = src.byte();
      scomp[j] = -1;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id && !used[c]) {
          scomp[j] = c;
          break;
        }
      if (scomp[j] < 0) fail("corrupt SOS: unknown component");
      used[scomp[j]] = true;
      dctbl[j] = t >> 4;
      actbl[j] = t & 15;
    }
    ss = src.byte();
    se = src.byte();
    const int a = src.byte();
    ah = a >> 4;
    al = a & 15;
    next_restart = 0;
    ++scans;
  }

  // ---- the bits of a Huffman scan (jpeg_fill_bit_buffer) -----------------

  // Load buf to at least 57 bits, stopping at a marker; past the marker,
  // a request for more bits than are left is served zeros and marks the
  // segment's data as run out.
  void fill(int nbits) {
    if (unread_marker == 0) {
      while (count < 57) {
        int c = src.byte();
        if (c == 0xFF) {
          do c = src.byte();
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            break;
          }
        }
        buf = (buf << 8) | uint64_t(c);
        count += 8;
      }
      if (unread_marker == 0) return;
    }
    if (nbits > count) {
      if (!insufficient) src.warnings |= kWarnHitMarker;
      insufficient = true;
      buf <<= 57 - count;
      count = 57;
    }
  }

  int get(int n) {
    if (n == 0) return 0;
    if (count < n) fill(n);
    count -= n;
    return int((buf >> count) & ((uint64_t(1) << n) - 1));
  }

  // HUFF_DECODE and jpeg_huff_decode
  int decode(const HuffTable& t) {
    int l = 1;
    int32_t code;
    if (count < kLookBits) fill(0);
    if (count >= kLookBits) {
      const uint16_t e =
          t.lookup[(buf >> (count - kLookBits)) & ((1u << kLookBits) - 1)];
      if (e) {
        count -= e >> 8;
        return e & 0xFF;
      }
      l = kLookBits;
    }
    code = get(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) {
      src.warnings |= kWarnHuffBadCode;
      return 0;  // libjpeg fakes a zero
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  // ---- restart markers (jdmarker.c, read_restart_marker) -----------------

  void read_restart_marker() {
    if (unread_marker == 0) unread_marker = next_marker();
    if (unread_marker == 0xD0 + next_restart)
      unread_marker = 0;
    else
      resync_to_restart(next_restart);
    next_restart = (next_restart + 1) & 7;
  }

  // jpeg_resync_to_restart: a marker below SOF0 or a restart before the
  // wanted one is skipped to the next marker; another marker, or one of
  // the two restarts after the wanted one, stays (the interval is then
  // empty); the wanted one, or one too far away, is taken as it.
  void resync_to_restart(int desired) {
    src.warnings |= kWarnResync;
    int marker = unread_marker;
    for (;;) {
      int action = 1;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((desired + 1) & 7) ||
                 marker == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((desired - 1) & 7) ||
                 marker == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      }
      if (action == 1) {
        unread_marker = 0;
        return;
      }
      if (action == 3) return;
      marker = unread_marker = next_marker();
    }
  }

  void process_restart() {
    read_restart_marker();
    for (int j = 0; j < ns; ++j) dc_pred[j] = 0;
    restarts_to_go = restart_interval;
    if (arith) {
      for (int j = 0; j < ns; ++j) {
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(dc_stats[dctbl[j]], 0, kDcStatBins);
          dc_context[j] = 0;
        }
        if (!progressive || ss)
          std::memset(ac_stats[actbl[j]], 0, kAcStatBins);
      }
      arith_c = arith_a = 0;
      arith_ct = -16;
    } else {
      buf = 0;
      count = 0;
      eobrun = 0;
      if (unread_marker == 0) insufficient = false;
    }
  }

  // ---- Huffman blocks (jdhuff.c, jdphuff.c) ------------------------------

  void block_baseline(int j, int16_t* blk) {
    int s = decode(dct[j]);
    if (s) s = extend(get(s), s);
    s = int(unsigned(s) + unsigned(dc_pred[j]));
    dc_pred[j] = s;
    blk[0] = int16_t(s);
    for (int i = 1; i < 64; ++i) {
      const int rs = decode(act[j]);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = int16_t(extend(get(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void block_dc_first(int j, int16_t* blk) {
    int s = decode(dct[j]);
    if (s) s = extend(get(s), s);
    s = int(unsigned(s) + unsigned(dc_pred[j]));
    dc_pred[j] = s;
    blk[0] = int16_t(int(unsigned(s) << al));
  }

  void block_dc_refine(int16_t* blk) {
    if (get(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void block_ac_first(int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int i = ss; i <= se; ++i) {
      const int rs = decode(act[0]);
      const int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = int16_t(int(unsigned(extend(get(s), s)) << al));
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get(r);
        --eobrun;
        break;
      }
    }
  }

  // decode_mcu_AC_refine (jdphuff.c)
  void block_ac_refine(int16_t* blk) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun == 0) {
      for (; i <= se; ++i) {
        const int rs = decode(act[0]);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            if (get(1) && (*c & p1) == 0)
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
        if (*c != 0 && get(1) && (*c & p1) == 0)
          *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  // ---- arithmetic blocks (jdarith.c) -------------------------------------

  // arith_decode: renormalization and data input (D.2.6), then the
  // decision and the estimation (D.2.4, D.2.5); a marker in the data
  // supplies zeros from there on
  int arith_decode(uint8_t* st) {
    while (arith_a < 0x8000) {
      if (--arith_ct < 0) {
        int data = 0;
        if (unread_marker == 0) {
          data = src.byte();
          if (data == 0xFF) {
            do data = src.byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              data = 0;
            }
          }
        }
        arith_c = (arith_c << 8) | data;
        if ((arith_ct += 8) < 0)
          if (++arith_ct == 0) arith_a = 0x8000;  // two initial bytes read
      }
      arith_a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = arith_a - qe;
    arith_a = temp;
    temp <<= arith_ct;
    if (arith_c >= temp) {
      arith_c -= temp;
      if (arith_a < qe) {
        arith_a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        arith_a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (arith_a < 0x8000) {
      if (arith_a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void arith_bad() {
    src.warnings |= kWarnArithBadCode;
    arith_ct = -1;  // the rest of the interval is skipped
  }

  // Figures F.19 and F.21-F.24: a DC difference into dc_pred[j]; false on
  // a bad code
  bool arith_dc(int j) {
    const int tbl = dctbl[j];
    uint8_t* st = dc_stats[tbl] + dc_context[j];
    if (arith_decode(st) == 0) {
      dc_context[j] = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          arith_bad();
          return false;
        }
        ++st;
      }
    }
    if (m < int((1L << arith_dc_l[tbl]) >> 1))
      dc_context[j] = 0;
    else if (m > int((1L << arith_dc_u[tbl]) >> 1))
      dc_context[j] = 12 + sign * 4;
    else
      dc_context[j] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    dc_pred[j] = (dc_pred[j] + v) & 0xFFFF;
    return true;
  }

  // Figure F.20: the AC coefficients k0..k1 of one block, shifted by `shift`;
  // false on a bad code
  bool arith_ac(int tbl, int16_t* blk, int k0, int k1, int shift) {
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) {
          arith_bad();  // spectral overflow
          return false;
        }
      }
      const int sign = arith_decode(fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m != 0 && arith_decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_ac_k[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            arith_bad();  // magnitude overflow
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(int(unsigned(v) << shift));
    }
    return true;
  }

  void arith_ac_refine(int16_t* blk) {
    const int tbl = actbl[0];
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* c = blk + kNatural[k];
        if (*c) {
          if (arith_decode(st + 2))
            *c = int16_t(*c < 0 ? *c + m1 : *c + p1);
          break;
        }
        if (arith_decode(st + 1)) {
          *c = int16_t(arith_decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          arith_bad();  // spectral overflow
          return;
        }
      }
    }
  }

  // ---- a scan ------------------------------------------------------------

  void read_scan() {
    if (!scanned) {
      initial_setup();
      // jdinput.c: a file whose first scan holds every component and
      // which is not progressive has one scan
      multiple_scans = ns < ncomp || progressive;
      scanned = true;
      for (int c = 0; c < ncomp; ++c)
        comp[c].coef.assign(size_t(comp[c].bw) * comp[c].bh * 64, 0);
    } else if (!multiple_scans) {
      fail("corrupt file: a second scan where EOI was expected");
    }
    int blocks_in_mcu = 0;
    for (int j = 0; j < ns; ++j) {
      Component& k = comp[scomp[j]];
      blocks_in_mcu += ns > 1 ? k.h * k.v : 1;
      if (blocks_in_mcu > 10)
        fail("refused: sampling factors too large for an interleaved scan");
    }
    for (int j = 0; j < ns; ++j) {  // latch_quant_tables
      Component& k = comp[scomp[j]];
      if (k.latched) continue;
      if (k.tq > 3 || !quant_defined[k.tq])
        fail("corrupt file: a component uses an undefined quantization "
             "table");
      std::memcpy(k.quant, quant[k.tq], sizeof(k.quant));
      k.latched = true;
    }
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("corrupt progressive scan parameters");
      for (int j = 0; j < ns; ++j) {
        const int c = scomp[j];
        if (ss && coef_bits[c][0] < 0) src.warnings |= kWarnBogusProgression;
        for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
          prev_bits[c][k] = scans > 1 ? coef_bits[c][k] : 0;
        for (int k = ss; k <= se; ++k) {
          if (ah != std::max(coef_bits[c][k], 0))
            src.warnings |= kWarnBogusProgression;
          coef_bits[c][k] = al;
        }
      }
    } else if (ss != 0 || ah != 0 || al != 0 || (se != 63 && (!arith || se < 64))) {
      src.warnings |= kWarnNotSequential;  // a warning, as in libjpeg
    }
    const bool dc_scan = !progressive || ss == 0;
    const bool ac_scan = !progressive || ss > 0;
    for (int j = 0; j < ns; ++j) {  // the tables
      if (arith) {
        if (dc_scan && (!progressive || ah == 0)) {
          std::memset(dc_stats[dctbl[j]], 0, kDcStatBins);
          dc_context[j] = 0;
        }
        if (ac_scan) std::memset(ac_stats[actbl[j]], 0, kAcStatBins);
        continue;
      }
      if (dc_scan && (!progressive || ah == 0)) {
        if (dctbl[j] > 3) fail("corrupt file: a scan uses an undefined DC table");
        HuffSpec& s = dc_spec[dctbl[j]];
        if (!s.defined && dctbl[j] < 2 && !progressive)
          std_spec(&s, dctbl[j] ? kDcChromBits : kDcLumBits, kDcVals, 12);
        if (!s.defined) fail("corrupt file: a scan uses an undefined DC table");
        build_table(&dct[j], s, true);
      }
      if (ac_scan) {
        if (actbl[j] > 3) fail("corrupt file: a scan uses an undefined AC table");
        HuffSpec& s = ac_spec[actbl[j]];
        if (!s.defined && actbl[j] == 0 && !progressive)
          std_spec(&s, kAcLumBits, kAcLumVals, 162);
        if (!s.defined && actbl[j] == 1 && !progressive)
          std_spec(&s, kAcChromBits, kAcChromVals, 162);
        if (!s.defined) fail("corrupt file: a scan uses an undefined AC table");
        build_table(&act[j], s, false);
      }
    }
    for (int j = 0; j < ns; ++j) dc_pred[j] = 0;
    buf = 0;
    count = 0;
    insufficient = false;
    eobrun = 0;
    arith_c = arith_a = 0;
    arith_ct = -16;
    restarts_to_go = restart_interval;

    const bool single = ns == 1;
    const Component& k0 = comp[scomp[0]];
    const int64_t mcus = single ? int64_t(k0.cbw) * k0.cbh
                                : int64_t(mcus_x) * mcus_y;
    const int per_row = single ? k0.cbw : mcus_x;
    for (int64_t m = 0; m < mcus; ++m) {
      const int mx = int(m % per_row), my = int(m / per_row);
      // jdcoefct.c: the iMCU row of every MCU begun with data
      if (!insufficient) last_good_row = single ? my / k0.v : my;
      if (restart_interval && restarts_to_go == 0) process_restart();
      // an MCU begun after the data ran out (or, arithmetic, after a bad
      // code) keeps what its blocks hold, to the next restart
      if (!(arith ? arith_ct == -1 : insufficient)) {
        if (single) {
          one_block(0, mx, my);
        } else {
          for (int j = 0; j < ns; ++j) {
            const Component& k = comp[scomp[j]];
            for (int y = 0; y < k.v; ++y)
              for (int x = 0; x < k.h; ++x)
                one_block(j, mx * k.h + x, my * k.v + y);
          }
        }
      }
      if (restart_interval) --restarts_to_go;
    }
  }

  // one block of the scan's component j at block (bx, by)
  void one_block(int j, int bx, int by) {
    Component& k = comp[scomp[j]];
    int16_t* blk = k.coef.data() + (size_t(by) * k.bw + bx) * 64;
    if (arith) {
      if (arith_ct == -1) return;  // a bad code ends the MCU
      if (!progressive) {
        if (!arith_dc(j)) return;
        blk[0] = int16_t(dc_pred[j]);
        arith_ac(actbl[j], blk, 1, 63, 0);
      } else if (ss == 0 && ah == 0) {
        if (arith_dc(j)) blk[0] = int16_t(int(unsigned(dc_pred[j]) << al));
      } else if (ss == 0) {
        if (arith_decode(fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
      } else if (ah == 0) {
        arith_ac(actbl[0], blk, ss, se, al);
      } else {
        arith_ac_refine(blk);
      }
    } else if (!progressive) {
      block_baseline(j, blk);
    } else if (ss == 0 && ah == 0) {
      block_dc_first(j, blk);
    } else if (ss == 0) {
      block_dc_refine(blk);
    } else if (ah == 0) {
      block_ac_first(blk);
    } else {
      block_ac_refine(blk);
    }
  }
};

// The marker that read_markers (jdmarker.c) would process next: 0 when a
// segment was read whole, else the one an entropy decoder stopped at.
// Returns true at the first SOS, with the scan's header read.
bool read_markers(Jpeg& j) {
  for (;;) {
    if (j.unread_marker == 0) j.unread_marker = j.next_marker();
    const int m = j.unread_marker;
    j.unread_marker = 0;
    switch (m) {
      case 0xD8:
        fail("corrupt file: a second SOI");
      case 0xC0:
      case 0xC1:
        j.get_sof(false, false);
        break;
      case 0xC2:
        j.get_sof(true, false);
        break;
      case 0xC9:
        j.get_sof(false, true);
        break;
      case 0xCA:
        j.get_sof(true, true);
        break;
      case 0xC3:
        fail("refused: lossless JPEG (SOF3)");
      case 0xCB:
        fail("refused: lossless JPEG (SOF11, arithmetic)");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail("refused: hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
             ")");
      case 0xC8:
        fail("refused: the JPG extension (SOF8)");
      case 0xDA:
        j.get_sos();
        return true;
      case 0xD9:
        return false;
      case 0xCC:
        j.get_dac();
        break;
      case 0xC4:
        j.get_dht();
        break;
      case 0xDB:
        j.get_dqt();
        break;
      case 0xDD:
        j.get_dri();
        break;
      case 0xE0:
      case 0xEE:
        j.get_app(m);
        break;
      case 0xDC:  // DNL: skipped, as libjpeg skips it
        j.skip_variable();
        break;
      case 0x01:  // TEM and a stray RSTn: no segment
      case 0xD0: case 0xD1: case 0xD2: case 0xD3:
      case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        break;
      case 0xDE:
      case 0xDF:
        fail("refused: hierarchical JPEG (DHP/EXP)");
      default:
        if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {  // APPn, COM
          j.skip_variable();
          break;
        }
        fail("corrupt file: unknown marker 0x" + hex(m));
    }
  }
}

// Everything up to EOI, the fake one included: every component's
// coefficients.
void parse(Jpeg& j, const uint8_t* d, size_t n) {
  j.start(d, n);
  if (!read_markers(j)) fail("corrupt file: no image (EOI before a scan)");
  do j.read_scan();
  while (read_markers(j));
}

// Geometry without decoding: the markers up to the first SOS.
void parse_header(Jpeg& j, const uint8_t* d, size_t n) {
  j.start(d, n);
  if (!read_markers(j)) fail("corrupt file: no image (EOI before a scan)");
  j.initial_setup();
}

// ---------------------------------------------------------------------------
// block smoothing (jdcoefct.c, libjpeg-turbo 2.1)
// ---------------------------------------------------------------------------

constexpr int kSavedCoefs = 10;
// natural-order positions of zigzag coefficients 1..9
const int kSmoothPos[kSavedCoefs] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// smoothing_ok: a progressive file whose every component has its table
// (no zero among the ten divisors) and DC bits, and some component an
// unfinished coefficient among the first nine AC ones
bool smoothing_ok(const Jpeg& j) {
  if (!j.progressive) return false;
  bool useful = false;
  for (int c = 0; c < j.ncomp; ++c) {
    const Component& k = j.comp[c];
    if (!k.latched) return false;
    for (int i = 0; i < kSavedCoefs; ++i)
      if (k.quant[kSmoothPos[i]] == 0) return false;
    if (j.coef_bits[c][0] < 0) return false;
    for (int i = 1; i < kSavedCoefs; ++i)
      if (j.coef_bits[c][i] != 0) useful = true;
  }
  return useful;
}

// smoothing_ok's latch of the bits before a component's latest scan: none
// known (-1) when the file has had one scan
void latched_prev(const Jpeg& j, int c, int* out) {
  for (int k = 0; k < 64; ++k) out[k] = j.scans > 1 ? j.prev_bits[c][k] : -1;
}

// The estimate of one coefficient, `num` / (q << 8) rounded, within the
// bits still unknown (al > 0)
inline int16_t predict(int64_t num, int64_t q, int al) {
  int64_t pred;
  if (num >= 0) {
    pred = ((q << 7) + num) / (q << 8);
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = ((q << 7) - num) / (q << 8);
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return int16_t(pred);
}

// The rows of the 5 x 5 window (two above, this, two below) of every
// block row, as decompress_smooth_data picks them: a row above or below is
// taken while its block row lies within the iMCU row, or while the iMCU
// row has one (two for the second row) before or after it, else the nearer
// one repeats; within the last iMCU row only cbh % v (or v) rows count.
void smooth_rows(const Component& k, int total_rows,
                 std::vector<std::array<int, 5>>* out) {
  out->assign(size_t(k.cbh), {});
  const int last = total_rows - 1;
  for (int row = 0; row < total_rows; ++row) {
    int block_rows = k.v;
    if (row == last) {
      block_rows = k.cbh % k.v;
      if (block_rows == 0) block_rows = k.v;
    }
    for (int br = 0; br < block_rows; ++br) {
      const int a = row * k.v + br;
      if (a >= k.cbh) continue;
      const int prev = br > 0 || row > 0 ? a - 1 : a;
      const int prev2 = br > 1 || row > 1 ? a - 2 : prev;
      const int next = br < block_rows - 1 || row < last ? a + 1 : a;
      const int next2 = br < block_rows - 2 || row + 1 < last ? a + 2 : next;
      (*out)[size_t(a)] = {prev2, prev, a, next, next2};
    }
  }
}

// The columns of the window of every block column: the sliding registers
// DC01..DC25 start at column 0 and take column c + 2 while c + 1 is below
// the last column (so that a two-block-wide component reads its first
// column two to its right).
void smooth_cols(int cbw, std::vector<std::array<int, 5>>* out) {
  out->assign(size_t(cbw), {});
  std::array<int, 5> reg = {0, 0, 0, 0, 0};
  const int last = cbw - 1;
  for (int b = 0; b < cbw; ++b) {
    if (b == 0 && b < last) reg[3] = 1;
    if (b + 1 < last) reg[4] = b + 2;
    (*out)[size_t(b)] = reg;
    reg = {reg[1], reg[2], reg[3], reg[4], reg[4]};
  }
}

// decompress_smooth_data on every real block of component c: the
// estimates go into a copy of its coefficients
std::vector<int16_t> smooth_component(const Jpeg& j, int c) {
  const Component& k = j.comp[c];
  std::vector<int16_t> out = k.coef;
  int prev[64];
  latched_prev(j, c, prev);
  std::vector<std::array<int, 5>> rows, cols;
  smooth_rows(k, j.mcus_y, &rows);
  smooth_cols(k.cbw, &cols);
  const int64_t q00 = k.quant[0], q01 = k.quant[1], q10 = k.quant[8],
                q20 = k.quant[16], q11 = k.quant[9], q02 = k.quant[2],
                q03 = k.quant[3], q12 = k.quant[10], q21 = k.quant[17],
                q30 = k.quant[24];
  for (int by = 0; by < k.cbh; ++by) {
    // rows after the last one decoded with data: the bits before the scan
    const int* bits = by / k.v > j.last_good_row ? prev : j.coef_bits[c];
    bool change_dc = true;
    for (int i = 1; i < kSavedCoefs; ++i)
      if (bits[i] != -1) change_dc = false;
    for (int bx = 0; bx < k.cbw; ++bx) {
      int64_t dc[26];
      for (int r = 0; r < 5; ++r)
        for (int s = 0; s < 5; ++s)
          dc[1 + 5 * r + s] = k.coef[(size_t(rows[size_t(by)][size_t(r)]) *
                                          k.bw +
                                      size_t(cols[size_t(bx)][size_t(s)])) *
                                     64];
      const int16_t* src = k.coef.data() + (size_t(by) * k.bw + bx) * 64;
      int16_t* w = out.data() + (size_t(by) * k.bw + bx) * 64;
      int al;
      if ((al = bits[1]) != 0 && src[1] == 0) {
        const int64_t num =
            q00 * (change_dc
                       ? (-dc[1] - dc[2] + dc[4] + dc[5] - 3 * dc[6] +
                          13 * dc[7] - 13 * dc[9] + 3 * dc[10] - 3 * dc[11] +
                          38 * dc[12] - 38 * dc[14] + 3 * dc[15] -
                          3 * dc[16] + 13 * dc[17] - 13 * dc[19] +
                          3 * dc[20] - dc[21] - dc[22] + dc[24] + dc[25])
                       : (-7 * dc[11] + 50 * dc[12] - 50 * dc[14] +
                          7 * dc[15]));
        w[1] = predict(num, q01, al);
      }
      if ((al = bits[2]) != 0 && src[8] == 0) {
        const int64_t num =
            q00 * (change_dc
                       ? (-dc[1] - 3 * dc[2] - 3 * dc[3] - 3 * dc[4] - dc[5] -
                          dc[6] + 13 * dc[7] + 38 * dc[8] + 13 * dc[9] -
                          dc[10] + dc[16] - 13 * dc[17] - 38 * dc[18] -
                          13 * dc[19] + dc[20] + dc[21] + 3 * dc[22] +
                          3 * dc[23] + 3 * dc[24] + dc[25])
                       : (-7 * dc[3] + 50 * dc[8] - 50 * dc[18] +
                          7 * dc[23]));
        w[8] = predict(num, q10, al);
      }
      if ((al = bits[3]) != 0 && src[16] == 0) {
        const int64_t num =
            q00 * (change_dc
                       ? (dc[3] + 2 * dc[7] + 7 * dc[8] + 2 * dc[9] -
                          5 * dc[12] - 14 * dc[13] - 5 * dc[14] + 2 * dc[17] +
                          7 * dc[18] + 2 * dc[19] + dc[23])
                       : (-dc[3] + 13 * dc[8] - 24 * dc[13] + 13 * dc[18] -
                          dc[23]));
        w[16] = predict(num, q20, al);
      }
      if ((al = bits[4]) != 0 && src[9] == 0) {
        const int64_t num =
            q00 * (change_dc
                       ? (-dc[1] + dc[5] + 9 * dc[7] - 9 * dc[9] -
                          9 * dc[17] + 9 * dc[19] + dc[21] - dc[25])
                       : (dc[10] + dc[16] - 10 * dc[17] + 10 * dc[19] -
                          dc[2] - dc[20] + dc[22] - dc[24] + dc[4] - dc[6] +
                          10 * dc[7] - 10 * dc[9]));
        w[9] = predict(num, q11, al);
      }
      if ((al = bits[5]) != 0 && src[2] == 0) {
        const int64_t num =
            q00 * (change_dc
                       ? (2 * dc[7] - 5 * dc[8] + 2 * dc[9] + dc[11] +
                          7 * dc[12] - 14 * dc[13] + 7 * dc[14] + dc[15] +
                          2 * dc[17] - 5 * dc[18] + 2 * dc[19])
                       : (-dc[11] + 13 * dc[12] - 24 * dc[13] + 13 * dc[14] -
                          dc[15]));
        w[2] = predict(num, q02, al);
      }
      if (change_dc) {
        if ((al = bits[6]) != 0 && src[3] == 0)
          w[3] = predict(q00 * (dc[7] - dc[9] + 2 * dc[12] - 2 * dc[14] +
                                dc[17] - dc[19]),
                         q03, al);
        if ((al = bits[7]) != 0 && src[10] == 0)
          w[10] = predict(q00 * (dc[7] - 3 * dc[8] + dc[9] - dc[17] +
                                 3 * dc[18] - dc[19]),
                          q12, al);
        if ((al = bits[8]) != 0 && src[17] == 0)
          w[17] = predict(q00 * (dc[7] - dc[9] - 3 * dc[12] + 3 * dc[14] +
                                 dc[17] - dc[19]),
                          q21, al);
        if ((al = bits[9]) != 0 && src[24] == 0)
          w[24] = predict(q00 * (dc[7] + 2 * dc[8] + dc[9] - dc[17] -
                                 2 * dc[18] - dc[19]),
                          q30, al);
        const int64_t num =
            q00 * (-2 * dc[1] - 6 * dc[2] - 8 * dc[3] - 6 * dc[4] -
                   2 * dc[5] - 6 * dc[6] + 6 * dc[7] + 42 * dc[8] +
                   6 * dc[9] - 6 * dc[10] - 8 * dc[11] + 42 * dc[12] +
                   152 * dc[13] + 42 * dc[14] - 8 * dc[15] - 6 * dc[16] +
                   6 * dc[17] + 42 * dc[18] + 6 * dc[19] - 6 * dc[20] -
                   2 * dc[21] - 6 * dc[22] - 8 * dc[23] - 6 * dc[24] -
                   2 * dc[25]);
        w[0] = predict(num, q00, 0);
      }
    }
  }
  return out;
}

void smooth(Jpeg& j) {
  if (!smoothing_ok(j)) return;
  std::vector<int16_t> smoothed[kMaxComponents];
  for (int c = 0; c < j.ncomp; ++c) smoothed[c] = smooth_component(j, c);
  for (int c = 0; c < j.ncomp; ++c) j.comp[c].coef.swap(smoothed[c]);
}

// ---------------------------------------------------------------------------
// the back half: jidctint.c, jdsample.c, jdcolor.c
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                  F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                  F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                  F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t wrap16(int32_t x) { return int16_t(uint16_t(x)); }

inline int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : x > 32767 ? 32767 : x;
}

// One pass of jpeg_idct_islow over 8 values as libjpeg-turbo's SIMD code
// computes it (jidctint-sse2.asm, jidctint-avx2.asm): the sums x0 + x4,
// x0 - x4, x7 + x3 and x5 + x1 wrap at 16 bits; every other value is the
// exact one, which for 16-bit inputs fits 32 bits (where the SIMD code
// keeps it), so the C code's formulas are computed modulo 2^32 (unsigned)
// and give it.  o[k] are the 8 results before their descale.
inline void idct_pass(const int32_t* x, int32_t* o) {
  using U = uint32_t;
  const U z2 = U(x[2]), z3 = U(x[6]);
  const U z1 = (z2 + z3) * U(F_0_541);
  const U tmp2 = z1 - z3 * U(F_1_847), tmp3 = z1 + z2 * U(F_0_765);
  const U tmp0 = U(wrap16(x[0] + x[4])) << kConstBits;
  const U tmp1 = U(wrap16(x[0] - x[4])) << kConstBits;
  const U tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const U tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  U t0 = U(x[7]), t1 = U(x[5]), t2 = U(x[3]), t3 = U(x[1]);
  U a1 = t0 + t3, a2 = t1 + t2;
  U a3 = U(wrap16(x[7] + x[3])), a4 = U(wrap16(x[5] + x[1]));
  const U z5 = (a3 + a4) * U(F_1_175);
  t0 *= U(F_0_298);
  t1 *= U(F_2_053);
  t2 *= U(F_3_072);
  t3 *= U(F_1_501);
  a1 *= U(-F_0_899);
  a2 *= U(-F_2_562);
  a3 = a3 * U(-F_1_961) + z5;
  a4 = a4 * U(-F_0_390) + z5;
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  o[0] = int32_t(tmp10 + t3);
  o[7] = int32_t(tmp10 - t3);
  o[1] = int32_t(tmp11 + t2);
  o[6] = int32_t(tmp11 - t2);
  o[2] = int32_t(tmp12 + t1);
  o[5] = int32_t(tmp12 - t1);
  o[3] = int32_t(tmp13 + t0);
  o[4] = int32_t(tmp13 - t0);
}

inline uint8_t sample(int32_t x) {
  return uint8_t((x < -128 ? -128 : x > 127 ? 127 : x) + 128);
}

// jpeg_idct_islow on one block -> 8x8 samples at out (row stride
// `stride`), as libjpeg-turbo's SIMD code gives it on any coefficients:
// dequantized at 16 bits (pmullw), a block whose rows 1-7 are zero taking
// row 0 << PASS1_BITS at 16 bits, the first pass saturated to 16 bits,
// the output clamped to the sample range (jdmaster.c's range-limit table
// gives the same wherever its 10-bit index does not wrap).
void idct_islow(const int16_t* coef, const int* q, uint8_t* out,
                size_t stride) {
  int32_t ws[64], in[8], o[8];
  bool ac_zero = true;
  for (int i = 8; i < 64; ++i) ac_zero &= coef[i] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      const int32_t dc =
          wrap16(wrap16(int32_t(coef[c]) * q[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
    }
  } else {
    constexpr int n = kConstBits - kPass1Bits;
    for (int c = 0; c < 8; ++c) {  // columns
      for (int r = 0; r < 8; ++r)
        in[r] = wrap16(int32_t(coef[r * 8 + c]) * q[r * 8 + c]);
      idct_pass(in, o);
      for (int r = 0; r < 8; ++r)
        ws[r * 8 + c] = sat16((o[r] + (1 << (n - 1))) >> n);
    }
  }
  constexpr int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {  // rows
    idct_pass(ws + r * 8, o);
    uint8_t* p = out + r * stride;
    for (int c = 0; c < 8; ++c) p[c] = sample((o[c] + (1 << (n - 1))) >> n);
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

// The component at full size [H][W]: jdsample.c's method for its ratio
// (fancy at 2, boxes at any other ratio), over its dw x dh real samples.  Rows above the first and below the last
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
  if (rh > 2 || rv > 2) {  // int_upsample: rh x rv boxes
    for (int y = 0; y < H; ++y) {
      const uint8_t* a = in(y / rv);
      for (int x = 0; x < W; ++x) out[size_t(y) * W + x] = a[x / rh];
    }
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
  smooth(j);
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

uint32_t decode_jpeg(const uint8_t* d, size_t n, Image* out) {
  Jpeg j;
  parse(j, d, n);
  to_rgb(j, out);
  return j.src.warnings;
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
// 2 RGB, 3 CMYK, 4 YCCK), progressive, hmax, vmax, arithmetic; then for
// each component c at 8 + 6c: h, v, blocks across and down (the MCU
// grid's), samples across and down.
int decode_header(const uint8_t* data, size_t len, int32_t* info, char* err,
                  int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j;
    parse_header(j, data, len);
    const int32_t head[8] = {j.width, j.height, j.ncomp, j.color,
                             j.progressive, j.hmax, j.vmax, j.arith};
    std::memcpy(info, head, sizeof(head));
    for (int c = 0; c < j.ncomp; ++c) {
      const Component& k = j.comp[c];
      const int32_t v[6] = {k.h, k.v, k.bw, k.bh, k.dw, k.dh};
      std::memcpy(info + 8 + 6 * c, v, sizeof(v));
    }
  });
}

// quant: [components][64] natural order (0 where a component had no scan);
// coef: every component's blocks [bh][bw][64] in turn, natural order
// (`cap` int16 values at most); progress: [components][2][64], each
// component's coef_bits (the lowest bit of each coefficient known, -1
// none) and the same before its latest scan as smoothing takes it (-1
// after a single scan; zigzag order), then three values: the last iMCU
// row begun with data in the last scan, whether libjpeg smooths the
// blocks, the warnings.
int decode_coefficients(const uint8_t* data, size_t len, int32_t* quant,
                        int16_t* coef, size_t cap, int32_t* progress,
                        char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j;
    parse(j, data, len);
    size_t total = 0;
    for (int c = 0; c < j.ncomp; ++c) total += j.comp[c].coef.size();
    if (total > cap) fail("coefficient buffer too small");
    for (int c = 0; c < j.ncomp; ++c) {
      std::memcpy(quant + 64 * c, j.comp[c].quant, 64 * sizeof(int32_t));
      std::memcpy(coef, j.comp[c].coef.data(),
                  j.comp[c].coef.size() * sizeof(int16_t));
      coef += j.comp[c].coef.size();
      std::memcpy(progress + 128 * c, j.coef_bits[c], 64 * sizeof(int32_t));
      latched_prev(j, c, progress + 128 * c + 64);
    }
    int32_t* tail = progress + 128 * j.ncomp;
    tail[0] = j.last_good_row;
    tail[1] = smoothing_ok(j);
    tail[2] = int32_t(j.src.warnings);
  });
}

// out: [height][width][3] uint8 RGB (`cap` bytes at most); warnings: the
// bits of libjpeg's warnings the decode met.
int decode_rgb(const uint8_t* data, size_t len, uint8_t* out, size_t cap,
               uint32_t* warnings, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Image img;
    *warnings = decode_jpeg(data, len, &img);
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
