// PNG's five row filters undone on the host, for eval/image_io.load_png.
//
// A PNG image (or an Adam7 pass of one) is h scanlines, each a filter-type
// byte and `stride` bytes filtered against the byte `bpp` to the left (a)
// and the bytes above (b) and above-left (c) in the unfiltered previous
// row (PNG specification, section 9):
//   0 None     x
//   1 Sub      x + a
//   2 Up       x + b
//   3 Average  x + floor((a + b) / 2)
//   4 Paeth    x + the one of a, b, c nearest to a + b - c (ties: a, b, c)
// all modulo 256, with a and c zero left of the row and b and c zero above
// the first row.  Average and Paeth depend on the byte just unfiltered, so
// they run byte by byte: the Python loops of eval/image_io.py (the plain
// version, `_unfilter_plain`) took about 0.8 s for a 1024x768 RGB image of
// Paeth rows.  Here every filter is a loop in C++, called through ctypes,
// which releases the GIL for the call.
//
// C entry point (ctypes, aqualora_torch/eval/image_io.py):
//   png_unfilter  h rows of 1 + stride bytes -> h rows of stride bytes
// It returns 0 on success, else writes its reason into `err`.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -ffp-contract=off

#include <cstdint>
#include <cstdio>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// data: h rows of (1 + stride) bytes, each a filter type then the filtered
// bytes; out: h * stride bytes; bpp >= 1, the filters' byte distance.
int png_unfilter(const uint8_t* data, int h, int stride, int bpp,
                 uint8_t* out, char* err, int errlen) {
  if (h < 0 || stride < 0 || bpp < 1) {
    std::snprintf(err, errlen, "bad PNG geometry: %d rows of %d bytes, "
                  "bpp %d", h, stride, bpp);
    return 1;
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = data + static_cast<size_t>(y) * (stride + 1);
    const uint8_t kind = row[0];
    const uint8_t* x = row + 1;
    uint8_t* o = out + static_cast<size_t>(y) * stride;
    const uint8_t* up = y ? o - stride : nullptr;
    switch (kind) {
      case 0:
        for (int i = 0; i < stride; ++i) o[i] = x[i];
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          o[i] = static_cast<uint8_t>(x[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i)
          o[i] = static_cast<uint8_t>(x[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          o[i] = static_cast<uint8_t>(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = up && i >= bpp ? up[i - bpp] : 0;
          o[i] = static_cast<uint8_t>(x[i] + paeth(a, b, c));
        }
        break;
      default:
        std::snprintf(err, errlen, "PNG row %d has filter type %d", y, kind);
        return 1;
    }
  }
  return 0;
}

}  // extern "C"
