// PNG scanline unfiltering for the native host stage (the inflate runs in Python's
// zlib; the pixel layout and the colour conversion in numpy, data/png.py).
//
// `filtered` holds `height` rows of 1 + `stride` bytes: each row's filter type
// (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) followed by its filtered bytes. The
// unfiltered rows go to `out` (height * stride bytes). `bpp` is the bytes per
// complete pixel, rounded up to 1 (the PNG specification's left-neighbour
// distance). Returns 0, or 1 when a row has an unknown filter type.
//
// C ABI only, bound from Python via ctypes.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

int oct_png_unfilter(const uint8_t* filtered, uint8_t* out, int height, size_t stride, int bpp) {
  const uint8_t* prev = nullptr;  // the row above; zeros for the first row
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = filtered + static_cast<size_t>(y) * (stride + 1);
    uint8_t* row = out + static_cast<size_t>(y) * stride;
    const uint8_t type = src[0];
    ++src;
    switch (type) {
      case 0:
        for (size_t i = 0; i < stride; ++i) row[i] = src[i];
        break;
      case 1:
        for (size_t i = 0; i < stride; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (i >= static_cast<size_t>(bpp) ? row[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          const int left = i >= static_cast<size_t>(bpp) ? row[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          row[i] = static_cast<uint8_t>(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          const bool has_left = i >= static_cast<size_t>(bpp);
          const int left = has_left ? row[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          const int up_left = (has_left && prev) ? prev[i - bpp] : 0;
          row[i] = static_cast<uint8_t>(src[i] + paeth(left, up, up_left));
        }
        break;
      default:
        return 1;
    }
    prev = row;
  }
  return 0;
}

}  // extern "C"
