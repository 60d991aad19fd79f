// PNG row unfiltering on the host (PNG spec, section 9), for the port's
// image reader (`tamtr_torch/data/image_io.py`). Average and Paeth rows are
// serial along the row, which numpy cannot vectorise; this loop reads all
// five filter types.
//
// raw: h rows of (1 filter byte + w * bpp bytes), as inflated from IDAT.
// out: h * w * bpp bytes. Returns 0, or 1 + the row whose filter byte is
// not 0-4.
#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* raw, uint8_t* out, int h, int w, int bpp) {
  const long stride = (long)w * bpp;
  for (int r = 0; r < h; ++r) {
    const uint8_t* f = raw + r * (stride + 1);
    const int type = f[0];
    ++f;
    uint8_t* cur = out + r * stride;
    const uint8_t* prev = r ? cur - stride : nullptr;
    for (long i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return 1 + r;
      }
      cur[i] = (uint8_t)(f[i] + pred);
    }
  }
  return 0;
}
