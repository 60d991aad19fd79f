// TIFF strip and tile codecs on the host, for the port's image reader
// (`tamtr_torch/data/image_io.py:decode_tiff`): LZW (TIFF 6.0 section 13,
// codes MSB first, 9 to 12 bits, the width growing one code early as libtiff
// reads it) and PackBits (section 9). Deflate strips are inflated by zlib in
// Python; the container, the predictor and the colour conversion are numpy.
//
// Each function decodes `n` bytes at `src` into at most `cap` bytes at `dst`
// and returns the bytes written, or -1 on a corrupt stream. Output past
// `cap` is dropped (a strip may code more rows than the image has).
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" long tiff_lzw_decode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  const int kClear = 256, kEoi = 257;
  std::vector<int> prefix(4096), length(4096);
  std::vector<uint8_t> last(4096), first(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    length[i] = 1;
    last[i] = first[i] = static_cast<uint8_t>(i);
  }
  long out = 0;
  long bitpos = 0;
  const long nbits_total = n * 8;
  int width = 9, next = 258, prev = -1;
  // write entry `code` at `out` (clipped to cap), returning its length
  auto emit = [&](int code) -> long {
    const long len = length[code];
    long pos = out + len - 1;
    for (int c = code; c >= 0; c = prefix[c], --pos)
      if (pos < cap) dst[pos] = last[c];
    out += len;
    return len;
  };
  while (bitpos + width <= nbits_total) {
    int code = 0;
    for (int b = 0; b < width; ++b, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) return -1;
      emit(code);
      prev = code;
      continue;
    }
    if (code > next) return -1;
    if (next < 4096) {
      // the new entry: prev's string and the first byte of code's (or of
      // prev's, for the code not yet in the table)
      const uint8_t k = code < next ? first[code] : first[prev];
      prefix[next] = prev;
      last[next] = k;
      first[next] = first[prev];
      length[next] = length[prev] + 1;
    }
    emit(code);
    if (next < 4096) ++next;
    if (next >= (1 << width) - 1 && width < 12) ++width;
    prev = code;
  }
  return out < cap ? out : cap;
}

extern "C" long tiff_packbits_decode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  long i = 0, out = 0;
  while (i < n && out < cap) {
    const int c = static_cast<int8_t>(src[i++]);
    if (c >= 0) {
      const long len = c + 1;
      if (i + len > n) return -1;
      const long m = out + len <= cap ? len : cap - out;
      std::memcpy(dst + out, src + i, m);
      out += m;
      i += len;
    } else if (c != -128) {
      if (i >= n) return -1;
      const long len = 1 - c;
      const long m = out + len <= cap ? len : cap - out;
      std::memset(dst + out, src[i++], m);
      out += m;
    }
  }
  return out;
}
