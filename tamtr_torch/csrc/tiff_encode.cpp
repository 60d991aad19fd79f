// TIFF LZW strip coder on the host, for the port's image writer
// (`tamtr_torch/data/image_io.py:encode_tiff`); the reverse of
// `tiff_decode.cpp:tiff_lzw_decode`. It emits libtiff's own code stream
// (`tif_lzw.c:LZWEncode`, `LZWPostEncode`), so a strip's bytes equal the
// ones libtiff writes for the same (predicted) samples:
//   - a Clear code (256) opens the strip and EOI (257) closes it;
//   - codes are packed MSB first, 9 to 12 bits wide, the width growing as
//     soon as the next free code would not fit ("early change");
//   - when the next free code reaches 4094 the table is cleared (Clear
//     written at the old width, the width back to 9);
//   - every CHECK_GAP (10000) input bytes since the last clear, libtiff
//     compares the compression ratio (input bytes << 8 over output bits)
//     with the one it saw at the previous check and clears the table when
//     it has not improved. The check runs only where a code was added
//     without the width growing, as in libtiff.
// The dictionary is a (code, byte) -> code table; libtiff's hash table
// finds the same strings, so the emitted codes are the same.
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

const int kClear = 256, kEoi = 257, kFirst = 258, kBitsMin = 9, kBitsMax = 12;
const int kCodeMax = (1 << kBitsMax) - 1;  // MAXCODE(BITS_MAX)
const long kCheckGap = 10000;

inline int MaxCode(int nbits) { return (1 << nbits) - 1; }

struct Writer {
  uint8_t* dst;
  long cap, n = 0;
  unsigned long data = 0;
  long bits = 0;
  void Byte(uint8_t b) {
    if (n < cap) dst[n] = b;
    ++n;
  }
  // libtiff's PutNextCode
  void Put(int code, int nbits) {
    data = (data << nbits) | static_cast<unsigned long>(code);
    bits += nbits;
    Byte(static_cast<uint8_t>((data >> (bits - 8)) & 0xff));
    bits -= 8;
    if (bits >= 8) {
      Byte(static_cast<uint8_t>((data >> (bits - 8)) & 0xff));
      bits -= 8;
    }
  }
};

}  // namespace

// Codes the `n` bytes at `src` as one strip into at most `cap` bytes at
// `dst`. Returns the strip's length, which may exceed `cap` (nothing is
// written past it; call again with a larger buffer).
extern "C" long tiff_lzw_encode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  Writer out{dst, cap};
  if (n <= 0) {
    out.Put(kEoi, kBitsMin);
    if (out.bits > 0) out.Byte(static_cast<uint8_t>((out.data << (8 - out.bits)) & 0xff));
    return out.n;
  }
  // child[code * 256 + byte]: the code of string(code) + byte, or 0
  std::vector<uint16_t> child(static_cast<size_t>(kCodeMax + 1) * 256, 0);
  std::vector<int> used;  // the slots filled since the last clear
  used.reserve(kCodeMax);
  auto clear_table = [&]() {
    for (int slot : used) child[slot] = 0;
    used.clear();
  };
  int nbits = kBitsMin, maxcode = MaxCode(kBitsMin), free_ent = kFirst;
  long incount = 0, outcount = 0, checkpoint = kCheckGap, ratio = 0;
  auto put = [&](int code) {
    out.Put(code, nbits);
    outcount += nbits;
  };
  put(kClear);
  int ent = src[0];
  incount = 1;
  for (long i = 1; i < n; ++i) {
    const int c = src[i];
    ++incount;
    const int slot = ent * 256 + c;
    if (child[slot]) {
      ent = child[slot];
      continue;
    }
    put(ent);
    ent = c;
    child[slot] = static_cast<uint16_t>(free_ent++);
    used.push_back(slot);
    if (free_ent == kCodeMax - 1) {  // the table is full
      clear_table();
      ratio = 0;
      incount = outcount = 0;
      free_ent = kFirst;
      put(kClear);
      nbits = kBitsMin;
      maxcode = MaxCode(kBitsMin);
    } else if (free_ent > maxcode) {
      ++nbits;
      maxcode = MaxCode(nbits);
    } else if (incount >= checkpoint) {
      checkpoint = incount + kCheckGap;
      long rat;
      if (incount > 0x007fffff) {
        rat = outcount >> 8;
        rat = rat == 0 ? 0x7fffffff : incount / rat;
      } else {
        rat = (incount << 8) / outcount;
      }
      if (rat <= ratio) {
        clear_table();
        ratio = 0;
        incount = outcount = 0;
        free_ent = kFirst;
        put(kClear);
        nbits = kBitsMin;
        maxcode = MaxCode(kBitsMin);
      } else {
        ratio = rat;
      }
    }
  }
  // LZWPostEncode: the pending string, then EOI at the width the next free
  // code asks for
  put(ent);
  ++free_ent;
  if (free_ent == kCodeMax - 1) {
    put(kClear);
    nbits = kBitsMin;
  } else if (free_ent > maxcode) {
    ++nbits;
  }
  put(kEoi);
  if (out.bits > 0) out.Byte(static_cast<uint8_t>((out.data << (8 - out.bits)) & 0xff));
  return out.n;
}
