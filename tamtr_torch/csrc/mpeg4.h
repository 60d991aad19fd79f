// The MPEG-4 Part 2 (ISO/IEC 14496-2) pieces both sides of the port's
// video codec use (`mpeg4_decode.cpp`, `mpeg4_encode.cpp`): the
// variable-length code tables of the Simple profile (Annex B: MCBPC, CBPY,
// motion vector, intra DC size, and the intra and inter TCOEF tables with
// their run and level columns), the three scans, the DC scalers, a
// big-endian bit reader and writer, the 8x8 inverse DCT as FFmpeg's simple
// IDCT computes it (`ff_simple_idct_int16_8bit`: 14-bit weights, row shift
// 11, column shift 20, the DC-only row shortcut), the half-pel motion
// compensation with its two rounding modes over edges replicated past the
// macroblock-aligned picture, and YUV 4:2:0 to BGR as swscale's x86 converter does it
// (BT.601, limited range).
#pragma once

#include <cstdint>
#include <cstdlib>
#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace mpeg4 {

// ---------------------------------------------------------------- tables
// TCOEF (Tables B-16, B-17): {code, length} per symbol, symbol 102 the
// escape; symbols from kIntraLast / kInterLast on carry LAST = 1.
static const uint16_t kIntraVlc[206] = {
    2, 2, 6, 3, 15, 4, 13, 5, 12, 5, 21, 6, 19, 6, 18, 6,
    23, 7, 31, 8, 30, 8, 29, 8, 37, 9, 36, 9, 35, 9, 33, 9,
    33, 10, 32, 10, 15, 10, 14, 10, 7, 11, 6, 11, 32, 11, 33, 11,
    80, 12, 81, 12, 82, 12, 14, 4, 20, 6, 22, 7, 28, 8, 32, 9,
    31, 9, 13, 10, 34, 11, 83, 12, 85, 12, 11, 5, 21, 7, 30, 9,
    12, 10, 86, 12, 17, 6, 27, 8, 29, 9, 11, 10, 16, 6, 34, 9,
    10, 10, 13, 6, 28, 9, 8, 10, 18, 7, 27, 9, 84, 12, 20, 7,
    26, 9, 87, 12, 25, 8, 9, 10, 24, 8, 35, 11, 23, 8, 25, 9,
    24, 9, 7, 10, 88, 12, 7, 4, 12, 6, 22, 8, 23, 9, 6, 10,
    5, 11, 4, 11, 89, 12, 15, 6, 22, 9, 5, 10, 14, 6, 4, 10,
    17, 7, 36, 11, 16, 7, 37, 11, 19, 7, 90, 12, 21, 8, 91, 12,
    20, 8, 19, 8, 26, 8, 21, 9, 20, 9, 19, 9, 18, 9, 17, 9,
    38, 11, 39, 11, 92, 12, 93, 12, 94, 12, 95, 12, 3, 7,
};
static const uint8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0,
    0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20,
};
static const uint8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5,
    6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};
static const uint16_t kInterVlc[206] = {
    2, 2, 15, 4, 21, 6, 23, 7, 31, 8, 37, 9, 36, 9, 33, 10,
    32, 10, 7, 11, 6, 11, 32, 11, 6, 3, 20, 6, 30, 8, 15, 10,
    33, 11, 80, 12, 14, 4, 29, 8, 14, 10, 81, 12, 13, 5, 35, 9,
    13, 10, 12, 5, 34, 9, 82, 12, 11, 5, 12, 10, 83, 12, 19, 6,
    11, 10, 84, 12, 18, 6, 10, 10, 17, 6, 9, 10, 16, 6, 8, 10,
    22, 7, 85, 12, 21, 7, 20, 7, 28, 8, 27, 8, 33, 9, 32, 9,
    31, 9, 30, 9, 29, 9, 28, 9, 27, 9, 26, 9, 34, 11, 35, 11,
    86, 12, 87, 12, 7, 4, 25, 9, 5, 11, 15, 6, 4, 11, 14, 6,
    13, 6, 12, 6, 19, 7, 18, 7, 17, 7, 16, 7, 26, 8, 25, 8,
    24, 8, 23, 8, 22, 8, 21, 8, 20, 8, 19, 8, 24, 9, 23, 9,
    22, 9, 21, 9, 20, 9, 19, 9, 18, 9, 17, 9, 7, 10, 6, 10,
    5, 10, 4, 10, 36, 11, 37, 11, 38, 11, 39, 11, 88, 12, 89, 12,
    90, 12, 91, 12, 92, 12, 93, 12, 94, 12, 95, 12, 3, 7,
};
static const uint8_t kInterRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3,
    3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40,
};
static const uint8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};
static const uint8_t kAltH[64] = {
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63,
};
static const uint8_t kAltV[64] = {
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63,
};
static const uint8_t kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

const int kTcoefEscape = 102;
const int kIntraLast = 67;
const int kInterLast = 58;

// MCBPC of I-VOPs: symbol = (dquant << 2) | cbpc, 8 = stuffing.
const uint8_t kIntraMcbpcCode[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
const uint8_t kIntraMcbpcBits[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
// MCBPC of P-VOPs: symbol = (4mv << 4) | (dquant << 3) | (intra << 2) | cbpc,
// 20 = stuffing (lengths 0 mark unused symbols).
const uint8_t kInterMcbpcCode[28] = {1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6, 5, 4, 4, 3, 2,
                                     2, 5, 4, 5, 1, 0, 0, 0, 2, 12, 14, 15};
const uint8_t kInterMcbpcBits[28] = {1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7, 9, 6, 9, 9, 9,
                                     3, 7, 7, 8, 9, 0, 0, 0, 11, 13, 13, 13};
// CBPY: symbol = cbpy of an intra macroblock (15 - cbpy for inter).
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                              {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// motion vector magnitude 0..32 (the sign follows as one bit)
const uint8_t kMv[33][2] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7},
                            {11, 9}, {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10},
                            {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10}, {7, 10}, {6, 10}, {5, 10},
                            {4, 10}, {7, 11}, {6, 11}, {5, 11}, {4, 11}, {3, 11}, {2, 11}, {3, 12},
                            {2, 12}};
// intra DC size (Tables B-13, B-14)
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
const uint8_t kYDcScale[32] = {0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
                               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDquant[4] = {-1, -2, 1, 2};

// The largest level of each (last, run) and the largest run of each
// (last, level) of a TCOEF table: what escapes 1 and 2 add.
struct RunLevelLimits {
  int max_level[2][64];
  int max_run[2][64];
  RunLevelLimits(const uint8_t* run, const uint8_t* level, int last) {
    std::memset(max_level, 0, sizeof(max_level));
    std::memset(max_run, 0, sizeof(max_run));
    for (int i = 0; i < 102; ++i) {
      const int l = i >= last;
      if (level[i] > max_level[l][run[i]]) max_level[l][run[i]] = level[i];
      if (run[i] > max_run[l][level[i]]) max_run[l][level[i]] = run[i];
    }
  }
};

// ------------------------------------------------------------ bit reader
struct BitReader {
  const uint8_t* data;
  long size_bits;
  long pos = 0;
  BitReader(const uint8_t* d, long n) : data(d), size_bits(n * 8) {}
  // the next k <= 32 bits (zeros past the end)
  uint32_t Peek(int k) const {
    if (k == 0) return 0;
    const long byte = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) {
      const long b = byte + i;
      v = (v << 8) | (b < (size_bits >> 3) && b >= 0 ? data[b] : 0);
    }
    return static_cast<uint32_t>((v << (pos & 7)) >> (64 - k));
  }
  uint32_t Read(int k) { const uint32_t v = Peek(k); pos += k; return v; }
  int Bit() { return static_cast<int>(Read(1)); }
  int SRead(int k) { const uint32_t v = Read(k); return static_cast<int>(v << (32 - k)) >> (32 - k); }
  void Skip(int k) { pos += k; }
  bool Over() const { return pos > size_bits; }
  long Left() const { return size_bits - pos; }
};

// ------------------------------------------------------------ bit writer
struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void Put(uint32_t v, int k) {
    if (k == 0) return;
    acc = (acc << k) | (v & ((k == 32) ? 0xffffffffu : ((1u << k) - 1)));
    n += k;
    while (n >= 8) { out.push_back(static_cast<uint8_t>(acc >> (n - 8))); n -= 8; }
  }
  long Bits() const { return static_cast<long>(out.size()) * 8 + n; }
  // MPEG-4 next_start_code(): a zero bit, then ones up to the byte boundary
  void Stuff() { Put(0, 1); while (n) Put(1, 1); }
  void StartCode(uint32_t code) { Put(0, 16); Put(1, 8); Put(code, 8); }
};

// --------------------------------------------------------- VLC lookup
// A table of 2^bits entries indexed by the next `bits` bits: the symbol
// whose code prefixes them and its length (length 0: no such code).
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  Vlc(const uint8_t (*codes)[2], int n) { Build([&](int i, int& c, int& l) { c = codes[i][0]; l = codes[i][1]; }, n); }
  Vlc(const uint8_t* code, const uint8_t* bits_, int n) { Build([&](int i, int& c, int& l) { c = code[i]; l = bits_[i]; }, n); }
  Vlc(const uint16_t* pairs, int n) { Build([&](int i, int& c, int& l) { c = pairs[2 * i]; l = pairs[2 * i + 1]; }, n); }
  template <class F> void Build(F get, int n) {
    for (int i = 0; i < n; ++i) { int c, l; get(i, c, l); if (l > bits) bits = l; }
    sym.assign(1u << bits, -1);
    len.assign(1u << bits, 0);
    for (int i = 0; i < n; ++i) {
      int c, l; get(i, c, l);
      if (!l) continue;
      const uint32_t first = static_cast<uint32_t>(c) << (bits - l), count = 1u << (bits - l);
      for (uint32_t j = 0; j < count; ++j) { sym[first + j] = static_cast<int16_t>(i); len[first + j] = static_cast<uint8_t>(l); }
    }
  }
  // the next symbol, or -1 (the reader is then left where it was)
  int Read(BitReader& br) const {
    const uint32_t k = br.Peek(bits);
    if (!len[k]) return -1;
    br.Skip(len[k]);
    return sym[k];
  }
};

// ------------------------------------------------------------------ IDCT
// FFmpeg's simple IDCT on int16 coefficients in raster order, rows first.
const int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
const int ROW_SHIFT = 11, COL_SHIFT = 20, DC_SHIFT = 3;

inline void IdctRow(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    const int16_t t = static_cast<int16_t>(static_cast<uint16_t>(row[0] * (1 << DC_SHIFT)));
    for (int i = 0; i < 8; ++i) row[i] = t;
    return;
  }
  int a0 = W4 * row[0] + (1 << (ROW_SHIFT - 1)), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * row[2]; a1 += W6 * row[2]; a2 -= W6 * row[2]; a3 -= W2 * row[2];
  int b0 = W1 * row[1] + W3 * row[3];
  int b1 = W3 * row[1] - W7 * row[3];
  int b2 = W5 * row[1] - W1 * row[3];
  int b3 = W7 * row[1] - W5 * row[3];
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += W4 * row[4] + W6 * row[6];
    a1 += -W4 * row[4] - W2 * row[6];
    a2 += -W4 * row[4] + W2 * row[6];
    a3 += W4 * row[4] - W6 * row[6];
    b0 += W5 * row[5] + W7 * row[7];
    b1 += -W1 * row[5] - W5 * row[7];
    b2 += W7 * row[5] + W3 * row[7];
    b3 += W3 * row[5] - W1 * row[7];
  }
  row[0] = static_cast<int16_t>((a0 + b0) >> ROW_SHIFT);
  row[7] = static_cast<int16_t>((a0 - b0) >> ROW_SHIFT);
  row[1] = static_cast<int16_t>((a1 + b1) >> ROW_SHIFT);
  row[6] = static_cast<int16_t>((a1 - b1) >> ROW_SHIFT);
  row[2] = static_cast<int16_t>((a2 + b2) >> ROW_SHIFT);
  row[5] = static_cast<int16_t>((a2 - b2) >> ROW_SHIFT);
  row[3] = static_cast<int16_t>((a3 + b3) >> ROW_SHIFT);
  row[4] = static_cast<int16_t>((a3 - b3) >> ROW_SHIFT);
}

// one column's eight outputs (before clamping) into out[0..7]
inline void IdctCol(const int16_t* col, int* out) {
  int a0 = W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * col[16]; a1 += W6 * col[16]; a2 += -W6 * col[16]; a3 += -W2 * col[16];
  int b0 = W1 * col[8] + W3 * col[24];
  int b1 = W3 * col[8] - W7 * col[24];
  int b2 = W5 * col[8] - W1 * col[24];
  int b3 = W7 * col[8] - W5 * col[24];
  a0 += W4 * col[32]; a1 -= W4 * col[32]; a2 -= W4 * col[32]; a3 += W4 * col[32];
  b0 += W5 * col[40]; b1 -= W1 * col[40]; b2 += W7 * col[40]; b3 += W3 * col[40];
  a0 += W6 * col[48]; a1 -= W2 * col[48]; a2 += W2 * col[48]; a3 -= W6 * col[48];
  b0 += W7 * col[56]; b1 -= W5 * col[56]; b2 += W3 * col[56]; b3 -= W1 * col[56];
  out[0] = (a0 + b0) >> COL_SHIFT; out[1] = (a1 + b1) >> COL_SHIFT;
  out[2] = (a2 + b2) >> COL_SHIFT; out[3] = (a3 + b3) >> COL_SHIFT;
  out[4] = (a3 - b3) >> COL_SHIFT; out[5] = (a2 - b2) >> COL_SHIFT;
  out[6] = (a1 - b1) >> COL_SHIFT; out[7] = (a0 - b0) >> COL_SHIFT;
}

inline uint8_t Clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// block (raster, destroyed) -> dst, written (add = false) or added
inline void Idct(int16_t* block, uint8_t* dst, long stride, bool add) {
  for (int i = 0; i < 8; ++i) IdctRow(block + 8 * i);
  int out[8];
  for (int x = 0; x < 8; ++x) {
    IdctCol(block + x, out);
    for (int y = 0; y < 8; ++y) {
      uint8_t& d = dst[y * stride + x];
      d = Clip8(add ? d + out[y] : out[y]);
    }
  }
}

// ------------------------------------------------ motion compensation
// A plane whose samples outside [0, w) x [0, h) repeat its edges.
struct PlaneRef {
  const uint8_t* p;
  long stride;
  int w, h;
  inline int At(int x, int y) const {
    x = x < 0 ? 0 : x >= w ? w - 1 : x;
    y = y < 0 ? 0 : y >= h ? h - 1 : y;
    return p[y * stride + x];
  }
};

// The size x size prediction at integer (x, y) and half-pel phase dxy
// (bit 0 horizontal, bit 1 vertical); no_rnd: the VOP's rounding_type 1.
inline void HpelPredict(const PlaneRef& ref, int x, int y, int dxy, int size, bool no_rnd, uint8_t* dst,
                        long stride) {
  uint8_t src[17 * 17];
  const bool inside = x >= 0 && y >= 0 && x + size + 1 <= ref.w && y + size + 1 <= ref.h;
  for (int j = 0; j <= size; ++j)
    for (int i = 0; i <= size; ++i)
      src[j * 17 + i] = static_cast<uint8_t>(inside ? ref.p[(y + j) * ref.stride + x + i] : ref.At(x + i, y + j));
  const int r1 = no_rnd ? 0 : 1, r2 = no_rnd ? 1 : 2;
  for (int j = 0; j < size; ++j)
    for (int i = 0; i < size; ++i) {
      const uint8_t* s = src + j * 17 + i;
      int v;
      switch (dxy) {
        case 0: v = s[0]; break;
        case 1: v = (s[0] + s[1] + r1) >> 1; break;
        case 2: v = (s[0] + s[17] + r1) >> 1; break;
        default: v = (s[0] + s[1] + s[17] + s[18] + r2) >> 2; break;
      }
      dst[j * stride + i] = static_cast<uint8_t>(v);
    }
}

// ------------------------------------------------------- YUV -> BGR
// Limited-range BT.601 YUV 4:2:0 to BGR as swscale converts yuv420p to
// bgr24 on x86 (`yuv420_bgr24_ssse3`, which cv2's FFmpeg backend runs for
// a frame of even height): each chroma sample serves its 2x2 luma block,
// the samples are scaled by 8 and multiplied by 16-bit coefficients
// keeping the high word (`pmulhw`); the coefficients are swscale's
// (`ff_yuv2rgb_c_init_tables`: the BT.601 inverse table times 2^13,
// rounded to 16 bits).
struct YuvToBgr {
  int yc, yo, vr, ub, ug, vg;
  static int Round16(int64_t x) { return static_cast<int>((x + 0x8000) >> 16); }
  YuvToBgr() {
    const int64_t cy = (int64_t{1} << 16) * 255 / 219, oy = int64_t{16} << 16;
    yc = Round16(cy * 8192);
    yo = Round16(oy * 8);
    vr = Round16(104597LL * 8192);
    ub = Round16(132201LL * 8192);
    ug = Round16(-25675LL * 8192);
    vg = Round16(-53279LL * 8192);
  }
  void Convert(const uint8_t* y, long ys, const uint8_t* u, const uint8_t* v, long cs, int w, int h,
               uint8_t* bgr) const {
    for (int j = 0; j < h; ++j) {
      const uint8_t* yr = y + j * ys;
      const uint8_t* ur = u + (j >> 1) * cs;
      const uint8_t* vr_ = v + (j >> 1) * cs;
      uint8_t* o = bgr + static_cast<long>(j) * w * 3;
      for (int i = 0; i < w; ++i, o += 3) {
        const int yy = (((yr[i] << 3) - yo) * yc) >> 16;
        const int uu = (ur[i >> 1] << 3) - 1024, vv = (vr_[i >> 1] << 3) - 1024;
        o[0] = Clip8(yy + ((uu * ub) >> 16));
        o[1] = Clip8(yy + ((uu * ug) >> 16) + ((vv * vg) >> 16));
        o[2] = Clip8(yy + ((vv * vr) >> 16));
      }
    }
  }
};

// --------------------------------------------------------- decoder
// The decoder (FFmpeg's `mpeg4` decoder on Simple-profile I/P streams); the
// encoder reconstructs its reference frames by running it on what it wrote.
inline const Vlc& IntraMcbpc() { static const Vlc v(kIntraMcbpcCode, kIntraMcbpcBits, 9); return v; }
inline const Vlc& InterMcbpc() { static const Vlc v(kInterMcbpcCode, kInterMcbpcBits, 28); return v; }
inline const Vlc& Cbpy() { static const Vlc v(kCbpy, 16); return v; }
inline const Vlc& MvVlc() { static const Vlc v(kMv, 33); return v; }
inline const Vlc& DcLum() { static const Vlc v(kDcLum, 13); return v; }
inline const Vlc& DcChrom() { static const Vlc v(kDcChrom, 13); return v; }
inline const Vlc& IntraTcoef() { static const Vlc v(kIntraVlc, 103); return v; }
inline const Vlc& InterTcoef() { static const Vlc v(kInterVlc, 103); return v; }
inline const RunLevelLimits& IntraLimits() { static const RunLevelLimits r(kIntraRun, kIntraLevel, kIntraLast); return r; }
inline const RunLevelLimits& InterLimits() { static const RunLevelLimits r(kInterRun, kInterLevel, kInterLast); return r; }

// counters of what a stream used, read by the tests that hold each tool
// against cv2's decode
enum Stat {
  kIVops, kPVops, kIntraMbs, kIntraMbsInP, kInterMbs, kSkippedMbs, kAcPred, kDquantMbs, kEsc1, kEsc2, kEsc3,
  kHalfPel, kMvOutside, kRounding1, kNotCodedBlocks, kAcRescaled, kStatCount
};

struct Unsupported {
  std::string what;
};
struct Corrupt {
  std::string what;
};

struct Frame {
  int w = 0, h = 0;  // macroblock-aligned
  std::vector<uint8_t> y, u, v;
  void Alloc(int mbw, int mbh) {
    w = mbw * 16; h = mbh * 16;
    y.assign(static_cast<size_t>(w) * h, 0);
    u.assign(static_cast<size_t>(w / 2) * (h / 2), 0);
    v.assign(static_cast<size_t>(w / 2) * (h / 2), 0);
  }
};

struct Decoder {
  uint32_t fourcc;
  // VOL
  bool have_vol = false;
  int width = 0, height = 0, mbw = 0, mbh = 0;
  int time_bits = 1;
  int vo_type = 0, vol_control = 0;
  // user data
  int lavc = -1, xvid = -1, divx = -1;
  // state
  Frame cur, ref;
  bool have_ref = false, have_frame = false;
  int qscale = 1;
  bool ac_pred = false;
  std::vector<int16_t> dc[3];   // luma (2 mbh + 1) x (2 mbw + 1), chroma (mbh + 1) x (mbw + 1), row/col 0 border
  std::vector<int16_t> ac[3];   // 16 per entry: [1..7] first column, [9..15] first row
  std::vector<int8_t> mb_q;     // qscale per macroblock
  std::vector<int16_t> mv;      // (mbh + 1) x (mbw + 2) x 2, border row 0, columns 0 and mbw + 1
  long stats[kStatCount] = {0};

  explicit Decoder(uint32_t tag) : fourcc(tag) {}

  int DcStride(int c) const { return c == 0 ? 2 * mbw + 1 : mbw + 1; }

  void Configure(int w, int h) {
    if (have_vol && (w != width || h != height)) throw Unsupported{"a change of frame size within the stream"};
    width = w; height = h;
    mbw = (w + 15) / 16; mbh = (h + 15) / 16;
    if (!have_vol) {
      cur.Alloc(mbw, mbh);
      ref.Alloc(mbw, mbh);
      dc[0].assign(static_cast<size_t>(2 * mbh + 1) * (2 * mbw + 1), 1024);
      ac[0].assign(dc[0].size() * 16, 0);
      for (int c = 1; c < 3; ++c) {
        dc[c].assign(static_cast<size_t>(mbh + 1) * (mbw + 1), 1024);
        ac[c].assign(dc[c].size() * 16, 0);
      }
      mb_q.assign(static_cast<size_t>(mbw) * mbh, 0);
      mv.assign(static_cast<size_t>(mbh + 1) * (mbw + 2) * 2, 0);
    }
    have_vol = true;
  }

  // ------------------------------------------------------------ headers
  void ParseUserData(const uint8_t* p, long n) {
    std::string s(reinterpret_cast<const char*>(p), static_cast<size_t>(n < 255 ? n : 255));
    if (s.compare(0, 4, "DivX") == 0) divx = 1;
    if (s.compare(0, 4, "XviD") == 0) xvid = 1;
    if (s.compare(0, 4, "Lavc") == 0 || s.compare(0, 5, "FFmpe") == 0 || s == "ffmpeg") lavc = 1;
  }

  void ParseVol(BitReader& br) {
    br.Skip(1);  // random_accessible_vol
    vo_type = static_cast<int>(br.Read(8));
    int ver = 1;
    if (br.Bit()) { ver = static_cast<int>(br.Read(4)); br.Skip(3); }
    if (br.Read(4) == 15) br.Skip(16);  // extended pixel aspect ratio
    vol_control = br.Bit();
    if (vol_control) {
      if (br.Read(2) != 1) throw Unsupported{"a chroma format other than 4:2:0"};
      br.Skip(1);  // low_delay
      if (br.Bit()) br.Skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);
    }
    if (br.Read(2) != 0) throw Unsupported{"a video object layer shape other than rectangular"};
    br.Skip(1);
    const int resolution = static_cast<int>(br.Read(16));
    if (resolution == 0) throw Corrupt{"vop_time_increment_resolution 0"};
    time_bits = 1;
    while ((1 << time_bits) < resolution) ++time_bits;
    br.Skip(1);
    if (br.Bit()) br.Skip(time_bits);  // fixed_vop_rate
    br.Skip(1);
    const int w = static_cast<int>(br.Read(13));
    br.Skip(1);
    const int h = static_cast<int>(br.Read(13));
    br.Skip(1);
    if (w <= 0 || h <= 0) throw Corrupt{"a zero frame size"};
    if (br.Bit()) throw Unsupported{"interlaced video"};
    br.Skip(1);  // obmc_disable
    if (br.Read(ver == 1 ? 1 : 2)) throw Unsupported{"sprites (S-VOPs, global motion compensation)"};
    if (br.Bit()) throw Unsupported{"more than 8 bits per pixel"};
    if (br.Bit()) throw Unsupported{"MPEG quantisation (quant_type 1)"};
    if (ver != 1 && br.Bit()) throw Unsupported{"quarter-pel motion"};
    if (!br.Bit()) throw Unsupported{"complexity estimation headers"};
    if (!br.Bit()) throw Unsupported{"resync markers (video packets)"};
    if (br.Bit()) throw Unsupported{"data partitioning (and reversible VLCs)"};
    if (ver != 1) {
      if (br.Bit()) throw Unsupported{"newpred"};
      if (br.Bit()) throw Unsupported{"reduced-resolution VOPs"};
    }
    if (br.Bit()) throw Unsupported{"scalability"};
    if (br.Over()) throw Corrupt{"a truncated video object layer header"};
    Configure(w, h);
  }

  void CheckEncoder() const {
    if (xvid >= 0) throw Unsupported{"an XviD-encoded stream (FFmpeg decodes it with the Xvid IDCT)"};
    if (divx >= 0) throw Unsupported{"a DivX-encoded stream (FFmpeg applies DivX workarounds)"};
    if (lavc < 0) {
      static const char* xvid_tags[] = {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"};
      for (const char* t : xvid_tags)
        if (fourcc == (static_cast<uint32_t>(t[0]) | (t[1] << 8) | (t[2] << 16) | (static_cast<uint32_t>(t[3]) << 24)))
          throw Unsupported{"an XVID-tagged stream with no encoder name (FFmpeg decodes it with the Xvid IDCT)"};
      if (fourcc == 0x58564944u /* DIVX */ && vo_type == 0 && vol_control == 0)
        throw Unsupported{"a DIVX-tagged stream with no encoder name (FFmpeg applies DivX 4 workarounds)"};
    }
  }

  // ------------------------------------------------------------ blocks
  void SetQ(int q) { qscale = q < 1 ? 1 : q > 31 ? 31 : q; }

  // DC prediction (FFmpeg's ff_mpeg4_pred_dc): returns the predicted
  // quantized DC plus `level`; stores its reconstruction in the table
  int PredDc(int n, int mbx, int mby, int level, int* dir) {
    const int c = n < 4 ? 0 : n - 3;
    const int stride = DcStride(c);
    const int bx = c == 0 ? 2 * mbx + (n & 1) + 1 : mbx + 1;
    const int by = c == 0 ? 2 * mby + (n >> 1) + 1 : mby + 1;
    int16_t* t = dc[c].data();
    const int idx = by * stride + bx;
    const int a = t[idx - 1], b = t[idx - 1 - stride], cc = t[idx - stride];
    int pred;
    if (std::abs(a - b) < std::abs(b - cc)) { pred = cc; *dir = 1; } else { pred = a; *dir = 0; }
    const int scale = n < 4 ? kYDcScale[qscale] : kCDcScale[qscale];
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int rec = level * scale;
    if (rec & ~2047) rec = rec < 0 ? 0 : 2047;
    t[idx] = static_cast<int16_t>(rec);
    return level;
  }

  int16_t* AcEntry(int n, int mbx, int mby) {
    const int c = n < 4 ? 0 : n - 3;
    const int stride = DcStride(c);
    const int bx = c == 0 ? 2 * mbx + (n & 1) + 1 : mbx + 1;
    const int by = c == 0 ? 2 * mby + (n >> 1) + 1 : mby + 1;
    return ac[c].data() + static_cast<size_t>(by * stride + bx) * 16;
  }

  static int RoundedDiv(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

  // AC prediction (FFmpeg's ff_mpeg4_pred_ac) on raster-order raw levels
  void PredAc(int16_t* block, int n, int mbx, int mby, int dir) {
    int16_t* acv = AcEntry(n, mbx, mby);
    if (ac_pred) {
      if (dir == 0) {
        const int16_t* left = acv - 16;
        const int q = mbx > 0 ? mb_q[mby * mbw + mbx - 1] : qscale;
        if (mbx == 0 || q == qscale || n == 1 || n == 3) {
          for (int i = 1; i < 8; ++i) block[i * 8] = static_cast<int16_t>(block[i * 8] + left[i]);
        } else {
          ++stats[kAcRescaled];
          for (int i = 1; i < 8; ++i) block[i * 8] = static_cast<int16_t>(block[i * 8] + RoundedDiv(left[i] * q, qscale));
        }
      } else {
        const int c = n < 4 ? 0 : n - 3;
        const int16_t* top = acv - 16 * DcStride(c);
        const int q = mby > 0 ? mb_q[(mby - 1) * mbw + mbx] : qscale;
        if (mby == 0 || q == qscale || n == 2 || n == 3) {
          for (int i = 1; i < 8; ++i) block[i] = static_cast<int16_t>(block[i] + top[i + 8]);
        } else {
          ++stats[kAcRescaled];
          for (int i = 1; i < 8; ++i) block[i] = static_cast<int16_t>(block[i] + RoundedDiv(top[i + 8] * q, qscale));
        }
      }
    }
    for (int i = 1; i < 8; ++i) acv[i] = block[i * 8];
    for (int i = 1; i < 8; ++i) acv[8 + i] = block[i];
  }

  // TCOEF run-level decoding into block (raster) along `scan` from
  // position i + 1; levels scaled by qmul / qadd as FFmpeg's decoder does
  // while parsing (intra: 1 / 0, scaled later)
  void DecodeCoeffs(BitReader& br, int16_t* block, bool intra, const uint8_t* scan, int i, int qmul, int qadd) {
    const Vlc& vlc = intra ? IntraTcoef() : InterTcoef();
    const uint8_t* trun = intra ? kIntraRun : kInterRun;
    const uint8_t* tlev = intra ? kIntraLevel : kInterLevel;
    const int lastidx = intra ? kIntraLast : kInterLast;
    const RunLevelLimits& lim = intra ? IntraLimits() : InterLimits();
    for (;;) {
      int sym = vlc.Read(br);
      if (sym < 0) throw Corrupt{"an invalid TCOEF code"};
      int level, last;
      if (sym == kTcoefEscape) {
        if (!br.Bit()) {  // escape 1: level offset
          sym = vlc.Read(br);
          if (sym < 0 || sym == kTcoefEscape) throw Corrupt{"an invalid TCOEF escape"};
          last = sym >= lastidx;
          const int run = trun[sym];
          level = (tlev[sym] + lim.max_level[last][run]) * qmul + qadd;
          i += run + 1;
          if (br.Bit()) level = -level;
          ++stats[kEsc1];
        } else if (!br.Bit()) {  // escape 2: run offset
          sym = vlc.Read(br);
          if (sym < 0 || sym == kTcoefEscape) throw Corrupt{"an invalid TCOEF escape"};
          last = sym >= lastidx;
          level = tlev[sym] * qmul + qadd;
          i += trun[sym] + lim.max_run[last][tlev[sym]] + 2;
          if (br.Bit()) level = -level;
          ++stats[kEsc2];
        } else {  // escape 3: fixed length
          last = br.Bit();
          const int run = static_cast<int>(br.Read(6));
          if (!br.Bit()) throw Corrupt{"a missing marker in a TCOEF escape"};
          level = br.SRead(12);
          if (!br.Bit()) throw Corrupt{"a missing marker in a TCOEF escape"};
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          if (level + 2048 < 0 || level + 2048 > 4095) level = level < 0 ? -2048 : 2047;
          i += run + 1;
          ++stats[kEsc3];
        }
      } else {
        last = sym >= lastidx;
        level = tlev[sym] * qmul + qadd;
        i += trun[sym] + 1;
        if (br.Bit()) level = -level;
      }
      if (i > 63) throw Corrupt{"a TCOEF run past the block"};
      block[scan[i]] = static_cast<int16_t>(level);
      if (last) return;
    }
  }

  // one intra block: DC, AC, AC prediction, inverse quantisation, IDCT
  void IntraBlock(BitReader& br, int n, int mbx, int mby, bool coded) {
    int16_t block[64] = {0};
    const Vlc& dcv = n < 4 ? DcLum() : DcChrom();
    const int size = dcv.Read(br);
    if (size < 0) throw Corrupt{"an invalid intra DC size"};
    int diff = 0;
    if (size) {
      const uint32_t v = br.Read(size);
      diff = (v >> (size - 1)) ? static_cast<int>(v) : static_cast<int>(v) - ((1 << size) - 1);
      if (size > 8 && !br.Bit()) throw Corrupt{"a missing marker after an intra DC"};
    }
    int dir;
    block[0] = static_cast<int16_t>(PredDc(n, mbx, mby, diff, &dir));
    if (coded) {
      const uint8_t* scan = ac_pred ? (dir == 0 ? kAltV : kAltH) : kZigzag;
      DecodeCoeffs(br, block, true, scan, 0, 1, 0);
    } else {
      ++stats[kNotCodedBlocks];
    }
    PredAc(block, n, mbx, mby, dir);
    // H.263 inverse quantisation of an intra block
    block[0] = static_cast<int16_t>(block[0] * (n < 4 ? kYDcScale[qscale] : kCDcScale[qscale]));
    const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
    for (int i = 1; i < 64; ++i) {
      const int l = block[i];
      if (l) block[i] = static_cast<int16_t>(l < 0 ? l * qmul - qadd : l * qmul + qadd);
    }
    uint8_t* dst;
    long stride;
    BlockDest(n, mbx, mby, &dst, &stride);
    Idct(block, dst, stride, false);
  }

  void BlockDest(int n, int mbx, int mby, uint8_t** dst, long* stride) {
    if (n < 4) {
      *stride = cur.w;
      *dst = cur.y.data() + static_cast<long>(mby * 16 + (n >> 1) * 8) * cur.w + mbx * 16 + (n & 1) * 8;
    } else {
      *stride = cur.w / 2;
      *dst = (n == 4 ? cur.u.data() : cur.v.data()) + static_cast<long>(mby * 8) * (cur.w / 2) + mbx * 8;
    }
  }

  void CleanIntraTables(int mbx, int mby) {
    for (int n = 0; n < 6; ++n) {
      const int c = n < 4 ? 0 : n - 3;
      const int stride = DcStride(c);
      const int bx = c == 0 ? 2 * mbx + (n & 1) + 1 : mbx + 1;
      const int by = c == 0 ? 2 * mby + (n >> 1) + 1 : mby + 1;
      dc[c][by * stride + bx] = 1024;
      std::memset(ac[c].data() + static_cast<size_t>(by * stride + bx) * 16, 0, 16 * sizeof(int16_t));
    }
  }

  int16_t* Mv(int mbx, int mby) { return mv.data() + (static_cast<size_t>(mby + 1) * (mbw + 2) + mbx + 1) * 2; }

  static int Median(int a, int b, int c) {
    return a > b ? (b > c ? b : (a > c ? c : a)) : (a > c ? a : (b > c ? c : b));
  }

  int DecodeMotion(BitReader& br, int pred, int fcode) {
    const int code = MvVlc().Read(br);
    if (code < 0) throw Corrupt{"an invalid motion vector code"};
    if (code == 0) return pred;
    const int sign = br.Bit();
    const int shift = fcode - 1;
    int val = code;
    if (shift) { val = (val - 1) << shift; val |= static_cast<int>(br.Read(shift)); ++val; }
    if (sign) val = -val;
    val += pred;
    const int bits = 5 + fcode;  // wrap into [-32 f, 32 f)
    return static_cast<int>(static_cast<uint32_t>(val) << (32 - bits)) >> (32 - bits);
  }

  void MotionCompensate(int mbx, int mby, int mx, int my, bool no_rnd) {
    // FFmpeg's edges are those of whole macroblocks (h_edge_pos, v_edge_pos)
    const PlaneRef ry{ref.y.data(), ref.w, ref.w, ref.h};
    const PlaneRef ru{ref.u.data(), ref.w / 2, ref.w / 2, ref.h / 2};
    const PlaneRef rv{ref.v.data(), ref.w / 2, ref.w / 2, ref.h / 2};
    const int dxy = ((my & 1) << 1) | (mx & 1);
    const int sx = mbx * 16 + (mx >> 1), sy = mby * 16 + (my >> 1);
    if (dxy) ++stats[kHalfPel];
    if (sx < 0 || sy < 0 || sx + 16 + (mx & 1) > ref.w || sy + 16 + (my & 1) > ref.h) ++stats[kMvOutside];
    HpelPredict(ry, sx, sy, dxy, 16, no_rnd, cur.y.data() + static_cast<long>(mby * 16) * cur.w + mbx * 16, cur.w);
    const int cx = (mx >> 1) | (mx & 1), cy = (my >> 1) | (my & 1);
    const int cdxy = ((cy & 1) << 1) | (cx & 1);
    const int csx = mbx * 8 + (cx >> 1), csy = mby * 8 + (cy >> 1);
    const long co = static_cast<long>(mby * 8) * (cur.w / 2) + mbx * 8;
    HpelPredict(ru, csx, csy, cdxy, 8, no_rnd, cur.u.data() + co, cur.w / 2);
    HpelPredict(rv, csx, csy, cdxy, 8, no_rnd, cur.v.data() + co, cur.w / 2);
  }

  void IntraMb(BitReader& br, int mbx, int mby, int cbpc, bool dquant) {
    ac_pred = br.Bit();
    if (ac_pred) ++stats[kAcPred];
    const int cbpy = Cbpy().Read(br);
    if (cbpy < 0) throw Corrupt{"an invalid CBPY code"};
    int cbp = (cbpc & 3) | (cbpy << 2);
    if (dquant) { SetQ(qscale + kDquant[br.Read(2)]); ++stats[kDquantMbs]; }
    mb_q[mby * mbw + mbx] = static_cast<int8_t>(qscale);
    for (int n = 0; n < 6; ++n, cbp <<= 1) IntraBlock(br, n, mbx, mby, cbp & 32);
    ++stats[kIntraMbs];
  }

  // ------------------------------------------------------------ VOP
  void DecodeVop(BitReader& br) {
    if (!have_vol) throw Corrupt{"a VOP before any video object layer header"};
    CheckEncoder();
    const int type = static_cast<int>(br.Read(2));
    if (type == 2) throw Unsupported{"B-VOPs"};
    if (type == 3) throw Unsupported{"S-VOPs (sprites, global motion compensation)"};
    while (br.Bit()) {
      if (br.Over()) throw Corrupt{"a truncated VOP header"};
    }  // modulo_time_base
    br.Skip(1);
    br.Skip(time_bits);
    br.Skip(1);
    if (!br.Bit()) throw Unsupported{"not-coded VOPs"};
    const bool p = type == 1;
    if (p && !have_ref) throw Corrupt{"a P-VOP with no reference VOP before it"};
    const bool no_rnd = p ? br.Bit() : false;
    if (br.Read(3) != 0) throw Unsupported{"an intra DC VLC threshold (intra_dc_vlc_thr > 0)"};
    SetQ(static_cast<int>(br.Read(5)));
    if (qscale == 0) throw Corrupt{"vop_quant 0"};
    const int fcode = p ? static_cast<int>(br.Read(3)) : 1;
    if (fcode == 0) throw Corrupt{"vop_fcode_forward 0"};
    ++stats[p ? kPVops : kIVops];
    if (no_rnd) ++stats[kRounding1];
    for (int mby = 0; mby < mbh; ++mby)
      for (int mbx = 0; mbx < mbw; ++mbx) {
        if (br.Over()) throw Corrupt{"a VOP truncated before its last macroblock"};
        int16_t* m = Mv(mbx, mby);
        if (!p) {
          int cbpc;
          do {
            cbpc = IntraMcbpc().Read(br);
            if (cbpc < 0) throw Corrupt{"an invalid intra MCBPC code"};
          } while (cbpc == 8);
          IntraMb(br, mbx, mby, cbpc, cbpc & 4);
          continue;
        }
        int cbpc;
        bool skipped = false;
        do {
          if (br.Bit()) { skipped = true; break; }
          cbpc = InterMcbpc().Read(br);
          if (cbpc < 0) throw Corrupt{"an invalid inter MCBPC code"};
        } while (cbpc == 20);
        if (skipped) {
          m[0] = m[1] = 0;
          mb_q[mby * mbw + mbx] = static_cast<int8_t>(qscale);
          MotionCompensate(mbx, mby, 0, 0, no_rnd);
          CleanIntraTables(mbx, mby);
          ++stats[kSkippedMbs];
          continue;
        }
        if (cbpc & 16) throw Unsupported{"four motion vectors per macroblock (inter4v)"};
        const bool dquant = cbpc & 8;
        if (cbpc & 4) {
          m[0] = m[1] = 0;
          IntraMb(br, mbx, mby, cbpc, dquant);
          ++stats[kIntraMbsInP];
          continue;
        }
        const int cbpy = Cbpy().Read(br);
        if (cbpy < 0) throw Corrupt{"an invalid CBPY code"};
        int cbp = (cbpc & 3) | ((cbpy ^ 15) << 2);
        if (dquant) { SetQ(qscale + kDquant[br.Read(2)]); ++stats[kDquantMbs]; }
        mb_q[mby * mbw + mbx] = static_cast<int8_t>(qscale);
        // median prediction (FFmpeg's ff_h263_pred_motion, one vector)
        int px, py;
        const int16_t* a = m - 2;
        if (mby == 0) {
          if (mbx == 0) { px = py = 0; } else { px = a[0]; py = a[1]; }
        } else {
          const int16_t* b = Mv(mbx, mby - 1);
          const int16_t* c = Mv(mbx + 1, mby - 1);
          px = Median(a[0], b[0], c[0]);
          py = Median(a[1], b[1], c[1]);
        }
        const int mx = DecodeMotion(br, px, fcode);
        const int my = DecodeMotion(br, py, fcode);
        m[0] = static_cast<int16_t>(mx);
        m[1] = static_cast<int16_t>(my);
        MotionCompensate(mbx, mby, mx, my, no_rnd);
        const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        for (int n = 0; n < 6; ++n, cbp <<= 1) {
          if (!(cbp & 32)) continue;
          int16_t block[64] = {0};
          DecodeCoeffs(br, block, false, kZigzag, -1, qmul, qadd);
          uint8_t* dst;
          long stride;
          BlockDest(n, mbx, mby, &dst, &stride);
          Idct(block, dst, stride, true);
        }
        CleanIntraTables(mbx, mby);
        ++stats[kInterMbs];
      }
    if (br.Over()) throw Corrupt{"a VOP truncated before its last macroblock"};
    std::swap(cur, ref);
    have_ref = true;
    have_frame = true;
    // the right and bottom border of the motion-vector table stays zero
  }

  // one packet: headers and at most one VOP; returns 1 when it held a VOP
  int Decode(const uint8_t* d, long n) {
    long i = 0;
    auto next_start = [&](long from) {
      for (long k = from; k + 3 < n; ++k)
        if (d[k] == 0 && d[k + 1] == 0 && d[k + 2] == 1) return k;
      return n;
    };
    i = next_start(0);
    while (i < n) {
      const int code = d[i + 3];
      const long body = i + 4;
      const long end = next_start(body);
      if (code == 0xB6) {
        BitReader br(d + body, n - body);
        DecodeVop(br);
        return 1;
      }
      if (code >= 0x20 && code <= 0x2F) {
        BitReader br(d + body, end - body);
        ParseVol(br);
      } else if (code == 0xB2) {
        ParseUserData(d + body, end - body);
      }
      i = end;
    }
    return 0;
  }
};

}  // namespace mpeg4
