// Baseline JPEG encoding on the host, for the port's image writer
// (`tamtr_torch/data/image_io.py:encode_jpeg`). The bytes are those of
// `cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q])` with OpenCV's other
// defaults, because every step is libjpeg-turbo's default compression path:
//   - the JFIF APP0 marker (version 1.01, no density unit, 1:1), one DQT
//     segment per table, SOF0, one DHT segment per table, SOS, EOI
//     (`jcmarker.c`);
//   - the Annex K quantization tables scaled by quality (`jcparam.c`:
//     `jpeg_quality_scaling`, `jpeg_add_quant_table` with force_baseline);
//   - colour: fixed-point BGR -> YCbCr (`jccolor.c`, SCALEBITS 16), Y at
//     2x2 and Cb, Cr at 1x1 (4:2:0), Cb and Cr sharing table 1; gray (one
//     component): the samples as they are, table 0;
//   - the edge of the image: the last row repeated to a whole row group and
//     the last column to twice the chroma blocks' width before downsampling
//     (`jcprepct.c:expand_bottom_edge`, `jcsample.c:expand_right_edge`), the
//     downsampled rows repeated to a whole MCU row, and dummy blocks (AC 0,
//     DC of the block before) where the luma blocks do not fill an MCU
//     (`jccoefct.c:compress_data`);
//   - `h2v2_downsample` with the alternating bias 1, 2 (`jcsample.c`);
//   - the accurate integer forward DCT (`jfdctint.c`, CONST_BITS 13,
//     PASS1_BITS 2) of the samples less 128;
//   - quantization by the reciprocal, correction and shift of
//     `jcdctmgr.c:compute_reciprocal` for the divisor q << 3, 16-bit DCTELEM
//     as in the SIMD build;
//   - sequential Huffman coding with the standard tables (`jstdhuff.c`): DC
//     differences, AC runs with ZRL and EOB, 0xFF stuffed with 0x00, the
//     last byte padded with 1-bits (`jchuff.c`).
//
// C entry point: jpeg_encode(img, h, w, channels, quality, out, cap) reads
// an (h, w) gray or (h, w, 3) BGR uint8 image and returns the encoded size;
// the bytes are written to `out` only when that size is at most `cap` (the
// caller retries with a larger buffer otherwise). It returns -1 on bad
// arguments.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
                         41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
                         30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c: std_luminance_quant_tbl, std_chrominance_quant_tbl (natural order)
const int kLumaQuant[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                            14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                            18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                            49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts per length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint32_t code[256];
  int size[256];

  HuffTable(const uint8_t* b, const uint8_t* v) : bits(b), vals(v), nvals(0) {
    std::memset(size, 0, sizeof(size));
    for (int l = 0; l < 16; ++l) nvals += bits[l];
    uint32_t c = 0;  // jchuff.c: jpeg_make_c_derived_tbl, canonical codes
    for (int l = 1, k = 0; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k) {
        code[vals[k]] = c++;
        size[vals[k]] = l;
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c: the divisor of one coefficient as reciprocal, correction, shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor compute_reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor, c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;  // bits not yet written, right-aligned
  int nacc = 0;

  void byte(int b) { out.push_back((uint8_t)b); }
  void word(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++nacc == 8) {
        byte(acc);
        if (acc == 0xFF) byte(0);
        acc = 0;
        nacc = 0;
      }
    }
  }
  void flush() {  // fill the partial byte with 1-bits
    if (nacc) bits((1u << (8 - nacc)) - 1, 8 - nacc);
  }
  void dqt(int index, const int* q) {
    word(0xFFDB);
    word(64 + 1 + 2);
    byte(index);
    for (int i = 0; i < 64; ++i) byte(q[kZigzag[i]]);
  }
  void dht(int index, const HuffTable& t) {
    word(0xFFC4);
    word(t.nvals + 2 + 1 + 16);
    byte(index);
    for (int l = 0; l < 16; ++l) byte(t.bits[l]);
    for (int i = 0; i < t.nvals; ++i) byte(t.vals[i]);
  }
};

// jfdctint.c: jpeg_fdct_islow, in place on 64 samples less 128
void fdct_islow(int* d) {
  const int CB = 13, P1 = 2;
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return (int)((x + ((int64_t)1 << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    for (int i = 0; i < 8; ++i) {
      int* p = d + i * stride;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass ? CB + P1 : CB - P1;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, P1);
        p[4 * step] = descale(tmp10 - tmp11, P1);
      } else {
        p[0] = (int)((tmp10 + tmp11) * (1 << P1));
        p[4 * step] = (int)((tmp10 - tmp11) * (1 << P1));
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, sh);
      p[6 * step] = descale(z1 + tmp12 * -F1847, sh);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, sh);
      p[5 * step] = descale(tmp5 + z2 + z4, sh);
      p[3 * step] = descale(tmp6 + z2 + z3, sh);
      p[step] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

struct Plane {
  int bw, bh;                 // blocks that hold image data (width_in_blocks, height_in_blocks)
  int pw, ph;                 // samples held: whole MCUs
  std::vector<uint8_t> s;     // (ph, pw)
  std::vector<int16_t> coef;  // (bh, bw, 64) quantized, natural order
};

// One plane's blocks: FDCT and quantization
void transform(Plane& p, const Divisor* div) {
  p.coef.assign((size_t)p.bw * p.bh * 64, 0);
  int ws[64];
  for (int by = 0; by < p.bh; ++by)
    for (int bx = 0; bx < p.bw; ++bx) {
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) ws[r * 8 + c] = p.s[(size_t)(by * 8 + r) * p.pw + bx * 8 + c] - 128;
      fdct_islow(ws);
      int16_t* out = &p.coef[((size_t)by * p.bw + bx) * 64];
      for (int i = 0; i < 64; ++i) {
        int t = (int16_t)ws[i];  // DCTELEM
        uint32_t a = (uint32_t)(t < 0 ? -t : t);
        int q = (int)(((uint64_t)(a + div[i].corr) * div[i].recip) >> div[i].shift);
        out[i] = (int16_t)(t < 0 ? -q : q);
      }
    }
}

struct Encoder {
  Writer w;
  int last_dc[3] = {0, 0, 0};

  void block(const int16_t* c, int comp, const HuffTable& dc, const HuffTable& ac) {
    auto emit = [&](const HuffTable& t, int sym) { w.bits(t.code[sym], t.size[sym]); };
    auto nbits_of = [](int v) {
      int n = 0;
      for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
      return n;
    };
    int diff = c[0] - last_dc[comp];
    last_dc[comp] = c[0];
    int n = nbits_of(diff);
    emit(dc, n);
    if (n) w.bits((uint32_t)(diff < 0 ? diff - 1 : diff) & ((1u << n) - 1), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = c[kZigzag[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        emit(ac, 0xF0);
        run -= 16;
      }
      n = nbits_of(v);
      emit(ac, (run << 4) + n);
      w.bits((uint32_t)(v < 0 ? v - 1 : v) & ((1u << n) - 1), n);
      run = 0;
    }
    if (run > 0) emit(ac, 0x00);
  }
};

}  // namespace

extern "C" long jpeg_encode(const uint8_t* img, int h, int w, int channels, int quality, uint8_t* out, long cap) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535 || (channels != 1 && channels != 3)) return -1;
  // jcparam.c: jpeg_quality_scaling, jpeg_add_quant_table(force_baseline)
  int q = quality <= 0 ? 1 : quality > 100 ? 100 : quality;
  int scale = q < 50 ? 5000 / q : 200 - q * 2;
  int qt[2][64];
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = ((long)(t ? kChromaQuant : kLumaQuant)[i] * scale + 50) / 100;
      qt[t][i] = v <= 0 ? 1 : v > 255 ? 255 : (int)v;
      div[t][i] = compute_reciprocal((uint32_t)qt[t][i] << 3);
    }
  const HuffTable dc0(kDcLumaBits, kDcVals), ac0(kAcLumaBits, kAcLumaVals);
  const HuffTable dc1(kDcChromaBits, kDcVals), ac1(kAcChromaBits, kAcChromaVals);
  const bool color = channels == 3;
  const int hmax = color ? 2 : 1, mcu = 8 * hmax;
  const int mcux = (w + mcu - 1) / mcu, mcuy = (h + mcu - 1) / mcu;

  // samples: Y (and Cb, Cr at full size) from the image, then the planes
  std::vector<Plane> planes(color ? 3 : 1);
  if (!color) {
    Plane& p = planes[0];
    p.bw = (w + 7) / 8;
    p.bh = (h + 7) / 8;
    p.pw = p.bw * 8;
    p.ph = p.bh * 8;
    p.s.resize((size_t)p.pw * p.ph);
    for (int y = 0; y < p.ph; ++y)
      for (int x = 0; x < p.pw; ++x) p.s[(size_t)y * p.pw + x] = img[(size_t)(y < h ? y : h - 1) * w + (x < w ? x : w - 1)];
  } else {
    // jccolor.c: rgb_ycc_start, rgb_ycc_convert (BGR input)
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1), CBCR_OFF = (int64_t)128 << SB;
    auto fix = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    int64_t tab[8][256];
    for (int i = 0; i < 256; ++i) {
      tab[0][i] = fix(0.29900) * i;
      tab[1][i] = fix(0.58700) * i;
      tab[2][i] = fix(0.11400) * i + HALF;
      tab[3][i] = -fix(0.16874) * i;
      tab[4][i] = -fix(0.33126) * i;
      tab[5][i] = fix(0.50000) * i + CBCR_OFF + HALF - 1;  // B -> Cb and R -> Cr
      tab[6][i] = -fix(0.41869) * i;
      tab[7][i] = -fix(0.08131) * i;
    }
    // full-size planes, the image's edge repeated to the samples the blocks need:
    // luma to its blocks, chroma's source to twice the chroma blocks
    const int cbw = (w + 15) / 16, cbh = (h + 15) / 16;
    const int fw = cbw * 16, fh = ((h + 1) / 2) * 2;  // chroma source: a whole row group
    std::vector<uint8_t> full[3];
    for (auto& f : full) f.resize((size_t)fw * fh);
    for (int y = 0; y < fh; ++y)
      for (int x = 0; x < fw; ++x) {
        const uint8_t* px = img + ((size_t)(y < h ? y : h - 1) * w + (x < w ? x : w - 1)) * 3;
        int b = px[0], g = px[1], r = px[2];
        size_t o = (size_t)y * fw + x;
        full[0][o] = (uint8_t)((tab[0][r] + tab[1][g] + tab[2][b]) >> SB);
        full[1][o] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> SB);
        full[2][o] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> SB);
      }
    Plane& Y = planes[0];
    Y.bw = (w + 7) / 8;
    Y.bh = (h + 7) / 8;
    Y.pw = mcux * 16;
    Y.ph = mcuy * 16;
    Y.s.resize((size_t)Y.pw * Y.ph);
    for (int y = 0; y < Y.ph; ++y)
      for (int x = 0; x < Y.pw; ++x)
        Y.s[(size_t)y * Y.pw + x] = full[0][(size_t)(y < h ? y : h - 1) * fw + (x < w ? x : w - 1)];
    const int dh = (h + 1) / 2;  // downsampled rows that hold image data
    for (int ci = 1; ci < 3; ++ci) {
      Plane& p = planes[ci];
      p.bw = cbw;
      p.bh = cbh;
      p.pw = cbw * 8;
      p.ph = cbh * 8;
      p.s.resize((size_t)p.pw * p.ph);
      for (int y = 0; y < p.ph; ++y) {
        int sy = y < dh ? y : dh - 1;
        const uint8_t* r0 = &full[ci][(size_t)(2 * sy) * fw];
        const uint8_t* r1 = &full[ci][(size_t)(2 * sy + 1) * fw];
        for (int x = 0, bias = 1; x < p.pw; ++x, bias ^= 3)
          p.s[(size_t)y * p.pw + x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
      }
    }
  }
  for (size_t ci = 0; ci < planes.size(); ++ci) transform(planes[ci], div[ci ? 1 : 0]);

  Encoder e;
  Writer& wr = e.w;
  wr.out.reserve((size_t)h * w * channels / 4 + 1024);
  wr.word(0xFFD8);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  wr.word(0xFFE0);
  wr.word(16);
  for (uint8_t b : jfif) wr.byte(b);
  wr.dqt(0, qt[0]);
  if (color) wr.dqt(1, qt[1]);
  wr.word(0xFFC0);
  wr.word(8 + 3 * channels);
  wr.byte(8);
  wr.word(h);
  wr.word(w);
  wr.byte(channels);
  for (int ci = 0; ci < channels; ++ci) {
    wr.byte(ci + 1);
    wr.byte(ci == 0 && color ? 0x22 : 0x11);
    wr.byte(ci ? 1 : 0);
  }
  wr.dht(0x00, dc0);
  wr.dht(0x10, ac0);
  if (color) {
    wr.dht(0x01, dc1);
    wr.dht(0x11, ac1);
  }
  wr.word(0xFFDA);
  wr.word(6 + 2 * channels);
  wr.byte(channels);
  for (int ci = 0; ci < channels; ++ci) {
    wr.byte(ci + 1);
    wr.byte(ci ? 0x11 : 0x00);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  if (!color) {
    const Plane& p = planes[0];
    for (int by = 0; by < p.bh; ++by)
      for (int bx = 0; bx < p.bw; ++bx) e.block(&p.coef[((size_t)by * p.bw + bx) * 64], 0, dc0, ac0);
  } else {
    const Plane& Y = planes[0];
    int16_t dummy[64];
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        int16_t prev_dc = 0;
        for (int v = 0; v < 2; ++v) {
          int by = my * 2 + v;
          for (int hh = 0; hh < 2; ++hh) {
            int bx = mx * 2 + hh;
            if (by < Y.bh && bx < Y.bw) {
              const int16_t* c = &Y.coef[((size_t)by * Y.bw + bx) * 64];
              e.block(c, 0, dc0, ac0);
              prev_dc = c[0];
            } else {
              // jccoefct.c: a dummy block takes the DC of the block before it
              // (the row's last real block; below the image, the last block
              // of the MCU's row above)
              std::memset(dummy, 0, sizeof(dummy));
              dummy[0] = prev_dc;
              e.block(dummy, 0, dc0, ac0);
            }
          }
        }
        for (int ci = 1; ci < 3; ++ci) {
          const Plane& p = planes[ci];
          e.block(&p.coef[((size_t)my * p.bw + mx) * 64], ci, dc1, ac1);
        }
      }
  }
  wr.flush();
  wr.word(0xFFD9);
  long n = (long)wr.out.size();
  if (n <= cap) std::memcpy(out, wr.out.data(), (size_t)n);
  return n;
}
