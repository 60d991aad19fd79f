// Baseline and progressive JPEG decoding on the host, for the port's image
// reader (`tamtr_torch/data/image_io.py:decode_jpeg`). The output is what
// `cv2.imdecode(buf, cv2.IMREAD_COLOR)` gives before it applies the EXIF
// orientation (done in Python): BGR uint8, bitwise, because every step is
// libjpeg-turbo's default decompression path, which OpenCV uses:
//   - Huffman-coded sequential DCT, 8-bit samples (SOF0 / SOF1), interleaved
//     or not, with restart intervals; a table that a scan uses and no DHT
//     defined (Motion-JPEG frames) is Annex K's, as `jstdhuff.c` supplies;
//   - Huffman-coded progressive DCT (SOF2, `jdphuff.c`): any scan script of
//     DC first and refinement scans (interleaved or not) and AC first and
//     refinement scans (one component, with EOB runs), restart intervals;
//     every scan fills one coefficient buffer, whose blocks then take the
//     IDCT that a sequential file's blocks take as they are decoded. libjpeg's block smoothing
//     (`jdcoefct.c:smoothing_ok`) changes the output only while a
//     component's coefficients 1-9 miss bits (a script cut short): such a
//     file is refused, so a complete one decodes bitwise;
//   - dequantization and the accurate integer IDCT (`jidctint.c`,
//     CONST_BITS 13, PASS1_BITS 2) through the post-IDCT range-limit table
//     (`jdmaster.c:prepare_range_limit_table`, indices masked to 10 bits);
//   - "fancy" triangle upsampling (`jdsample.c`): h2v1 and h2v2 where the
//     downsampled row is wider than 2 samples, h1v2 always, 3 * near + far
//     with the +1 / +2 (h2v1, h1v2) and +8 / +7 (h2v2) biases, the edge
//     samples replicated (the context rows of `jdmainct.c`); other integral
//     factors replicate samples (`int_upsample`);
//   - fixed-point YCbCr -> RGB (`jdcolor.c`, SCALEBITS 16) clamped by the
//     range-limit table; a gray image repeated into three channels; an RGB
//     file (Adobe transform 0, or component ids 'R', 'G', 'B' without JFIF
//     or Adobe markers) copied.
// Arithmetic-coded, lossless, hierarchical and 12-bit files, and CMYK / YCCK,
// are refused with a message.
//
// C entry point: jpeg_decode(data, n, out, h, w, msg, msg_len) writes the
// (h, w, 3) BGR image into `out` (h, w from the caller's header parse, held
// against the SOF) and returns 0, or writes a message and returns 1
// (malformed) or 2 (a mode this decoder does not take).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};  // k past 63 on corrupt data

struct Fail {
  int code;
  std::string msg;
};

struct Huff {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  int look_nbits[512];  // 9-bit lookahead: code length (0: longer code)
  uint8_t look_sym[512];
};

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int bw, bh;          // blocks in the plane (a whole number of MCUs)
  int dw, dh;          // downsampled width and height (samples that hold image data)
  std::vector<uint8_t> plane;  // (bh * 8) rows of (bw * 8) samples
  std::vector<int16_t> coef;   // progressive: (bh, bw, 64) quantized coefficients (JCOEF), natural order
  int coef_bits[64];           // progressive: the Al of the last scan of each coefficient, -1 before any
  uint16_t q[64];              // the quantization table, latched at the component's first scan
  bool latched = false;
  int pred = 0;
};

struct Decoder {
  const uint8_t* d;
  long n, pos = 0;
  int width = 0, height = 0, hmax = 1, vmax = 1, restart = 0;
  bool jfif = false, adobe = false, have_sof = false, progressive = false;
  int eobrun = 0;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Component> comps;
  // bit reader
  uint32_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;

  int byte() {
    if (pos >= n) throw Fail{1, "unexpected end of data"};
    return d[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void define_quant(long end) {
    while (pos < end) {
      int pq_tq = byte(), pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw Fail{1, "quantization table id > 3"};
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = (uint16_t)(pq ? word() : byte());
      qt_defined[tq] = true;
    }
  }

  static void build_huff(Huff& t, const int* counts, const uint8_t* vals, int total) {
    for (int i = 0; i < total; ++i) t.vals[i] = vals[i];
    int code = 0, k = 0;
    for (int i = 0; i < 512; ++i) t.look_nbits[i] = 0;
    for (int l = 1; l <= 16; ++l) {
      t.valoffset[l] = k - code;
      for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
        if (l <= 9) {
          int lo = code << (9 - l), hi = (code + 1) << (9 - l);
          for (int j = lo; j < hi; ++j) {
            t.look_nbits[j] = l;
            t.look_sym[j] = t.vals[k];
          }
        }
      }
      t.maxcode[l] = counts[l] ? code - 1 : -1;
      code <<= 1;
    }
    t.maxcode[17] = 0x7fffffff;  // ends the slow path on a corrupt code
    t.defined = true;
  }

  void define_huff(long end) {
    while (pos < end) {
      int tc_th = byte(), tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Fail{1, "bad Huffman table class or id"};
      Huff& t = tc ? ac[th] : dc[th];
      int counts[17] = {0}, total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
      if (total > 256) throw Fail{1, "Huffman table with more than 256 codes"};
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)byte();
      build_huff(t, counts, vals, total);
    }
  }

  // jstdhuff.c: a table a scan uses but no DHT defined (Motion-JPEG frames
  // leave them out) is the ITU T.81 Annex K.3 table of its class, the
  // luminance one for id 0 and the chrominance one for id 1
  void default_huff(bool is_dc, int id) {
    static const uint8_t dc_bits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                           {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
    static const uint8_t dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
    static const uint8_t ac_bits[2][17] = {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                           {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
    static const uint8_t ac_vals[2][162] = {
      {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
       0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
       0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
       0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
       0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
       0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
       0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
       0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
       0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
      {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
       0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
       0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
       0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
       0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
       0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
       0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
       0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
       0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};
    if (id > 1) throw Fail{1, "scan uses an undefined Huffman table"};
    const uint8_t* bits = is_dc ? dc_bits[id] : ac_bits[id];
    int counts[17] = {0}, total = 0;
    for (int l = 1; l <= 16; ++l) total += counts[l] = bits[l];
    build_huff(is_dc ? dc[id] : ac[id], counts, is_dc ? dc_vals : ac_vals[id], total);
  }

  void start_of_frame(int marker) {
    int precision = byte();
    height = word();
    width = word();
    int nc = byte();
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2)
      throw Fail{2, marker == 0xC3 ? "lossless" : marker >= 0xC9 ? "arithmetic-coded" : "hierarchical"};
    progressive = marker == 0xC2;
    if (precision != 8) throw Fail{2, std::to_string(precision) + "-bit"};
    if (nc != 1 && nc != 3) throw Fail{2, nc == 4 ? "CMYK/YCCK" : std::to_string(nc) + "-component"};
    if (height == 0 || width == 0) throw Fail{2, "zero height (DNL marker)"};
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) throw Fail{1, "bad component parameters"};
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    if (nc == 1) comps[0].h = comps[0].v = hmax = vmax = 1;  // one component: its MCU is one block
    int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) throw Fail{2, "non-integral sampling factors"};
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
      if (progressive) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int& b : c.coef_bits) b = -1;
    }
    have_sof = true;
  }

  // ---- entropy-coded data
  void fill() {
    while (nbits <= 24) {
      int b = 0;
      if (!hit_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          int nx = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (nx == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // zeros from here on, as libjpeg inserts
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      bits |= (uint32_t)b << (24 - nbits);
      nbits += 8;
    }
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    int v = (int)(bits >> (32 - k));
    bits <<= k;
    nbits -= k;
    return v;
  }
  int decode(const Huff& t) {
    if (nbits < 16) fill();
    int look = (int)(bits >> 23);
    int l = t.look_nbits[look];
    if (l) {
      bits <<= l;
      nbits -= l;
      return t.look_sym[look];
    }
    int code = get_bits(9);
    l = 9;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      if (++l > 16) return 0;  // corrupt: libjpeg warns and returns 0
    }
    return t.vals[(t.valoffset[l] + code) & 0xFF];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void restart_marker() {
    nbits = 0;
    bits = 0;
    // skip to the RSTn marker (libjpeg resyncs on a missing one; valid data has it here)
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)) ++pos;
    if (pos + 1 < n) pos += 2;
    hit_marker = false;
    for (auto& c : comps) c.pred = 0;
    eobrun = 0;
  }

  int16_t* block_of(Component& c, int bx, int by) { return &c.coef[((size_t)by * c.bw + bx) * 64]; }

  // sequential: a whole block into `coef` (zeroed), then through the IDCT
  void decode_block(Component& c, int bx, int by) {
    const Huff& hd = dc[c.td];
    const Huff& ha = ac[c.ta];
    int16_t coef[64] = {};
    int s = decode(hd);
    int diff = s ? extend(get_bits(s), s) : 0;
    c.pred += diff;
    coef[0] = (int16_t)c.pred;  // JCOEF
    for (int k = 1; k < 64; ++k) {
      int rs = decode(ha), r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_block(c, coef, bx, by);
  }

  static void idct_block(Component& c, const int16_t* coef, int bx, int by) {
    idct_islow(coef, c.q, &c.plane[(size_t)by * 8 * c.bw * 8 + (size_t)bx * 8], c.bw * 8);
  }

  // jdphuff.c: decode_mcu_DC_first / decode_mcu_DC_refine, one block
  void decode_dc(Component& c, int bx, int by, int ah, int al) {
    int16_t* coef = block_of(c, bx, by);
    if (ah == 0) {
      int s = decode(dc[c.td]);
      c.pred += s ? extend(get_bits(s), s) : 0;
      coef[0] = (int16_t)((uint32_t)c.pred << al);
    } else if (get_bits(1)) {
      coef[0] = (int16_t)(coef[0] | (1 << al));
    }
  }

  // jdphuff.c: decode_mcu_AC_first, one block of a one-component scan
  void decode_ac_first(Component& c, int bx, int by, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    int16_t* coef = block_of(c, bx, by);
    const Huff& t = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = decode(t), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = (int16_t)((uint32_t)extend(get_bits(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c: decode_mcu_AC_refine, one block of a one-component scan
  void decode_ac_refine(Component& c, int bx, int by, int ss, int se, int al) {
    int16_t* coef = block_of(c, bx, by);
    const Huff& t = ac[c.ta];
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto refine = [&](int16_t& v) {
      if (get_bits(1) && (v & p1) == 0) v = (int16_t)(v + (v >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;  // the size of a new coefficient is 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;  // the rest of the block is the EOB run's
        }
        do {  // skip r zero coefficients, refining the nonzero ones passed
          int16_t& v = coef[kNatural[k]];
          if (v != 0) {
            refine(v);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) coef[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& v = coef[kNatural[k]];
        if (v != 0) refine(v);
      }
      --eobrun;
    }
  }

  // jidctint.c: jpeg_idct_islow
  static uint8_t range_limit(int x) {
    // post-IDCT table of prepare_range_limit_table, indexed by x & 1023
    int j = x & 1023;
    if (j < 128) return (uint8_t)(j + 128);
    if (j < 512) return 255;
    if (j < 896) return 0;
    return (uint8_t)(j - 896);
  }
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const int CB = 13, P1 = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dcval = (int)((uint32_t)(ip[0] * (int)qp[0]) << P1);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = ip[16] * (int)qp[16], z3 = ip[48] * (int)qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * (int)qp[0];
      z3 = ip[32] * (int)qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB), tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * (int)qp[56];
      tmp1 = ip[40] * (int)qp[40];
      tmp2 = ip[24] * (int)qp[24];
      tmp3 = ip[8] * (int)qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB - P1;
      const int64_t half = (int64_t)1 << (sh - 1);
      wp[0] = (int)((tmp10 + tmp3 + half) >> sh);
      wp[56] = (int)((tmp10 - tmp3 + half) >> sh);
      wp[8] = (int)((tmp11 + tmp2 + half) >> sh);
      wp[48] = (int)((tmp11 - tmp2 + half) >> sh);
      wp[16] = (int)((tmp12 + tmp1 + half) >> sh);
      wp[40] = (int)((tmp12 - tmp1 + half) >> sh);
      wp[24] = (int)((tmp13 + tmp0 + half) >> sh);
      wp[32] = (int)((tmp13 - tmp0 + half) >> sh);
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = range_limit((int)(((int64_t)wp[0] + (1 << (P1 + 2))) >> (P1 + 3)));
        for (int i = 0; i < 8; ++i) op[i] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB), tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB + P1 + 3;
      const int64_t half = (int64_t)1 << (sh - 1);
      op[0] = range_limit((int)((tmp10 + tmp3 + half) >> sh));
      op[7] = range_limit((int)((tmp10 - tmp3 + half) >> sh));
      op[1] = range_limit((int)((tmp11 + tmp2 + half) >> sh));
      op[6] = range_limit((int)((tmp11 - tmp2 + half) >> sh));
      op[2] = range_limit((int)((tmp12 + tmp1 + half) >> sh));
      op[5] = range_limit((int)((tmp12 - tmp1 + half) >> sh));
      op[3] = range_limit((int)((tmp13 + tmp0 + half) >> sh));
      op[4] = range_limit((int)((tmp13 - tmp0 + half) >> sh));
    }
  }

  void scan() {
    if (!have_sof) throw Fail{1, "SOS before SOF"};
    int ns = byte();
    if (ns < 1 || ns > 4) throw Fail{1, "bad scan component count"};
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int cid = byte(), t = byte();
      Component* c = nullptr;
      for (auto& cc : comps)
        if (cc.id == cid) c = &cc;
      if (!c) throw Fail{1, "scan names an unknown component"};
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) throw Fail{1, "bad Huffman table id"};
      sc.push_back(c);
    }
    int ss = byte(), se = byte(), ahal = byte(), ah = ahal >> 4, al = ahal & 15;
    if (!progressive && (ss != 0 || se != 63 || ahal != 0)) throw Fail{1, "sequential scan with spectral selection"};
    if (progressive && (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13 ||
                        (ah && ah != al + 1)))
      throw Fail{1, "bad progressive scan parameters"};
    for (auto* c : sc) {
      bool need_dc = !progressive || (ss == 0 && ah == 0), need_ac = !progressive || ss > 0;
      if (need_dc && !dc[c->td].defined) default_huff(true, c->td);
      if (need_ac && !ac[c->ta].defined) default_huff(false, c->ta);
      if (!qt_defined[c->tq]) throw Fail{1, "component uses an undefined quantization table"};
      if (!c->latched) {
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
      if (progressive)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
    // one block of this scan
    auto block = [&](Component& c, int bx, int by) {
      if (!progressive)
        decode_block(c, bx, by);
      else if (ss == 0)
        decode_dc(c, bx, by, ah, al);
      else if (ah == 0)
        decode_ac_first(c, bx, by, ss, se, al);
      else
        decode_ac_refine(c, bx, by, ss, se, al);
    };
    for (auto* c : sc) c->pred = 0;
    eobrun = 0;
    bits = 0;
    nbits = 0;
    hit_marker = false;
    int left = restart;
    if (ns == 1) {
      Component& c = *sc[0];
      int bw = (c.dw + 7) / 8, bh = (c.dh + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          if (restart && left == 0) {
            restart_marker();
            left = restart;
          }
          block(c, bx, by);
          --left;
        }
    } else {
      int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart && left == 0) {
            restart_marker();
            left = restart;
          }
          for (auto* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h) block(*c, mx * c->h + h, my * c->v + v);
          --left;
        }
    }
    // leave the reader on the marker that ends the scan
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 && !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
      ++pos;
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw Fail{1, "not a JPEG file (no SOI)"};
    pos = 2;
    bool scanned = false;
    while (pos < n) {
      if (d[pos] != 0xFF) {
        ++pos;  // garbage between markers: libjpeg skips it with a warning
        continue;
      }
      int marker = d[pos + 1 < n ? pos + 1 : pos];
      pos += 2;
      if (marker == 0xFF) {
        --pos;  // fill byte
        continue;
      }
      if (marker == 0xD9) break;  // EOI
      if (marker == 0xD8 || marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      long len = word();
      long end = pos + len - 2;
      if (len < 2 || end > n) throw Fail{1, "marker segment runs past the end"};
      if (marker == 0xDB) {
        define_quant(end);
      } else if (marker == 0xC4) {
        define_huff(end);
      } else if (marker == 0xCC) {
        throw Fail{2, "arithmetic-coded"};
      } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC8) {
        if (have_sof) throw Fail{2, "more than one frame"};
        start_of_frame(marker);
      } else if (marker == 0xDD) {
        restart = word();
      } else if (marker == 0xE0) {
        if (len >= 7 && !std::memcmp(d + pos, "JFIF\0", 5)) jfif = true;
      } else if (marker == 0xEE) {
        if (len >= 14 && !std::memcmp(d + pos, "Adobe", 5)) {
          adobe = true;
          adobe_transform = d[pos + 11];
        }
      } else if (marker == 0xDA) {
        scan();
        scanned = true;
        continue;
      }
      pos = end;
    }
    if (!scanned) throw Fail{1, "no scan"};
    if (!progressive) return;
    if (smoothing_ok()) throw Fail{2, "progressive with coefficient bits missing (libjpeg's block smoothing)"};
    for (auto& c : comps) {
      if (!c.latched) std::memset(c.q, 0, sizeof(c.q));  // in no scan: jddctmgr.c's zero multipliers
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) idct_block(c, block_of(c, bx, by), bx, by);
    }
  }

  // jdcoefct.c: smoothing_ok after the last scan (libjpeg-turbo 2.1 on: the
  // DC and the first 9 AC coefficients in zigzag order); true where libjpeg
  // would smooth the blocks
  bool smoothing_ok() const {
    bool useful = false;
    for (const auto& c : comps) {
      for (int k = 0; k < 10; ++k)
        if (!c.latched || c.q[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // ---- upsampling to full size and colour conversion
  std::vector<uint8_t> upsample(const Component& c) const {
    const int fx = hmax / c.h, fy = vmax / c.v, dw = c.dw, dh = c.dh, pw = c.bw * 8;
    const int ow = dw * fx, oh = dh * fy;  // upsampled, at least the image
    std::vector<uint8_t> out((size_t)ow * oh);
    auto in = [&](int y, int x) -> int { return c.plane[(size_t)y * pw + x]; };
    if (fx == 1 && fy == 1) {
      for (int y = 0; y < oh; ++y) std::memcpy(&out[(size_t)y * ow], &c.plane[(size_t)y * pw], ow);
    } else if (fx == 2 && fy == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < dh; ++y) {
        uint8_t* o = &out[(size_t)y * ow];
        int v = in(y, 0);
        o[0] = (uint8_t)v;
        o[1] = (uint8_t)((v * 3 + in(y, 1) + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = in(y, x) * 3;
          o[2 * x] = (uint8_t)((v + in(y, x - 1) + 1) >> 2);
          o[2 * x + 1] = (uint8_t)((v + in(y, x + 1) + 2) >> 2);
        }
        v = in(y, dw - 1);
        o[2 * dw - 2] = (uint8_t)((v * 3 + in(y, dw - 2) + 1) >> 2);
        o[2 * dw - 1] = (uint8_t)v;
      }
    } else if (fx == 1 && fy == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < dh; ++y)
        for (int half = 0; half < 2; ++half) {
          int yf = half ? (y + 1 < dh ? y + 1 : dh - 1) : (y > 0 ? y - 1 : 0), bias = half ? 2 : 1;
          uint8_t* o = &out[(size_t)(2 * y + half) * ow];
          for (int x = 0; x < dw; ++x) o[x] = (uint8_t)((in(y, x) * 3 + in(yf, x) + bias) >> 2);
        }
    } else if (fx == 2 && fy == 2 && dw > 2) {  // h2v2_fancy_upsample
      for (int y = 0; y < dh; ++y)
        for (int half = 0; half < 2; ++half) {
          int yf = half ? (y + 1 < dh ? y + 1 : dh - 1) : (y > 0 ? y - 1 : 0);
          uint8_t* o = &out[(size_t)(2 * y + half) * ow];
          auto col = [&](int x) { return in(y, x) * 3 + in(yf, x); };
          int this_s = col(0), next_s = col(1), last_s;
          o[0] = (uint8_t)((this_s * 4 + 8) >> 4);
          o[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
          last_s = this_s;
          this_s = next_s;
          for (int x = 1; x < dw - 1; ++x) {
            next_s = col(x + 1);
            o[2 * x] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
            o[2 * x + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
            last_s = this_s;
            this_s = next_s;
          }
          o[2 * dw - 2] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
          o[2 * dw - 1] = (uint8_t)((this_s * 4 + 7) >> 4);
        }
    } else {  // int_upsample / h2v1_upsample / h2v2_upsample: replication
      for (int y = 0; y < oh; ++y)
        for (int x = 0; x < ow; ++x) out[(size_t)y * ow + x] = (uint8_t)in(y / fy, x / fx);
    }
    return out;
  }

  void to_bgr(uint8_t* out) const {
    if (comps.size() == 1) {
      const Component& c = comps[0];
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
          uint8_t v = c.plane[(size_t)y * c.bw * 8 + x];
          uint8_t* o = out + ((size_t)y * width + x) * 3;
          o[0] = o[1] = o[2] = v;
        }
      return;
    }
    std::vector<uint8_t> up[3];
    int ow[3];
    for (int i = 0; i < 3; ++i) {
      up[i] = upsample(comps[i]);
      ow[i] = comps[i].dw * (hmax / comps[i].h);
    }
    bool rgb;
    if (jfif) {
      rgb = false;
    } else if (adobe) {
      rgb = adobe_transform == 0;
    } else {
      rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
    }
    if (rgb) {
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
          uint8_t* o = out + ((size_t)y * width + x) * 3;
          o[2] = up[0][(size_t)y * ow[0] + x];
          o[1] = up[1][(size_t)y * ow[1] + x];
          o[0] = up[2][(size_t)y * ow[2] + x];
        }
      return;
    }
    // jdcolor.c: build_ycc_rgb_table, ycc_rgb_convert
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int yy = 0; yy < height; ++yy)
      for (int x = 0; x < width; ++x) {
        int Y = up[0][(size_t)yy * ow[0] + x], cb = up[1][(size_t)yy * ow[1] + x], cr = up[2][(size_t)yy * ow[2] + x];
        uint8_t* o = out + ((size_t)yy * width + x) * 3;
        o[2] = clamp(Y + cr_r[cr]);
        o[1] = clamp(Y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
        o[0] = clamp(Y + cb_b[cb]);
      }
  }
};

}  // namespace

extern "C" int jpeg_decode(const uint8_t* data, long n, uint8_t* out, int h, int w, char* msg, int msg_len) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = n;
    dec.parse();
    if (dec.height != h || dec.width != w) throw Fail{1, "frame size differs from the header's"};
    dec.to_bgr(out);
    return 0;
  } catch (const Fail& f) {
    std::snprintf(msg, msg_len, "%s", f.msg.c_str());
    return f.code;
  } catch (const std::exception& e) {
    std::snprintf(msg, msg_len, "%s", e.what());
    return 1;
  }
}
