// MPEG-4 Part 2 video encoding on the host, for the port's video writer
// (`tamtr_torch/data/video_io.py:VideoWriter`, which `AnnotatedVideoWriter`
// uses as the JAX package uses cv2.VideoWriter with fourcc "mp4v"): Simple
// profile, an I-VOP every `gop` frames and P-VOPs between, H.263
// quantisation around one quantizer, moved by dquant per macroblock.
//
// BGR frames become limited-range BT.601 YUV 4:2:0 (chroma from each 2x2
// block's mean), edge-replicated to whole macroblocks. I-VOPs code every
// macroblock intra with DC prediction, and AC prediction where it lowers
// the levels of the predicted row or column. P-VOPs code every
// macroblock inter with one motion vector or skip it: the search starts
// from the zero vector, the median predictor and the left and upper
// neighbours' vectors, takes small-diamond steps at whole pixels, then
// tries the eight half-pel positions around the best (sum of absolute
// differences plus a vector-cost term); f_code is the smallest that holds
// the VOP's vectors; rounding_type alternates from one P-VOP to the next,
// as FFmpeg's encoder does. Coefficients use the TCOEF tables, escapes 1
// and 2 where they fit and escape 3 otherwise. The quantizer of a
// macroblock is the VOP's, or two coarser on busy luma (dquant), which
// keeps the bytes below cv2's writer's at its quality.
//
// The reference frames are the decoder's own (`mpeg4.h:Decoder`) output
// on the packets written, so encoder and decoder share their IDCT and
// motion compensation and never drift apart.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "mpeg4.h"

namespace {

using namespace mpeg4;

// (last, run, |level|) -> TCOEF symbol, -1 where the table has none
struct TcoefIndex {
  int16_t sym[2][64][32];
  TcoefIndex(const uint8_t* run, const uint8_t* level, int last) {
    std::memset(sym, 0xff, sizeof(sym));
    for (int i = 0; i < 102; ++i) sym[i >= last][run[i]][level[i]] = static_cast<int16_t>(i);
  }
  int Find(int last, int run, int level) const { return run < 64 && level > 0 && level < 32 ? sym[last][run][level] : -1; }
};

const TcoefIndex& IntraIndex() { static const TcoefIndex t(kIntraRun, kIntraLevel, kIntraLast); return t; }
const TcoefIndex& InterIndex() { static const TcoefIndex t(kInterRun, kInterLevel, kInterLast); return t; }

// the forward DCT whose flat block of value c gives F(0, 0) = 8 c, the scale
// the IDCT inverts
struct Fdct {
  double c[8][8];
  Fdct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u == 0 ? std::sqrt(0.125) : 0.5) * std::cos((2 * x + 1) * u * M_PI / 16.0);
  }
  void Run(const int* in, int* out) const {
    double t[64];
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int x = 0; x < 8; ++x) s += c[u][x] * in[y * 8 + x];
        t[y * 8 + u] = s;
      }
    for (int u = 0; u < 8; ++u)
      for (int v = 0; v < 8; ++v) {
        double s = 0;
        for (int y = 0; y < 8; ++y) s += c[v][y] * t[y * 8 + u];
        out[v * 8 + u] = static_cast<int>(std::lround(s));
      }
  }
};

const Fdct& Dct() { static const Fdct f; return f; }

void PutVlc(BitWriter& bw, const uint8_t (*tab)[2], int sym) { bw.Put(tab[sym][0], tab[sym][1]); }

struct Encoder {
  int width, height, mbw, mbh, q, res, inc, gop, time_bits = 1;
  long index = 0;
  long last_seconds = 0;
  bool no_rnd = false;
  Decoder recon{0};
  std::vector<uint8_t> y, u, v;  // the source, macroblock-aligned
  int yw, cw;
  std::vector<int16_t> dcv[3];   // DC reconstructions of the I-VOP being written (border row/col 0)
  std::vector<int16_t> acv[3];   // its first rows and columns of levels, as the decoder's tables
  std::vector<int> mbq;          // its quantizer per macroblock
  std::vector<int> mvs;          // (mbh + 1) x (mbw + 2) x 2 vectors of the P-VOP being written
  std::vector<uint8_t> packet;

  Encoder(int w, int h, int res_, int inc_, int q_, int gop_)
      : width(w), height(h), mbw((w + 15) / 16), mbh((h + 15) / 16), q(q_), res(res_), inc(inc_), gop(gop_) {
    while ((1 << time_bits) < res) ++time_bits;
    yw = mbw * 16;
    cw = mbw * 8;
    y.resize(static_cast<size_t>(yw) * mbh * 16);
    u.resize(static_cast<size_t>(cw) * mbh * 8);
    v.resize(u.size());
    mvs.assign(static_cast<size_t>(mbh + 1) * (mbw + 2) * 2, 0);
    std::vector<uint8_t> cfg = Config();
    recon.Decode(cfg.data(), static_cast<long>(cfg.size()));
  }

  // visual object sequence, visual object and video object layer headers
  std::vector<uint8_t> Config() const {
    BitWriter bw;
    bw.StartCode(0xB0);
    bw.Put(0x03, 8);  // Simple profile level 3
    bw.StartCode(0xB5);
    bw.Put(0, 1);     // no visual object identifier
    bw.Put(1, 4);     // video
    bw.Put(0, 1);     // no video signal type
    bw.Stuff();
    bw.StartCode(0x00);
    bw.StartCode(0x20);
    bw.Put(0, 1);     // random_accessible_vol
    bw.Put(1, 8);     // simple object type
    bw.Put(0, 1);     // no object layer identifier
    bw.Put(1, 4);     // square pixels
    bw.Put(1, 1);     // vol_control_parameters
    bw.Put(1, 2);     // 4:2:0
    bw.Put(1, 1);     // low_delay
    bw.Put(0, 1);     // no vbv parameters
    bw.Put(0, 2);     // rectangular
    bw.Put(1, 1);
    bw.Put(static_cast<uint32_t>(res), 16);
    bw.Put(1, 1);
    bw.Put(0, 1);     // no fixed_vop_rate
    bw.Put(1, 1);
    bw.Put(static_cast<uint32_t>(width), 13);
    bw.Put(1, 1);
    bw.Put(static_cast<uint32_t>(height), 13);
    bw.Put(1, 1);
    bw.Put(0, 1);     // progressive
    bw.Put(1, 1);     // obmc_disable
    bw.Put(0, 1);     // no sprites
    bw.Put(0, 1);     // 8 bits
    bw.Put(0, 1);     // H.263 quantisation
    bw.Put(1, 1);     // complexity_estimation_disable
    bw.Put(1, 1);     // resync_marker_disable
    bw.Put(0, 1);     // no data partitioning
    bw.Put(0, 1);     // no scalability
    bw.Stuff();
    return bw.out;
  }

  void LoadFrame(const uint8_t* bgr) {
    const int ph = mbh * 16;
    for (int j = 0; j < ph; ++j) {
      const int sj = j < height ? j : height - 1;
      for (int i = 0; i < yw; ++i) {
        const int si = i < width ? i : width - 1;
        const uint8_t* p = bgr + (static_cast<long>(sj) * width + si) * 3;
        y[static_cast<size_t>(j) * yw + i] = static_cast<uint8_t>(((66 * p[2] + 129 * p[1] + 25 * p[0] + 128) >> 8) + 16);
      }
    }
    for (int j = 0; j < mbh * 8; ++j)
      for (int i = 0; i < cw; ++i) {
        int r = 0, g = 0, b = 0;
        for (int dj = 0; dj < 2; ++dj)
          for (int di = 0; di < 2; ++di) {
            const int sj = std::min(2 * j + dj, height - 1), si = std::min(2 * i + di, width - 1);
            const uint8_t* p = bgr + (static_cast<long>(sj) * width + si) * 3;
            b += p[0]; g += p[1]; r += p[2];
          }
        u[static_cast<size_t>(j) * cw + i] = Clip8(((-38 * r - 74 * g + 112 * b + 512) >> 10) + 128);
        v[static_cast<size_t>(j) * cw + i] = Clip8(((112 * r - 94 * g - 18 * b + 512) >> 10) + 128);
      }
  }

  // the 8x8 source block n of macroblock (mbx, mby) as ints
  void SourceBlock(int n, int mbx, int mby, int* out) const {
    const uint8_t* p;
    long stride;
    if (n < 4) { stride = yw; p = y.data() + static_cast<long>(mby * 16 + (n >> 1) * 8) * yw + mbx * 16 + (n & 1) * 8; }
    else { stride = cw; p = (n == 4 ? u.data() : v.data()) + static_cast<long>(mby * 8) * cw + mbx * 8; }
    for (int j = 0; j < 8; ++j)
      for (int i = 0; i < 8; ++i) out[j * 8 + i] = p[j * stride + i];
  }

  // TCOEF run-level coding of levels[scan[first..63]] with the intra or inter table
  static void PutCoeffs(BitWriter& bw, const int* levels, int first, bool intra, const uint8_t* scan) {
    const TcoefIndex& index = intra ? IntraIndex() : InterIndex();
    const RunLevelLimits& lim = intra ? IntraLimits() : InterLimits();
    const uint16_t* vlc = intra ? kIntraVlc : kInterVlc;
    int last_pos = -1;
    for (int i = first; i < 64; ++i)
      if (levels[scan[i]]) last_pos = i;
    int run = 0;
    for (int i = first; i <= last_pos; ++i) {
      const int l = levels[scan[i]];
      if (!l) { ++run; continue; }
      const int last = i == last_pos, a = std::abs(l), sign = l < 0;
      int sym = index.Find(last, run, a);
      if (sym >= 0) {
        bw.Put(vlc[2 * sym], vlc[2 * sym + 1]);
        bw.Put(static_cast<uint32_t>(sign), 1);
      } else if ((sym = index.Find(last, run, a - lim.max_level[last][run])) >= 0) {
        bw.Put(vlc[2 * kTcoefEscape], vlc[2 * kTcoefEscape + 1]);
        bw.Put(0, 1);
        bw.Put(vlc[2 * sym], vlc[2 * sym + 1]);
        bw.Put(static_cast<uint32_t>(sign), 1);
      } else if (a < 64 && run - lim.max_run[last][a] - 1 >= 0 &&
                 (sym = index.Find(last, run - lim.max_run[last][a] - 1, a)) >= 0) {
        bw.Put(vlc[2 * kTcoefEscape], vlc[2 * kTcoefEscape + 1]);
        bw.Put(2, 2);
        bw.Put(vlc[2 * sym], vlc[2 * sym + 1]);
        bw.Put(static_cast<uint32_t>(sign), 1);
      } else {
        bw.Put(vlc[2 * kTcoefEscape], vlc[2 * kTcoefEscape + 1]);
        bw.Put(3, 2);
        bw.Put(static_cast<uint32_t>(last), 1);
        bw.Put(static_cast<uint32_t>(run), 6);
        bw.Put(1, 1);
        bw.Put(static_cast<uint32_t>(l) & 0xfff, 12);
        bw.Put(1, 1);
      }
      run = 0;
    }
  }

  void VopHeader(BitWriter& bw, bool p, int fcode) {
    const long t = index * inc, seconds = t / res;
    bw.StartCode(0xB6);
    bw.Put(p ? 1 : 0, 2);
    for (long s = last_seconds; s < seconds; ++s) bw.Put(1, 1);
    bw.Put(0, 1);
    last_seconds = seconds;
    bw.Put(1, 1);
    bw.Put(static_cast<uint32_t>(t % res), time_bits);
    bw.Put(1, 1);
    bw.Put(1, 1);  // vop_coded
    if (p) bw.Put(no_rnd ? 1 : 0, 1);
    bw.Put(0, 3);  // intra_dc_vlc_thr
    bw.Put(static_cast<uint32_t>(q), 5);
    if (p) bw.Put(static_cast<uint32_t>(fcode), 3);
  }

  // ------------------------------------------------------------ quantizer
  // the macroblock's quantizer: the VOP's, two coarser on busy luma (its
  // errors are masked there), within the +-2 a dquant can move from `prev`
  int MbQuant(int mbx, int mby, int prev) const {
    const uint8_t* s = y.data() + static_cast<long>(mby * 16) * yw + mbx * 16;
    long sum = 0, sq = 0;
    for (int j = 0; j < 16; ++j)
      for (int i = 0; i < 16; ++i) { const int p = s[j * yw + i]; sum += p; sq += p * p; }
    const long var = (sq - sum * sum / 256) / 256;
    const int target = var > 900 ? q + 2 : q;
    return std::min(std::max(std::min(std::max(target, prev - 2), prev + 2), 1), 31);
  }

  static int DquantIndex(int delta) { return delta == -1 ? 0 : delta == -2 ? 1 : delta == 1 ? 2 : 3; }

  // ------------------------------------------------------------ I-VOP
  void IntraVop(BitWriter& bw) {
    VopHeader(bw, false, 1);
    dcv[0].assign(static_cast<size_t>(2 * mbh + 1) * (2 * mbw + 1), 1024);
    acv[0].assign(dcv[0].size() * 16, 0);
    for (int c = 1; c < 3; ++c) {
      dcv[c].assign(static_cast<size_t>(mbh + 1) * (mbw + 1), 1024);
      acv[c].assign(dcv[c].size() * 16, 0);
    }
    mbq.assign(static_cast<size_t>(mbw) * mbh, q);
    const Fdct& dct = Dct();
    int qcur = q;
    for (int mby = 0; mby < mbh; ++mby)
      for (int mbx = 0; mbx < mbw; ++mbx) {
        const int qmb = MbQuant(mbx, mby, qcur);
        const int delta = qmb - qcur;
        qcur = qmb;
        mbq[mby * mbw + mbx] = qmb;
        int levels[6][64], dc_diff[6], dir[6];
        for (int n = 0; n < 6; ++n) {
          int src[64], coef[64];
          SourceBlock(n, mbx, mby, src);
          dct.Run(src, coef);
          const int scale = n < 4 ? kYDcScale[qmb] : kCDcScale[qmb];
          const int dc_level = std::min(std::max((coef[0] + (scale >> 1)) / scale, 1), 2047 / scale);
          dc_diff[n] = PredictDc(n, mbx, mby, dc_level, scale, &dir[n]);
          levels[n][0] = 0;
          for (int k = 1; k < 64; ++k) {
            const int l = std::min(std::abs(coef[k]) / (2 * qmb), 2047);
            levels[n][k] = coef[k] < 0 ? -l : l;
          }
        }
        // AC prediction where it lowers the first row's or column's levels
        int pred[6][8], gain = 0;
        bool fits = true;
        for (int n = 0; n < 6; ++n) {
          // predicted from the blocks before it, whose levels are stored
          // first, as the decoder goes block by block
          AcPrediction(n, mbx, mby, dir[n], qmb, pred[n]);
          int16_t* entry = AcEntry(n, mbx, mby);
          for (int i = 1; i < 8; ++i) { entry[i] = static_cast<int16_t>(levels[n][i * 8]); entry[8 + i] = static_cast<int16_t>(levels[n][i]); }
          for (int i = 1; i < 8; ++i) {
            const int k = dir[n] == 0 ? i * 8 : i;
            const int r = levels[n][k] - pred[n][i];
            gain += std::abs(levels[n][k]) - std::abs(r);
            fits &= std::abs(r) <= 2047;
          }
        }
        const bool ac_pred = gain > 0 && fits;
        int coded[6][64], cbp = 0;
        for (int n = 0; n < 6; ++n) {
          std::memcpy(coded[n], levels[n], sizeof(coded[n]));
          if (ac_pred)
            for (int i = 1; i < 8; ++i) coded[n][dir[n] == 0 ? i * 8 : i] -= pred[n][i];
          bool any = false;
          for (int k = 1; k < 64; ++k) any |= coded[n][k] != 0;
          cbp |= any ? 32 >> n : 0;
        }
        const int mcbpc = (delta ? 4 : 0) | (cbp & 3);
        bw.Put(kIntraMcbpcCode[mcbpc], kIntraMcbpcBits[mcbpc]);
        bw.Put(ac_pred ? 1 : 0, 1);
        bw.Put(kCbpy[cbp >> 2][0], kCbpy[cbp >> 2][1]);
        if (delta) bw.Put(static_cast<uint32_t>(DquantIndex(delta)), 2);
        for (int n = 0; n < 6; ++n) {
          const int diff = dc_diff[n];
          int size = 0;
          while ((std::abs(diff) >> size) > 0) ++size;
          PutVlc(bw, n < 4 ? kDcLum : kDcChrom, size);
          if (size) {
            bw.Put(static_cast<uint32_t>(diff > 0 ? diff : diff + (1 << size) - 1), size);
            if (size > 8) bw.Put(1, 1);
          }
          if (cbp & (32 >> n)) PutCoeffs(bw, coded[n], 1, true, ac_pred ? (dir[n] == 0 ? kAltV : kAltH) : kZigzag);
        }
      }
  }

  int TableIndex(int n, int mbx, int mby, int* stride) const {
    const int c = n < 4 ? 0 : n - 3;
    *stride = c == 0 ? 2 * mbw + 1 : mbw + 1;
    const int bx = c == 0 ? 2 * mbx + (n & 1) + 1 : mbx + 1;
    const int by = c == 0 ? 2 * mby + (n >> 1) + 1 : mby + 1;
    return by * *stride + bx;
  }

  int16_t* AcEntry(int n, int mbx, int mby) {
    int stride;
    const int idx = TableIndex(n, mbx, mby, &stride);
    return acv[n < 4 ? 0 : n - 3].data() + static_cast<size_t>(idx) * 16;
  }

  // DC prediction as the decoder's PredDc: the DC difference to code, the
  // prediction's direction (0 left, 1 top), the table updated
  int PredictDc(int n, int mbx, int mby, int dc_level, int scale, int* dir) {
    int stride;
    const int idx = TableIndex(n, mbx, mby, &stride);
    int16_t* t = dcv[n < 4 ? 0 : n - 3].data();
    const int a = t[idx - 1], b = t[idx - 1 - stride], cc = t[idx - stride];
    *dir = std::abs(a - b) < std::abs(b - cc) ? 1 : 0;
    const int pred = ((*dir ? cc : a) + (scale >> 1)) / scale;
    int rec = dc_level * scale;
    if (rec & ~2047) rec = rec < 0 ? 0 : 2047;
    t[idx] = static_cast<int16_t>(rec);
    return dc_level - pred;
  }

  static int RoundedDiv(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

  // the decoder's AC prediction of block n's first column (dir 0) or row
  // (dir 1), pred[1..7], rescaled from a neighbour macroblock's quantizer
  void AcPrediction(int n, int mbx, int mby, int dir, int qmb, int* pred) {
    const int16_t* entry = AcEntry(n, mbx, mby);
    int stride;
    TableIndex(n, mbx, mby, &stride);
    if (dir == 0) {
      const int16_t* left = entry - 16;
      const int ql = mbx > 0 ? mbq[mby * mbw + mbx - 1] : qmb;
      const bool same = mbx == 0 || ql == qmb || n == 1 || n == 3;
      for (int i = 1; i < 8; ++i) pred[i] = same ? left[i] : RoundedDiv(left[i] * ql, qmb);
    } else {
      const int16_t* top = entry - 16 * stride;
      const int qt = mby > 0 ? mbq[(mby - 1) * mbw + mbx] : qmb;
      const bool same = mby == 0 || qt == qmb || n == 2 || n == 3;
      for (int i = 1; i < 8; ++i) pred[i] = same ? top[i + 8] : RoundedDiv(top[i + 8] * qt, qmb);
    }
  }

  // ------------------------------------------------------------ P-VOP
  int Sad(const PlaneRef& ref, int mbx, int mby, int x, int y2, int limit) const {
    const uint8_t* s = y.data() + static_cast<long>(mby * 16) * yw + mbx * 16;
    int sad = 0;
    const bool inside = x >= 0 && y2 >= 0 && x + 16 <= ref.w && y2 + 16 <= ref.h;
    for (int j = 0; j < 16; ++j) {
      for (int i = 0; i < 16; ++i) {
        const int r = inside ? ref.p[(y2 + j) * ref.stride + x + i] : ref.At(x + i, y2 + j);
        sad += std::abs(s[j * yw + i] - r);
      }
      if (sad >= limit) return sad;
    }
    return sad;
  }

  int HalfSad(const PlaneRef& ref, int mbx, int mby, int mx, int my) const {
    uint8_t pred[256];
    HpelPredict(ref, mbx * 16 + (mx >> 1), mby * 16 + (my >> 1), ((my & 1) << 1) | (mx & 1), 16, no_rnd, pred, 16);
    const uint8_t* s = y.data() + static_cast<long>(mby * 16) * yw + mbx * 16;
    int sad = 0;
    for (int j = 0; j < 16; ++j)
      for (int i = 0; i < 16; ++i) sad += std::abs(s[j * yw + i] - pred[j * 16 + i]);
    return sad;
  }

  int* Mv(int mbx, int mby) { return mvs.data() + (static_cast<size_t>(mby + 1) * (mbw + 2) + mbx + 1) * 2; }

  static int Median(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

  void PredictMv(int mbx, int mby, int* px, int* py) {
    const int* a = Mv(mbx - 1, mby);
    if (mby == 0) {
      if (mbx == 0) { *px = *py = 0; } else { *px = a[0]; *py = a[1]; }
      return;
    }
    const int* b = Mv(mbx, mby - 1);
    const int* c = Mv(mbx + 1, mby - 1);
    *px = Median(a[0], b[0], c[0]);
    *py = Median(a[1], b[1], c[1]);
  }

  static int MvBits(int d) {
    int bits = 1;
    for (int a = std::abs(d); a; a >>= 1) bits += 2;
    return bits;
  }

  void Search(const PlaneRef& ref, int mbx, int mby, int* best_mv) {
    const int range = 126;  // half-pel units: f_code 4 at most
    int px, py;
    PredictMv(mbx, mby, &px, &py);
    const int lambda = q;
    auto cost_of = [&](int mx, int my, int sad) { return sad + lambda * (MvBits(mx - px) + MvBits(my - py)); };
    int bx = 0, by = 0;
    int best = cost_of(0, 0, Sad(ref, mbx, mby, mbx * 16, mby * 16, 1 << 30));
    const int zero_cost = best;
    const int cand[3][2] = {{px >> 1, py >> 1}, {Mv(mbx - 1, mby)[0] >> 1, Mv(mbx - 1, mby)[1] >> 1},
                            {Mv(mbx, mby - 1)[0] >> 1, Mv(mbx, mby - 1)[1] >> 1}};
    for (const auto& cnd : cand) {
      const int cx = cnd[0], cy = cnd[1];
      if (std::abs(2 * cx) > range || std::abs(2 * cy) > range) continue;
      const int c = cost_of(2 * cx, 2 * cy, Sad(ref, mbx, mby, mbx * 16 + cx, mby * 16 + cy, best));
      if (c < best) { best = c; bx = cx; by = cy; }
    }
    for (int step = 0; step < 64; ++step) {
      static const int dirs[4][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1}};
      int nbx = bx, nby = by;
      for (const auto& d : dirs) {
        const int cx = bx + d[0], cy = by + d[1];
        if (std::abs(2 * cx) > range || std::abs(2 * cy) > range) continue;
        const int c = cost_of(2 * cx, 2 * cy, Sad(ref, mbx, mby, mbx * 16 + cx, mby * 16 + cy, best));
        if (c < best) { best = c; nbx = cx; nby = cy; }
      }
      if (nbx == bx && nby == by) break;
      bx = nbx; by = nby;
    }
    int hx = 2 * bx, hy = 2 * by;
    best = cost_of(hx, hy, HalfSad(ref, mbx, mby, hx, hy));
    const int cx0 = hx, cy0 = hy;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if (!dx && !dy) continue;
        const int mx = cx0 + dx, my = cy0 + dy;
        if (std::abs(mx) > range || std::abs(my) > range) continue;
        const int c = cost_of(mx, my, HalfSad(ref, mbx, mby, mx, my));
        if (c < best) { best = c; hx = mx; hy = my; }
      }
    if (zero_cost <= best + 2 * lambda) { hx = hy = 0; }
    best_mv[0] = hx;
    best_mv[1] = hy;
  }

  static void PutMvd(BitWriter& bw, int d, int fcode) {
    const int span = 64 << (fcode - 1);
    d = ((d + span / 2) % span + span) % span - span / 2;  // wrap into [-32 f, 32 f)
    if (d == 0) { PutVlc(bw, kMv, 0); return; }
    const int shift = fcode - 1, a = std::abs(d) - 1;
    PutVlc(bw, kMv, (a >> shift) + 1);
    bw.Put(d < 0 ? 1 : 0, 1);
    if (shift) bw.Put(static_cast<uint32_t>(a & ((1 << shift) - 1)), shift);
  }

  void InterVop(BitWriter& bw) {
    const Frame& rf = recon.ref;
    const PlaneRef ry{rf.y.data(), rf.w, rf.w, rf.h};  // the decoder's edges: whole macroblocks
    const PlaneRef ru{rf.u.data(), rf.w / 2, rf.w / 2, rf.h / 2};
    const PlaneRef rv{rf.v.data(), rf.w / 2, rf.w / 2, rf.h / 2};
    std::fill(mvs.begin(), mvs.end(), 0);
    int maxv = 0;
    for (int mby = 0; mby < mbh; ++mby)
      for (int mbx = 0; mbx < mbw; ++mbx) {
        int* m = Mv(mbx, mby);
        Search(ry, mbx, mby, m);
        maxv = std::max({maxv, m[0] < 0 ? -m[0] : m[0] + 1, m[1] < 0 ? -m[1] : m[1] + 1});
      }
    int fcode = 1;
    while ((32 << (fcode - 1)) < maxv) ++fcode;
    VopHeader(bw, true, fcode);
    const Fdct& dct = Dct();
    int qcur = q;
    for (int mby = 0; mby < mbh; ++mby)
      for (int mbx = 0; mbx < mbw; ++mbx) {
        int* m = Mv(mbx, mby);
        const int mx = m[0], my = m[1];
        uint8_t py[256], pu[64], pv[64];
        HpelPredict(ry, mbx * 16 + (mx >> 1), mby * 16 + (my >> 1), ((my & 1) << 1) | (mx & 1), 16, no_rnd, py, 16);
        const int cx = (mx >> 1) | (mx & 1), cy = (my >> 1) | (my & 1);
        const int cdxy = ((cy & 1) << 1) | (cx & 1);
        HpelPredict(ru, mbx * 8 + (cx >> 1), mby * 8 + (cy >> 1), cdxy, 8, no_rnd, pu, 8);
        HpelPredict(rv, mbx * 8 + (cx >> 1), mby * 8 + (cy >> 1), cdxy, 8, no_rnd, pv, 8);
        const int qmb = MbQuant(mbx, mby, qcur);
        const int qadd = (qmb - 1) | 1, maxl = (2047 - qadd) / (2 * qmb);
        int levels[6][64], cbp = 0;
        for (int n = 0; n < 6; ++n) {
          int src[64], coef[64];
          SourceBlock(n, mbx, mby, src);
          const uint8_t* pr = n < 4 ? py + (n >> 1) * 128 + (n & 1) * 8 : (n == 4 ? pu : pv);
          const int ps = n < 4 ? 16 : 8;
          for (int j = 0; j < 8; ++j)
            for (int i = 0; i < 8; ++i) src[j * 8 + i] -= pr[j * ps + i];
          dct.Run(src, coef);
          bool any = false;
          for (int k = 0; k < 64; ++k) {
            int l = std::min((std::abs(coef[k]) - qmb / 2) / (2 * qmb), maxl);
            if (l < 0) l = 0;
            levels[n][k] = coef[k] < 0 ? -l : l;
            any |= l != 0;
          }
          cbp |= any ? 32 >> n : 0;
        }
        if (!cbp && !mx && !my) {
          bw.Put(1, 1);  // not coded
          continue;
        }
        bw.Put(0, 1);
        const int delta = qmb - qcur;
        qcur = qmb;
        const int mcbpc = (delta ? 8 : 0) | (cbp & 3), cbpy = cbp >> 2;
        bw.Put(kInterMcbpcCode[mcbpc], kInterMcbpcBits[mcbpc]);
        bw.Put(kCbpy[cbpy ^ 15][0], kCbpy[cbpy ^ 15][1]);
        if (delta) bw.Put(static_cast<uint32_t>(DquantIndex(delta)), 2);
        int px, pyy;
        PredictMv(mbx, mby, &px, &pyy);
        PutMvd(bw, mx - px, fcode);
        PutMvd(bw, my - pyy, fcode);
        for (int n = 0; n < 6; ++n)
          if (cbp & (32 >> n)) PutCoeffs(bw, levels[n], 0, false, kZigzag);
      }
  }

  // encode one h x w x 3 BGR frame; the packet is in `packet`
  int Encode(const uint8_t* bgr, int* key) {
    LoadFrame(bgr);
    BitWriter bw;
    const bool intra = index % gop == 0;
    if (intra) {
      no_rnd = false;
      IntraVop(bw);
    } else {
      no_rnd = !no_rnd;
      InterVop(bw);
    }
    bw.Stuff();
    packet = bw.out;
    *key = intra;
    ++index;
    return recon.Decode(packet.data(), static_cast<long>(packet.size())) == 1 ? 0 : -1;
  }
};

}  // namespace

// an encoder of w x h frames at `res / inc` frames a second (res is the VOL's
// vop_time_increment_resolution), quantizer q (1..29, the VOP's; busy
// macroblocks take q + 2 by dquant), an I-VOP every gop
extern "C" void* mpeg4_enc_new(int w, int h, int res, int inc, int q, int gop) {
  if (w <= 0 || h <= 0 || w >= 8192 || h >= 8192 || res <= 0 || res > 65535 || inc <= 0 || q < 1 || q > 29 || gop < 1)
    return nullptr;
  return new Encoder(w, h, res, inc, q, gop);
}

extern "C" void mpeg4_enc_free(void* h) { delete static_cast<Encoder*>(h); }

// the decoder configuration (VOS, VO and VOL headers) into out; its length
extern "C" long mpeg4_enc_config(void* h, uint8_t* out, long cap) {
  const std::vector<uint8_t> cfg = static_cast<Encoder*>(h)->Config();
  if (static_cast<long>(cfg.size()) > cap) return -static_cast<long>(cfg.size());
  std::memcpy(out, cfg.data(), cfg.size());
  return static_cast<long>(cfg.size());
}

// encode one frame (h x w x 3 BGR); returns the packet's length (copied to
// out; minus the length needed when cap is short, the packet then kept for
// the next call with a null frame), *key 1 for an I-VOP
extern "C" long mpeg4_enc_frame(void* h, const uint8_t* bgr, uint8_t* out, long cap, int* key) {
  Encoder* enc = static_cast<Encoder*>(h);
  if (bgr && enc->Encode(bgr, key) != 0) return 0;
  const long n = static_cast<long>(enc->packet.size());
  if (n > cap) return -n;
  std::memcpy(out, enc->packet.data(), static_cast<size_t>(n));
  return n;
}

// the decoder's reconstruction of the last frame written (h x w x 3 BGR)
extern "C" int mpeg4_enc_recon(void* h, uint8_t* bgr) {
  const Encoder* enc = static_cast<Encoder*>(h);
  if (!enc->recon.have_frame) return -1;
  static const YuvToBgr conv;
  const Frame& f = enc->recon.ref;
  conv.Convert(f.y.data(), f.w, f.u.data(), f.v.data(), f.w / 2, enc->width, enc->height, bgr);
  return 0;
}
