// Lossless WebP (VP8L) encoder on the host, for the port's image writer
// (`tamtr_torch/data/image_io.py:encode_webp`); the reverse of the VP8L
// decoder in `webp_decode.cpp`. The container is written in Python.
//
// What it does, within one image:
//   - subtract-green where it pays, then the predictor transform: one of
//     the 14 modes a tile, chosen by the entropy its residuals add to the
//     image's;
//   - the cross-colour transform, its three multipliers searched a tile at
//     a time, kept where its estimated saving exceeds its own bits;
//   - or, for an image of at most 256 colours, the colour-indexing
//     transform (pixels packed 2, 4 or 8 to a byte when the palette allows);
//   - LZ77 backward references: the pixel to the left, the three above and
//     a hash chain of pixel pairs, distances written as the 120 short plane
//     codes where one fits;
//   - a colour cache, its size chosen by the entropy it leaves;
//   - canonical Huffman codes limited to 15 bits (7 for the code-length
//     code), written as simple codes when one or two 8-bit symbols are used,
//     else through the code-length code with its run codes 16, 17 and 18.
// It encodes each layout that may win (the pixels as they are, the spatial
// transforms with and without subtract-green, at the default tile size and
// as one tile, the palette; a large image only those an entropy analysis
// favours) and keeps the shortest. Its bytes are not libwebp's: libwebp's
// encoder adds many heuristics (histogram clustering into several Huffman
// groups, cost-model parsing of the references), so its files are
// somewhat smaller; both decode to the same pixels.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

#include "vp8l.h"

namespace {

using namespace vp8l;

const int kMaxLength = 4096;
const int kWindowSize = (1 << 20) - 120;
const int kNumLengthCodes = 24, kNumDistanceCodes = 40;

// ------------------------------------------------------------ bits out

struct BitWriter {  // LSB first
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nacc = 0;
  void Put(uint32_t v, int n) {
    if (n == 0) return;
    acc |= static_cast<uint64_t>(v & ((n == 32) ? 0xffffffffu : ((1u << n) - 1))) << nacc;
    nacc += n;
    while (nacc >= 8) {
      buf.push_back(static_cast<uint8_t>(acc));
      acc >>= 8;
      nacc -= 8;
    }
  }
  long Bits() const { return static_cast<long>(buf.size()) * 8 + nacc; }
  void Finish() {
    if (nacc) buf.push_back(static_cast<uint8_t>(acc));
    acc = 0;
    nacc = 0;
  }
};

// ------------------------------------------------------------ prefix codes

// the prefix symbol and extra bits of a length or a distance code (>= 1)
inline void PrefixEncode(int value, int* sym, int* nbits, int* extra) {
  const int d = value - 1;
  if (d < 4) {
    *sym = d;
    *nbits = 0;
    *extra = 0;
    return;
  }
  int hb = 31 - __builtin_clz(static_cast<unsigned>(d));
  const int second = (d >> (hb - 1)) & 1;
  *nbits = hb - 1;
  *extra = d & ((1 << *nbits) - 1);
  *sym = 2 * hb + second;
}

// Shannon bits of a histogram
double Entropy(const uint32_t* h, int n) {
  double sum = 0, bits = 0;
  for (int i = 0; i < n; ++i) {
    sum += h[i];
    bits -= h[i] ? h[i] * std::log2(static_cast<double>(h[i])) : 0.0;
  }
  return sum > 0 ? bits + sum * std::log2(sum) : 0.0;
}

// Code lengths of a Huffman code for `h`, none above `limit`: the usual
// tree, rebuilt with the small counts raised until it fits.
void BuildLengths(const uint32_t* h, int n, int limit, std::vector<uint8_t>& len) {
  len.assign(n, 0);
  std::vector<int> used;
  for (int i = 0; i < n; ++i)
    if (h[i]) used.push_back(i);
  if (used.empty()) return;
  if (used.size() == 1) {
    len[used[0]] = 1;
    return;
  }
  for (uint64_t floor = 1;; floor *= 2) {
    struct Node {
      uint64_t w;
      int id;
      bool operator>(const Node& o) const { return w != o.w ? w > o.w : id > o.id; }
    };
    const int m = static_cast<int>(used.size());
    std::vector<int> parent(2 * m, -1);
    std::priority_queue<Node, std::vector<Node>, std::greater<Node>> q;
    for (int k = 0; k < m; ++k) q.push({std::max<uint64_t>(h[used[k]], floor), k});
    int next = m;
    while (q.size() > 1) {
      const Node a = q.top();
      q.pop();
      const Node b = q.top();
      q.pop();
      parent[a.id] = parent[b.id] = next;
      q.push({a.w + b.w, next++});
    }
    int maxlen = 0;
    for (int k = 0; k < m; ++k) {
      int d = 0;
      for (int p = parent[k]; p >= 0; p = parent[p]) ++d;
      len[used[k]] = static_cast<uint8_t>(d);
      maxlen = std::max(maxlen, d);
    }
    if (maxlen <= limit) return;
  }
}

struct Code {
  std::vector<uint8_t> len;
  std::vector<uint16_t> bits;  // bit-reversed canonical codes
  bool single = false;         // one symbol: written with no bits
  void Build(const uint32_t* h, int n, int limit) {
    BuildLengths(h, n, limit, len);
    int used = 0;
    for (uint8_t l : len) used += l != 0;
    single = used <= 1;
    bits.assign(n, 0);
    int count[16] = {0}, next[16] = {0};
    for (uint8_t l : len) ++count[l];
    count[0] = 0;
    for (int l = 1, code = 0; l < 16; ++l) {
      code = (code + count[l - 1]) << 1;
      next[l] = code;
    }
    for (int s = 0; s < n; ++s) {
      const int l = len[s];
      if (!l) continue;
      int c = next[l]++, r = 0;
      for (int b = 0; b < l; ++b) r |= ((c >> b) & 1) << (l - 1 - b);
      bits[s] = static_cast<uint16_t>(r);
    }
  }
  void Write(BitWriter& bw, int s) const {
    if (!single) bw.Put(bits[s], len[s]);
  }
};

// Writes a code for histogram `h` of alphabet `n` and returns it.
Code WriteCode(BitWriter& bw, const uint32_t* h, int n) {
  std::vector<int> used;
  for (int i = 0; i < n && used.size() < 3; ++i)
    if (h[i]) used.push_back(i);
  Code code;
  if (used.size() <= 2 && (used.empty() || used.back() < 256)) {  // simple code
    if (used.empty()) used.push_back(0);
    bw.Put(1, 1);
    bw.Put(static_cast<uint32_t>(used.size() - 1), 1);
    if (used[0] < 2) {
      bw.Put(0, 1);
      bw.Put(used[0], 1);
    } else {
      bw.Put(1, 1);
      bw.Put(used[0], 8);
    }
    if (used.size() == 2) bw.Put(used[1], 8);
    std::vector<uint32_t> hh(n, 0);
    for (int s : used) hh[s] = 1;
    code.Build(hh.data(), n, 15);
    return code;
  }
  code.Build(h, n, 15);
  // the lengths as code-length tokens (value, extra bits)
  std::vector<std::pair<int, int>> tokens;
  int prev = 8;
  for (int i = 0; i < n;) {
    const int v = code.len[i];
    int run = 1;
    while (i + run < n && code.len[i + run] == v) ++run;
    i += run;
    if (v == 0) {
      while (run >= 11) {
        const int r = std::min(run, 138);
        tokens.push_back({18, r - 11});
        run -= r;
      }
      if (run >= 3) {
        tokens.push_back({17, run - 3});
        run = 0;
      }
      for (; run > 0; --run) tokens.push_back({0, 0});
    } else {
      if (v != prev) {
        tokens.push_back({v, 0});
        prev = v;
        --run;
      }
      while (run >= 3) {
        const int r = std::min(run, 6);
        tokens.push_back({16, r - 3});
        run -= r;
      }
      for (; run > 0; --run) tokens.push_back({v, 0});
    }
  }
  uint32_t th[19] = {0};
  for (auto& t : tokens) ++th[t.first];
  Code cl;
  cl.Build(th, 19, 7);
  int num = 19;
  while (num > 4 && cl.len[kCodeLengthCodeOrder[num - 1]] == 0) --num;
  bw.Put(0, 1);
  bw.Put(num - 4, 4);
  for (int i = 0; i < num; ++i) bw.Put(cl.len[kCodeLengthCodeOrder[i]], 3);
  bw.Put(0, 1);  // max_symbol: the whole alphabet
  static const int kExtraBits[3] = {2, 3, 7};
  for (auto& t : tokens) {
    cl.Write(bw, t.first);
    if (t.first >= 16) bw.Put(t.second, kExtraBits[t.first - 16]);
  }
  return code;
}

// ------------------------------------------------------------ references

struct Ref {
  uint32_t argb;  // a literal's pixel
  int len;        // 0 for a literal, else a copy of `len` pixels
  int dist;       // the copy's distance in pixels
};

inline uint32_t HashPair(uint32_t a, uint32_t b, int bits) {
  const uint32_t k = (a * 0x9e3779b1u) ^ (b * 0x85ebca6bu) ^ (b >> 13);
  return (k * 0xc2b2ae35u) >> (32 - bits);
}

// the plane code of each distance reachable by one of the 120 short codes
// (the smallest where several reach it), else the distance + 120
struct PlaneCodes {
  std::vector<uint8_t> code;  // by distance, 0 where no short code reaches it
  explicit PlaneCodes(int xsize) : code(static_cast<size_t>(xsize) * 8 + 9, 0) {
    for (int c = 120; c >= 1; --c) {
      const int dc = kCodeToPlane[c - 1];
      const int d = std::max(1, (dc >> 4) * xsize + 8 - (dc & 0xf));
      code[d] = static_cast<uint8_t>(c);
    }
  }
  int operator()(int dist) const {
    return static_cast<size_t>(dist) < code.size() && code[dist] ? code[dist] : dist + 120;
  }
};

// LZ77 over the pixels: the pixel to the left, the three above and the
// hash chain of the pixel pair, longest match (ties to the cheaper distance
// code), one step of lazy matching.
std::vector<Ref> BackwardRefs(const std::vector<uint32_t>& px, int xsize, int iters) {
  const int n = static_cast<int>(px.size());
  std::vector<Ref> refs;
  refs.reserve(n);
  if (n < 3) {
    for (uint32_t p : px) refs.push_back({p, 0, 0});
    return refs;
  }
  const int hbits = n > (1 << 16) ? 18 : 14;
  std::vector<int> head(1 << hbits, -1), chain(n, -1);
  const PlaneCodes planes(xsize);
  const int window = std::min(kWindowSize, std::max(xsize << 8, 1 << 16));
  int inserted = 0;
  auto insert_upto = [&](int end) {  // hash positions < end
    for (; inserted < end && inserted + 1 < n; ++inserted) {
      const uint32_t hv = HashPair(px[inserted], px[inserted + 1], hbits);
      chain[inserted] = head[hv];
      head[hv] = inserted;
    }
  };
  auto match_len = [&](int i, int j, int maxl) {
    int l = 0;
    while (l < maxl && px[i + l] == px[j + l]) ++l;
    return l;
  };
  // the best (length, distance) at i, from candidates before i
  auto find = [&](int i, int* best_dist) {
    const int maxl = std::min(kMaxLength, n - i);
    int best = 0, best_code = 1 << 30;
    auto consider = [&](int j) {
      const int d = i - j;
      if (j < 0 || d < 1 || d > window) return;
      // a match that differs at `best` cannot be longer; it may only tie
      // with a cheaper distance code
      if (best > 0 && best < maxl && px[j + best] != px[i + best] && planes(d) >= best_code) return;
      const int l = match_len(i, j, maxl);
      if (l < 2) return;
      const int code = planes(d);
      if (l > best || (l == best && code < best_code)) {
        best = l;
        best_code = code;
        *best_dist = d;
      }
    };
    if (i >= 1) consider(i - 1);
    for (int d = xsize - 1; d <= xsize + 1; ++d)  // the row above, and its diagonals
      if (i >= d && d > 1) consider(i - d);
    if (i + 1 < n) {
      int j = head[HashPair(px[i], px[i + 1], hbits)];
      for (int k = 0; j >= 0 && k < iters && best < maxl; ++k, j = chain[j]) {
        if (i - j > window) break;
        consider(j);
      }
    }
    return best;
  };
  int i = 0, ahead_len = -1, ahead_dist = 0;  // the look-ahead's match at i, when known
  while (i < n) {
    insert_upto(i);
    int dist = ahead_dist;
    int len = ahead_len >= 0 ? ahead_len : find(i, &dist);
    ahead_len = -1;
    if (len >= 3 && len < 64 && i + 1 < n) {  // lazy: a longer match one pixel on
      insert_upto(i + 1);
      int d2 = 0;
      const int l2 = find(i + 1, &d2);
      if (l2 > len + 1) {
        len = 0;
        ahead_len = l2;
        ahead_dist = d2;
      }
    }
    if (len >= 3 || (len == 2 && planes(dist) <= 8)) {
      refs.push_back({0, len, dist});
      i += len;
    } else {
      refs.push_back({px[i], 0, 0});
      ++i;
    }
  }
  return refs;
}

// ------------------------------------------------------------ one stream

inline uint32_t CacheKey(uint32_t argb, int bits) { return (argb * 0x1e35a7bdu) >> (32 - bits); }

struct Histo {
  std::vector<uint32_t> h[5];  // green + lengths + cache, red, blue, alpha, distance
  explicit Histo(int cache_bits) {
    h[0].assign(256 + kNumLengthCodes + (cache_bits ? 1 << cache_bits : 0), 0);
    for (int k = 1; k < 4; ++k) h[k].assign(256, 0);
    h[4].assign(kNumDistanceCodes, 0);
  }
  double Bits() const {
    double b = 0;
    for (int k = 0; k < 5; ++k) b += Entropy(h[k].data(), static_cast<int>(h[k].size()));
    return b;
  }
};

// Walks the references with a colour cache of `cache_bits`, calling
// lit(argb), cached(key) and copy(len, plane code) in order.
template <class Lit, class Cached, class Copy>
void Walk(const std::vector<Ref>& refs, const std::vector<uint32_t>& px, int cache_bits, const PlaneCodes& planes,
          Lit lit, Cached cached, Copy copy) {
  std::vector<uint32_t> cache(cache_bits ? 1 << cache_bits : 0, 0);
  long pos = 0;
  for (const Ref& r : refs) {
    if (r.len == 0) {
      if (cache_bits) {
        const uint32_t key = CacheKey(r.argb, cache_bits);
        if (cache[key] == r.argb)
          cached(static_cast<int>(key));
        else
          lit(r.argb);
        cache[key] = r.argb;
      } else {
        lit(r.argb);
      }
      ++pos;
    } else {
      copy(r.len, planes(r.dist));
      if (cache_bits)
        for (int k = 0; k < r.len; ++k) cache[CacheKey(px[pos + k], cache_bits)] = px[pos + k];
      pos += r.len;
    }
  }
}

Histo Histogram(const std::vector<Ref>& refs, const std::vector<uint32_t>& px, int cache_bits,
                const PlaneCodes& planes) {
  Histo hs(cache_bits);
  Walk(
      refs, px, cache_bits, planes,
      [&](uint32_t p) {
        ++hs.h[0][(p >> 8) & 0xff];
        ++hs.h[1][(p >> 16) & 0xff];
        ++hs.h[2][p & 0xff];
        ++hs.h[3][p >> 24];
      },
      [&](int key) { ++hs.h[0][256 + kNumLengthCodes + key]; },
      [&](int len, int code) {
        int sym, nb, ex;
        PrefixEncode(len, &sym, &nb, &ex);
        ++hs.h[0][256 + sym];
        PrefixEncode(code, &sym, &nb, &ex);
        ++hs.h[4][sym];
      });
  return hs;
}

// The colour-cache size (0 for none, else 1-10 bits) whose symbols the
// Shannon estimate codes in the fewest bits, the larger code's own cost
// counted roughly; every size is tried in one walk over the references.
int BestCacheBits(const std::vector<Ref>& refs, const std::vector<uint32_t>& px, const PlaneCodes& planes) {
  const int kMax = 10;
  const Histo all = Histogram(refs, px, 0, planes);
  std::vector<uint32_t> caches[kMax + 1], keys[kMax + 1], hits[kMax + 1];  // hits: green, red, blue, alpha
  for (int b = 1; b <= kMax; ++b) {
    caches[b].assign(1 << b, 0);
    keys[b].assign(1 << b, 0);
    hits[b].assign(4 * 256, 0);
  }
  long pos = 0;
  auto insert = [&](uint32_t argb, bool literal) {
    const uint32_t hv = argb * 0x1e35a7bdu;
    for (int b = 1; b <= kMax; ++b) {
      const uint32_t key = hv >> (32 - b);
      if (literal && caches[b][key] == argb) {
        ++keys[b][key];
        ++hits[b][(argb >> 8) & 0xff];
        ++hits[b][256 + ((argb >> 16) & 0xff)];
        ++hits[b][512 + (argb & 0xff)];
        ++hits[b][768 + (argb >> 24)];
      }
      caches[b][key] = argb;
    }
  };
  for (const Ref& r : refs) {
    if (r.len == 0) {
      insert(r.argb, true);
      ++pos;
    } else {
      for (int k = 0; k < r.len; ++k) insert(px[pos + k], false);
      pos += r.len;
    }
  }
  double best = all.Bits();
  int best_bits = 0;
  std::vector<uint32_t> h;
  for (int b = 1; b <= kMax; ++b) {
    double bits = (1 << b) * 0.5 + Entropy(all.h[4].data(), kNumDistanceCodes);
    h.assign(all.h[0].begin(), all.h[0].end());
    for (int i = 0; i < 256; ++i) h[i] -= hits[b][i];
    h.insert(h.end(), keys[b].begin(), keys[b].end());
    bits += Entropy(h.data(), static_cast<int>(h.size()));
    for (int c = 1; c < 4; ++c) {
      h.assign(all.h[c].begin(), all.h[c].end());
      for (int i = 0; i < 256; ++i) h[i] -= hits[b][c * 256 + i];
      bits += Entropy(h.data(), 256);
    }
    if (bits < best) {
      best = bits;
      best_bits = b;
    }
  }
  return best_bits;
}

// the pixels of one image as an entropy-coded stream (cache bits, for the
// main image the meta-code bit, the five codes, the symbols)
void WriteStream(BitWriter& bw, const std::vector<uint32_t>& px, int xsize, bool main_image, int iters) {
  const std::vector<Ref> refs = BackwardRefs(px, xsize, iters);
  const PlaneCodes planes(xsize);
  const int cache_bits = main_image || px.size() > 256 ? BestCacheBits(refs, px, planes) : 0;
  const Histo hs = Histogram(refs, px, cache_bits, planes);
  if (cache_bits) {
    bw.Put(1, 1);
    bw.Put(cache_bits, 4);
  } else {
    bw.Put(0, 1);
  }
  if (main_image) bw.Put(0, 1);  // one group of codes
  Code codes[5];
  for (int k = 0; k < 5; ++k) codes[k] = WriteCode(bw, hs.h[k].data(), static_cast<int>(hs.h[k].size()));
  Walk(
      refs, px, cache_bits, planes,
      [&](uint32_t p) {
        codes[0].Write(bw, (p >> 8) & 0xff);
        codes[1].Write(bw, (p >> 16) & 0xff);
        codes[2].Write(bw, p & 0xff);
        codes[3].Write(bw, p >> 24);
      },
      [&](int key) { codes[0].Write(bw, 256 + kNumLengthCodes + key); },
      [&](int len, int code) {
        int sym, nb, ex;
        PrefixEncode(len, &sym, &nb, &ex);
        codes[0].Write(bw, 256 + sym);
        bw.Put(ex, nb);
        PrefixEncode(code, &sym, &nb, &ex);
        codes[4].Write(bw, sym);
        bw.Put(ex, nb);
      });
}

// ------------------------------------------------------------ transforms

template <int M>
void RowResidualsT(const uint32_t* cur, const uint32_t* top, int x0, int x1, uint32_t* out) {
  for (int x = x0; x < x1; ++x) out[x] = SubPixels(cur[x], Predict(M, cur, x, top));
}

// the residuals of row y of the w-wide image `px` under `mode`, for x in
// [x0, x1); row 0 and column 0 as the decoder predicts them (left, top)
void RowResiduals(int mode, const uint32_t* px, int w, int y, int x0, int x1, uint32_t* out) {
  const uint32_t* cur = px + static_cast<size_t>(y) * w;
  if (y == 0) {
    for (int x = x0; x < x1; ++x) out[x] = SubPixels(cur[x], x ? cur[x - 1] : 0xff000000u);
    return;
  }
  if (x0 == 0) {
    out[0] = SubPixels(cur[0], cur[-w]);
    x0 = 1;
  }
  if (x0 >= x1) return;
  using Fn = void (*)(const uint32_t*, const uint32_t*, int, int, uint32_t*);
  static const Fn kRows[14] = {RowResidualsT<0>, RowResidualsT<1>, RowResidualsT<2>,  RowResidualsT<3>,  RowResidualsT<4>,
                               RowResidualsT<5>, RowResidualsT<6>, RowResidualsT<7>,  RowResidualsT<8>,  RowResidualsT<9>,
                               RowResidualsT<10>, RowResidualsT<11>, RowResidualsT<12>, RowResidualsT<13>};
  kRows[mode](cur, cur - w, x0, x1, out);
}

// v * log2(v) for the counts the estimates meet most
double VLog2V(uint32_t v) {
  static const std::vector<float> table = [] {
    std::vector<float> t(1 << 16);
    t[0] = 0;
    for (uint32_t i = 1; i < t.size(); ++i) t[i] = static_cast<float>(i * std::log2(static_cast<double>(i)));
    return t;
  }();
  return v < table.size() ? table[v] : v * std::log2(static_cast<double>(v));
}

// A tile's histogram: the counts and the bins it touched.
struct Sparse {
  uint32_t count[256] = {0};
  int bins[256];
  int n = 0, total = 0;
  void Add(int b) {
    if (!count[b]++) bins[n++] = b;
    ++total;
  }
  void Clear() {
    for (int k = 0; k < n; ++k) count[bins[k]] = 0;
    n = total = 0;
  }
};

// bits a tile's histogram adds to the running one `acc` of `acc_total`
// symbols (the Shannon bits of their sum less those of `acc`; the bins the
// tile leaves empty cancel), plus a small bias toward residuals near 0
double AddedBits(const Sparse& tile, const uint32_t* acc, uint32_t acc_total) {
  double delta = 0, bias = 0;
  for (int k = 0; k < tile.n; ++k) {
    const int i = tile.bins[k];
    const uint32_t t = tile.count[i], a = acc[i];
    delta += VLog2V(a + t) - VLog2V(a);
    bias += static_cast<double>(t) * std::min(i, 256 - i);
  }
  return VLog2V(acc_total + tile.total) - VLog2V(acc_total) - delta + bias * (0.02 / 16);
}

// Predictor transform of `px` (in place: residuals) with tiles of 1 << bits;
// returns the modes image. A band of tile rows is predicted under every
// mode, then each tile takes the mode whose residuals add the fewest bits
// to those of the tiles before it (alpha is 255 throughout: its residual
// is 0 under every mode).
std::vector<uint32_t> PredictorTransform(std::vector<uint32_t>& px, int w, int h, int bits) {
  const int tw = (w + (1 << bits) - 1) >> bits, th = (h + (1 << bits) - 1) >> bits;
  const int size = 1 << bits;
  std::vector<uint32_t> modes(static_cast<size_t>(tw) * th);
  std::vector<uint32_t> acc(3 * 256, 0);
  uint32_t acc_total = 0;
  std::vector<uint32_t> band(static_cast<size_t>(14) * size * w), res(px.size());
  Sparse tile[3];
  for (int ty = 0; ty < th; ++ty) {
    const int y0 = ty << bits, y1 = std::min(h, y0 + size);
    for (int mode = 0; mode < 14; ++mode)
      for (int y = y0; y < y1; ++y)
        RowResiduals(mode, px.data(), w, y, 0, w, &band[(static_cast<size_t>(mode) * size + (y - y0)) * w]);
    for (int tx = 0; tx < tw; ++tx) {
      const int x0 = tx << bits, x1 = std::min(w, x0 + size);
      double best = 1e300;
      int best_mode = 0;
      for (int mode = 0; mode < 14; ++mode) {
        for (auto& t : tile) t.Clear();
        for (int y = y0; y < y1; ++y) {
          const uint32_t* r = &band[(static_cast<size_t>(mode) * size + (y - y0)) * w];
          for (int x = x0; x < x1; ++x) {
            tile[0].Add((r[x] >> 16) & 0xff);
            tile[1].Add((r[x] >> 8) & 0xff);
            tile[2].Add(r[x] & 0xff);
          }
        }
        double cost = 0;
        for (int c = 0; c < 3; ++c) cost += AddedBits(tile[c], &acc[c * 256], acc_total);
        if (cost < best) {
          best = cost;
          best_mode = mode;
        }
      }
      modes[static_cast<size_t>(ty) * tw + tx] = 0xff000000u | (static_cast<uint32_t>(best_mode) << 8);
      for (int y = y0; y < y1; ++y) {
        const uint32_t* r = &band[(static_cast<size_t>(best_mode) * size + (y - y0)) * w];
        for (int x = x0; x < x1; ++x) {
          ++acc[0 * 256 + ((r[x] >> 16) & 0xff)];
          ++acc[1 * 256 + ((r[x] >> 8) & 0xff)];
          ++acc[2 * 256 + (r[x] & 0xff)];
          ++acc_total;
          res[static_cast<size_t>(y) * w + x] = r[x];
        }
      }
    }
  }
  px.swap(res);
  return modes;
}

inline int ColorDelta(int8_t t, int8_t c) { return (static_cast<int>(t) * static_cast<int>(c)) >> 5; }

// Cross-colour transform of the residuals `px` (in place), tiles of
// 1 << bits; returns the multipliers image, or an empty one where the
// transform does not pay for its own bits.
std::vector<uint32_t> CrossColorTransform(std::vector<uint32_t>& px, int w, int h, int bits) {
  const int tw = (w + (1 << bits) - 1) >> bits, th = (h + (1 << bits) - 1) >> bits;
  std::vector<uint32_t> mult(static_cast<size_t>(tw) * th, 0xff000000u);
  std::vector<uint32_t> acc_r(256, 0), acc_b(256, 0);
  uint32_t acc_total = 0;
  Sparse hist;
  std::vector<int8_t> green, red;
  std::vector<uint8_t> ured, ublue;
  auto red_cost = [&](int g2r) {
    hist.Clear();
    for (size_t k = 0; k < green.size(); ++k) hist.Add((ured[k] - ColorDelta(static_cast<int8_t>(g2r), green[k])) & 0xff);
    return AddedBits(hist, acc_r.data(), acc_total);
  };
  auto blue_cost = [&](int g2b, int r2b) {
    hist.Clear();
    for (size_t k = 0; k < green.size(); ++k)
      hist.Add((ublue[k] - ColorDelta(static_cast<int8_t>(g2b), green[k]) -
                ColorDelta(static_cast<int8_t>(r2b), red[k])) & 0xff);
    return AddedBits(hist, acc_b.data(), acc_total);
  };
  // the best of 0 and `start`, then a step of 32, 16, ..., 1 either way
  auto search = [&](auto cost, int start, double* best_cost) {
    int best = 0;
    *best_cost = cost(0);
    if (start) {
      const double c = cost(start);
      if (c < *best_cost) {
        *best_cost = c;
        best = start;
      }
    }
    for (int step = 32; step >= 1; step >>= 1) {
      const int from = best;
      for (int v : {from - step, from + step}) {
        if (v < -128 || v > 127) continue;
        const double c = cost(v);
        if (c < *best_cost) {
          *best_cost = c;
          best = v;
        }
      }
    }
    return best;
  };
  double gain = 0;
  int prev_g2r = 0, prev_g2b = 0, prev_r2b = 0;
  for (int ty = 0; ty < th; ++ty)
    for (int tx = 0; tx < tw; ++tx) {
      const int x0 = tx << bits, y0 = ty << bits;
      const int x1 = std::min(w, x0 + (1 << bits)), y1 = std::min(h, y0 + (1 << bits));
      green.clear();
      red.clear();
      ured.clear();
      ublue.clear();
      for (int y = y0; y < y1; ++y)
        for (int x = x0; x < x1; ++x) {
          const uint32_t p = px[static_cast<size_t>(y) * w + x];
          green.push_back(static_cast<int8_t>(p >> 8));
          red.push_back(static_cast<int8_t>(p >> 16));
          ured.push_back(static_cast<uint8_t>(p >> 16));
          ublue.push_back(static_cast<uint8_t>(p));
        }
      const double red0 = red_cost(0), blue0 = blue_cost(0, 0);
      double red_best, blue_best;
      const int g2r = search(red_cost, prev_g2r, &red_best);
      const int g2b = search([&](int v) { return blue_cost(v, 0); }, prev_g2b, &blue_best);
      const int r2b = search([&](int v) { return blue_cost(g2b, v); }, prev_r2b, &blue_best);
      gain += red0 + blue0 - red_best - blue_best;
      prev_g2r = g2r;
      prev_g2b = g2b;
      prev_r2b = r2b;
      mult[static_cast<size_t>(ty) * tw + tx] = 0xff000000u | (static_cast<uint32_t>(r2b & 0xff) << 16) |
                                                (static_cast<uint32_t>(g2b & 0xff) << 8) |
                                                static_cast<uint32_t>(g2r & 0xff);
      size_t k = 0;
      for (int y = y0; y < y1; ++y)
        for (int x = x0; x < x1; ++x, ++k) {
          const int nr = (ured[k] - ColorDelta(static_cast<int8_t>(g2r), green[k])) & 0xff;
          const int nb = (ublue[k] - ColorDelta(static_cast<int8_t>(g2b), green[k]) -
                          ColorDelta(static_cast<int8_t>(r2b), red[k])) & 0xff;
          ++acc_r[nr];
          ++acc_b[nb];
          ++acc_total;
          uint32_t& p = px[static_cast<size_t>(y) * w + x];
          p = (p & 0xff00ff00u) | (static_cast<uint32_t>(nr) << 16) | static_cast<uint32_t>(nb);
        }
    }
  // the multipliers image's own cost, roughly: a few bits a tile
  if (gain <= 4.0 * tw * th + 200) mult.clear();
  return mult;
}

inline uint32_t SubtractGreen(uint32_t p) {
  const uint32_t g = (p >> 8) & 0xff;
  return (p & 0xff00ff00u) | ((((p >> 16) & 0xff) - g) & 0xff) << 16 | (((p & 0xff) - g) & 0xff);
}

// ------------------------------------------------------------ layouts

void Header(BitWriter& bw, int w, int h) {
  bw.Put(0x2f, 8);
  bw.Put(w - 1, 14);
  bw.Put(h - 1, 14);
  bw.Put(0, 1);  // alpha_is_used
  bw.Put(0, 3);  // version
}

int TileBits(int w, int h) {
  const long n = static_cast<long>(w) * h;
  return n < 64 * 64 ? 2 : n < 512 * 512 ? 3 : 4;
}

BitWriter EncodeDirect(const std::vector<uint32_t>& px, int w, int h, int iters) {
  BitWriter bw;
  Header(bw, w, h);
  bw.Put(0, 1);  // no transform
  WriteStream(bw, px, w, true, iters);
  return bw;
}

BitWriter EncodeSpatial(std::vector<uint32_t> px, int w, int h, int iters, bool subtract_green, int bits) {
  BitWriter bw;
  Header(bw, w, h);
  if (subtract_green) {
    for (auto& p : px) p = SubtractGreen(p);
    bw.Put(1, 1);
    bw.Put(2, 2);  // subtract green
  }
  const std::vector<uint32_t> modes = PredictorTransform(px, w, h, bits);
  bw.Put(1, 1);
  bw.Put(0, 2);  // predictor
  bw.Put(bits - 2, 3);
  WriteStream(bw, modes, (w + (1 << bits) - 1) >> bits, false, iters);
  std::vector<uint32_t> residuals = px;
  const std::vector<uint32_t> mult = CrossColorTransform(px, w, h, bits);
  if (!mult.empty()) {
    bw.Put(1, 1);
    bw.Put(1, 2);  // cross colour
    bw.Put(bits - 2, 3);
    WriteStream(bw, mult, (w + (1 << bits) - 1) >> bits, false, iters);
  } else {
    px.swap(residuals);
  }
  bw.Put(0, 1);  // no more transforms
  WriteStream(bw, px, w, true, iters);
  return bw;
}

// Shannon bits of the colour channels of the pixels as they are, less
// green, less their left neighbour, and both: which transforms may pay
struct Analysis {
  double direct, subtract_green, spatial, spatial_subtract_green;
};

Analysis Analyze(const std::vector<uint32_t>& px, int w) {
  std::vector<uint32_t> h(4 * 3 * 256, 0);  // [layout][channel][value]
  for (size_t i = 0; i < px.size(); ++i) {
    const uint32_t p = px[i], d = i % w ? SubPixels(p, px[i - 1]) : p;
    const uint32_t v[4] = {p, SubtractGreen(p), d, SubtractGreen(d)};
    for (int k = 0; k < 4; ++k) {
      ++h[(k * 3 + 0) * 256 + ((v[k] >> 16) & 0xff)];
      ++h[(k * 3 + 1) * 256 + ((v[k] >> 8) & 0xff)];
      ++h[(k * 3 + 2) * 256 + (v[k] & 0xff)];
    }
  }
  double bits[4] = {0, 0, 0, 0};
  for (int k = 0; k < 4; ++k)
    for (int c = 0; c < 3; ++c) bits[k] += Entropy(&h[(k * 3 + c) * 256], 256);
  return {bits[0], bits[1], bits[2], bits[3]};
}

// `palette` sorted; empty when the image has more than 256 colours
std::vector<uint32_t> Palette(const std::vector<uint32_t>& px) {
  std::vector<uint32_t> colours;
  std::unordered_map<uint32_t, int> seen;
  for (uint32_t p : px)
    if (seen.emplace(p, 0).second) {
      colours.push_back(p);
      if (colours.size() > 256) return {};
    }
  std::sort(colours.begin(), colours.end());
  return colours;
}

BitWriter EncodePalette(const std::vector<uint32_t>& px, const std::vector<uint32_t>& pal, int w, int h,
                        int iters) {
  BitWriter bw;
  Header(bw, w, h);
  const int n = static_cast<int>(pal.size());
  bw.Put(1, 1);
  bw.Put(3, 2);  // colour indexing
  bw.Put(n - 1, 8);
  std::vector<uint32_t> delta(n);
  for (int i = 0; i < n; ++i) delta[i] = i ? SubPixels(pal[i], pal[i - 1]) : pal[0];
  WriteStream(bw, delta, n, false, iters);
  const int xbits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
  const int per = 1 << xbits, bpp = 8 >> xbits;
  const int pw = (w + per - 1) >> xbits;
  std::unordered_map<uint32_t, uint32_t> index;
  for (int i = 0; i < n; ++i) index[pal[i]] = i;
  std::vector<uint32_t> packed(static_cast<size_t>(pw) * h, 0);
  uint32_t last = pal[0], last_index = 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const uint32_t p = px[static_cast<size_t>(y) * w + x];
      if (p != last) {
        last = p;
        last_index = index[p];
      }
      packed[static_cast<size_t>(y) * pw + (x >> xbits)] |= last_index << ((x & (per - 1)) * bpp);
    }
  for (auto& p : packed) p = 0xff000000u | (p << 8);
  bw.Put(0, 1);
  WriteStream(bw, packed, pw, true, iters);
  return bw;
}

}  // namespace

// The VP8L bitstream (the chunk's payload, from the 0x2f signature) of an
// h x w BGR image (3 bytes a pixel). Returns its length, which may exceed
// `cap` (nothing is written then; call again with a larger buffer), or -1
// for a side outside 1..16384.
extern "C" long webp_vp8l_encode(const uint8_t* bgr, int w, int h, uint8_t* dst, long cap) {
  if (w < 1 || h < 1 || w > 16384 || h > 16384) return -1;
  const long n = static_cast<long>(w) * h;
  std::vector<uint32_t> px(n);
  for (long i = 0; i < n; ++i)
    px[i] = 0xff000000u | (static_cast<uint32_t>(bgr[3 * i + 2]) << 16) |
            (static_cast<uint32_t>(bgr[3 * i + 1]) << 8) | bgr[3 * i];
  const int iters = 8;
  // a small image tries every layout; a large one those the analysis favours
  const bool small = n <= 1 << 16;
  const Analysis a = Analyze(px, w);
  std::vector<BitWriter> tries;
  const std::vector<uint32_t> pal = Palette(px);
  if (!pal.empty()) tries.push_back(EncodePalette(px, pal, w, h, iters));
  if (pal.empty() || pal.size() > 16) {
    const bool sg = a.spatial_subtract_green < a.spatial;
    const int bits = TileBits(w, h);
    tries.push_back(EncodeSpatial(px, w, h, iters, sg, bits));
    if (small) {  // the other subtract-green choice, and one tile for the whole image
      tries.push_back(EncodeSpatial(px, w, h, iters, !sg, bits));
      tries.push_back(EncodeSpatial(px, w, h, iters, sg, 9));
      tries.push_back(EncodeSpatial(px, w, h, iters, !sg, 9));
    }
  }
  if (small || std::min(a.direct, a.subtract_green) < 1.1 * std::min(a.spatial, a.spatial_subtract_green))
    tries.push_back(EncodeDirect(px, w, h, iters));
  size_t best = 0;
  for (size_t k = 1; k < tries.size(); ++k)
    if (tries[k].Bits() < tries[best].Bits()) best = k;
  BitWriter& bw = tries[best];
  bw.Finish();
  const long size = static_cast<long>(bw.buf.size());
  if (size <= cap) std::memcpy(dst, bw.buf.data(), size);
  return size;
}
