// Deformable-attention bilinear pair gather, backward, fp32: two launches,
// no float atomics, every dvalue row written once.
//
// Replaces the TPU kernel
// `tamtr_tpu/kernels/deform_scatter.py:_scatter_dw_pairs_kernel` (launched by
// `_scatter_dw_acc_pairs`, reached through `_bilinear_bwd`). The forward
// (`bilinear_gather_fwd.cu`) is, for each batch b, query q and head h,
//     out[b, q, h, :] = sum_{j < ppq} wa * value[b, i, h, :] + wb * value[b, i + 1, h, :]
// with u = q * ppq + j, i = idx2[b, u, h], (wa, wb) = w_pairs[b, u, h, :].
// Given dout (B, Q, nh, c) the backward is
//     dvalue[b, i]     += wa * dout[b, q, h]      dvalue[b, i + 1] += wb * dout[b, q, h]
//     dw[b, u, h, 0]    = value[b, i] . dout[b, q, h]
//     dw[b, u, h, 1]    = value[b, i + 1] . dout[b, q, h]
// A pair that starts on the global last row Lv-1 is shifted up one row with
// its weights swapped, as in the forward, and its dw is swapped back, so dw
// is in the caller's slot order.
//
// The TPU kernel walks the pairs of one (b, h) in order and adds each pair's
// two updates into a VMEM block. On the card, a scatter from the pairs' side
// needs atomics into a zeroed (B, Lv, nh, c) output (275 MB at 640 px, 5.5x
// the L2), and the order of their adds changes from run to run. This design
// turns the scatter into a gather from the rows' side, with every row's sum
// in a fixed order:
//   1. `pair_buckets_kernel`, one block per (b, h): a stable LSD radix
//      sort of the group's pairs by shifted start row, 8 bits a pass (two
//      passes below 65536 rows). In each pass every warp owns a run of the
//      current order, counts its digits (the lanes that share a digit found
//      with eight ballots, their first lane adding for them), the (digit,
//      warp) counts are scanned, and each warp places its run in order at
//      its cursors. So `order` (B, nh, nU2) is the pair ids sorted stably by
//      start row, every slot fixed by the pairs alone, in a time that does
//      not depend on how they cluster. The row offsets (B, nh, Lv+1) are
//      the exclusive scan of the rows' counts (shared-memory atomics, in
//      the space the sort has freed); the rows of more than kSmallTerms
//      terms are listed, cut into segments of kSegTerms terms; `pair_w`
//      holds the pairs' (wa, wb) in bucket order.
//   2. `gather_bwd_rows_kernel`. A row's terms, in a fixed order: wa dout
//      over bucket r (the pairs whose first row is r) in pair order, then
//      wb dout over bucket r - 1 (second row r) in pair order. Rows of at
//      most kSmallTerms terms: tiles of 128 rows of one (b, h), four rows a
//      warp stepping through their terms together, each summed from zero.
//      Longer rows (a training step's decoder puts hundreds of pairs on a
//      few hundred rows of the coarse level): each segment of kSegTerms terms
//      is summed from zero by one warp of the blocks ahead of the tiles, so
//      a hot row costs no block more than its share; a row of one segment
//      is that sum, a row of more is the sum of its segments' partials in
//      segment order, taken by the warp that finishes its last segment.
//      Every product and add is __fmul_rn / __fadd_rn (no contraction into
//      FMAs), so `bilinear_gather_bwd_rows_ref` transcribes the sums
//      bitwise. Each row is written once, zeros where no pair touches it, so
//      the output needs no zero fill. A touched row (or segment) loads
//      value[b, r, h] once and writes each of its pairs' dw slot for row r.
// dvalue is bitwise repeatable; value rows are read once per segment and
// only where touched; dvalue and dw are written once.
//
// Bound on the card: by bytes: the touched value rows, dout, idx2 and
// w_pairs read once, dvalue (the whole (B, Lv, nh, c) block) and dw written
// once; at 640 px, Q=700 and batch 4 about 0.41 GB, 0.123 ms at 3.35 TB/s.
// The buckets add ~11 MB of traffic (offsets, order, pair_w). What holds the
// rows pass back: the touched rows are scattered, and each term waits on a
// dependent L2 load of its dout row.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBucketThreads = 1024;
constexpr int kBucketWarps = kBucketThreads / 32;
constexpr int kDigitBits = 8;   // the radix sort's digit
constexpr int kDigits = 1 << kDigitBits;
// (digit, warp) counts at d * (kBucketWarps + 1) + w: a warp's digits fall
// in different banks; the pad entries stay zero through the scan
constexpr int kHistRow = kBucketWarps + 1;
constexpr int kHist = kDigits * kHistRow;
constexpr int kRowWarps = 8;     // rows pass: warps a block
constexpr int kRowsPerWarp = 16; // rows each warp of a tile walks in turn
constexpr int kTileRows = kRowWarps * kRowsPerWarp;
constexpr int kTileTerms = 1024; // bucketed pairs a tile stages in shared memory
constexpr int kSmallTerms = 16;  // a row of more terms is summed in segments
constexpr int kSegTerms = 32;    // terms a segment

__device__ __forceinline__ int shifted_start(int i, int Lv) { return i >= Lv - 1 ? Lv - 2 : i; }

// Exclusive scan of cnt[0, n) in place (n a multiple of 4, cnt 16-byte
// aligned).
__device__ void block_exclusive_scan(int* cnt, int n, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kBucketThreads / 32;
  int carry = 0;
  for (int t0 = 0; t0 < n; t0 += 4 * kBucketThreads) {
    const int i = t0 + 4 * tid;
    int4 v = i < n ? *reinterpret_cast<int4*>(cnt + i) : make_int4(0, 0, 0, 0);
    const int sum = v.x + v.y + v.z + v.w;
    int x = sum;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      s_warp[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    int e = carry + (warp ? s_warp[warp - 1] : 0) + x - sum;
    if (i < n) {
      int4 o;
      o.x = e;
      o.y = (e += v.x);
      o.z = (e += v.y);
      o.w = e + v.z;
      *reinterpret_cast<int4*>(cnt + i) = o;
    }
    carry += s_warp[kWarps - 1];
    __syncthreads();  // s_warp is reused by the next tile
  }
}

// The lanes of the warp whose digit d (8 bits) equals this lane's, among
// the valid lanes.
__device__ __forceinline__ unsigned digit_peers(int d, bool valid) {
  unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int bit = 0; bit < kDigitBits; ++bit) {
    const unsigned b = __ballot_sync(kFull, (d >> bit) & 1);
    peers &= ((d >> bit) & 1) ? b : ~b;
  }
  return peers;
}

// Block g = b * nh + h. Out: the group's offsets (of (G, Lv + 1)), its pair
// ids in bucket order and their (wa, wb) (of (G, nU2)), and its segments
// appended to `items` ({g, row, segment, the row's first item}) with the
// row's arrival count done[first] zeroed. `space` ints hold the shifted
// starts (by pair id) and the order between passes, then the row counts:
// shared memory, or scratch + g space where that is short.
__global__ void __launch_bounds__(kBucketThreads) pair_buckets_kernel(
    const int* __restrict__ idx2, const float2* __restrict__ w_pairs, int* offsets, int* order,
    float2* __restrict__ pair_w, int4* __restrict__ items, int* __restrict__ done, int* __restrict__ n_items,
    int* scratch, int space, int nU2, int nh, int Lv, int Lv4, int passes) {
  extern __shared__ int4 smem4[];
  __shared__ int4 hist4[kHist / 4];  // (digit, warp) counts, then cursors
  __shared__ int s_warp[32];
  int* hist = reinterpret_cast<int*>(hist4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = blockIdx.x, b = g / nh, h = g % nh;
  int* st = scratch ? scratch + (long long)g * space : reinterpret_cast<int*>(smem4);  // each pair's shifted start
  int* bufs[2] = {st + nU2, st + 2 * nU2};
  int* ord = order + (long long)g * nU2;
  const int* idx_g = idx2 + (long long)b * nU2 * nh + h;
#pragma unroll 8
  for (int u = tid; u < nU2; u += kBucketThreads) st[u] = shifted_start(idx_g[(long long)u * nh], Lv);

  // pass p sorts the current order stably by digit p; warp w owns its run
  // [lo, hi) of it. The first pass reads the pairs in id order, the last
  // writes `ord`.
  const int run = (nU2 + 32 * kBucketWarps - 1) / (32 * kBucketWarps) * 32;
  const int lo = min(warp * run, nU2), hi = min(lo + run, nU2);
  for (int p = 0; p < passes; ++p) {
    const int* src = p ? bufs[(p - 1) % 2] : nullptr;
    int* dst = p == passes - 1 ? ord : bufs[p % 2];
    const int shift = kDigitBits * p;
    __syncthreads();  // st, the previous pass's dst and its last use of hist are complete
    for (int i = tid; i < kHist; i += kBucketThreads) hist[i] = 0;
    __syncthreads();
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < hi;
      const int u = valid ? (src ? src[i] : i) : 0;
      const int d = valid ? (st[u] >> shift) & (kDigits - 1) : 0;
      const unsigned peers = digit_peers(d, valid);
      if (valid && lane == __ffs(peers) - 1) hist[d * kHistRow + warp] += __popc(peers);
    }
    __syncthreads();
    block_exclusive_scan(hist, kHist, s_warp);  // digit-major: a digit's warps in order
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < hi;
      const int u = valid ? (src ? src[i] : i) : 0;
      const int d = valid ? (st[u] >> shift) & (kDigits - 1) : 0;
      const unsigned peers = digit_peers(d, valid);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (valid && lane == leader) {
        at = hist[d * kHistRow + warp];
        hist[d * kHistRow + warp] = at + __popc(peers);
      }
      at = __shfl_sync(kFull, at, leader & 31) + __popc(peers & ((1u << lane) - 1u));
      if (valid) dst[at] = u;
    }
  }
  __syncthreads();  // `ord` is visible to the block; st and the buffers are free
  // the row counts, then their exclusive scan: the offsets. Row r sums
  // buckets r and r - 1 (row -1 holds none): a row of n > kSmallTerms terms
  // goes on the list as ceil(n / kSegTerms) <= n / 16 segments; the rows'
  // terms add up to 2 nU2, so a group lists at most nU2 / 8.
  int* cnt = st;
  for (int i = 4 * tid; i < Lv4; i += 4 * kBucketThreads) *reinterpret_cast<int4*>(cnt + i) = make_int4(0, 0, 0, 0);
  __syncthreads();
  const float2* w_g = w_pairs + (long long)b * nU2 * nh + h;
  float2* pw = pair_w + (long long)g * nU2;
#pragma unroll 4
  for (int i = tid; i < nU2; i += kBucketThreads) {
    pw[i] = w_g[(long long)ord[i] * nh];
    atomicAdd(&cnt[shifted_start(idx_g[(long long)i * nh], Lv)], 1);
  }
  __syncthreads();
  block_exclusive_scan(cnt, Lv4, s_warp);  // cnt[r]: the offset of row r; cnt[Lv] = nU2
  int* off_g = offsets + (long long)g * (Lv + 1);
  for (int r = tid; r <= Lv; r += kBucketThreads) off_g[r] = cnt[r];
  for (int r = tid; r < Lv; r += kBucketThreads) {
    const int n = cnt[r + 1] - cnt[r > 0 ? r - 1 : 0];
    if (n <= kSmallTerms) continue;
    const int ns = (n + kSegTerms - 1) / kSegTerms, first = atomicAdd(n_items, ns);
    for (int k = 0; k < ns; ++k) items[first + k] = make_int4(g, r, k, first);
    done[first] = 0;
  }
}

// q = u / ppq for u < 2^24, without an integer division
__device__ __forceinline__ int query_of(int u, int ppq, float inv_ppq) {
  int q = __float2int_rz(__int2float_rn(u) * inv_ppq);
  q += (q + 1) * ppq <= u;
  q -= q * ppq > u;
  return q;
}

struct Args {
  const float* value;
  const int* idx2;
  const float* dout;
  const int* offsets;
  const int* order;
  const float2* pair_w;
  const int4* items;
  int* done;
  const int* n_items;
  float* partials;
  float* dvalue;
  float* dw;
  int G, Lv, nh, c, Q, ppq;
  float inv_ppq;
  int seg_blocks;
};

// Pair u, with weights wp as given, as a term of row r in role 0 (r its
// first row) or 1: its dw slot and weight. Only bucket Lv - 2 holds shifted
// pairs: their slots and weights swap.
__device__ __forceinline__ void term_of(const Args& a, long long pair_bh, int u, float2 wp, int role, int r,
                                        int& slot, float& w) {
  slot = role;
  if (r - role == a.Lv - 2 && a.idx2[pair_bh + (long long)u * a.nh] >= a.Lv - 1) slot ^= 1;
  w = slot ? wp.y : wp.x;
}

// Tile `tile_block` (the last tiles first) owns kTileRows rows of one
// (b, h) and writes those of at most kSmallTerms terms. It stages the rows'
// offsets and, where they fit, their bucketed pairs (id, query, weights) in
// shared memory. Each warp takes its rows four at a time, eight lanes a row
// (channels 2 l + 16 k, k < 4, on lane l), the four stepping through their
// terms together, one term's dout loads in flight ahead.
__device__ void tile_rows(const Args& a, int tile_block) {
  __shared__ int s_off[kTileRows + 2];
  __shared__ int s_u[kTileTerms], s_q[kTileTerms];
  __shared__ float2 s_w[kTileTerms];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_tiles = (a.Lv + kTileRows - 1) / kTileRows;
  const int g = tile_block % a.G, h = g % a.nh, b = g / a.nh;
  const int r0 = (n_tiles - 1 - tile_block / a.G) * kTileRows;
  const int nU2 = a.Q * a.ppq, Lv = a.Lv, nh = a.nh, c = a.c;
  const int* off_g = a.offsets + (long long)g * (Lv + 1);
  const int* ord_g = a.order + (long long)g * nU2;
  const float2* pw_g = a.pair_w + (long long)g * nU2;
  // s_off[t]: the offset of row r0 - 1 + t (row -1 holds no pairs)
  for (int t = tid; t < kTileRows + 2; t += kRowWarps * 32) s_off[t] = off_g[min(max(r0 - 1 + t, 0), Lv)];
  __syncthreads();
  const int T0 = s_off[0], n_terms = s_off[kTileRows + 1] - T0;  // buckets r0 - 1 .. r0 + kTileRows - 1
  const bool staged = n_terms <= kTileTerms;
  if (staged)
    for (int i = tid; i < n_terms; i += kRowWarps * 32) {
      const int u = ord_g[T0 + i];
      s_u[i] = u;
      s_q[i] = query_of(u, a.ppq, a.inv_ppq);
      s_w[i] = pw_g[T0 + i];
    }
  __syncthreads();

  const float* dout_bh = a.dout + (long long)b * a.Q * nh * c + (long long)h * c;
  const long long pair_bh = (long long)b * nU2 * nh + h;
  const int l8 = lane % 8;
  bool live4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) live4[k] = 2 * l8 + 16 * k < c;

  for (int pass = 0; pass < kRowsPerWarp / 4; ++pass) {
    const int t0 = (pass * kRowWarps + warp) * 4;
    if (r0 + t0 >= Lv) break;  // uniform over the warp
    const int t = t0 + lane / 8, r = r0 + t;
    int n = r < Lv ? s_off[t + 2] - s_off[t] : 0;
    const bool mine = r < Lv && n <= kSmallTerms;  // the longer rows are summed in segments
    if (!mine) n = 0;
    int n_max = max(n, __shfl_xor_sync(kFull, n, 8));
    n_max = max(n_max, __shfl_xor_sync(kFull, n_max, 16));
    const int b0 = s_off[t], a0 = s_off[t + 1];  // bucket r - 1: [b0, a0), bucket r: [a0, a1)
    const int n_a = mine ? s_off[t + 2] - a0 : 0;
    const long long base = (((long long)b * Lv + r) * nh + h) * c + 2 * l8;
    float2 acc[4], v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[k] = make_float2(0.f, 0.f);
      v[k] = n > 0 && live4[k] ? *reinterpret_cast<const float2*>(a.value + base + 16 * k) : make_float2(0.f, 0.f);
    }
    // term i of the row: bucket r's first, then bucket r - 1's; the next
    // term's dout loads are in flight while this one's are summed
    int u = 0, slot = 0, q = 0;
    float w = 0.f;
    float2 d[4];
    auto fetch = [&](int i) {
      if (i < n) {
        const int role = i < n_a ? 0 : 1, at = role ? b0 + i - n_a : a0 + i;
        u = staged ? s_u[at - T0] : ord_g[at];
        q = staged ? s_q[at - T0] : query_of(u, a.ppq, a.inv_ppq);
        term_of(a, pair_bh, u, staged ? s_w[at - T0] : pw_g[at], role, r, slot, w);
      }
      const float* d_row = dout_bh + (long long)q * nh * c + 2 * l8;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        d[k] = i < n && live4[k] ? *reinterpret_cast<const float2*>(d_row + 16 * k) : make_float2(0.f, 0.f);
    };
    fetch(0);
    for (int i = 0; i < n_max; ++i) {
      const int cu = u, cslot = slot;
      const float cw = w;
      float2 cd[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) cd[k] = d[k];
      fetch(i + 1);
      float sdot = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i < n) {
          acc[k].x = __fadd_rn(acc[k].x, __fmul_rn(cw, cd[k].x));
          acc[k].y = __fadd_rn(acc[k].y, __fmul_rn(cw, cd[k].y));
        }
        sdot += v[k].x * cd[k].x + v[k].y * cd[k].y;
      }
      sdot += __shfl_xor_sync(kFull, sdot, 4, 8);
      sdot += __shfl_xor_sync(kFull, sdot, 2, 8);
      sdot += __shfl_xor_sync(kFull, sdot, 1, 8);
      if (i < n && l8 == 0) a.dw[2 * (pair_bh + (long long)cu * nh) + cslot] = sdot;
    }
    if (mine) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (live4[k]) *reinterpret_cast<float2*>(a.dvalue + base + 16 * k) = acc[k];
    }
  }
}

// The segments of the long rows, a warp a segment (item it, it + the
// segment warps, ...): lanes over channels 2 l, the segment's terms loaded
// a lane each, their dout rows eight ahead. A row of one segment is written
// at once; otherwise the segment's partial goes to `partials`, and the warp
// whose segment arrives last sums the row's partials in segment order.
__device__ void row_segments(const Args& a) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_items = *a.n_items, nU2 = a.Q * a.ppq, Lv = a.Lv, nh = a.nh, c = a.c;
  const bool live = 2 * lane < c;
  for (int it = blockIdx.x * kRowWarps + warp; it < n_items; it += a.seg_blocks * kRowWarps) {
    const int4 item = a.items[it];
    const int g = item.x, r = item.y, k = item.z, first = item.w, b = g / nh, h = g % nh;
    const int* off_g = a.offsets + (long long)g * (Lv + 1);
    const int b0 = off_g[r > 0 ? r - 1 : 0], a0 = off_g[r], n_a = off_g[r + 1] - a0;
    const int n = n_a + a0 - b0, ns = (n + kSegTerms - 1) / kSegTerms;
    const int t0 = k * kSegTerms, m = min(kSegTerms, n - t0);
    const long long pair_bh = (long long)b * nU2 * nh + h;
    const float* dout_bh = a.dout + (long long)b * a.Q * nh * c + (long long)h * c + 2 * lane;
    int u = 0, slot = 0, q = 0;
    float w = 0.f;
    if (lane < m) {
      const int i = t0 + lane, role = i < n_a ? 0 : 1, at = role ? b0 + i - n_a : a0 + i;
      u = a.order[(long long)g * nU2 + at];
      q = query_of(u, a.ppq, a.inv_ppq);
      term_of(a, pair_bh, u, a.pair_w[(long long)g * nU2 + at], role, r, slot, w);
    }
    const long long row = (((long long)b * Lv + r) * nh + h) * c + 2 * lane;
    const float2 v = live ? *reinterpret_cast<const float2*>(a.value + row) : make_float2(0.f, 0.f);
    float2 acc = make_float2(0.f, 0.f);
    for (int j0 = 0; j0 < m; j0 += 8) {
      float2 d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qj = __shfl_sync(kFull, q, (j0 + j) & 31);
        d[j] = j0 + j < m && live ? *reinterpret_cast<const float2*>(dout_bh + (long long)qj * nh * c)
                                  : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int src = (j0 + j) & 31;
        const bool ok = j0 + j < m;  // uniform over the warp
        const float wj = __shfl_sync(kFull, w, src);
        if (ok) {
          acc.x = __fadd_rn(acc.x, __fmul_rn(wj, d[j].x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(wj, d[j].y));
        }
        float sdot = v.x * d[j].x + v.y * d[j].y;
#pragma unroll
        for (int off = 16; off >= 1; off /= 2) sdot += __shfl_xor_sync(kFull, sdot, off);
        if (ok && lane == src) a.dw[2 * (pair_bh + (long long)u * nh) + slot] = sdot;
      }
    }
    if (ns == 1) {
      if (live) *reinterpret_cast<float2*>(a.dvalue + row) = acc;
      continue;
    }
    float* part = a.partials + (long long)first * c + 2 * lane;
    if (live) *reinterpret_cast<float2*>(part + (long long)k * c) = acc;
    __threadfence();
    __syncwarp();
    int arrived = 0;
    if (lane == 0) arrived = atomicAdd(a.done + first, 1);
    if (__shfl_sync(kFull, arrived, 0) != ns - 1) continue;  // uniform over the warp
    __threadfence();
    if (live) {
      float2 tot = __ldcg(reinterpret_cast<const float2*>(part));
      for (int kk = 1; kk < ns; ++kk) {
        const float2 p = __ldcg(reinterpret_cast<const float2*>(part + (long long)kk * c));
        tot.x = __fadd_rn(tot.x, p.x);
        tot.y = __fadd_rn(tot.y, p.y);
      }
      *reinterpret_cast<float2*>(a.dvalue + row) = tot;
    }
  }
}

// Blocks [0, seg_blocks) sum the long rows' segments; the rest are the
// tiles, which the card starts after them.
__global__ void __launch_bounds__(kRowWarps * 32, 4) gather_bwd_rows_kernel(const Args a) {
  if ((int)blockIdx.x < a.seg_blocks)
    row_segments(a);
  else
    tile_rows(a, blockIdx.x - a.seg_blocks);
}

}  // namespace

// Launch 1. idx2 (B, nU2, nh) int32, w_pairs (B, nU2, nh, 2) fp32 ->
// offsets (B, nh, Lv + 1) int32, order (B, nh, nU2) int32, pair_w
// (B, nh, nU2, 2) fp32, and the long rows' segments: items (B nh ceil(nU2 /
// 8), 4) int32 with their count n_items (1,) int32, done (as items' rows)
// int32. scratch (B nh max(Lv + 1, 3 nU2) rounded up to 4) int32 holds the
// starts, the passes' order and the row counts where they do not fit the
// block's shared memory. One block per (b, h).
extern "C" int pair_buckets(const int* idx2, const float* w_pairs, int* offsets, int* order, float* pair_w,
                            int* items, int* done, int* n_items, int* scratch, int B, int nU2, int nh, int Lv,
                            void* stream) {
  if (B < 1 || nU2 < 1 || nh < 1 || Lv < 2) return (int)cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  int passes = 1;  // 8-bit digits of the largest start, Lv - 2
  while (passes < 4 && ((Lv - 2) >> (kDigitBits * passes)) > 0) ++passes;
  const int Lv4 = (Lv + 1 + 3) / 4 * 4;
  // the starts and one or two buffers, then the counts; a multiple of 4
  const int space = (max(Lv + 1, (passes >= 3 ? 3 : 2) * nU2) + 3) / 4 * 4;
  const size_t smem = sizeof(int) * (size_t)space, fixed = sizeof(int) * (kHist + 32);
  const bool in_smem = smem + fixed <= (size_t)optin;
  err = cudaFuncSetAttribute(pair_buckets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             in_smem ? (int)smem : 0);
  if (err == cudaSuccess) err = cudaMemsetAsync(n_items, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  pair_buckets_kernel<<<B * nh, kBucketThreads, in_smem ? smem : 0, (cudaStream_t)stream>>>(
      idx2, reinterpret_cast<const float2*>(w_pairs), offsets, order, reinterpret_cast<float2*>(pair_w),
      reinterpret_cast<int4*>(items), done, n_items, in_smem ? nullptr : scratch, space, nU2, nh, Lv, Lv4,
      passes);
  return (int)cudaGetLastError();
}

// Launch 2, on launch 1's buckets and segments; partials (as items' rows,
// c) fp32 scratch. dvalue (B, Lv, nh, c) and dw (B, nU2, nh, 2) are written
// in full.
extern "C" int bilinear_gather_bwd(const float* value, const int* idx2, const float* dout, const int* offsets,
                                   const int* order, const float* pair_w, const int* items, int* done,
                                   const int* n_items, float* partials, float* dvalue, float* dw, int B, int Lv,
                                   int nh, int c, int Q, int ppq, void* stream) {
  if (c % 2 != 0 || c > 64 || c < 2 || Lv < 2 || B < 1 || Q < 1 || nh < 1 || ppq < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)Q * ppq >= (1 << 24)) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)B * nh * ((Lv + kTileRows - 1) / kTileRows);
  const int seg_blocks = 2 * sms;
  if (tiles + seg_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  Args a{value, idx2, dout, offsets, order, reinterpret_cast<const float2*>(pair_w),
         reinterpret_cast<const int4*>(items), done, n_items, partials, dvalue, dw,
         B * nh, Lv, nh, c, Q, ppq, 1.0f / (float)ppq, seg_blocks};
  gather_bwd_rows_kernel<<<(unsigned)(tiles + seg_blocks), kRowWarps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
