// Row-owned scatter-accumulate, fp32 sums: the buckets launch and the rows pass
// that the gather backward (B4, `bilinear_gather_bwd.cu`) and the row and
// pair scatters (B7, B8, `deform_scatter.cu`) share.
//
// A scatter adds, for every group g = b nh + h and update u of query
// q = u / ppq, w dout[b, q, h, :] into rows of out[b, :, h, :]. Done from the
// updates' side that needs float atomics into a zeroed output (275 MB at the
// 640 px decoder shapes, 5.5x the L2), in an order that changes from run to
// run. Here the scatter becomes a gather from the rows' side, every row
// summed in a fixed order and written once, zeros where no update lands:
//   1. `buckets_kernel`: per group, a stable LSD radix sort of the updates
//      by bucket key, 8 bits a pass (two passes below 65536 keys), spread
//      over a thread-block cluster of up to kMaxCluster blocks (the launch
//      takes the most blocks a group for which every group's cluster is on
//      the card at once). Block k of a cluster owns the k-th share of each
//      pass's order, staged in its shared memory, its warps runs of that
//      share. A block counts its (digit, warp) pairs (the lanes that share
//      a digit found with eight ballots, their first lane adding for them) and
//      scans them; the blocks' digit starts, exchanged through distributed
//      shared memory, put block k's run of a digit after blocks 0..k-1's,
//      so the placement is the single-block sort's. Each warp places its
//      run in order at its cursors in the block's sorted share, which goes
//      out to the group's order in runs of consecutive positions. The
//      passes' (key, id) pairs live in a global (L2) buffer between cluster
//      barriers. So `order` is the update ids sorted stably by key, every
//      slot fixed by the updates alone; the last pass writes the weights in
//      that order (`upd_w`) beside it. The bucket offsets: each block counts
//      its range of buckets from the runs of equal sorted keys and scans
//      the counts; rows of more than kSmallTerms terms are listed, cut into
//      segments of kSegTerms terms.
//   2. `rows_kernel`. A row's terms, in a fixed order: the first-row
//      weight times dout over the bucket of updates starting on the row, in
//      update order, then (pairs) the second-row weight times dout over the
//      bucket of those starting on the row above, in update order. Rows of
//      at most kSmallTerms terms: tiles of 128 rows of one group, four rows a
//      warp stepping through their terms together, each summed from zero.
//      Longer rows: each segment of kSegTerms terms is summed from zero by
//      one warp of the blocks ahead of the tiles; a row of one segment is
//      that sum, a row of more is the sum of its segments' partials in
//      segment order, taken by the warp that finishes its last segment.
//      Every product and add is __fmul_rn / __fadd_rn, so the plain
//      transcription (`_rows_pass_ref` in kernels/deform_scatter.py) holds
//      the output bitwise.
//
// The rule (`Rule`) says how an update reaches rows:
//   - pairs (B4, B8) add wa dout to row s and wb dout to row s + 1; rows
//     (B7) add w dout to row s;
//   - B4's shift: a pair starting on row rows - 1 or later moves to rows - 2
//     with its weights swapped (the forward's rule); the skip rule (B7, B8):
//     a row outside [0, rows) is skipped, never written;
//   - B4 also loads each touched value row once per row or segment and
//     writes each pair's dw slot for the row (value . dout).
// Element type E of value, dout and out (the rows pass's template
// argument): float, or __nv_bfloat16 for B4 at bf16. Rows are read two
// elements a lane and widened to fp32; every product, sum and partial is
// fp32, and a row is rounded to E once, at its store. dw stays fp32.
// Keys: bucket key = s + shift holds the updates whose first row is s, with
// shift = 1 for skip-rule pairs (a start of -1 still reaches row 0) and 0
// otherwise; NB = rows + shift buckets, offsets (G, NB + 1). Under the skip
// rule an update that reaches no row gets key NB and sorts after the rest.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <algorithm>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBucketThreads = 1024;
constexpr int kBucketWarps = kBucketThreads / 32;
constexpr int kDigitBits = 8;  // the radix sort's digit
constexpr int kDigits = 1 << kDigitBits;
// (digit, warp) counts at d * (kBucketWarps + 1) + w: a warp's digits fall
// in different banks; the pad entries stay zero through the scan
constexpr int kHistRow = kBucketWarps + 1;
constexpr int kHist = kDigits * kHistRow;
constexpr int kMaxCluster = 8;   // blocks a group's sort spreads over (the portable limit)
constexpr int kRowWarps = 8;     // rows pass: warps a block
constexpr int kRowsPerWarp = 16; // rows each warp of a tile walks in turn
constexpr int kTileRows = kRowWarps * kRowsPerWarp;
constexpr int kTileTerms = 1024; // bucketed terms a tile stages in shared memory
constexpr int kSmallTerms = 16;  // a row of more terms is summed in segments
constexpr int kSegTerms = 32;    // terms a segment (SEG_TERMS in kernels/deform_scatter.py)

template <bool kPairs, bool kSkip, bool kDw>
struct Rule {
  static constexpr bool pairs = kPairs, skip = kSkip, dw = kDw;
  static constexpr int shift = kPairs && kSkip ? 1 : 0;
  using W = typename std::conditional<kPairs, float2, float>::type;  // an update's weights
};

struct BucketArgs {
  const int* idx;    // (B, n, nh) starts
  const float* wa;   // first-row weights: element e = (b n + u) nh + h at wa[e ws]
  const float* wb;   // second-row weights (pairs) at wb[e ws]
  int ws;
  int* offsets;      // (G, NB + 1)
  int* order;        // (G, n)
  void* upd_w;       // (G, n) of Rule::W
  int4* items;       // the long rows' segments {g, row, segment, the row's first item}
  int* done;         // the rows' arrival counts, at their first item
  int* n_items;      // zeroed before the launch
  int2* bufs;        // (G, 2, n): the passes' (key, id)
  int* keys;         // (G, n): the sorted keys
  int n, nh, rows, NB, passes, cluster, staged, counted;
};

template <class R>
__device__ __forceinline__ int key_of(int s, int rows, int NB) {
  if constexpr (R::skip) {
    const int k = s + R::shift;
    return (unsigned)k < (unsigned)NB ? k : NB;
  } else {
    return s >= rows - 1 ? rows - 2 : s;
  }
}

// Exclusive scan of cnt[0, n) in place (n a multiple of 4, cnt 16-byte
// aligned), by a block of kBucketThreads.
__device__ void block_exclusive_scan(int* cnt, int n, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
      for (int off = 1; off < kBucketWarps; off <<= 1) {
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
    carry += s_warp[kBucketWarps - 1];
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

// Cluster c = blockIdx.x / a.cluster sorts group c. Out: the group's
// offsets, its update ids in bucket order and their weights, and its long
// rows' segments appended to `items` with the row's arrival count done[first]
// zeroed. Dynamic shared memory: with a.staged, the block's share of each
// pass's order, as read and sorted by the pass's digit; with a.counted, the
// counts of the block's buckets. Without them (shares or bucket ranges too
// large for shared memory) the passes read and write the global buffers
// directly and the offsets are binary searches in the global keys.
template <class R>
__global__ void __launch_bounds__(kBucketThreads) buckets_kernel(const BucketArgs a) {
  using W = typename R::W;
  extern __shared__ int4 s_dyn4[];
  __shared__ int4 hist4[kHist / 4];  // (digit, warp) counts, then cursors
  __shared__ int s_warp[32];
  __shared__ int s_pub[kDigits + 1];  // this block's digit starts in its own share; the cluster reads them
  __shared__ int s_adj[kDigits];      // what the cluster's other blocks put before this block's digit d
  __shared__ int s_base;
  int* hist = reinterpret_cast<int*>(hist4);
  cg::cluster_group cluster = cg::this_cluster();
  const int K = a.cluster, rank = (int)cluster.block_rank(), g = blockIdx.x / K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = a.n, nh = a.nh, b = g / nh, h = g % nh;
  const int* idx_g = a.idx + (long long)b * n * nh + h;
  int2* bufs[2] = {a.bufs + (long long)g * 2 * n, a.bufs + (long long)g * 2 * n + n};
  int* ord = a.order + (long long)g * n;
  int* keys = a.keys + (long long)g * n;
  W* pw = static_cast<W*>(a.upd_w) + (long long)g * n;
  const long long e0 = (long long)b * n * nh + h;
  auto weights = [&](int u) -> W {
    const long long e = (e0 + (long long)u * nh) * a.ws;
    if constexpr (R::pairs)
      return make_float2(__ldg(a.wa + e), __ldg(a.wb + e));
    else
      return __ldg(a.wa + e);
  };
  // block `rank` owns positions [blo, bhi) of each pass's order, warp w the
  // run [lo, hi) of them. The first pass reads the updates in id order, the
  // last writes `ord`, `keys` and the weights.
  const int share = (n + K - 1) / K;
  const int blo = min(rank * share, n), bhi = min(blo + share, n), cnt = bhi - blo;
  const int run = (cnt + 32 * kBucketWarps - 1) / (32 * kBucketWarps) * 32;
  const int lo = min(blo + warp * run, bhi), hi = min(lo + run, bhi);
  int2* s_elem = reinterpret_cast<int2*>(s_dyn4);  // a.staged: the share in the pass's order
  int2* s_sorted = s_elem + share;                  // a.staged: the share sorted by the pass's digit
  for (int p = 0; p < a.passes; ++p) {
    const int2* src = p ? bufs[(p - 1) % 2] : nullptr;
    int2* dst = bufs[p % 2];
    const bool last = p == a.passes - 1;
    const int shift = kDigitBits * p;
    // (key, id) at position i of the current order; other blocks wrote it
    auto load = [&](int i) {
      return src ? __ldcg(src + i) : make_int2(key_of<R>(__ldg(idx_g + (long long)i * nh), a.rows, a.NB), i);
    };
    auto put = [&](int at, int2 e) {  // the element at position `at` of the pass's order
      if (last) {
        ord[at] = e.y;
        keys[at] = e.x;
        pw[at] = weights(e.y);
      } else {
        dst[at] = e;
      }
    };
    if (a.staged && src) {  // the share's loads in flight eight at a time
#pragma unroll 8
      for (int i = blo + tid; i < bhi; i += kBucketThreads) s_elem[i - blo] = __ldcg(src + i);
    } else if (a.staged) {
#pragma unroll 8
      for (int i = blo + tid; i < bhi; i += kBucketThreads)
        s_elem[i - blo] = make_int2(key_of<R>(__ldg(idx_g + (long long)i * nh), a.rows, a.NB), i);
    }
    auto element = [&](int i) { return a.staged ? s_elem[i - blo] : load(i); };
    for (int i = tid; i < kHist; i += kBucketThreads) hist[i] = 0;
    __syncthreads();
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < hi;
      const int2 e = valid ? element(i) : make_int2(0, 0);
      const int d = (e.x >> shift) & (kDigits - 1);
      const unsigned peers = digit_peers(d, valid);
      if (valid && lane == __ffs(peers) - 1) hist[d * kHistRow + warp] += __popc(peers);
    }
    __syncthreads();
    block_exclusive_scan(hist, kHist, s_warp);  // digit-major: a digit's warps in order
    for (int d = tid; d <= kDigits; d += kBucketThreads) s_pub[d] = d < kDigits ? hist[d * kHistRow] : cnt;
    cluster.sync();  // every block's starts are published
    if (tid < kDigits) {
      // the group's updates of digits below d, less this block's (its scan
      // holds them), plus the earlier blocks' updates of digit d
      int all_before = 0, earlier = 0;
      for (int k = 0; k < K; ++k) {
        const int* pub = cluster.map_shared_rank(s_pub, k);
        const int start = pub[tid];
        all_before += start;
        if (k < rank) earlier += pub[tid + 1] - start;
      }
      s_adj[tid] = all_before - s_pub[tid] + earlier;
    }
    __syncthreads();
    // each element's place in the block's share sorted by the digit; its
    // place in the group's order adds s_adj of its digit
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < hi;
      const int2 e = valid ? element(i) : make_int2(0, 0);
      const int d = (e.x >> shift) & (kDigits - 1);
      const unsigned peers = digit_peers(d, valid);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (valid && lane == leader) {
        at = hist[d * kHistRow + warp];
        hist[d * kHistRow + warp] = at + __popc(peers);
      }
      at = __shfl_sync(kFull, at, leader & 31) + __popc(peers & ((1u << lane) - 1u));
      if (valid) {
        if (a.staged)
          s_sorted[at] = e;
        else
          put(at + s_adj[d], e);
      }
    }
    if (a.staged) {  // out in runs of consecutive positions
      __syncthreads();
      if (last) {
#pragma unroll 8
        for (int j = tid; j < cnt; j += kBucketThreads) {
          const int2 e = s_sorted[j];
          const int at = j + s_adj[(e.x >> shift) & (kDigits - 1)];
          ord[at] = e.y;
          keys[at] = e.x;
          pw[at] = weights(e.y);
        }
      } else {
#pragma unroll 4
        for (int j = tid; j < cnt; j += kBucketThreads) {
          const int2 e = s_sorted[j];
          dst[j + s_adj[(e.x >> shift) & (kDigits - 1)]] = e;
        }
      }
    }
    __threadfence();
    cluster.sync();  // this pass's order is complete and visible; s_pub and the staging may be rewritten
  }

  // the offsets: bucket j starts at lb(j), the number of keys below j.
  // Block `rank` owns the buckets [jlo, jhi) of the NB + 1 entries. Row r's
  // first bucket is j = r + shift, its second (pairs) j - 1; a row of more
  // than kSmallTerms terms goes on the list as ceil(terms / kSegTerms) <=
  // terms / 16 segments: the terms add up to at most 2 n, so a group lists
  // at most n / 8.
  const int NB = a.NB;
  const int bshare = (NB + 1 + K - 1) / K;
  const int jlo = min(rank * bshare, NB + 1), jhi = min(jlo + bshare, NB + 1);
  int* off_g = a.offsets + (long long)g * (NB + 1);
  auto list_row = [&](int j, int nt) {  // bucket j's row, if it is one, of nt terms
    const int r = j - R::shift;
    if (r < 0 || r >= a.rows || nt <= kSmallTerms) return;
    const int ns = (nt + kSegTerms - 1) / kSegTerms, first = atomicAdd(a.n_items, ns);
    for (int k = 0; k < ns; ++k) a.items[first + k] = make_int4(g, r, k, first);
    a.done[first] = 0;
  };
  if (a.counted) {
    // the counts of buckets [jlo - 1, jhi) at t = j - jlo + 1, from the
    // runs of equal keys (a run adds its end and takes its start); their
    // exclusive scan is lb(j) - lb(jlo - 1), the total at `bins`
    int* s_cnt = reinterpret_cast<int*>(s_dyn4);
    const int bins = jhi - jlo + 1, bins4 = (bins + 1 + 3) / 4 * 4;
    for (int t = tid; t < bins4; t += kBucketThreads) s_cnt[t] = 0;
    if (tid == 0) s_base = n;
    __syncthreads();
    constexpr int kBatch = 8;  // keys a lane has in flight
    for (int i0 = warp * 32; i0 < n; i0 += kBatch * kBucketThreads) {  // uniform over the warp
      int k[kBatch], kp[kBatch], kn[kBatch];
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        const int i = i0 + m * kBucketThreads + lane;
        k[m] = i < n ? __ldcg(keys + i) : INT_MAX;
        kp[m] = lane == 0 && i > 0 && i <= n ? __ldcg(keys + i - 1) : INT_MIN;
        kn[m] = lane == 31 && i + 1 < n ? __ldcg(keys + i + 1) : INT_MAX;
      }
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        const int i = i0 + m * kBucketThreads + lane;
        const int up = __shfl_up_sync(kFull, k[m], 1), down = __shfl_down_sync(kFull, k[m], 1);
        if (lane > 0) kp[m] = up;
        if (lane < 31) kn[m] = down;
        if (i >= n) continue;
        if (kp[m] < jlo - 1 && k[m] >= jlo - 1) s_base = i;  // lb(jlo - 1)
        if (k[m] < jlo - 1 || k[m] >= jhi) continue;
        if (kp[m] != k[m]) atomicAdd(&s_cnt[k[m] - jlo + 1], -i);
        if (kn[m] != k[m]) atomicAdd(&s_cnt[k[m] - jlo + 1], i + 1);
      }
    }
    __syncthreads();
    block_exclusive_scan(s_cnt, bins4, s_warp);
    const int base = s_base;
    for (int t = 1 + tid; t < bins; t += kBucketThreads) {
      const int j = jlo - 1 + t;
      off_g[j] = base + s_cnt[t];
      list_row(j, s_cnt[t + 1] - s_cnt[R::pairs ? t - 1 : t]);
    }
  } else {
    // binary searches in the global keys: a warp takes 30 buckets at a
    // time, lane l finds lb(c0 - 1 + l) and the bucket of lanes 1..30 takes
    // its neighbours' bounds by shuffles
    auto lower = [&](int key) {  // the first position whose key is >= key, or n
      int l = 0, r = n;
      while (l < r) {
        const int mid = (l + r) >> 1;
        if (__ldcg(keys + mid) < key)
          l = mid + 1;
        else
          r = mid;
      }
      return l;
    };
    for (int c0 = jlo + warp * 30; c0 < jhi; c0 += kBucketWarps * 30) {  // uniform over the warp
      const int j = c0 - 1 + lane;
      const int cur = j > 0 ? lower(j) : 0;  // bucket -1 holds none
      const int prev = __shfl_up_sync(kFull, cur, 1), next = __shfl_down_sync(kFull, cur, 1);
      if (lane < 1 || lane > 30 || j >= jhi) continue;
      off_g[j] = cur;
      list_row(j, next - (R::pairs ? prev : cur));
    }
  }
}

// Launch 1 on a.n updates of G groups: a.idx, the weights, the outputs and
// the scratch set; a.rows and a.NB = rows + Rule::shift set. The cluster:
// the most blocks a group (up to kMaxCluster, the groups' blocks no more
// than the SMs) for which the card holds every group's cluster at once.
// The plan is kept for the next launch of the same shape on the device.
struct BucketPlan {
  int device = -1, G = 0, n = 0, rows = 0, NB = 0;
  int passes = 0, cluster = 0, staged = 0, counted = 0;
  size_t dyn = 0;
};

template <class R>
cudaError_t plan_buckets(BucketPlan& p, int device) {
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, buckets_kernel<R>);
  if (err != cudaSuccess) return err;
  const int top = R::skip ? p.NB : p.rows - 2;  // the largest key
  p.passes = 1;
  while (p.passes < 4 && (top >> (kDigitBits * p.passes)) > 0) ++p.passes;
  const size_t room = (size_t)optin - fa.sharedSizeBytes;
  err = cudaFuncSetAttribute(buckets_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)room);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kBucketThreads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int K = min(kMaxCluster, max(1, sms / p.G));; --K) {
    if ((long long)p.G * K > INT_MAX) return cudaErrorInvalidValue;
    const size_t share_bytes = 2 * sizeof(int2) * (size_t)((p.n + K - 1) / K);
    const size_t count_bytes = sizeof(int) * (size_t)(((p.NB + 1 + K - 1) / K + 2 + 3) / 4 * 4);
    p.cluster = K;
    p.staged = share_bytes <= room;
    p.counted = count_bytes <= room;
    p.dyn = std::max(p.staged ? share_bytes : 0, p.counted ? count_bytes : 0);
    cfg.gridDim = dim3((unsigned)(p.G * K));
    cfg.dynamicSmemBytes = p.dyn;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    int clusters = 0;
    const bool placed = cudaOccupancyMaxActiveClusters(&clusters, buckets_kernel<R>, &cfg) == cudaSuccess;
    (void)cudaGetLastError();
    if (K == 1 || (placed && clusters >= p.G)) break;
  }
  p.device = device;
  return cudaSuccess;
}

template <class R>
cudaError_t launch_buckets(BucketArgs a, int G, cudaStream_t stream) {
  static thread_local BucketPlan plan;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (plan.device != device || plan.G != G || plan.n != a.n || plan.rows != a.rows || plan.NB != a.NB) {
    plan = BucketPlan{-1, G, a.n, a.rows, a.NB};
    err = plan_buckets<R>(plan, device);
    if (err != cudaSuccess) {
      plan.device = -1;
      return err;
    }
  }
  a.passes = plan.passes;
  a.cluster = plan.cluster;
  a.staged = plan.staged;
  a.counted = plan.counted;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(G * plan.cluster));
  cfg.blockDim = dim3(kBucketThreads);
  cfg.dynamicSmemBytes = plan.dyn;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaMemsetAsync(a.n_items, 0, sizeof(int), stream);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, buckets_kernel<R>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// q = u / ppq for u < 2^24, without an integer division
__device__ __forceinline__ int query_of(int u, int ppq, float inv_ppq) {
  int q = __float2int_rz(__int2float_rn(u) * inv_ppq);
  q += (q + 1) * ppq <= u;
  q -= q * ppq > u;
  return q;
}

// two consecutive elements as fp32, and back rounded once (E float or bf16)
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void st2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

struct RowArgs {
  const void* value;   // B4: (B, rows, nh, cs) of E
  const int* idx;      // B4: the starts (B, n, nh), for the last-row swap
  const void* dout;    // (B, Q, nh, cs) of E, channels [0, c) of each row read
  const int* offsets;
  const int* order;
  const void* upd_w;
  const int4* items;
  int* done;
  const int* n_items;
  float* partials;  // (items, c)
  void* out;        // (B, rows, nh, cs) of E, channels [0, c) of each row written
  float* dw;        // B4: (B, n, nh, 2)
  int G, rows, NB, nh, c, cs, Q, ppq;
  float inv_ppq;
  int seg_blocks;
};

// Update u, with weights wp as bucketed, as a term of row r in role 0 (r
// its first row) or 1: its weight, and (B4) its dw slot. Under B4's shift
// only bucket rows - 2 holds shifted pairs: their slots and weights swap.
template <class R>
__device__ __forceinline__ float term_w(const RowArgs& a, long long upd_bh, int u, typename R::W wp, int role,
                                        int r, int& slot) {
  if constexpr (R::pairs) {
    slot = role;
    if constexpr (!R::skip) {
      if (r - role == a.rows - 2 && a.idx[upd_bh + (long long)u * a.nh] >= a.rows - 1) slot ^= 1;
    }
    return slot ? wp.y : wp.x;
  } else {
    slot = 0;
    return wp;
  }
}

// Tile `tile_block` (the last tiles first) owns kTileRows rows of one group
// and writes those of at most kSmallTerms terms. It stages the rows' bucket
// offsets and, where they fit, their bucketed updates (id, query, weights)
// in shared memory. Each warp takes its rows four at a time, eight lanes a
// row (channels 2 l + 16 k, k < 4, on lane l), the four stepping through
// their terms together, one term's dout loads in flight ahead.
template <class R, typename E>
__device__ void tile_rows(const RowArgs& a, int tile_block) {
  using W = typename R::W;
  __shared__ int s_off[kTileRows + 2];
  __shared__ int s_u[kTileTerms], s_q[kTileTerms];
  __shared__ W s_w[kTileTerms];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_tiles = (a.rows + kTileRows - 1) / kTileRows;
  const int g = tile_block % a.G, h = g % a.nh, b = g / a.nh;
  const int r0 = (n_tiles - 1 - tile_block / a.G) * kTileRows;
  const int n = a.Q * a.ppq, rows = a.rows, nh = a.nh, c = a.c, cs = a.cs;
  const int* off_g = a.offsets + (long long)g * (a.NB + 1);
  const int* ord_g = a.order + (long long)g * n;
  const W* pw_g = static_cast<const W*>(a.upd_w) + (long long)g * n;
  // s_off[t]: the start of bucket r0 + shift - 1 + t, the first bucket of
  // row r0 - 1 + t (bucket -1 holds none)
  for (int t = tid; t < kTileRows + 2; t += kRowWarps * 32) s_off[t] = off_g[min(max(r0 + R::shift - 1 + t, 0), a.NB)];
  __syncthreads();
  const int T0 = s_off[R::pairs ? 0 : 1], n_terms = s_off[kTileRows + 1] - T0;  // the tile's buckets
  const bool staged = n_terms <= kTileTerms;
  if (staged)
    for (int i = tid; i < n_terms; i += kRowWarps * 32) {
      const int u = ord_g[T0 + i];
      s_u[i] = u;
      s_q[i] = query_of(u, a.ppq, a.inv_ppq);
      s_w[i] = pw_g[T0 + i];
    }
  __syncthreads();

  const E* dout_bh = static_cast<const E*>(a.dout) + (long long)b * a.Q * nh * cs + (long long)h * cs;
  const E* value = static_cast<const E*>(a.value);
  E* out = static_cast<E*>(a.out);
  const long long upd_bh = (long long)b * n * nh + h;
  const int l8 = lane % 8;
  bool live4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) live4[k] = 2 * l8 + 16 * k < c;

  for (int pass = 0; pass < kRowsPerWarp / 4; ++pass) {
    const int t0 = (pass * kRowWarps + warp) * 4;
    if (r0 + t0 >= rows) break;  // uniform over the warp
    const int t = t0 + lane / 8, r = r0 + t;
    int nt = r < rows ? s_off[t + 2] - s_off[R::pairs ? t : t + 1] : 0;
    const bool mine = r < rows && nt <= kSmallTerms;  // the longer rows are summed in segments
    if (!mine) nt = 0;
    int n_max = max(nt, __shfl_xor_sync(kFull, nt, 8));
    n_max = max(n_max, __shfl_xor_sync(kFull, n_max, 16));
    const int b0 = s_off[t], a0 = s_off[t + 1];  // the second bucket: [b0, a0), the first: [a0, a1)
    const int n_a = mine ? s_off[t + 2] - a0 : 0;
    const long long base = (((long long)b * rows + r) * nh + h) * cs + 2 * l8;
    float2 acc[4], v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[k] = make_float2(0.f, 0.f);
      if constexpr (R::dw)
        v[k] = nt > 0 && live4[k] ? ld2(value + base + 16 * k) : make_float2(0.f, 0.f);
    }
    // term i of the row: the first bucket's, then the second's; the next
    // term's dout loads are in flight while this one's are summed
    int u = 0, slot = 0, q = 0;
    float w = 0.f;
    float2 d[4];
    auto fetch = [&](int i) {
      if (i < nt) {
        const int role = i < n_a ? 0 : 1, at = role ? b0 + i - n_a : a0 + i;
        u = staged ? s_u[at - T0] : ord_g[at];
        q = staged ? s_q[at - T0] : query_of(u, a.ppq, a.inv_ppq);
        w = term_w<R>(a, upd_bh, u, staged ? s_w[at - T0] : pw_g[at], role, r, slot);
      }
      const E* d_row = dout_bh + (long long)q * nh * cs + 2 * l8;
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = i < nt && live4[k] ? ld2(d_row + 16 * k) : make_float2(0.f, 0.f);
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
        if (i < nt) {
          acc[k].x = __fadd_rn(acc[k].x, __fmul_rn(cw, cd[k].x));
          acc[k].y = __fadd_rn(acc[k].y, __fmul_rn(cw, cd[k].y));
        }
        if constexpr (R::dw) sdot += v[k].x * cd[k].x + v[k].y * cd[k].y;
      }
      if constexpr (R::dw) {
        sdot += __shfl_xor_sync(kFull, sdot, 4, 8);
        sdot += __shfl_xor_sync(kFull, sdot, 2, 8);
        sdot += __shfl_xor_sync(kFull, sdot, 1, 8);
        if (i < nt && l8 == 0) a.dw[2 * (upd_bh + (long long)cu * nh) + cslot] = sdot;
      } else {
        (void)cu, (void)cslot, (void)sdot;
      }
    }
    if (mine) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (live4[k]) st2(out + base + 16 * k, acc[k]);
    }
  }
}

// The segments of the long rows, a warp a segment (item it, it + the
// segment warps, ...): lanes over channels 2 l, the segment's terms loaded
// a lane each, their dout rows eight ahead. A row of one segment is written
// at once; otherwise the segment's partial goes to `partials`, and the warp
// whose segment arrives last sums the row's partials in segment order.
template <class R, typename E>
__device__ void row_segments(const RowArgs& a) {
  using W = typename R::W;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_items = *a.n_items, n = a.Q * a.ppq, nh = a.nh, c = a.c, cs = a.cs;
  const bool live = 2 * lane < c;
  const W* pw = static_cast<const W*>(a.upd_w);
  for (int it = blockIdx.x * kRowWarps + warp; it < n_items; it += a.seg_blocks * kRowWarps) {
    const int4 item = a.items[it];
    const int g = item.x, r = item.y, k = item.z, first = item.w, b = g / nh, h = g % nh;
    const int* off_g = a.offsets + (long long)g * (a.NB + 1);
    const int j = r + R::shift;  // the row's first bucket
    const int a0 = off_g[j], n_a = off_g[j + 1] - a0;
    const int b0 = R::pairs ? off_g[j > 0 ? j - 1 : 0] : a0;
    const int nt = n_a + a0 - b0, ns = (nt + kSegTerms - 1) / kSegTerms;
    const int t0 = k * kSegTerms, m = min(kSegTerms, nt - t0);
    const long long upd_bh = (long long)b * n * nh + h;
    const E* dout_bh = static_cast<const E*>(a.dout) + (long long)b * a.Q * nh * cs + (long long)h * cs + 2 * lane;
    int u = 0, slot = 0, q = 0;
    float w = 0.f;
    if (lane < m) {
      const int i = t0 + lane, role = i < n_a ? 0 : 1, at = role ? b0 + i - n_a : a0 + i;
      u = a.order[(long long)g * n + at];
      q = query_of(u, a.ppq, a.inv_ppq);
      w = term_w<R>(a, upd_bh, u, pw[(long long)g * n + at], role, r, slot);
    }
    const long long row = (((long long)b * a.rows + r) * nh + h) * cs + 2 * lane;
    float2 v = make_float2(0.f, 0.f);
    if constexpr (R::dw) v = live ? ld2(static_cast<const E*>(a.value) + row) : make_float2(0.f, 0.f);
    float2 acc = make_float2(0.f, 0.f);
    for (int j0 = 0; j0 < m; j0 += 8) {
      float2 d[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int qj = __shfl_sync(kFull, q, (j0 + jj) & 31);
        d[jj] = j0 + jj < m && live ? ld2(dout_bh + (long long)qj * nh * cs) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int src = (j0 + jj) & 31;
        const bool ok = j0 + jj < m;  // uniform over the warp
        const float wj = __shfl_sync(kFull, w, src);
        if (ok) {
          acc.x = __fadd_rn(acc.x, __fmul_rn(wj, d[jj].x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(wj, d[jj].y));
        }
        if constexpr (R::dw) {
          float sdot = v.x * d[jj].x + v.y * d[jj].y;
#pragma unroll
          for (int off = 16; off >= 1; off /= 2) sdot += __shfl_xor_sync(kFull, sdot, off);
          if (ok && lane == src) a.dw[2 * (upd_bh + (long long)u * nh) + slot] = sdot;
        }
      }
    }
    if (ns == 1) {
      if (live) st2(static_cast<E*>(a.out) + row, acc);
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
      st2(static_cast<E*>(a.out) + row, tot);
    }
  }
}

// Blocks [0, seg_blocks) sum the long rows' segments; the rest are the
// tiles, which the card starts after them.
template <class R, typename E>
__global__ void __launch_bounds__(kRowWarps * 32, 4) rows_kernel(const RowArgs a) {
  if ((int)blockIdx.x < a.seg_blocks)
    row_segments<R, E>(a);
  else
    tile_rows<R, E>(a, blockIdx.x - a.seg_blocks);
}

// Launch 2, on launch 1's buckets and segments: a's pointers and G, rows,
// NB, nh, c, cs, Q, ppq set (c even, 2 <= c <= 64, cs even and >= c,
// Q ppq < 2^24); value, dout and out of E.
template <class R, typename E = float>
cudaError_t launch_rows(RowArgs a, cudaStream_t stream) {
  if (a.c % 2 != 0 || a.c > 64 || a.c < 2 || a.cs % 2 != 0 || a.cs < a.c || a.rows < 1 || a.G < 1 || a.Q < 1 ||
      a.nh < 1 || a.ppq < 1 || (long long)a.Q * a.ppq >= (1 << 24))
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)a.G * ((a.rows + kTileRows - 1) / kTileRows);
  a.seg_blocks = 2 * sms;
  a.inv_ppq = 1.0f / (float)a.ppq;
  if (tiles + a.seg_blocks > INT_MAX) return cudaErrorInvalidValue;
  rows_kernel<R, E><<<(unsigned)(tiles + a.seg_blocks), kRowWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
