// Jacobi auction assignment, every round on the device, fp32.
//
// Replaces the TPU kernel `tamtr_tpu/kernels/auction.py:_auction_kernel`
// (launched by `auction_match_pallas`) and computes the functions of the JAX
// package's default matcher: `tamtr_tpu/losses/matcher.py:auction_match`
// (single phase from zero prices, a per-problem eps, persons = valid gt
// columns bidding for objects = query rows, optional row_mask) and
// `auction_assignment` (the forward solve, or for an over-full image, with
// more valid gts than queries, the transposed solve). One round, per problem:
//   - every valid unassigned person p finds its best object j1 (first index
//     of the maximum of value - price, as jnp.argmax) and the runner-up w2
//     (the maximum of the rest and NEG), and bids
//     price[j1] + (w1 - w2) + eps if w1 > NEG/2;
//   - every object with bids goes to the highest bid (ties: the lowest p),
//     its previous owner becomes unassigned, its price becomes the bid.
//
// Setup, in-block, with the fp32 operations of
// `tamtr_torch/kernels/auction.py:auction_setup`: value = -cost, NEG = -1e9
// at invalid pairs; spread = max(max - min, 1) over the valid pairs' values
// and, if any pair is invalid, 0; eps = spread * (1e-2 if #valid persons >=
// 0.7 #valid objects, else 1e-3); target = min(#valid persons, #objects).
//
// `auction_assignment`: ONE launch, one block per image, no host read. The
// block orients its own problem: an image with n_valid <= nq is solved
// forward (persons = gts), an over-full one transposed (persons = the nq
// queries, objects = the valid gts, C[b] read through strides, no copy).
// Each problem runs to its own stop (target reached, or max_rounds) and
// writes the gt-ordered answer; for a transposed problem out[gt] = query.
// Why this equals JAX's `auction_assignment`, whose while_loops stop for the
// whole batch: a problem's own stop differs from the batch's R only for a
// problem that still has valid unassigned persons at its own stop, i.e.
// more persons than objects. Those are the forward solves of over-full
// images and the transposed solves of the other images, and the final
// `where` (`tamtr_tpu/losses/matcher.py:201`) discards both. Every kept
// problem stops with every person assigned, and a round without bidders
// changes nothing.
//
// `auction_match` keeps the batch-wide stop (a problem done with persons
// still unassigned keeps bidding until the whole batch stops). The count of
// assigned persons never falls (an owned object stays owned), so the batch
// stops after R = max over problems of each one's own stopping round. Two
// launches give the same rounds for any batch size, with no block waiting
// on another: launch 1 runs every problem to its own stop, stores its
// assignment, and folds its round count into R with an atomicMax; a problem
// left with bidders also stores its prices, owners and round count; launch 2
// runs those problems alone from that state on to R. R stays on the device.
//
// Design: one block per problem, the round body (`auction_round`) shared by
// both ops. Prices, owners, the assignment and the bidders live in shared
// memory, and value does too (person-major, rows of odd length) where it
// fits the block's opt-in limit (300 x 101 fp32 is 121 KB); above it (M
// beyond about 560 at nq = 100) a second instantiation computes value from
// the cost in device memory, which stays in L2 across rounds. A round keeps
// a compacted list of its bidders (the unassigned who may still bid: a
// person whose best net value fell to NEG/2 never bids again, as prices
// never fall); a team of T = 8 lanes serves each bidder (about 7% faster
// than T = 4 at (16, 100, 300)), each lane scans every T-th object, and
// the team merges its (w1, j1, w2) partials with shuffles,
// ties to the lower index: bit-identical to the serial scan. The best bid
// per object is a 64-bit atomicMax on (ordered bid bits, ~p), so the
// highest bid wins and equal bids go to the lowest p. The award pass appends
// the kicked owners and the outbid bidders to the next round's list and
// keeps the assigned count as a running total: two barriers a round. The
// list's order varies from run to run; no result depends on it, so the
// assignment is bitwise deterministic.
//
// Bound on the card: cost read once, the assignment written once, and
// rounds x nq x M compare-and-subtract operations; at (16, 100, 300) both
// are microseconds. Each round is two block-wide barriers and a scan of
// O / T objects per team, so the kernel is bound by the number of rounds of
// its slowest problem.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int T = 8;  // lanes a bidder
constexpr float kNeg = -1e9f;

enum Mode { kAssign = 0, kMatchFirst = 1, kMatchResume = 2 };

__device__ __forceinline__ unsigned long long bid_key(float bid, int p) {
  unsigned int bits = __float_as_uint(bid);
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);  // order-preserving
  return ((unsigned long long)bits << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned int)p);
}

__device__ __forceinline__ float key_bid(unsigned long long key) {
  unsigned int bits = (unsigned int)(key >> 32);
  bits = (bits & 0x80000000u) ? (bits & 0x7FFFFFFFu) : ~bits;
  return __uint_as_float(bits);
}

__device__ __forceinline__ int key_person(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

// One block's oriented problem and its shared state.
struct Problem {
  const float* cost;           // C[b] (nq, M)
  long long sp, so;            // strides of person and object in cost
  const float* val;            // shared value [P][ldv], or null: from cost
  int ldv;
  const unsigned char* pv;     // [P] valid persons
  const unsigned char* ov;     // [O] valid objects
  unsigned long long* key;     // [2][O] best bid per object, by round parity
  float* price;                // [O]
  int* owner;                  // [O]
  int* asg;                    // [P] object of each person, -1 if none
  int* list;                   // [2][P] bidders, by round parity
  int* bid_obj;                // [P] object each listed bidder bid for, -1 if none
  int* n_list;                 // [2] list lengths
  int* count;                  // assigned persons
  int P, O;
  float eps;
};

__device__ __forceinline__ float value_at(const Problem& q, int p, int o) {
  if (q.val) return q.val[p * q.ldv + o];
  return (q.pv[p] && q.ov[o]) ? -q.cost[p * q.sp + o * q.so] : kNeg;
}

// One Jacobi round on the bidders of list[cur]; appends the next round's to
// list[cur ^ 1]. Two block-wide barriers; the caller reads n_list[cur ^ 1]
// and count after it.
__device__ void auction_round(const Problem& q, int cur) {
  const int tid = threadIdx.x;
  unsigned long long* key = q.key + cur * q.O;
  // the other parity's keys were last read before the previous round's end
  for (int o = tid; o < q.O; o += kThreads) q.key[(cur ^ 1) * q.O + o] = 0ull;
  if (tid == 0) q.n_list[cur ^ 1] = 0;
  const int n = q.n_list[cur];
  const int* lst = q.list + cur * q.P;
  const int lane = tid % T;
  const unsigned team_mask = ((1u << T) - 1u) << ((tid % 32) & ~(T - 1));
  for (int i = tid / T; i < n; i += kThreads / T) {
    const int p = lst[i];
    float w1 = -INFINITY, w2 = kNeg;
    int j1 = INT_MAX;
    for (int o = lane; o < q.O; o += T) {
      const float v = __fsub_rn(value_at(q, p, o), q.price[o]);
      if (v > w1) {
        w2 = fmaxf(w2, w1);
        w1 = v;
        j1 = o;
      } else {
        w2 = fmaxf(w2, v);
      }
    }
#pragma unroll
    for (int off = T / 2; off >= 1; off /= 2) {  // the team's partials, ties to the lower index
      const float ow1 = __shfl_xor_sync(team_mask, w1, off, T);
      const float ow2 = __shfl_xor_sync(team_mask, w2, off, T);
      const int oj1 = __shfl_xor_sync(team_mask, j1, off, T);
      const bool mine = w1 > ow1 || (w1 == ow1 && j1 < oj1);
      w2 = mine ? fmaxf(w2, ow1) : fmaxf(ow2, w1);
      if (!mine) {
        w1 = ow1;
        j1 = oj1;
      }
    }
    if (lane == 0) {
      int bid_for = -1;
      if (w1 > kNeg * 0.5f) {
        const float bid = __fadd_rn(__fadd_rn(q.price[j1], __fsub_rn(w1, w2)), q.eps);
        atomicMax(&key[j1], bid_key(bid, p));
        bid_for = j1;
      }
      q.bid_obj[i] = bid_for;
    }
  }
  __syncthreads();
  int* nxt = q.list + (cur ^ 1) * q.P;
  int newly = 0;
  for (int o = tid; o < q.O; o += kThreads) {
    const unsigned long long k = key[o];
    if (k == 0ull) continue;
    const int p = key_person(k), prev = q.owner[o];
    if (prev >= 0) {  // prev owns o, so it is no bidder: no race with p
      q.asg[prev] = -1;
      nxt[atomicAdd(&q.n_list[cur ^ 1], 1)] = prev;
    } else {
      ++newly;
    }
    q.asg[p] = o;
    q.owner[o] = p;
    q.price[o] = key_bid(k);
  }
  for (int i = tid; i < n; i += kThreads) {  // outbid bidders bid again
    const int j = q.bid_obj[i];
    if (j >= 0 && key_person(key[j]) != lst[i]) nxt[atomicAdd(&q.n_list[cur ^ 1], 1)] = lst[i];
  }
  if (newly) atomicAdd(q.count, newly);
  __syncthreads();
}

__device__ int block_sum(int v, int* s_red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tid % 32 == 0) s_red[tid / 32] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < kThreads / 32; ++w) t += s_red[w];
  __syncthreads();
  return t;
}

__device__ float block_max(float v, float* s_red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (tid % 32 == 0) s_red[tid / 32] = v;
  __syncthreads();
  float t = -INFINITY;
  for (int w = 0; w < kThreads / 32; ++w) t = fmaxf(t, s_red[w]);
  __syncthreads();
  return t;
}

size_t round_up8(size_t n) { return (n + 7) & ~(size_t)7; }

// Shared bytes for problems of at most PM persons and OM objects, with
// value (rows of odd length ldv) in shared memory or not.
size_t smem_bytes(int PM, int OM, size_t val_floats) {
  return round_up8(sizeof(unsigned long long) * 2 * OM + sizeof(float) * val_floats +
                   sizeof(float) * OM + sizeof(int) * (OM + 4 * (size_t)PM + 3)) +
         PM + OM;
}

__host__ __device__ int odd(int n) { return n | 1; }

// mode kAssign: out (B, M) the gt-ordered assignment. kMatchFirst /
// kMatchResume: launch 1 / 2 of `auction_match`; out (B, M) holds each
// problem's assignment between the launches, price_g and owner_g (B, nq)
// and rounds_g (B,) the state of the problems that run on (rounds_g < 0 for
// the others), ctrl[0] the batch's round count R.
template <bool kValueInSmem>
__global__ void __launch_bounds__(kThreads) auction_kernel(
    const float* __restrict__ cost, const unsigned char* __restrict__ gt_mask,
    const unsigned char* __restrict__ row_mask, int* __restrict__ out, float* __restrict__ price_g,
    int* __restrict__ owner_g, int* __restrict__ rounds_g, int* ctrl, int nq, int M, int max_rounds, int mode) {
  extern __shared__ unsigned long long smem_u64[];
  __shared__ int s_red_i[kThreads / 32];
  __shared__ float s_red_f[kThreads / 32];
  const int tid = threadIdx.x, b = blockIdx.x;
  int r = 0;
  if (mode == kMatchResume) {
    r = rounds_g[b];
    if (r < 0) return;  // block-uniform: this problem stopped for good in launch 1
  }
  const unsigned char* gm = gt_mask + (long long)b * M;
  bool transposed = false;
  if (mode == kAssign) {
    int c = 0;
    for (int m = tid; m < M; m += kThreads) c += gm[m] != 0;
    transposed = block_sum(c, s_red_i) > nq;
  }
  const int PM = max(nq, M), OM = PM;
  Problem q;
  q.cost = cost + (long long)b * nq * M;
  q.P = transposed ? nq : M;
  q.O = transposed ? M : nq;
  q.sp = transposed ? M : 1;
  q.so = transposed ? 1 : M;
  q.ldv = odd(q.O);
  q.key = smem_u64;
  float* s_val = reinterpret_cast<float*>(q.key + 2 * OM);
  const size_t val_floats = kValueInSmem ? (size_t)max(M * odd(nq), nq * odd(M)) : 0;
  q.price = s_val + val_floats;
  q.owner = reinterpret_cast<int*>(q.price + OM);
  q.asg = q.owner + OM;
  q.list = q.asg + PM;
  q.bid_obj = q.list + 2 * PM;
  q.n_list = q.bid_obj + PM;
  q.count = q.n_list + 2;
  unsigned char* pv = reinterpret_cast<unsigned char*>(q.count + 1);
  unsigned char* ov = pv + PM;
  q.pv = pv;
  q.ov = ov;
  q.val = nullptr;

  // validity: persons are the gts forward, the queries transposed
  for (int p = tid; p < q.P; p += kThreads) pv[p] = transposed ? 1 : gm[p] != 0;
  for (int o = tid; o < q.O; o += kThreads)
    ov[o] = transposed ? gm[o] != 0 : (row_mask ? row_mask[(long long)b * nq + o] != 0 : 1);
  for (int o = tid; o < 2 * q.O; o += kThreads) q.key[o] = 0ull;
  if (tid == 0) q.n_list[0] = *q.count = 0;
  __syncthreads();
  int n_pv = 0, n_ov = 0;
  for (int p = tid; p < q.P; p += kThreads) n_pv += pv[p];
  for (int o = tid; o < q.O; o += kThreads) n_ov += ov[o];
  n_pv = block_sum(n_pv, s_red_i);
  n_ov = block_sum(n_ov, s_red_i);
  // value over the valid pairs, read in the cost's own order (coalesced)
  float vmax = -INFINITY, nvmin = -INFINITY;  // max of value and of -value
  for (int i = tid; i < nq * M; i += kThreads) {
    const int row = i / M, col = i % M;
    const int p = transposed ? row : col, o = transposed ? col : row;
    const bool ok = pv[p] && ov[o];
    const float v = ok ? -q.cost[i] : kNeg;
    if (kValueInSmem) s_val[p * q.ldv + o] = v;
    if (ok) {
      vmax = fmaxf(vmax, v);
      nvmin = fmaxf(nvmin, -v);
    }
  }
  if (kValueInSmem) q.val = s_val;
  vmax = block_max(vmax, s_red_f);
  float vmin = -block_max(nvmin, s_red_f);
  if (n_pv < q.P || n_ov < q.O) {  // an invalid pair counts as 0 in the spread
    vmax = fmaxf(vmax, 0.f);
    vmin = fminf(vmin, 0.f);
  }
  const float spread = fmaxf(__fsub_rn(vmax, vmin), 1.0f);
  const bool contested = (float)n_pv >= __fmul_rn(0.7f, (float)n_ov);
  q.eps = __fmul_rn(spread, contested ? 1e-2f : 1e-3f);
  const int target = min(n_pv, n_ov);

  // state, and the first list of bidders: the valid unassigned persons
  const bool resume = mode == kMatchResume;
  for (int o = tid; o < q.O; o += kThreads) {
    q.price[o] = resume ? price_g[(long long)b * nq + o] : 0.f;
    q.owner[o] = resume ? owner_g[(long long)b * nq + o] : -1;
  }
  int* asg_b = out + (long long)b * M;
  for (int p = tid; p < q.P; p += kThreads) {
    const int a = resume ? asg_b[p] : -1;
    q.asg[p] = a;
    if (pv[p] && a < 0) q.list[atomicAdd(&q.n_list[0], 1)] = p;
  }
  __syncthreads();

  const int R = resume ? ctrl[0] : max_rounds;  // launch 1 has finished
  int cur = 0;
  for (;;) {
    const int n = q.n_list[cur];
    if (resume) {
      if (r >= R || n == 0) break;
    } else {
      if (*q.count >= target || r >= max_rounds) break;
      if (n == 0) {  // nothing can change any more: this problem's own stop is max_rounds
        r = max_rounds;
        break;
      }
    }
    auction_round(q, cur);
    ++r;
    cur ^= 1;
  }

  if (mode == kMatchFirst) {
    const bool more = q.n_list[cur] > 0 && r < max_rounds;  // launch 2 runs it on
    if (tid == 0) {
      atomicMax(ctrl, r);
      rounds_g[b] = more ? r : -1;
    }
    if (more)
      for (int o = tid; o < q.O; o += kThreads) {
        price_g[(long long)b * nq + o] = q.price[o];
        owner_g[(long long)b * nq + o] = q.owner[o];
      }
  }
  // invalid persons never bid, so their entries stay -1
  if (transposed)
    for (int o = tid; o < M; o += kThreads) asg_b[o] = q.owner[o];
  else
    for (int p = tid; p < M; p += kThreads) asg_b[p] = q.asg[p];
}

template <bool kValueInSmem>
cudaError_t launch(const float* cost, const unsigned char* gt_mask, const unsigned char* row_mask, int* out,
                   float* price, int* owner, int* rounds, int* ctrl, int B, int nq, int M, int max_rounds,
                   int first_mode, int n_modes, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(auction_kernel<kValueInSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  for (int mode = first_mode; mode < first_mode + n_modes; ++mode) {
    auction_kernel<kValueInSmem><<<B, kThreads, smem, stream>>>(cost, gt_mask, row_mask, out, price, owner,
                                                                   rounds, ctrl, nq, M, max_rounds, mode);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int run(const float* cost, const unsigned char* gt_mask, const unsigned char* row_mask, int* out, float* price,
        int* owner, int* rounds, int* ctrl, int B, int nq, int M, int max_rounds, int first_mode,
        int n_modes, void* stream) {
  if (B < 1 || nq < 1 || M < 1 || max_rounds < 0) return (int)cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int PM = nq > M ? nq : M;
  const size_t in_smem = smem_bytes(PM, PM, (size_t)(M * odd(nq) > nq * odd(M) ? M * odd(nq) : nq * odd(M)));
  const size_t from_l2 = smem_bytes(PM, PM, 0);
  if (in_smem <= (size_t)optin)
    return (int)launch<true>(cost, gt_mask, row_mask, out, price, owner, rounds, ctrl, B, nq, M, max_rounds,
                             first_mode, n_modes, in_smem, s);
  if (from_l2 <= (size_t)optin)
    return (int)launch<false>(cost, gt_mask, row_mask, out, price, owner, rounds, ctrl, B, nq, M, max_rounds,
                              first_mode, n_modes, from_l2, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// cost (B, nq, M) fp32 minimised; gt_mask (B, M) bool -> out (B, M) int32,
// the query of each gt (-1 if none), as JAX's `auction_assignment`. One
// launch.
extern "C" int auction_assignment(const float* cost, const unsigned char* gt_mask, int* out, int B, int nq, int M,
                                  int max_rounds, void* stream) {
  return run(cost, gt_mask, nullptr, out, nullptr, nullptr, nullptr, nullptr, B, nq, M, max_rounds,
             kAssign, 1, stream);
}

// cost (B, nq, M); gt_mask (B, M) bool persons; row_mask (B, nq) bool
// objects or null -> assigned (B, M) int32. price (B, nq) fp32, owner (B,
// nq) and rounds (B,) int32 scratch; ctrl (1,) int32 zeroed (the batch's
// round count). Two launches.
extern "C" int auction_match(const float* cost, const unsigned char* gt_mask, const unsigned char* row_mask,
                             int* assigned, float* price, int* owner, int* rounds, int* ctrl, int B, int nq, int M,
                             int max_rounds, void* stream) {
  return run(cost, gt_mask, row_mask, assigned, price, owner, rounds, ctrl, B, nq, M, max_rounds,
             kMatchFirst, 2, stream);
}
