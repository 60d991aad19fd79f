// Jacobi auction assignment, every round on the device, fp32.
//
// Replaces the TPU kernel `tamtr_tpu/kernels/auction.py:_auction_kernel`
// (launched by `auction_match_pallas`) and computes the function of the JAX
// package's default matcher, `tamtr_tpu/losses/matcher.py:auction_match`:
// single phase from zero prices, a per-problem eps, persons = valid gt
// columns bidding for objects = query rows. The caller prepares
// value = -cost with invalid pairs at NEG = -1e9 (gt_mask, and row_mask for
// the transposed solve), eps (B,) and target (B,) = min(#valid, #objects);
// `tamtr_torch/kernels/auction.py:auction_setup` does that for this kernel
// and for the plain version alike. One round, per problem:
//   - every valid unassigned person m finds its best object j1 (first index
//     of the maximum of value - price, as jnp.argmax) and the runner-up w2,
//     and bids price[j1] + (w1 - w2) + eps if w1 > NEG/2;
//   - every object with bids goes to the highest bid (ties: the lowest m),
//     its previous owner becomes unassigned, its price becomes the bid.
// The JAX while_loop stops when every problem of the batch has
// min(#valid, #objects) persons assigned, or after max_rounds. A problem
// that is done with persons still unassigned (more bidders than objects)
// keeps bidding until the whole batch stops. The count of assigned persons
// never falls (an owned object stays owned), so the batch stops after
// R = max over problems of each one's own stopping round. Two launches give
// the same rounds for any batch size, with no block waiting on another:
//   1. every problem runs to its own stop, stores its assignment, and adds
//      its round count to R with an atomicMax; a problem left with
//      unassigned persons also stores its prices, owners and round count;
//   2. those problems alone reload their state and run on to R (a round
//      without bids ends one early: nothing can change after it). The other
//      blocks return at once. R stays on the device: no host read.
//
// Design: one block per problem; prices, owners and the assignment live in
// shared memory. value (nq x M) does too where it fits the block's opt-in
// limit (100 x 300 fp32 is 120 KB); above it (with nq = 100, M beyond about
// 560) a second instantiation reads value from device memory, where one
// problem's 0.24 MB at M = 600 stays in L2 across its rounds. A person's
// scan over the objects reads value[q][m] with consecutive threads on
// consecutive m. The per-object best bid is one 64-bit atomicMax on
// (ordered bid bits, ~m), so the highest bid wins and equal bids go to the
// lowest m, as jnp.argmax picks. The result is bitwise deterministic.
//
// Bound on the card: value read once, the assignment written once (0.12 MB
// per problem), and rounds x nq x M compare-and-subtract operations; at
// (16, 100, 300) both are microseconds. Each round is a few block-wide
// barriers, so this design is bound by the number of rounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr float kNeg = -1e9f;

__device__ __forceinline__ unsigned long long bid_key(float bid, int m) {
  unsigned int bits = __float_as_uint(bid);
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);  // order-preserving
  return ((unsigned long long)bits << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned int)m);
}

__device__ __forceinline__ float key_bid(unsigned long long key) {
  unsigned int bits = (unsigned int)(key >> 32);
  bits = (bits & 0x80000000u) ? (bits & 0x7FFFFFFFu) : ~bits;
  return __uint_as_float(bits);
}

__device__ __forceinline__ int key_person(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

struct Problem {
  unsigned long long* key;  // [nq] best bid per object this round
  const float* val;         // [nq][M], in shared or device memory
  float* price;             // [nq]
  int* owner;               // [nq]
  int* asg;                 // [M] object of each person, -1 if none
  int* valid;               // [M]
  int nq, M;
  float eps;
};

// One Jacobi round; returns (block-uniformly) whether any object got a bid.
__device__ bool auction_round(const Problem& p, int* s_flag) {
  const int tid = threadIdx.x;
  for (int q = tid; q < p.nq; q += kThreads) p.key[q] = 0ull;
  if (tid == 0) *s_flag = 0;
  __syncthreads();
  for (int m = tid; m < p.M; m += kThreads) {
    if (!p.valid[m] || p.asg[m] >= 0) continue;
    float w1 = -INFINITY, w2 = kNeg;
    int j1 = 0;
    for (int q = 0; q < p.nq; ++q) {
      const float v = p.val[q * p.M + m] - p.price[q];
      if (v > w1) {
        w2 = fmaxf(w2, w1);
        w1 = v;
        j1 = q;
      } else {
        w2 = fmaxf(w2, v);
      }
    }
    if (w1 > kNeg * 0.5f) {
      const float bid = p.price[j1] + (w1 - w2) + p.eps;
      atomicMax(&p.key[j1], bid_key(bid, m));
    }
  }
  __syncthreads();
  for (int q = tid; q < p.nq; q += kThreads) {
    const unsigned long long key = p.key[q];
    if (key == 0ull) continue;
    const int m = key_person(key);
    const int prev = p.owner[q];
    if (prev >= 0) p.asg[prev] = -1;  // prev owns q, so it is no bidder: no race with m
    p.asg[m] = q;
    p.owner[q] = m;
    p.price[q] = key_bid(key);
    *s_flag = 1;
  }
  __syncthreads();
  return *s_flag != 0;
}

// Launch 1 (resume == 0) or launch 2 (resume == 1) of the header's scheme.
// assigned (B, M) holds each problem's assignment between the launches;
// price_g, owner_g (B, nq) and rounds_g (B,) the state of the problems that
// run on (rounds_g < 0 for the others); ctrl[0] the batch's round count R.
template <bool kValueInSmem>
__global__ void __launch_bounds__(kThreads) auction_kernel(
    const float* __restrict__ value, const float* __restrict__ eps,
    const unsigned char* __restrict__ gt_mask, const int* __restrict__ target,
    int* __restrict__ assigned, float* __restrict__ price_g, int* __restrict__ owner_g,
    int* __restrict__ rounds_g, int* ctrl, int nq, int M, int max_rounds, int resume) {
  extern __shared__ unsigned long long smem_u64[];
  __shared__ int s_count, s_flag;
  const int tid = threadIdx.x, b = blockIdx.x;
  int r = 0;
  if (resume) {
    r = rounds_g[b];
    if (r < 0) return;  // block-uniform: this problem stopped for good in launch 1
  }
  const float* val_b = value + (long long)b * nq * M;
  Problem p;
  p.key = smem_u64;
  float* s_val = reinterpret_cast<float*>(p.key + nq);
  p.price = s_val + (kValueInSmem ? (long long)nq * M : 0);
  p.owner = reinterpret_cast<int*>(p.price + nq);
  p.asg = p.owner + nq;
  p.valid = p.asg + M;
  p.val = kValueInSmem ? s_val : val_b;
  p.nq = nq;
  p.M = M;
  p.eps = eps[b];
  int* asg_b = assigned + (long long)b * M;

  if (kValueInSmem)
    for (int i = tid; i < nq * M; i += kThreads) s_val[i] = val_b[i];
  for (int q = tid; q < nq; q += kThreads) {
    p.price[q] = resume ? price_g[(long long)b * nq + q] : 0.f;
    p.owner[q] = resume ? owner_g[(long long)b * nq + q] : -1;
  }
  for (int m = tid; m < M; m += kThreads) {
    p.asg[m] = resume ? asg_b[m] : -1;
    p.valid[m] = gt_mask[(long long)b * M + m] != 0;
  }
  __syncthreads();

  if (resume) {
    const int R = ctrl[0];  // final: launch 1 has finished
    while (r < R) {
      ++r;
      if (!auction_round(p, &s_flag)) break;
    }
  } else {
    // this problem's own rounds: until min(#valid, #objects) are assigned
    const int tgt = target[b];
    for (;;) {
      if (tid == 0) s_count = 0;
      __syncthreads();
      int c = 0;
      for (int m = tid; m < M; m += kThreads) c += p.asg[m] >= 0;
      if (c) atomicAdd(&s_count, c);
      __syncthreads();
      if (s_count >= tgt || r >= max_rounds) break;
      auction_round(p, &s_flag);
      ++r;
    }
    if (tid == 0) {
      atomicMax(ctrl, r);
      s_flag = 0;
    }
    __syncthreads();
    // done with valid persons still unassigned: launch 2 runs it on
    if (r < max_rounds)
      for (int m = tid; m < M; m += kThreads)
        if (p.valid[m] && p.asg[m] < 0) s_flag = 1;
    __syncthreads();
    if (tid == 0) rounds_g[b] = s_flag ? r : -1;
    if (s_flag)
      for (int q = tid; q < nq; q += kThreads) {
        price_g[(long long)b * nq + q] = p.price[q];
        owner_g[(long long)b * nq + q] = p.owner[q];
      }
  }
  // invalid persons never bid, so their entries stay -1
  for (int m = tid; m < M; m += kThreads) asg_b[m] = p.asg[m];
}

size_t smem_bytes(int nq, int M, bool value_in_smem) {
  return sizeof(unsigned long long) * nq +
         sizeof(float) * ((value_in_smem ? (size_t)nq * M : 0) + nq) +
         sizeof(int) * (nq + 2 * (size_t)M);
}

template <bool kValueInSmem>
cudaError_t launch_both(const float* value, const float* eps, const unsigned char* gt_mask,
                        const int* target, int* assigned, float* price, int* owner, int* rounds,
                        int* ctrl, int B, int nq, int M, int max_rounds, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(auction_kernel<kValueInSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  for (int resume = 0; resume < 2; ++resume) {
    auction_kernel<kValueInSmem><<<B, kThreads, smem, stream>>>(
        value, eps, gt_mask, target, assigned, price, owner, rounds, ctrl, nq, M, max_rounds,
        resume);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// value (B, nq, M) maximised, NEG at invalid pairs; eps (B,); gt_mask (B, M)
// bool; target (B,) int32; assigned (B, M) int32 out; price (B, nq) fp32,
// owner (B, nq) and rounds (B,) int32 scratch; ctrl (1,) int32 zeroed (the
// batch's round count).
extern "C" int auction_match(const float* value, const float* eps, const unsigned char* gt_mask,
                             const int* target, int* assigned, float* price, int* owner,
                             int* rounds, int* ctrl, int B, int nq, int M, int max_rounds,
                             void* stream) {
  if (B < 1 || nq < 1 || M < 1 || max_rounds < 0) return (int)cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (smem_bytes(nq, M, true) <= (size_t)optin)
    return (int)launch_both<true>(value, eps, gt_mask, target, assigned, price, owner, rounds,
                                  ctrl, B, nq, M, max_rounds, smem_bytes(nq, M, true), s);
  if (smem_bytes(nq, M, false) <= (size_t)optin)
    return (int)launch_both<false>(value, eps, gt_mask, target, assigned, price, owner, rounds,
                                   ctrl, B, nq, M, max_rounds, smem_bytes(nq, M, false), s);
  return (int)cudaErrorInvalidValue;
}
