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
// keeps bidding until the whole batch stops; this kernel does the same: each
// block runs its own problem until it is done, reports its round count,
// and, if it still has unassigned persons, waits for every block's count
// and runs on to the batch's maximum (a round without bids ends it early:
// nothing can change after it). The blocks must therefore all be resident
// at once: the launch is cooperative and fails if they cannot be.
//
// Design: one block per problem; value (nq x M), prices, owners and the
// assignment live in shared memory (100 x 300 fp32 is 120 KB, above the
// default 48 KB, so the launch opts in to more). A person's scan over the
// objects reads value[q][m] with consecutive threads on consecutive m. The
// per-object best bid is one 64-bit atomicMax on (ordered bid bits, ~m), so
// the highest bid wins and equal bids go to the lowest m, as jnp.argmax
// picks. The result is bitwise deterministic.
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
  float* val;               // [nq][M]
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

__global__ void __launch_bounds__(kThreads) auction_kernel(
    const float* __restrict__ value, const float* __restrict__ eps,
    const unsigned char* __restrict__ gt_mask, const int* __restrict__ target,
    int* __restrict__ assigned, int* ctrl, int nq, int M, int max_rounds) {
  extern __shared__ unsigned long long smem_u64[];
  __shared__ int s_count, s_flag, s_rounds;
  const int tid = threadIdx.x, b = blockIdx.x;
  Problem p;
  p.key = smem_u64;
  p.val = reinterpret_cast<float*>(p.key + nq);
  p.price = p.val + (long long)nq * M;
  p.owner = reinterpret_cast<int*>(p.price + nq);
  p.asg = p.owner + nq;
  p.valid = p.asg + M;
  p.nq = nq;
  p.M = M;
  p.eps = eps[b];

  const float* val_b = value + (long long)b * nq * M;
  for (int i = tid; i < nq * M; i += kThreads) p.val[i] = val_b[i];
  for (int q = tid; q < nq; q += kThreads) {
    p.price[q] = 0.f;
    p.owner[q] = -1;
  }
  for (int m = tid; m < M; m += kThreads) {
    p.asg[m] = -1;
    p.valid[m] = gt_mask[(long long)b * M + m] != 0;
  }
  const int tgt = target[b];
  __syncthreads();

  // this problem's own rounds: until min(#valid, #objects) are assigned
  int r = 0;
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
    atomicMax(&ctrl[1], r);
    __threadfence();
    atomicAdd(&ctrl[0], 1);
  }
  // done with persons still unassigned: run on to the batch's round count
  if (r < max_rounds) {
    if (tid == 0) s_flag = 0;
    __syncthreads();
    for (int m = tid; m < M; m += kThreads)
      if (p.valid[m] && p.asg[m] < 0) s_flag = 1;
    __syncthreads();
    if (s_flag) {
      if (tid == 0) {
        while (atomicAdd(&ctrl[0], 0) < (int)gridDim.x) __nanosleep(256);
        s_rounds = atomicAdd(&ctrl[1], 0);
      }
      __syncthreads();
      const int R = s_rounds;
      while (r < R) {
        ++r;
        if (!auction_round(p, &s_flag)) break;
      }
    }
  }
  for (int m = tid; m < M; m += kThreads)
    assigned[(long long)b * M + m] = p.valid[m] ? p.asg[m] : -1;
}

size_t smem_bytes(int nq, int M) {
  return sizeof(unsigned long long) * nq + sizeof(float) * ((size_t)nq * M + nq) +
         sizeof(int) * (nq + 2 * (size_t)M);
}

}  // namespace

// value (B, nq, M) maximised, NEG at invalid pairs; eps (B,); gt_mask (B, M)
// bool; target (B,) int32; assigned (B, M) int32 out; ctrl (2,) int32 zeroed
// (finished blocks, their largest round count).
extern "C" int auction_match(const float* value, const float* eps, const unsigned char* gt_mask,
                             const int* target, int* assigned, int* ctrl, int B, int nq, int M,
                             int max_rounds, void* stream) {
  if (B < 1 || nq < 1 || M < 1 || max_rounds < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nq, M);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(auction_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&value, (void*)&eps, (void*)&gt_mask, (void*)&target,
                  (void*)&assigned, (void*)&ctrl, (void*)&nq, (void*)&M, (void*)&max_rounds};
  err = cudaLaunchCooperativeKernel((const void*)auction_kernel, dim3(B), dim3(kThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
