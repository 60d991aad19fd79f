// One-direction S6 selective scan, forward, fp32, dt given.
//
// Replaces the TPU kernel `tamtr_tpu/kernels/selective_scan.py:_scan_kernel`
// (launched by `_run_scan`, reached through `selective_scan_pallas`). Same
// contract: for every group g, channel d and state lane n, from h = 0,
//     h_t = exp(delta_t A[g, d, n]) h_{t-1} + (delta_t u_t) B_t[n]
//     y_t = sum_n C_t[n] h_t[n] + D[g, d] u_t        (the D term if D given)
// with u, delta, y (G, L, Din), A (G, Din, N), B, C (G, L, N), D (G, Din)
// or null, all contiguous fp32 (the wrapper upcasts other types).
//
// Design: one thread per (g, d, n) keeps its state h in a register for the
// whole sequence, as kernel B1 (`ss2d_scan_fwd.cu`) does. A block holds
// 128 / N channels of one group, N lanes each. Chunks of kT steps of u,
// delta, B and C are staged in shared memory; each thread steps through the
// chunk and the N lanes of a channel sum C.h with __shfl_xor_sync; y goes
// back out through shared memory once per chunk. The result does not depend
// on any chunk size: the state is carried step by step.
//
// Bound on the card: by bytes: u, delta, B, C, A and D read once, y written
// once; at 640 px level 0 (G = 4, L = 25600, Din = 256) that is ~0.3 GB,
// ~0.09 ms at 3.35 TB/s, with ~8 operations per (t, d, n). This simple
// design runs only G.Din.N threads, each a serial loop of L steps, so it is
// latency bound far above that; a chunked parallel scan is the later design.
// Precise expf (no fast-math) keeps it within 1e-4 of the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 64;  // steps staged per chunk

template <int kN>
__global__ void __launch_bounds__(kThreads) selective_scan_fwd_kernel(
    const float* __restrict__ u, const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Bs, const float* __restrict__ Cs, const float* __restrict__ Dskip,
    float* __restrict__ y, int L, int D) {
  constexpr int kCPB = kThreads / kN;  // channels per block
  __shared__ float s_u[kT * kCPB], s_dt[kT * kCPB], s_y[kT * kCPB];
  __shared__ float s_B[kT * kN], s_C[kT * kN];

  const int g = blockIdx.y;
  const int d0 = blockIdx.x * kCPB;
  const int tid = threadIdx.x;
  const int n = tid % kN;
  const int dl = tid / kN;
  const int d = d0 + dl;
  const bool active = d < D;
  const long long seq = (long long)g * L;
  const float a_dn = active ? A[((long long)g * D + d) * kN + n] : 0.f;
  const float d_skip = (Dskip != nullptr && active) ? Dskip[(long long)g * D + d] : 0.f;
  float h = 0.f;

  for (int s0 = 0; s0 < L; s0 += kT) {
    const int T = min(kT, L - s0);
    __syncthreads();  // the previous chunk is consumed and written out
    for (int i = tid; i < T * kN; i += kThreads) {
      const long long t = seq + s0 + i / kN;
      s_B[i] = Bs[t * kN + i % kN];
      s_C[i] = Cs[t * kN + i % kN];
    }
    for (int i = tid; i < T * kCPB; i += kThreads) {
      const int dd = d0 + i % kCPB;
      const long long at = (seq + s0 + i / kCPB) * D + dd;
      s_u[i] = dd < D ? u[at] : 0.f;
      s_dt[i] = dd < D ? delta[at] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < T; ++s) {
      const float dt = s_dt[s * kCPB + dl];
      const float uu = s_u[s * kCPB + dl];
      h = expf(dt * a_dn) * h + dt * uu * s_B[s * kN + n];
      float p = s_C[s * kN + n] * h;
#pragma unroll
      for (int off = kN / 2; off >= 1; off /= 2) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) s_y[s * kCPB + dl] = p + uu * d_skip;
    }
    __syncthreads();
    for (int i = tid; i < T * kCPB; i += kThreads) {
      const int dd = d0 + i % kCPB;
      if (dd < D) y[(seq + s0 + i / kCPB) * D + dd] = s_y[i];
    }
  }
}

template <int kN>
cudaError_t launch(const float* u, const float* delta, const float* A, const float* Bs,
                   const float* Cs, const float* Dskip, float* y, int G, int L, int D,
                   cudaStream_t stream) {
  constexpr int kCPB = kThreads / kN;
  dim3 grid((D + kCPB - 1) / kCPB, G);
  selective_scan_fwd_kernel<kN><<<grid, kThreads, 0, stream>>>(u, delta, A, Bs, Cs, Dskip, y, L, D);
  return cudaGetLastError();
}

}  // namespace

// N (the state size) must be 4, 8, 16 or 32; Dskip may be null.
extern "C" int selective_scan_fwd(const float* u, const float* delta, const float* A,
                                  const float* Bs, const float* Cs, const float* Dskip, float* y,
                                  int G, int L, int D, int N, void* stream) {
  if (G < 1 || L < 1 || D < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 4: return (int)launch<4>(u, delta, A, Bs, Cs, Dskip, y, G, L, D, s);
    case 8: return (int)launch<8>(u, delta, A, Bs, Cs, Dskip, y, G, L, D, s);
    case 16: return (int)launch<16>(u, delta, A, Bs, Cs, Dskip, y, G, L, D, s);
    case 32: return (int)launch<32>(u, delta, A, Bs, Cs, Dskip, y, G, L, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
