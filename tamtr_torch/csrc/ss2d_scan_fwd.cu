// Fused 4-direction SS2D selective scan, forward, fp32 (VMamba S6).
//
// Replaces the TPU kernel `tamtr_tpu/kernels/selective_scan.py:_ss2d_kernel`
// (launched by `_run_ss2d_scan`, reached through `ss2d_scan`). Same contract
// as `ss2d_scan_xla` there: for direction k (row-fwd, col-fwd, row-rev,
// col-rev), with u = layouts[b, k % 2] and the (f, j) = (k / 2, k % 2) slice
// of dts_raw, Bs and Cs,
//     dt_t = softplus(dt_raw_t . dt_w[k, d] + dt_b[k, d])
//     h_t  = exp(dt_t A[k, d, n]) h_{t-1} + (dt_t u_t) B_t[n]
//     y_t  = sum_n C_t[n] h_t[n] + D[k, d] u_t
// with the reversed directions walking t from L-1 down to 0. Output
// (B, 4, L, D) in natural order. Inputs are read in place: layouts is
// (B, 2, L, D) contiguous; dts_raw, Bs and Cs are (B, 2, 2, L, *) with a row
// stride that may exceed their width (views split out of one x_proj result).
//
// Design: one thread per (b, k, d, n). A block holds kDB = 8 channels d of one
// (b, k), 16 lanes each, and keeps its state h in a register for the whole
// sequence. Chunks of kT steps of dt_raw, B, C and u are staged in shared
// memory; the block computes dt for the chunk (the dt projection, bias and
// softplus are fused here), then each thread steps through the chunk and the
// 16 n-lanes of a channel reduce C.h with __shfl_xor_sync. y goes back out
// through shared memory once per chunk.
//
// Bound on the card: by bytes. At 640 px level 0 (B=1, L=25600, D=256) it
// reads ~70 MB and writes ~105 MB, with 4.L.D.N exp's. This simple design
// runs only B.4.D.N threads, each a serial loop of L steps, so it is latency
// bound far above that; a chunked parallel scan is the later design.
// Precise expf/log1pf (no fast-math) keep it within 1e-4 of the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 16;             // state size, one lane per n
constexpr int kDB = 8;             // channels per block
constexpr int kT = 64;             // steps staged per chunk
constexpr int kThreads = kDB * kN;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(kThreads) ss2d_scan_fwd_kernel(
    const float* __restrict__ layouts, const float* __restrict__ dts_raw,
    const float* __restrict__ Bs, const float* __restrict__ Cs,
    const float* __restrict__ dt_w, const float* __restrict__ dt_b,
    const float* __restrict__ A, const float* __restrict__ Ds,
    float* __restrict__ y, int L, int D, int R,
    long long dt_rs, long long b_rs, long long c_rs) {
  extern __shared__ float smem[];
  float* s_dtw = smem;               // [kDB][R]
  float* s_dtr = s_dtw + kDB * R;    // [kT][R]
  float* s_B = s_dtr + kT * R;       // [kT][kN]
  float* s_C = s_B + kT * kN;        // [kT][kN]
  float* s_u = s_C + kT * kN;        // [kT][kDB]
  float* s_dt = s_u + kT * kDB;      // [kT][kDB]
  float* s_y = s_dt + kT * kDB;      // [kT][kDB]

  const int d0 = blockIdx.x * kDB;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n = tid % kN;
  const int dl = tid / kN;
  const int f = k / 2, j = k % 2;
  const bool rev = f == 1;

  const float* u_base = layouts + ((long long)b * 2 + j) * L * D + d0;
  const long long seq = (((long long)b * 2 + f) * 2 + j) * L;
  const float* dtr_base = dts_raw + seq * dt_rs;
  const float* B_base = Bs + seq * b_rs;
  const float* C_base = Cs + seq * c_rs;
  float* y_base = y + ((long long)b * 4 + k) * L * D + d0;

  for (int i = tid; i < kDB * R; i += kThreads)
    s_dtw[i] = dt_w[((long long)k * D + d0) * R + i];
  const float a_dn = A[((long long)k * D + d0 + dl) * kN + n];
  const float d_skip = Ds[k * D + d0 + dl];
  float h = 0.f;

  for (int s0 = 0; s0 < L; s0 += kT) {
    const int T = min(kT, L - s0);
    __syncthreads();  // the previous chunk is consumed and written out
    for (int i = tid; i < T * R; i += kThreads) {
      const int s = s0 + i / R;
      const long long t = rev ? L - 1 - s : s;
      s_dtr[i] = dtr_base[t * dt_rs + i % R];
    }
    for (int i = tid; i < T * kN; i += kThreads) {
      const int s = s0 + i / kN;
      const long long t = rev ? L - 1 - s : s;
      s_B[i] = B_base[t * b_rs + i % kN];
      s_C[i] = C_base[t * c_rs + i % kN];
    }
    for (int i = tid; i < T * kDB; i += kThreads) {
      const int s = s0 + i / kDB;
      const long long t = rev ? L - 1 - s : s;
      s_u[i] = u_base[t * D + i % kDB];
    }
    __syncthreads();
    for (int i = tid; i < T * kDB; i += kThreads) {
      const int s = i / kDB, dd = i % kDB;
      float z = 0.f;
      for (int r = 0; r < R; ++r) z += s_dtr[s * R + r] * s_dtw[dd * R + r];
      s_dt[i] = softplus(z + dt_b[k * D + d0 + dd]);
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < T; ++s) {
      const float dt = s_dt[s * kDB + dl];
      const float u = s_u[s * kDB + dl];
      h = expf(dt * a_dn) * h + dt * u * s_B[s * kN + n];
      float p = s_C[s * kN + n] * h;
      p += __shfl_xor_sync(0xffffffffu, p, 8);
      p += __shfl_xor_sync(0xffffffffu, p, 4);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      if (n == 0) s_y[s * kDB + dl] = p + u * d_skip;
    }
    __syncthreads();
    for (int i = tid; i < T * kDB; i += kThreads) {
      const int s = s0 + i / kDB;
      const long long t = rev ? L - 1 - s : s;
      y_base[t * D + i % kDB] = s_y[i];
    }
  }
}

}  // namespace

extern "C" int ss2d_scan_fwd(
    const float* layouts, const float* dts_raw, const float* Bs, const float* Cs,
    const float* dt_w, const float* dt_b, const float* A, const float* Ds, float* y,
    int B, int L, int D, int R, int N, long long dt_rs, long long b_rs,
    long long c_rs, void* stream) {
  if (N != kN || D % kDB != 0 || R < 1 || L < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kDB * R + kT * R + 2 * kT * kN + 3 * kT * kDB);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(D / kDB, 4, B);
  ss2d_scan_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      layouts, dts_raw, Bs, Cs, dt_w, dt_b, A, Ds, y, L, D, R, dt_rs, b_rs, c_rs);
  return (int)cudaGetLastError();
}
