// Fused 4-direction SS2D selective scan, backward, fp32 (VMamba S6).
//
// Replaces the two TPU kernels of `tamtr_tpu/kernels/selective_scan.py`
// behind `_ss2d_bwd_pallas` / `_run_ss2d_bwd_fwddir`:
//   - `_carriers_kernel` (B3a): the state entering each chunk, recomputed
//     from the inputs -> `ss2d_scan_bwd_carriers` here;
//   - `_bwd_kernel` (B3b): the reverse-time walk carrying g = dL/dh ->
//     `ss2d_scan_bwd` here.
// Same forward as `ss2d_scan_fwd.cu`: for direction k (row-fwd, col-fwd,
// row-rev, col-rev), step s of the walk reads t = s (k < 2) or t = L-1-s
// (k >= 2), and per (d, n)
//     dt_s = softplus(dt_raw_s . dt_w[k, d] + dt_b[k, d]),  a_s = exp(dt_s A[k, d, n])
//     h_s  = a_s h_{s-1} + dt_s u_s B_s[n],                  y_s = sum_n C_s[n] h_s[n] + D u_s
// Given dy, in step order (g_L = 0, a_L = 0):
//     g_s      = a_{s+1} g_{s+1} + C_s[n] dy_s
//     dC_s[n]  = sum_d dy_s h_s              dB_s[n] = sum_d g_s dt_s u_s
//     ddA      = g_s h_{s-1} a_s              dA     += ddA dt_s
//     du_core  = (sum_n g_s B_s[n]) dt_s
//     dz       = (sum_n ddA A + (sum_n g_s B_s[n]) u_s) (1 - exp(-dt_s))
// (the formulas of the TPU kernel, `selective_scan.py:641-660`). The D-skip,
// dDs, and the dt_w / dt_b / dts_raw gradients (matrix products with dz) are
// put together by the caller with torch ops, as the JAX package keeps them
// outside Pallas. The reversed directions walk t backwards over the same
// (B, 2, L, D) layouts: no flipped copies. dts_raw, Bs and Cs are read in
// place as (B, 2, 2, L, *) views with a row stride.
//
// Design: one thread per (b, k, d, n) as in the forward; a block holds
// kDB = 32 channels of one (b, k), 512 threads. B3a walks the whole
// sequence forward once and stores h every kT = 16 steps
// (hcar (B, 4, ceil(L/kT), D, N)). B3b walks the chunks in reverse; per
// chunk it recomputes the kT states from the stored carrier into registers
// (fully unrolled, so h_{s-1} is at hand without any division), then steps
// backwards through them. Sums over n (du, dz) use four __shfl_xor_sync
// steps over the 16 n-lanes. Sums over d (dB, dC) go one shuffle across the
// two channels of a warp, then through shared memory across the 16 warps;
// each block writes its partial (B, 4, D/kDB, L, N) and the caller sums
// over D/kDB. No atomics: the result is bitwise the same from run to run.
//
// Bound on the card: by bytes. At 640 px level 0 (B=4, L=25600, D=256) the
// function reads ~0.7 GB (u, dy, dts_raw/B/C) and writes ~0.4 GB (du, dz,
// dB, dC); the carriers add a round trip of 0.42 GB. Like the forward this
// simple design runs B.4.D.N threads, each a serial chain over L, so it is
// latency bound far above that.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 16;                 // state size, one lane per n
constexpr int kDB = 32;                // channels per block
constexpr int kThreads = kDB * kN;     // 512
constexpr int kWarps = kThreads / 32;  // 16
constexpr int kT = 16;                 // steps per chunk = carrier spacing

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Per-block view of one (b, k) sequence.
struct Seq {
  const float* u;    // layouts[b, k % 2] + d0, row stride D
  const float* dtr;  // dts_raw[b, k / 2, k % 2], row stride dt_rs
  const float* Bm;   // Bs[b, k / 2, k % 2], row stride b_rs
  const float* Cm;   // Cs[b, k / 2, k % 2], row stride c_rs
  long long dt_rs, b_rs, c_rs;
  int L, D, R;
  bool rev;
  __device__ long long t_of(int s) const { return rev ? L - 1 - s : s; }
};

__device__ Seq make_seq(const float* layouts, const float* dts_raw, const float* Bs,
                        const float* Cs, int b, int k, int d0, int L, int D, int R,
                        long long dt_rs, long long b_rs, long long c_rs) {
  const int f = k / 2, j = k % 2;
  const long long seq = (((long long)b * 2 + f) * 2 + j) * L;
  Seq q;
  q.u = layouts + ((long long)b * 2 + j) * L * D + d0;
  q.dtr = dts_raw + seq * dt_rs;
  q.Bm = Bs + seq * b_rs;
  q.Cm = Cs ? Cs + seq * c_rs : nullptr;
  q.dt_rs = dt_rs;
  q.b_rs = b_rs;
  q.c_rs = c_rs;
  q.L = L;
  q.D = D;
  q.R = R;
  q.rev = f == 1;
  return q;
}

// Stage steps [s0, s0 + T) (step order) of dt_raw, B, (C) and u into shared
// memory, then compute dt there. Ends synchronised.
__device__ void stage_chunk(const Seq& q, int s0, int T, const float* s_dtw, const float* dt_b_k,
                            float* s_dtr, float* s_B, float* s_C, float* s_u, float* s_dt) {
  const int tid = threadIdx.x;
  const int R = q.R;
  for (int i = tid; i < T * R; i += kThreads)
    s_dtr[i] = q.dtr[q.t_of(s0 + i / R) * q.dt_rs + i % R];
  for (int i = tid; i < T * kN; i += kThreads) {
    const long long t = q.t_of(s0 + i / kN);
    s_B[i] = q.Bm[t * q.b_rs + i % kN];
    if (s_C) s_C[i] = q.Cm[t * q.c_rs + i % kN];
  }
  for (int i = tid; i < T * kDB; i += kThreads)
    s_u[i] = q.u[q.t_of(s0 + i / kDB) * q.D + i % kDB];
  __syncthreads();
  for (int i = tid; i < T * kDB; i += kThreads) {
    const int s = i / kDB, dd = i % kDB;
    float z = 0.f;
    for (int r = 0; r < R; ++r) z += s_dtr[s * R + r] * s_dtw[dd * R + r];
    s_dt[i] = softplus(z + dt_b_k[dd]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) ss2d_carriers_kernel(
    const float* __restrict__ layouts, const float* __restrict__ dts_raw,
    const float* __restrict__ Bs, const float* __restrict__ dt_w,
    const float* __restrict__ dt_b, const float* __restrict__ A,
    float* __restrict__ hcar, int L, int D, int R, long long dt_rs, long long b_rs) {
  extern __shared__ float smem[];
  float* s_dtw = smem;             // [kDB][R]
  float* s_dtr = s_dtw + kDB * R;  // [kT][R]
  float* s_B = s_dtr + kT * R;     // [kT][kN]
  float* s_u = s_B + kT * kN;      // [kT][kDB]
  float* s_dt = s_u + kT * kDB;    // [kT][kDB]

  const int d0 = blockIdx.x * kDB, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, n = tid % kN, dl = tid / kN;
  const Seq q = make_seq(layouts, dts_raw, Bs, nullptr, b, k, d0, L, D, R, dt_rs, b_rs, 0);
  const int nC = (L + kT - 1) / kT;
  for (int i = tid; i < kDB * R; i += kThreads) s_dtw[i] = dt_w[((long long)k * D + d0) * R + i];
  const float a_dn = A[((long long)k * D + d0 + dl) * kN + n];
  float* out = hcar + ((long long)b * 4 + k) * nC * D * kN + (long long)(d0 + dl) * kN + n;
  float h = 0.f;
  for (int c = 0; c < nC; ++c) {
    out[(long long)c * D * kN] = h;  // the state entering chunk c
    const int s0 = c * kT, T = min(kT, L - s0);
    __syncthreads();  // the previous chunk is consumed
    stage_chunk(q, s0, T, s_dtw, dt_b + (long long)k * D + d0, s_dtr, s_B, nullptr, s_u, s_dt);
    for (int i = 0; i < T; ++i) {
      const float dt = s_dt[i * kDB + dl];
      h = expf(dt * a_dn) * h + dt * s_u[i * kDB + dl] * s_B[i * kN + n];
    }
  }
}

__global__ void __launch_bounds__(kThreads) ss2d_bwd_kernel(
    const float* __restrict__ layouts, const float* __restrict__ dts_raw,
    const float* __restrict__ Bs, const float* __restrict__ Cs,
    const float* __restrict__ dt_w, const float* __restrict__ dt_b,
    const float* __restrict__ A, const float* __restrict__ dy,
    const float* __restrict__ hcar, float* __restrict__ du, float* __restrict__ dz,
    float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ dA_out,
    int L, int D, int R, long long dt_rs, long long b_rs, long long c_rs) {
  extern __shared__ float smem[];
  float* s_dtw = smem;               // [kDB][R]
  float* s_dtr = s_dtw + kDB * R;    // [kT][R]
  float* s_B = s_dtr + kT * R;       // [kT][kN]
  float* s_C = s_B + kT * kN;        // [kT][kN]
  float* s_u = s_C + kT * kN;        // [kT][kDB]
  float* s_dt = s_u + kT * kDB;      // [kT][kDB]
  float* s_dy = s_dt + kT * kDB;     // [kT][kDB]
  float* s_du = s_dy + kT * kDB;     // [kT][kDB]
  float* s_dz = s_du + kT * kDB;     // [kT][kDB]
  float* s_rB = s_dz + kT * kDB;     // [kT][kWarps][kN]
  float* s_rC = s_rB + kT * kWarps * kN;

  const int d0 = blockIdx.x * kDB, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, n = tid % kN, dl = tid / kN;
  const int lane = tid % 32, warp = tid / 32;
  const int nDb = gridDim.x;
  const Seq q = make_seq(layouts, dts_raw, Bs, Cs, b, k, d0, L, D, R, dt_rs, b_rs, c_rs);
  const int nC = (L + kT - 1) / kT;
  const long long bk = (long long)b * 4 + k;
  const float* dy_bk = dy + bk * L * D + d0;
  float* du_bk = du + bk * L * D + d0;
  float* dz_bk = dz + bk * L * D + d0;
  float* dB_bk = dBp + (bk * nDb + blockIdx.x) * L * kN;
  float* dC_bk = dCp + (bk * nDb + blockIdx.x) * L * kN;
  const float* hin_bk = hcar + bk * nC * D * kN + (long long)(d0 + dl) * kN + n;

  for (int i = tid; i < kDB * R; i += kThreads) s_dtw[i] = dt_w[((long long)k * D + d0) * R + i];
  const float a_dn = A[((long long)k * D + d0 + dl) * kN + n];
  float g = 0.f, a_next = 0.f, dA = 0.f;

  for (int c = nC - 1; c >= 0; --c) {
    const int s0 = c * kT, T = min(kT, L - s0);
    __syncthreads();  // the previous chunk's results are written out
    for (int i = tid; i < T * kDB; i += kThreads)
      s_dy[i] = dy_bk[q.t_of(s0 + i / kDB) * D + i % kDB];
    stage_chunk(q, s0, T, s_dtw, dt_b + (long long)k * D + d0, s_dtr, s_B, s_C, s_u, s_dt);

    // recompute the chunk's states from the carrier, into registers
    const float h_in = hin_bk[(long long)c * D * kN];
    float hs[kT], as[kT];
    float h = h_in;
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      if (i < T) {
        const float dt = s_dt[i * kDB + dl];
        const float a = expf(dt * a_dn);
        h = a * h + dt * s_u[i * kDB + dl] * s_B[i * kN + n];
        as[i] = a;
        hs[i] = h;
      }
    }
    // walk the chunk backwards
#pragma unroll
    for (int i = kT - 1; i >= 0; --i) {
      if (i < T) {
        const float dt = s_dt[i * kDB + dl];
        const float u = s_u[i * kDB + dl];
        const float dyv = s_dy[i * kDB + dl];
        const float Bn = s_B[i * kN + n];
        g = a_next * g + s_C[i * kN + n] * dyv;
        const float h_prev = i > 0 ? hs[i > 0 ? i - 1 : 0] : h_in;
        const float ddA = g * h_prev * as[i];
        dA += ddA * dt;
        float gB = g * Bn;
        float dAA = ddA * a_dn;
#pragma unroll
        for (int off = 8; off >= 1; off /= 2) {
          gB += __shfl_xor_sync(0xffffffffu, gB, off);
          dAA += __shfl_xor_sync(0xffffffffu, dAA, off);
        }
        float pC = dyv * hs[i];
        float pB = g * dt * u;
        pC += __shfl_xor_sync(0xffffffffu, pC, 16);
        pB += __shfl_xor_sync(0xffffffffu, pB, 16);
        if (lane < kN) {
          s_rB[(i * kWarps + warp) * kN + n] = pB;
          s_rC[(i * kWarps + warp) * kN + n] = pC;
        }
        if (n == 0) {
          s_du[i * kDB + dl] = gB * dt;
          s_dz[i * kDB + dl] = (dAA + gB * u) * (1.f - expf(-dt));
        }
        a_next = as[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < T * kDB; i += kThreads) {
      const long long o = q.t_of(s0 + i / kDB) * D + i % kDB;
      du_bk[o] = s_du[i];
      dz_bk[o] = s_dz[i];
    }
    for (int i = tid; i < T * kN; i += kThreads) {
      const int s = i / kN, nn = i % kN;
      float sb = 0.f, sc = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sb += s_rB[(s * kWarps + w) * kN + nn];
        sc += s_rC[(s * kWarps + w) * kN + nn];
      }
      const long long o = q.t_of(s0 + s) * kN + nn;
      dB_bk[o] = sb;
      dC_bk[o] = sc;
    }
  }
  dA_out[(bk * D + d0 + dl) * kN + n] = dA;
}

size_t carriers_smem(int R) { return sizeof(float) * (kDB * R + kT * R + kT * kN + 2 * kT * kDB); }

size_t bwd_smem(int R) {
  return sizeof(float) * (kDB * R + kT * R + 2 * kT * kN + 5 * kT * kDB + 2 * kT * kWarps * kN);
}

bool shapes_ok(int B, int L, int D, int R, int N) {
  return N == kN && D % kDB == 0 && R >= 1 && R <= 64 && L >= 1 && B >= 1;
}

}  // namespace

// hcar (B, 4, ceil(L/16), D, 16): the state entering every 16-step chunk of
// each direction's walk.
extern "C" int ss2d_scan_bwd_carriers(
    const float* layouts, const float* dts_raw, const float* Bs, const float* dt_w,
    const float* dt_b, const float* A, float* hcar, int B, int L, int D, int R, int N,
    long long dt_rs, long long b_rs, void* stream) {
  if (!shapes_ok(B, L, D, R, N)) return (int)cudaErrorInvalidValue;
  const size_t smem = carriers_smem(R);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(D / kDB, 4, B);
  ss2d_carriers_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      layouts, dts_raw, Bs, dt_w, dt_b, A, hcar, L, D, R, dt_rs, b_rs);
  return (int)cudaGetLastError();
}

// du, dz (B, 4, L, D) natural order; dBp, dCp (B, 4, D/32, L, 16) partial
// sums over each block's 32 channels; dA (B, 4, D, 16).
extern "C" int ss2d_scan_bwd(
    const float* layouts, const float* dts_raw, const float* Bs, const float* Cs,
    const float* dt_w, const float* dt_b, const float* A, const float* dy, const float* hcar,
    float* du, float* dz, float* dBp, float* dCp, float* dA, int B, int L, int D, int R, int N,
    long long dt_rs, long long b_rs, long long c_rs, void* stream) {
  if (!shapes_ok(B, L, D, R, N)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(R);
  cudaError_t err = cudaFuncSetAttribute(ss2d_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(D / kDB, 4, B);
  ss2d_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      layouts, dts_raw, Bs, Cs, dt_w, dt_b, A, dy, hcar, du, dz, dBp, dCp, dA, L, D, R, dt_rs,
      b_rs, c_rs);
  return (int)cudaGetLastError();
}
