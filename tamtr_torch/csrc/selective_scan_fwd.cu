// One-direction S6 selective scan, forward, dt given, as a segment-parallel
// scan: sequence I/O in fp32 or bf16, maths and state fp32.
//
// Replaces the TPU kernel `tamtr_tpu/kernels/selective_scan.py:_scan_kernel`
// (launched by `_run_scan`, reached through `selective_scan_pallas`). Same
// contract: for every group g, channel d and state lane n, from h = 0,
//     h_t = exp(delta_t A[g, d, n]) h_{t-1} + (delta_t u_t) B_t[n]
//     y_t = sum_n C_t[n] h_t[n] + D[g, d] u_t        (the D term if D given)
// with u, delta, y (G, L, Din), A (G, Din, N), B, C (G, L, N), D (G, Din)
// or null, all contiguous; u, delta, B, C and y one dtype, fp32 or bf16
// (widened as staged, y rounded once at its store; the wrapper upcasts a
// mix), A and D fp32; N is 4, 8, 16 or 32, any G, L, Din >= 1.
//
// The algebra of kernel B1 (`ss2d_scan_fwd.cu`), with delta read as given
// (no projection, no softplus): each group's walk is cut into
// S = ceil(L / kSeg) segments of kSeg = 48 steps (the last one ragged), and
// every (segment, g, 32 channels) is a 128-thread block of its own, grid
// (S, G, ceil(Din / 32)), segments on x so that any L fits: channel dl = 8 warp + lane / 4, and the channel's
// 4 threads hold N / 4 state lanes each. Three launches:
//   1. summaries: from h = 0, the segment's local end state h_loc
//      (G, S, Din, N) and sum delta (G, S, Din), so that the segment's decay
//      is exp(A sum delta);
//   2. combine: per (g, d, n), serial over the S segments, in place:
//      h_in[j+1] = exp(A sum delta_j) h_in[j] + h_loc[j] from h_in[0] = 0,
//      loads kAhead1d segments ahead of the chain; a block of the
//      sequence-parallel scan seeds h_in[0] and reads what leaves the block
//      (B1's `CombineEnds`);
//   3. output: each block rebuilds its segment's states from h_in[j], step
//      by step, and per step y_s = sum_n C_s[n] h_s[n] + D u_s: a thread sums
//      its lanes for four steps at a time, a reduce-scatter across the
//      channel's 4 threads (three shuffles per four steps, as B1's) leaves
//      each thread one step's sum, and y goes out through shared memory as
//      coalesced 32-channel rows.
// Staging by cp.async in rows along the steps (`ss2d_scan_seg.cuh`'s
// helpers and pitch); channels past Din and the steps that pad a ragged
// segment to whole sub-chunks are zeros (delta = 0: a no-op step), and
// neither is written out. exp as ex2.approx.ftz of delta (A log2 e). No
// atomics: bitwise the same from run to run.
//
// Bound on the card (`chip_smoke.py:check_selective_scan`): the function,
// inputs read once and y written once, at level 0 (G = 4, L = 25600,
// Din = 256, N = 16) moves ~0.33 GB: ~0.1 ms by bytes. The segment design
// reads u and delta twice (summaries and output), adds the (G, S, Din, N)
// states (written, rewritten by the combine, read by the output), and runs
// the state recurrence twice: one ex2 per (g, t, d, n) in each pass, at 16
// a clock per SM. The first design ran one serial L-step chain per
// (g, d, n) thread, 128 blocks at level 0; segments make 17088 there.

#include "ss2d_scan_seg.cuh"

namespace {

constexpr int kAhead1d = 16;  // segments the combine loads ahead of its chain

template <int kL>
__device__ __forceinline__ void load_lanes(const float* p, float* h) {
  if constexpr (kL % 4 == 0) {
#pragma unroll
    for (int m = 0; m < kL; m += 4) {
      const float4 v = ld4(p + m);
      h[m] = v.x, h[m + 1] = v.y, h[m + 2] = v.z, h[m + 3] = v.w;
    }
  } else if constexpr (kL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    h[0] = v.x, h[1] = v.y;
  } else {
    h[0] = p[0];
  }
}

template <int kL>
__device__ __forceinline__ void store_lanes(float* p, const float* h) {
  if constexpr (kL % 4 == 0) {
#pragma unroll
    for (int m = 0; m < kL; m += 4)
      *reinterpret_cast<float4*>(p + m) = make_float4(h[m], h[m + 1], h[m + 2], h[m + 3]);
  } else if constexpr (kL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(h[0], h[1]);
  } else {
    p[0] = h[0];
  }
}

// A block's place: group g, channels d0 .. d0 + 31, segment steps [s0, s0 + T);
// this thread's channel d = d0 + dl and state lanes n0 .. n0 + N/4 - 1.
struct Block1d {
  int g, d0, seg, S, s0, T, lane, warp, dl, j, d;
  bool live;  // d < Din
};

__device__ Block1d block_1d(int L, int Din) {
  Block1d k;
  k.seg = blockIdx.x;
  k.S = gridDim.x;
  k.g = blockIdx.y;
  k.d0 = blockIdx.z * kDB;
  k.s0 = k.seg * kSeg;
  k.T = min(kSeg, L - k.s0);
  k.lane = threadIdx.x % 32;
  k.warp = threadIdx.x / 32;
  k.dl = k.warp * kCPW + k.lane / kTPC;
  k.j = k.lane % kTPC;
  k.d = k.d0 + k.dl;
  k.live = k.d < Din;
  return k;
}

// Stage the segment's u and delta rows ([channel][step], one step a warp)
// and B (and C with kC) rows ([n][step], 32 / N steps a warp), fp32 in
// shared memory: float by cp.async, bf16 (E) widened as it is read (B1's
// `stage1`). Channels past Din and steps [T, Tpad) are zeros. Ends
// synchronised.
template <int N, bool kC, typename E>
__device__ void stage_1d(const Block1d& k, const E* u, const E* delta, const E* Bs, const E* Cs,
                         float* s_u, float* s_dt, float* s_B, float* s_C, int L, int Din) {
  const int lane = k.lane, warp = k.warp, T = k.T;
  const int Tpad = (T + kT - 1) / kT * kT;
  const bool col = k.d0 + lane < Din;
  const long long at0 = ((long long)k.g * L + k.s0) * Din + k.d0 + lane;
  for (int s = warp; s < T; s += kWarps) {
    if (col) {
      stage1(&s_u[lane * kP + s], u + at0 + (long long)s * Din);
      stage1(&s_dt[lane * kP + s], delta + at0 + (long long)s * Din);
    } else {
      s_u[lane * kP + s] = 0.f;
      s_dt[lane * kP + s] = 0.f;
    }
  }
  constexpr int kSPW = 32 / N;  // steps of B (C) a warp copies at once
  const int nl = lane % N;
  const long long bt0 = ((long long)k.g * L + k.s0) * N + nl;
  for (int s = kSPW * warp + lane / N; s < T; s += kSPW * kWarps) {
    stage1(&s_B[nl * kP + s], Bs + bt0 + (long long)s * N);
    if (kC) stage1(&s_C[nl * kP + s], Cs + bt0 + (long long)s * N);
  }
  cp_async_commit();
  for (int s = T + warp; s < Tpad; s += kWarps) {
    s_u[lane * kP + s] = 0.f;
    s_dt[lane * kP + s] = 0.f;
    if (lane < N) {
      s_B[lane * kP + s] = 0.f;
      if (kC) s_C[lane * kP + s] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// This thread's A lanes times log2 e (zeros past Din).
template <int kL>
__device__ void a_log2(const float* A, const Block1d& k, int Din, int N, float* a2) {
#pragma unroll
  for (int m = 0; m < kL; ++m)
    a2[m] = k.live ? A[((long long)k.g * Din + k.d) * N + kL * k.j + m] * kLog2e : 0.f;
}

template <int N, typename E>
__global__ void __launch_bounds__(kThreads, N > 16 ? 3 : 6) scan1d_summaries_kernel(
    const E* __restrict__ u, const E* __restrict__ delta, const float* __restrict__ A,
    const E* __restrict__ Bs, float* __restrict__ hloc, float* __restrict__ sdt, int L,
    int Din) {
  constexpr int kL = N / kTPC;  // state lanes a thread
  __shared__ __align__(16) float s_u[kDB * kP];
  __shared__ __align__(16) float s_dt[kDB * kP];
  __shared__ __align__(16) float s_B[N * kP];
  const Block1d k = block_1d(L, Din);
  float a2[kL];
  a_log2<kL>(A, k, Din, N, a2);
  stage_1d<N, false, E>(k, u, delta, Bs, nullptr, s_u, s_dt, s_B, nullptr, L, Din);
  const float *dtp = s_dt + k.dl * kP, *up = s_u + k.dl * kP, *B0 = s_B + kL * k.j * kP;
  float h[kL], sum_dt = 0.f;
#pragma unroll
  for (int m = 0; m < kL; ++m) h[m] = 0.f;
#pragma unroll 2
  for (int s4 = 0; s4 < k.T; s4 += 4) {  // steps past T are zeros: no-ops
    const float4 dt4 = ld4(dtp + s4), u4 = ld4(up + s4);
    float4 Bq[kL];
#pragma unroll
    for (int m = 0; m < kL; ++m) Bq[m] = ld4(B0 + m * kP + s4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dt = at(dt4, i), dtu = dt * at(u4, i);
#pragma unroll
      for (int m = 0; m < kL; ++m) h[m] = fmaf(ex2(dt * a2[m]), h[m], dtu * at(Bq[m], i));
      sum_dt += dt;
    }
  }
  if (k.live) {
    const long long row = ((long long)k.g * k.S + k.seg) * Din + k.d;
    store_lanes<kL>(&hloc[row * N + kL * k.j], h);
    if (k.j == 0) sdt[row] = sum_dt;
  }
}

// The combine, serial over the S segments, in place: one thread per
// (g, d, n) turns hloc into h_in. `ends` as B1's (`ss2d_scan_seg.cuh`),
// each (G, Din, N): seed_h, leave_h, decay and store (no carry here).
template <int N>
__global__ void __launch_bounds__(kCombineThreads) scan1d_combine_kernel(
    const float* __restrict__ A, const float* __restrict__ sdt, float* __restrict__ hloc, int G,
    int Din, int S, CombineEnds ends) {
  const long long DN = (long long)Din * N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= G * DN) return;
  const long long g = idx / DN, rem = idx % DN;
  const float a2 = A[idx] * kLog2e;  // A (G, Din, N): idx = g DN + rem
  float* p = hloc + g * S * DN + rem;
  const float* sp = sdt + g * S * Din + rem / N;
  float v = ends.seed_h != nullptr ? ends.seed_h[idx] : 0.f;
  float sum_dt = 0.f;
  int c = 0;
  for (; c + kAhead1d <= S; c += kAhead1d) {
    float loc[kAhead1d], E[kAhead1d];
#pragma unroll
    for (int i = 0; i < kAhead1d; ++i) {
      loc[i] = p[(c + i) * DN];
      const float sdt_j = sp[(long long)(c + i) * Din];
      E[i] = ex2(a2 * sdt_j);
      sum_dt += sdt_j;
    }
#pragma unroll
    for (int i = 0; i < kAhead1d; ++i) {
      if (ends.store) p[(c + i) * DN] = v;
      v = fmaf(E[i], v, loc[i]);
    }
  }
  for (; c < S; ++c) {
    const float loc = p[c * DN], sdt_j = sp[(long long)c * Din], E = ex2(a2 * sdt_j);
    if (ends.store) p[c * DN] = v;
    v = fmaf(E, v, loc);
    sum_dt += sdt_j;
  }
  if (ends.leave_h != nullptr) ends.leave_h[idx] = v;
  if (ends.decay != nullptr) ends.decay[idx] = ex2(a2 * sum_dt);
}

template <int N, typename E, typename O>
__global__ void __launch_bounds__(kThreads, N > 16 ? 3 : 6) scan1d_output_kernel(
    const E* __restrict__ u, const E* __restrict__ delta, const float* __restrict__ A,
    const E* __restrict__ Bs, const E* __restrict__ Cs, const float* __restrict__ Dskip,
    const float* __restrict__ h_in, O* __restrict__ y, int L, int Din) {
  constexpr int kL = N / kTPC;
  __shared__ __align__(16) float s_u[kDB * kP];
  __shared__ __align__(16) float s_dt[kDB * kP];
  __shared__ __align__(16) float s_y[kDB * kP];
  __shared__ __align__(16) float s_B[N * kP];
  __shared__ __align__(16) float s_C[N * kP];
  const Block1d k = block_1d(L, Din);
  float a2[kL], h[kL];
  a_log2<kL>(A, k, Din, N, a2);
  const float d_skip = Dskip != nullptr && k.live ? Dskip[(long long)k.g * Din + k.d] : 0.f;
  const long long row = ((long long)k.g * k.S + k.seg) * Din + k.d;
  if (k.live) {
    load_lanes<kL>(&h_in[row * N + kL * k.j], h);
  } else {
#pragma unroll
    for (int m = 0; m < kL; ++m) h[m] = 0.f;
  }
  stage_1d<N, true, E>(k, u, delta, Bs, Cs, s_u, s_dt, s_B, s_C, L, Din);
  const float *dtp = s_dt + k.dl * kP, *up = s_u + k.dl * kP;
  const float *B0 = s_B + kL * k.j * kP, *C0 = s_C + kL * k.j * kP;
  float* yrow = s_y + k.dl * kP + k.j;  // thread j writes step s4 + j
  const bool hi2 = k.lane & 2, hi1 = k.lane & 1;
#pragma unroll 2
  for (int s4 = 0; s4 < k.T; s4 += 4) {  // steps past T are zeros: no-ops
    const float4 dt4 = ld4(dtp + s4), u4 = ld4(up + s4);
    float4 Bq[kL], Cq[kL];
#pragma unroll
    for (int m = 0; m < kL; ++m) Bq[m] = ld4(B0 + m * kP + s4), Cq[m] = ld4(C0 + m * kP + s4);
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dt = at(dt4, i), dtu = dt * at(u4, i);
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kL; ++m) {
        h[m] = fmaf(ex2(dt * a2[m]), h[m], dtu * at(Bq[m], i));
        acc = fmaf(at(Cq[m], i), h[m], acc);
      }
      p[i] = acc;
    }
    // over the channel's 4 threads: j = 2 hi2 + hi1 ends with step s4 + j
    const float x0 = (hi2 ? p[2] : p[0]) + __shfl_xor_sync(0xffffffffu, hi2 ? p[0] : p[2], 2);
    const float x1 = (hi2 ? p[3] : p[1]) + __shfl_xor_sync(0xffffffffu, hi2 ? p[1] : p[3], 2);
    const float v = (hi1 ? x1 : x0) + __shfl_xor_sync(0xffffffffu, hi1 ? x0 : x1, 1);
    yrow[s4] = fmaf(d_skip, up[s4 + k.j], v);
  }
  __syncthreads();
  // rows of 32 channels, one step per warp
  if (k.d0 + k.lane < Din) {
    O* yg = y + ((long long)k.g * L + k.s0) * Din + k.d0 + k.lane;
    for (int s = k.warp; s < k.T; s += kWarps) store_seq(yg + (long long)s * Din, s_y[k.lane * kP + s]);
  }
}

bool shapes_ok_1d(int G, int L, int Din) {
  return G >= 1 && L >= 1 && Din >= 1 && G <= 65535 && (Din + kDB - 1) / kDB <= 65535;
}

dim3 grid_1d(int G, int L, int Din) { return dim3(segments(L), G, (Din + kDB - 1) / kDB); }

template <int N, typename E>
cudaError_t summaries(const E* u, const E* delta, const float* A, const E* Bs,
                      float* hloc, float* sdt, int G, int L, int Din, cudaStream_t stream) {
  scan1d_summaries_kernel<N, E><<<grid_1d(G, L, Din), kThreads, 0, stream>>>(u, delta, A, Bs, hloc,
                                                                            sdt, L, Din);
  return cudaGetLastError();
}

template <int N>
cudaError_t combine(const float* A, const float* sdt, float* hloc, int G, int L, int Din,
                    CombineEnds ends, cudaStream_t stream) {
  const long long threads = (long long)G * Din * N;
  scan1d_combine_kernel<N><<<(unsigned)((threads + kCombineThreads - 1) / kCombineThreads),
                             kCombineThreads, 0, stream>>>(A, sdt, hloc, G, Din, segments(L), ends);
  return cudaGetLastError();
}

template <int N, typename E, typename O>
cudaError_t output(const E* u, const E* delta, const float* A, const E* Bs,
                   const E* Cs, const float* Dskip, const float* h_in, O* y, int G, int L,
                   int Din, cudaStream_t stream) {
  scan1d_output_kernel<N, E, O><<<grid_1d(G, L, Din), kThreads, 0, stream>>>(u, delta, A, Bs, Cs, Dskip,
                                                                         h_in, y, L, Din);
  return cudaGetLastError();
}

template <int N>
cudaError_t occupancy(int* out) {
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], scan1d_summaries_kernel<N, float>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], scan1d_combine_kernel<N>, kCombineThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], scan1d_output_kernel<N, float, float>, kThreads, 0);
  return err;
}

// The state size N picks the kernels' instance: 4, 8, 16 or 32.
#define SCAN1D_DISPATCH(N, fn, ...)                     \
  switch (N) {                                          \
    case 4: return (int)fn<4>(__VA_ARGS__);             \
    case 8: return (int)fn<8>(__VA_ARGS__);             \
    case 16: return (int)fn<16>(__VA_ARGS__);           \
    case 32: return (int)fn<32>(__VA_ARGS__);           \
    default: return (int)cudaErrorInvalidValue;         \
  }

}  // namespace

// hloc (G, S, Din, N) and sdt (G, S, Din), S = ceil(L / kSeg): per segment,
// the local end state from h = 0 and the sum of delta. u, delta and Bs are
// float (bf16 == 0) or bf16, as u, delta, Bs, Cs and y of the output.
extern "C" int selective_scan_fwd_summaries(const void* u, const void* delta, const float* A,
                                            const void* Bs, float* hloc, float* sdt, int G, int L,
                                            int Din, int N, int bf16, void* stream) {
  if (!shapes_ok_1d(G, L, Din)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  using H = __nv_bfloat16;
  if (bf16) {
    SCAN1D_DISPATCH(N, summaries, (const H*)u, (const H*)delta, A, (const H*)Bs, hloc, sdt, G, L, Din, s)
  }
  SCAN1D_DISPATCH(N, summaries, (const float*)u, (const float*)delta, A, (const float*)Bs, hloc, sdt, G, L, Din, s)
}

// In place (store != 0): hloc -> the state entering each segment, from
// seed (G, Din, N), the state entering the walk, or 0 when null. leave and
// decay (G, Din, N), when not null, get the state past the last segment and
// exp(A sum delta) over the walk.
extern "C" int selective_scan_fwd_combine(const float* A, const float* sdt, float* hloc,
                                          const float* seed, float* leave, float* decay, int G,
                                          int L, int Din, int N, int store, void* stream) {
  if (!shapes_ok_1d(G, L, Din)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const CombineEnds ends{seed, nullptr, leave, nullptr, decay, store != 0};
  SCAN1D_DISPATCH(N, combine, A, sdt, hloc, G, L, Din, ends, s)
}

// y (G, L, Din) from the state entering each segment, rounded once to the
// sequence dtype, or in float for bf16 sequences when y_f32 != 0 (the
// pieces of a state larger than 32 lanes, added in fp32 and rounded once);
// Dskip may be null.
extern "C" int selective_scan_fwd_output(const void* u, const void* delta, const float* A,
                                         const void* Bs, const void* Cs, const float* Dskip,
                                         const float* h_in, void* y, int G, int L, int Din, int N,
                                         int bf16, int y_f32, void* stream) {
  if (!shapes_ok_1d(G, L, Din)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  using H = __nv_bfloat16;
  if (bf16 && y_f32) {
    SCAN1D_DISPATCH(N, output, (const H*)u, (const H*)delta, A, (const H*)Bs, (const H*)Cs, Dskip, h_in, (float*)y,
                    G, L, Din, s)
  }
  if (bf16) {
    SCAN1D_DISPATCH(N, output, (const H*)u, (const H*)delta, A, (const H*)Bs, (const H*)Cs, Dskip, h_in, (H*)y, G,
                    L, Din, s)
  }
  SCAN1D_DISPATCH(N, output, (const float*)u, (const float*)delta, A, (const float*)Bs, (const float*)Cs, Dskip,
                  h_in, (float*)y, G, L, Din, s)
}

// Resident blocks per SM of (summaries, combine, output) at N, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int selective_scan_fwd_occupancy(int N, int* out) {
  SCAN1D_DISPATCH(N, occupancy, out)
}
