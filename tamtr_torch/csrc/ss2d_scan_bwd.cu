// Fused 4-direction SS2D selective scan, backward (VMamba S6), as a
// segment-parallel scan: sequence I/O in fp32 or bf16, maths and state fp32.
//
// Dtypes (`tamtr_tpu/kernels/selective_scan.py:732, 814-817, 882-896`):
// layouts, dts_raw, Bs, Cs and dy are read in their dtype, fp32 or bf16
// (`ss2d_scan_seg.cuh` widens them as it stages), du is written in it,
// rounded once; dz, the dB / dC partials and dA stay fp32, and the caller
// rounds dBs, dCs and d_dts once after its sums.
//
// Replaces the two TPU kernels of `tamtr_tpu/kernels/selective_scan.py`
// behind `_ss2d_bwd_pallas` / `_run_ss2d_bwd_fwddir`:
//   - `_carriers_kernel` (B3a): the state entering each chunk ->
//     `ss2d_summaries_kernel` (per-segment summaries) and
//     `ss2d_combine_kernel` (the pass across segments) here;
//   - `_bwd_kernel` (B3b): the reverse-time walk carrying g = dL/dh ->
//     `ss2d_walk_kernel` here.
// Same forward as `ss2d_scan_fwd.cu`: for direction k (row-fwd, col-fwd,
// row-rev, col-rev), step s of the walk reads t = s (k < 2) or t = L-1-s
// (k >= 2), and per (d, n)
//     dt_s = softplus(dt_raw_s . dt_w[k, d] + dt_b[k, d]),  a_s = exp(dt_s A[k, d, n])
//     h_s  = a_s h_{s-1} + dt_s u_s B_s[n],                  y_s = sum_n C_s[n] h_s[n] + D u_s
// Given dy, in step order (g_L = 0, a_L = 0), with q_s = C_s[n] dy_s:
//     g_s      = a_{s+1} g_{s+1} + q_s
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
// Segments. The TPU walks the chunks in order along a sequential grid axis.
// Here each direction's walk is cut into S = ceil(L / kSeg) segments of
// kSeg = 48 steps (the last one ragged), and every (channel block, b, k, segment) is
// a block of its own: grid (D/32, 4B, S). The staging, the summaries and
// the combine are `ss2d_scan_seg.cuh`'s, shared with the forward (which
// runs them without r and the carry). Three launches:
//   1. summaries (B3a): from h = 0, the segment's local end state h_loc; and
//      r = sum_s (prod_{i=first..s} a_i) q_s, i.e. a_first times the local g
//      at the segment's first step with g = 0 past its end; and sum dt. The
//      segment's decay is E = prod a_s = exp(A sum dt), kept per channel.
//   2. combine (its own launch, the tail of B3a): per (b, k, d, n), serial
//      over the S segments, in place: h_in[j+1] = E_j h_in[j] + h_loc[j]
//      from h_in[0] = 0, and the carry c[j-1] = E_j c[j] + r[j] from
//      c[S-1] = 0. c[j] = a_{e+1} g_{e+1} is what enters segment j's last
//      step e: the a of the next segment's first step is already inside
//      r[j+1], so the off-by-one of g_s = a_{s+1} g_{s+1} + q_s stays inside
//      the summaries.
//   3. walk (B3b): from h_in[j] the block rebuilds the states entering its
//      8-step sub-chunks into shared memory, then walks the sub-chunks
//      backwards from g = c[j] (a_next = 1), each sub-chunk's 8 states
//      recomputed into registers (a_s is recomputed once more in the
//      backward step rather than held: the registers then allow four
//      blocks per SM), and emits du, dz, its dB/dC partials over
//      its 32 channels (B, 4, D/32, L, 16) and a per-segment dA partial
//      (B, 4, S, D, 16); the caller sums both in a fixed order. No atomics:
//      the result is bitwise the same from run to run.
// Threads: 32 channels per block, 4 threads per channel, each holding four
// state lanes n = 4j .. 4j + 3 (128 threads): per-channel work (loads of
// dt, u, dy, their products) is shared by four lanes, and the sums over n
// go three adds in the thread and two shuffles. A block stages its whole
// segment of dt_raw, B, C, u and dy with cp.async in two groups (the walk
// starts its forward rebuild while C and dy still land), in rows along the
// steps: a thread reads four steps with one 16-byte load. Ragged segments
// are padded with zeros, which make the padded steps no-ops, so no step is
// guarded.
// Sums over n reduce-scatter gB and ddA A across the channel's 4 threads;
// dB and dC reduce-scatter across the warp's 8 channels, then go through
// shared memory across the 4 warps, double-buffered per sub-chunk. exp is
// ex2.approx.ftz of dt (A log2 e); softplus keeps precise expf / log1pf.
//
// Bound on the card (`chip_smoke.py:check_ss2d_scan_bwd`): the function,
// inputs read once and the eight gradients' parts written once, at 640 px
// level 0 (B=4, L=25600, D=256) moves ~1.6 GB and does ~30 fp32 operations
// (two exps among them) per (b, k, l, d, n), 1.68 G of them: 0.77 ms, by
// operations.
// The segment design adds its own traffic, the (B, 4, S, D, 16) summaries
// written by the summaries, read and rewritten by the combine, read by the
// walk: counted with it, the summaries launch alone needs 0.29 ms and the
// walk 0.56 ms at level 0, both by bytes. What bounds the kernels instead is
// the instruction issue: per state lane and step the walk issues ~40
// instructions (the two forward passes, the backward step, ~9 for the
// shuffle reductions), the summaries ~12, at 16 resident warps per SM. The
// first design ran one serial L-step chain per thread on 128-512 blocks;
// with segments of 48 steps level 0 runs 68352 blocks.

#include "ss2d_scan_seg.cuh"

namespace {

constexpr size_t kCarFloats = (size_t)(kSeg / kT) * kThreads * kNP;

__host__ __device__ size_t walk_floats(int R) {
  const size_t scratch = kCarFloats > (size_t)kSeg * R ? kCarFloats : (size_t)kSeg * R;
  return head_floats<true>(R) + scratch + 2 * kT * kWarps * 32 + 2 * kT * kDB * 2;
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 4) ss2d_walk_kernel(
    const E* __restrict__ layouts, const E* __restrict__ dts_raw,
    const E* __restrict__ Bs, const E* __restrict__ Cs, const float* __restrict__ dt_w,
    const float* __restrict__ dt_b, const float* __restrict__ A, const E* __restrict__ dy,
    const float* __restrict__ h_in, const float* __restrict__ carry, E* __restrict__ du,
    float* __restrict__ dz, float* __restrict__ dBp, float* __restrict__ dCp,
    float* __restrict__ dAp, int L, int D, int R, long long dt_rs, long long b_rs,
    long long c_rs) {
  extern __shared__ __align__(16) float smem[];
  const SegSmem m = carve_seg<true>(smem, R);
  float* s_car = m.scratch;  // [kSeg/kT][kThreads][kNP], after dt_raw is consumed
  float* s_red = smem + walk_floats(R) - 2 * kT * kWarps * 32 - 2 * kT * kDB * 2;  // [2][kT][kWarps][32]
  float* s_gd = s_red + 2 * kT * kWarps * 32;  // [2][kT][kDB][2]: sum_n gB, sum_n ddA A

  const int d0 = blockIdx.x * kDB, bk = blockIdx.y, b = bk / 4, k = bk % 4;
  const Lanes th = lanes_of_thread();
  const int tid = threadIdx.x, S = gridDim.z;
  const Seq<E> q = make_seq(layouts, dts_raw, Bs, Cs, dy, b, k, d0, L, D, R, dt_rs, b_rs, c_rs);
  const float4 A4 = ld4(&A[((long long)k * D + d0 + th.dl) * kN + th.n0]);
  float a_dn[kNP], a2[kNP];
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) a_dn[mm] = at(A4, mm), a2[mm] = at(A4, mm) * kLog2e;
  const long long o = (((long long)bk * S + blockIdx.z) * D + d0 + th.dl) * kN + th.n0;
  const float4 hin4 = ld4(&h_in[o]), c4 = ld4(&carry[o]);
  stage_segment<true, true>(q, k, d0, dt_w, dt_b, m);
  const float *dtp = m.dt + th.dl * kP, *up = m.u + th.dl * kP, *dyp = m.dy + th.dl * kP;
  const float *B0 = m.B + th.n0 * kP, *C0 = m.C + th.n0 * kP;

  // the state entering each sub-chunk (each thread reads back only its own);
  // the last sub-chunk's steps are not needed for that
  float h[kNP];
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) h[mm] = at(hin4, mm);
  float4* car = reinterpret_cast<float4*>(s_car) + tid;
  const int last = (q.T - 1) / kT * kT;
#pragma unroll 2
  for (int s4 = 0; s4 < last; s4 += 4) {
    if (s4 % kT == 0) car[(s4 / kT) * kThreads] = make_float4(h[0], h[1], h[2], h[3]);
    const float4 dt4 = ld4(dtp + s4), u4 = ld4(up + s4);
    float4 Bq[kNP];
#pragma unroll
    for (int mm = 0; mm < kNP; ++mm) Bq[mm] = ld4(B0 + mm * kP + s4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dt = at(dt4, i), dtu = dt * at(u4, i);
#pragma unroll
      for (int mm = 0; mm < kNP; ++mm) h[mm] = fmaf(ex2(dt * a2[mm]), h[mm], dtu * at(Bq[mm], i));
    }
  }
  car[(last / kT) * kThreads] = make_float4(h[0], h[1], h[2], h[3]);
  cp_async_wait<0>();
  __syncthreads();  // C and dy have landed

  // outputs: thread (i, c) writes step base + i of the sub-chunk, channel
  // c of du and dz, and value c of dB / dC (dB for c < 16)
  const int nDb = gridDim.x, c = tid % kDB, nn = 4 * (c % kTPC) + (c / kTPC) % 4;
  const long long t_first = q.t_of(q.s0), dir = q.rev ? -1 : 1;
  E* du_c = du + (long long)bk * L * D + d0 + c + t_first * D;
  float* dz_c = dz + (long long)bk * L * D + d0 + c + t_first * D;
  float* dBC_c = (c < kN ? dBp : dCp) + ((long long)bk * nDb + blockIdx.x) * L * kN + nn + t_first * kN;
  const bool hi2 = th.lane & 2, hi4 = th.lane & 4, hi8 = th.lane & 8, hi16 = th.lane & 16;
  float* red_t = s_red + th.warp * 32 + th.lane;  // + parity + step * kWarps * 32
  float* gd_t = s_gd + th.dl * 2 + th.j / 2;      // + parity + step * kDB * 2, written by j = 0, 2
  float g[kNP], a_next[kNP], dA[kNP];
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) g[mm] = at(c4, mm), a_next[mm] = 1.f, dA[mm] = 0.f;
  for (int sub = (q.T - 1) / kT; sub >= 0; --sub) {
    const int base = sub * kT, Tsub = min(kT, q.T - base);
    float* red = red_t + (sub & 1) * kT * kWarps * 32;
    float* gd = gd_t + (sub & 1) * kT * kDB * 2;
    const float4 h04 = car[sub * kThreads];
    float h0[kNP], hs[kT][kNP];
#pragma unroll
    for (int mm = 0; mm < kNP; ++mm) h0[mm] = h[mm] = at(h04, mm);
#pragma unroll
    for (int i4 = 0; i4 < kT; i4 += 4) {
      const float4 dt4 = ld4(dtp + base + i4), u4 = ld4(up + base + i4);
      float4 Bq[kNP];
#pragma unroll
      for (int mm = 0; mm < kNP; ++mm) Bq[mm] = ld4(B0 + mm * kP + base + i4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dt = at(dt4, i), dtu = dt * at(u4, i);
#pragma unroll
        for (int mm = 0; mm < kNP; ++mm) {
          h[mm] = fmaf(ex2(dt * a2[mm]), h[mm], dtu * at(Bq[mm], i));
          hs[i4 + i][mm] = h[mm];
        }
      }
    }
#pragma unroll
    for (int i4 = kT - 4; i4 >= 0; i4 -= 4) {
      const float4 dt4 = ld4(dtp + base + i4), u4 = ld4(up + base + i4), dy4 = ld4(dyp + base + i4);
      float4 Bq[kNP], Cq[kNP];
#pragma unroll
      for (int mm = 0; mm < kNP; ++mm)
        Bq[mm] = ld4(B0 + mm * kP + base + i4), Cq[mm] = ld4(C0 + mm * kP + base + i4);
#pragma unroll
      for (int i = 3; i >= 0; --i) {  // padded steps (g = 0, q = 0) add nothing
        const int ii = i4 + i;
        const float dt = at(dt4, i), dyv = at(dy4, i), dtu = dt * at(u4, i);
        float gB = 0.f, dAA = 0.f, pB[kNP], pC[kNP];
#pragma unroll
        for (int mm = 0; mm < kNP; ++mm) {
          g[mm] = fmaf(a_next[mm], g[mm], at(Cq[mm], i) * dyv);
          const float a = ex2(dt * a2[mm]);  // recomputed: bitwise the forward's a
          const float h_prev = ii > 0 ? hs[ii > 0 ? ii - 1 : 0][mm] : h0[mm];
          const float ddA = g[mm] * h_prev * a;
          dA[mm] = fmaf(ddA, dt, dA[mm]);
          gB = fmaf(g[mm], at(Bq[mm], i), gB);
          dAA = fmaf(ddA, a_dn[mm], dAA);
          pB[mm] = g[mm] * dtu;
          pC[mm] = dyv * hs[ii][mm];
          a_next[mm] = a;
        }
        // over the channel's 4 threads: j < 2 end with sum_n gB, j >= 2
        // with sum_n ddA A
        float v = (hi2 ? dAA : gB) + __shfl_xor_sync(0xffffffffu, hi2 ? gB : dAA, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if ((th.j & 1) == 0) gd[ii * kDB * 2] = v;
        // over the warp's 8 channels: lane (b4, b3, b2, j) ends with dB
        // (b4 = 0) or dC (b4 = 1) of n = 4j + 2 b3 + b2
        float x[4], y[2];
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
          x[mm] = (hi16 ? pC[mm] : pB[mm]) + __shfl_xor_sync(0xffffffffu, hi16 ? pB[mm] : pC[mm], 16);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          y[mm] = (hi8 ? x[mm + 2] : x[mm]) + __shfl_xor_sync(0xffffffffu, hi8 ? x[mm] : x[mm + 2], 8);
        red[ii * kWarps * 32] = (hi4 ? y[1] : y[0]) + __shfl_xor_sync(0xffffffffu, hi4 ? y[0] : y[1], 4);
      }
    }
    __syncthreads();
    red -= th.warp * 32 + th.lane;
    gd -= th.dl * 2 + th.j / 2;
#pragma unroll
    for (int it = 0; it < kT * kDB / kThreads; ++it) {
      const int i = it * (kThreads / kDB) + tid / kDB, s = base + i;
      if (i < Tsub) {
        const long long ds = dir * s;
        const float dt = m.dt[c * kP + s], gB = gd[(i * kDB + c) * 2];
        store_seq(du_c + ds * D, gB * dt);
        dz_c[ds * D] = (gd[(i * kDB + c) * 2 + 1] + gB * m.u[c * kP + s]) * (1.f - expf(-dt));
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[(i * kWarps + w) * 32 + c];
        dBC_c[ds * kN] = sum;
      }
    }
  }
  *reinterpret_cast<float4*>(&dAp[o]) = make_float4(dA[0], dA[1], dA[2], dA[3]);
}

static_assert(kT * kDB % kThreads == 0, "the walk writes a sub-chunk in whole rounds of the block");

}  // namespace

// hloc, rsum (B, 4, S, D, 16) and sdt (B, 4, S, D), S = ceil(L / kSeg): per
// segment, the local end state from h = 0, r, and the sum of dt.
extern "C" int ss2d_scan_bwd_summaries(
    const void* layouts, const void* dts_raw, const void* Bs, const void* Cs,
    const float* dt_w, const float* dt_b, const float* A, const void* dy, float* hloc,
    float* rsum, float* sdt, int B, int L, int D, int R, int N, int bf16, long long dt_rs,
    long long b_rs, long long c_rs, void* stream) {
  if (!shapes_ok(B, L, D, R, N)) return (int)cudaErrorInvalidValue;
  return (int)launch_summaries_of<true>(bf16, layouts, dts_raw, Bs, Cs, dt_w, dt_b, A, dy, hloc, rsum, sdt,
                                        B, L, D, R, dt_rs, b_rs, c_rs, (cudaStream_t)stream);
}

// In place (store != 0): hloc -> the state entering each segment, from
// seed_h, and rsum -> the carry c entering each segment's last step, from
// seed_c at the walk's last segment (each (B, 4, D, 16), 0 when null).
// leave_c and decay (B, 4, D, 16), when not null, get the carry leaving the
// first segment and exp(A sum dt) over the walk.
extern "C" int ss2d_scan_bwd_combine(const float* A, const float* sdt, float* hloc, float* rsum,
                                     const float* seed_h, const float* seed_c, float* leave_c,
                                     float* decay, int B, int L, int D, int N, int store,
                                     void* stream) {
  if (!shapes_ok(B, L, D, 1, N)) return (int)cudaErrorInvalidValue;
  const CombineEnds ends{seed_h, seed_c, nullptr, leave_c, decay, store != 0};
  return (int)launch_combine<true>(A, sdt, hloc, rsum, B, L, D, ends, (cudaStream_t)stream);
}

// du, dz (B, 4, L, D) natural order; dBp, dCp (B, 4, D/32, L, 16) partial
// sums over each block's 32 channels; dAp (B, 4, S, D, 16) per segment.
namespace {

template <typename E>
cudaError_t launch_walk(const E* layouts, const E* dts_raw, const E* Bs, const E* Cs, const float* dt_w,
                        const float* dt_b, const float* A, const E* dy, const float* h_in,
                        const float* carry, E* du, float* dz, float* dBp, float* dCp, float* dAp, int B,
                        int L, int D, int R, long long dt_rs, long long b_rs, long long c_rs,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * walk_floats(R);
  cudaError_t err = cudaFuncSetAttribute(ss2d_walk_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(D / kDB, 4 * B, segments(L));
  ss2d_walk_kernel<E><<<grid, kThreads, smem, stream>>>(
      layouts, dts_raw, Bs, Cs, dt_w, dt_b, A, dy, h_in, carry, du, dz, dBp, dCp, dAp, L, D, R,
      dt_rs, b_rs, c_rs);
  return cudaGetLastError();
}

}  // namespace

// du (B, 4, L, D) in the sequence dtype (float for bf16 == 0, else bf16),
// as its primal; dz, the dB / dC partials and dA in fp32.
extern "C" int ss2d_scan_bwd_walk(
    const void* layouts, const void* dts_raw, const void* Bs, const void* Cs,
    const float* dt_w, const float* dt_b, const float* A, const void* dy, const float* h_in,
    const float* carry, void* du, float* dz, float* dBp, float* dCp, float* dAp, int B, int L,
    int D, int R, int N, int bf16, long long dt_rs, long long b_rs, long long c_rs, void* stream) {
  if (!shapes_ok(B, L, D, R, N)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  using H = __nv_bfloat16;
  if (bf16)
    return (int)launch_walk((const H*)layouts, (const H*)dts_raw, (const H*)Bs, (const H*)Cs, dt_w, dt_b, A,
                            (const H*)dy, h_in, carry, (H*)du, dz, dBp, dCp, dAp, B, L, D, R, dt_rs, b_rs,
                            c_rs, st);
  return (int)launch_walk((const float*)layouts, (const float*)dts_raw, (const float*)Bs, (const float*)Cs,
                          dt_w, dt_b, A, (const float*)dy, h_in, carry, (float*)du, dz, dBp, dCp, dAp, B, L,
                          D, R, dt_rs, b_rs, c_rs, st);
}

// Resident blocks per SM of (summaries, combine, walk) at R, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int ss2d_scan_bwd_occupancy(int R, int* out) {
  const size_t s_walk = sizeof(float) * walk_floats(R);
  cudaError_t err = shared_occupancy<true>(R, out);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ss2d_walk_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s_walk);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], ss2d_walk_kernel<float>, kThreads,
                                                        s_walk);
  return (int)err;
}
