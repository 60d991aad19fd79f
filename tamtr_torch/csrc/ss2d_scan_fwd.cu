// Fused 4-direction SS2D selective scan, forward (VMamba S6), as a
// segment-parallel scan: sequence I/O in fp32 or bf16, maths and state fp32.
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
// Segments, as the backward (`ss2d_scan_bwd.cu`) cuts them: each
// direction's walk is cut into S = ceil(L / kSeg) segments of kSeg = 48
// steps (the last one ragged), and every (32 channels, b, k, segment) is a
// 128-thread block of its own, grid (D/32, 4B, S), four state lanes per
// thread. Three launches:
//   1. summaries: from h = 0, the segment's local end state h_loc
//      (B, 4, S, D, 16) and sum dt (B, 4, S, D); the backward's summaries
//      kernel without r (`ss2d_scan_seg.cuh`);
//   2. combine: per (b, k, d, n), serial over the S segments, in place:
//      h_in[j+1] = exp(A sum dt_j) h_in[j] + h_loc[j] from h_in[0] = 0; the
//      backward's combine without the carry;
//   3. output: each block rebuilds its segment's states from h_in[j], step
//      by step, and per step y_s = sum_n C_s[n] h_s[n] + D u_s. A thread
//      sums its four lanes for four steps at a time; a reduce-scatter
//      across the channel's 4 threads (three shuffles per four steps) leaves
//      each thread with one step's sum. y is staged in shared memory and
//      written as coalesced 32-channel rows at t = s or t = L-1-s.
// Staging by cp.async in rows along the steps, ragged segments padded with
// zeros (dt = 0: a no-op step), the dt projection and a precise softplus
// fused, exp as ex2.approx.ftz. No atomics: bitwise the same from run to run.
// bf16 sequence I/O (layouts, dts_raw, Bs, Cs read, y written in bf16) runs
// the same code on the fp32 values staging makes (`ss2d_scan_seg.cuh`),
// y rounded once at its store: the TPU kernel's contract
// (`selective_scan.py:455-489`).
//
// Bound on the card (`chip_smoke.py:check_ss2d_scan`): the function, inputs
// read once and y written once, at 640 px level 0 (B=1, L=25600, D=256)
// moves ~175 MB and does 4.L.D.(2R + 8N + 3) = 3.9 G fp32 operations:
// 0.058 ms, by operations. The segment design adds the (B, 4, S, D, 16)
// states (written, read and rewritten by the combine, read by the output:
// 35 MB at B=1) and runs the state recurrence twice. What bounds it instead
// is the exp unit and the instruction issue: each pass evaluates one ex2 per
// (b, k, l, d, n), 0.42 G at level 0, at 16 a clock per SM. The first design
// ran one serial L-step chain per thread, 128 blocks at level 0; segments of
// 48 steps make 17088 blocks there at B=1.

#include "ss2d_scan_seg.cuh"

namespace {

template <typename E, typename O>
__global__ void __launch_bounds__(kThreads, 6) ss2d_output_kernel(
    const E* __restrict__ layouts, const E* __restrict__ dts_raw,
    const E* __restrict__ Bs, const E* __restrict__ Cs, const float* __restrict__ dt_w,
    const float* __restrict__ dt_b, const float* __restrict__ A, const float* __restrict__ Ds,
    const float* __restrict__ h_in, O* __restrict__ y, int L, int D, int R, long long dt_rs,
    long long b_rs, long long c_rs) {
  extern __shared__ __align__(16) float smem[];
  const SegSmem m = carve_seg<true>(smem, R);  // y is staged in the `dy` rows
  const int d0 = blockIdx.x * kDB, bk = blockIdx.y, b = bk / 4, k = bk % 4;
  const Lanes th = lanes_of_thread();
  const int S = gridDim.z;
  const Seq<E> q = make_seq(layouts, dts_raw, Bs, Cs, (const E*)nullptr, b, k, d0, L, D, R, dt_rs, b_rs, c_rs);
  const float4 A4 = ld4(&A[((long long)k * D + d0 + th.dl) * kN + th.n0]);
  float a2[kNP];
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) a2[mm] = at(A4, mm) * kLog2e;
  const float d_skip = Ds[(long long)k * D + d0 + th.dl];
  const float4 hin4 = ld4(&h_in[(((long long)bk * S + blockIdx.z) * D + d0 + th.dl) * kN + th.n0]);
  stage_segment<true, false>(q, k, d0, dt_w, dt_b, m);
  cp_async_wait<0>();
  __syncthreads();
  const float *dtp = m.dt + th.dl * kP, *up = m.u + th.dl * kP;
  const float *B0 = m.B + th.n0 * kP, *C0 = m.C + th.n0 * kP;
  float* yrow = m.dy + th.dl * kP + th.j;  // thread j writes step s4 + j
  const bool hi2 = th.lane & 2, hi1 = th.lane & 1;
  float h[kNP];
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) h[mm] = at(hin4, mm);
#pragma unroll 2
  for (int s4 = 0; s4 < q.T; s4 += 4) {  // steps past T are zeros: no-ops
    const float4 dt4 = ld4(dtp + s4), u4 = ld4(up + s4);
    float4 Bq[kNP], Cq[kNP];
#pragma unroll
    for (int mm = 0; mm < kNP; ++mm) Bq[mm] = ld4(B0 + mm * kP + s4), Cq[mm] = ld4(C0 + mm * kP + s4);
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dt = at(dt4, i), dtu = dt * at(u4, i);
      float acc = 0.f;
#pragma unroll
      for (int mm = 0; mm < kNP; ++mm) {
        h[mm] = fmaf(ex2(dt * a2[mm]), h[mm], dtu * at(Bq[mm], i));
        acc = fmaf(at(Cq[mm], i), h[mm], acc);
      }
      p[i] = acc;
    }
    // over the channel's 4 threads: j = 2 hi2 + hi1 ends with step s4 + j
    const float x0 = (hi2 ? p[2] : p[0]) + __shfl_xor_sync(0xffffffffu, hi2 ? p[0] : p[2], 2);
    const float x1 = (hi2 ? p[3] : p[1]) + __shfl_xor_sync(0xffffffffu, hi2 ? p[1] : p[3], 2);
    const float v = (hi1 ? x1 : x0) + __shfl_xor_sync(0xffffffffu, hi1 ? x0 : x1, 1);
    yrow[s4] = fmaf(d_skip, up[s4 + th.j], v);
  }
  __syncthreads();
  // rows of 32 channels, one step per warp
  const long long dir = q.rev ? -1 : 1;
  O* yg = y + (long long)bk * L * D + d0 + th.lane + q.t_of(q.s0) * D;
  for (int s = th.warp; s < q.T; s += kWarps) store_seq(yg + dir * s * D, m.dy[th.lane * kP + s]);
}

}  // namespace

// hloc (B, 4, S, D, 16) and sdt (B, 4, S, D), S = ceil(L / kSeg): per
// segment, the local end state from h = 0 and the sum of dt. The sequence
// tensors are float (bf16 == 0) or bf16, as in every entry point here.
extern "C" int ss2d_scan_fwd_summaries(const void* layouts, const void* dts_raw, const void* Bs,
                                       const float* dt_w, const float* dt_b, const float* A,
                                       float* hloc, float* sdt, int B, int L, int D, int R, int N,
                                       int bf16, long long dt_rs, long long b_rs, void* stream) {
  if (!shapes_ok(B, L, D, R, N)) return (int)cudaErrorInvalidValue;
  return (int)launch_summaries_of<false>(bf16, layouts, dts_raw, Bs, nullptr, dt_w, dt_b, A, nullptr,
                                         hloc, nullptr, sdt, B, L, D, R, dt_rs, b_rs, 0,
                                         (cudaStream_t)stream);
}

// In place (store != 0): hloc -> the state entering each segment, from
// seed (B, 4, D, 16), the state entering the walk, or 0 when null. leave and
// decay (B, 4, D, 16), when not null, get the state past the last segment
// and exp(A sum dt) over the walk.
extern "C" int ss2d_scan_fwd_combine(const float* A, const float* sdt, float* hloc, const float* seed,
                                     float* leave, float* decay, int B, int L, int D, int N, int store,
                                     void* stream) {
  if (!shapes_ok(B, L, D, 1, N)) return (int)cudaErrorInvalidValue;
  const CombineEnds ends{seed, nullptr, leave, nullptr, decay, store != 0};
  return (int)launch_combine<false>(A, sdt, hloc, nullptr, B, L, D, ends, (cudaStream_t)stream);
}

namespace {

template <typename E, typename O>
cudaError_t launch_output(const E* layouts, const E* dts_raw, const E* Bs, const E* Cs,
                          const float* dt_w, const float* dt_b, const float* A, const float* Ds,
                          const float* h_in, O* y, int B, int L, int D, int R, long long dt_rs,
                          long long b_rs, long long c_rs, cudaStream_t stream) {
  const size_t smem = sizeof(float) * summaries_floats<true>(R);
  cudaError_t err = cudaFuncSetAttribute(ss2d_output_kernel<E, O>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(D / kDB, 4 * B, segments(L));
  ss2d_output_kernel<E, O><<<grid, kThreads, smem, stream>>>(
      layouts, dts_raw, Bs, Cs, dt_w, dt_b, A, Ds, h_in, y, L, D, R, dt_rs, b_rs, c_rs);
  return cudaGetLastError();
}

}  // namespace

// y (B, 4, L, D) natural order from the state entering each segment: in
// the sequence dtype, or in float for bf16 sequences when y_f32 != 0 (the
// pieces of a state larger than 16 lanes, added in fp32 and rounded once).
extern "C" int ss2d_scan_fwd_output(const void* layouts, const void* dts_raw, const void* Bs,
                                    const void* Cs, const float* dt_w, const float* dt_b,
                                    const float* A, const float* Ds, const float* h_in, void* y,
                                    int B, int L, int D, int R, int N, int bf16, int y_f32,
                                    long long dt_rs, long long b_rs, long long c_rs, void* stream) {
  if (!shapes_ok(B, L, D, R, N)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  using H = __nv_bfloat16;
  if (bf16 && y_f32)
    return (int)launch_output((const H*)layouts, (const H*)dts_raw, (const H*)Bs, (const H*)Cs, dt_w, dt_b,
                              A, Ds, h_in, (float*)y, B, L, D, R, dt_rs, b_rs, c_rs, st);
  if (bf16)
    return (int)launch_output((const H*)layouts, (const H*)dts_raw, (const H*)Bs, (const H*)Cs, dt_w, dt_b,
                              A, Ds, h_in, (H*)y, B, L, D, R, dt_rs, b_rs, c_rs, st);
  return (int)launch_output((const float*)layouts, (const float*)dts_raw, (const float*)Bs,
                            (const float*)Cs, dt_w, dt_b, A, Ds, h_in, (float*)y, B, L, D, R, dt_rs,
                            b_rs, c_rs, st);
}

// Resident blocks per SM of (summaries, combine, output) at R, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int ss2d_scan_fwd_occupancy(int R, int* out) {
  const size_t s_out = sizeof(float) * summaries_floats<true>(R);
  cudaError_t err = shared_occupancy<false>(R, out);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ss2d_output_kernel<float, float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s_out);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], ss2d_output_kernel<float, float>, kThreads, s_out);
  return (int)err;
}
