// Fused 4-direction SS2D selective scan, backward, fp32 (VMamba S6), as a
// segment-parallel scan.
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
// a block of its own: grid (D/32, 4B, S). Three launches:
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 16;                 // state size
constexpr int kNP = 4;                 // state lanes per thread
constexpr int kTPC = kN / kNP;         // threads per channel: 4
constexpr int kDB = 32;                // channels per block
constexpr int kThreads = kDB * kTPC;   // 128
constexpr int kWarps = kThreads / 32;  // 4
constexpr int kCPW = 32 / kTPC;        // channels per warp: 8
constexpr int kT = 8;                  // steps per sub-chunk of the walk
constexpr int kSeg = 48;               // steps per segment (SEG_STEPS in kernels/selective_scan.py)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// 2^x; subnormal results flush to 0 (a decay below 1e-38 is 0 here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Per-block view of one (b, k) sequence and one segment of it.
struct Seq {
  const float* u;    // layouts[b, k % 2] + d0, row stride D
  const float* dtr;  // dts_raw[b, k / 2, k % 2], row stride dt_rs
  const float* Bm;   // Bs[b, k / 2, k % 2], row stride b_rs
  const float* Cm;   // Cs[b, k / 2, k % 2], row stride c_rs
  const float* dy;   // dy[b, k] + d0, row stride D
  long long dt_rs, b_rs, c_rs;
  int L, D, R;
  int s0, T;  // the segment: steps [s0, s0 + T)
  bool rev;
  __device__ long long t_of(int s) const { return rev ? L - 1 - s : s; }
};

__device__ Seq make_seq(const float* layouts, const float* dts_raw, const float* Bs,
                        const float* Cs, const float* dy, int b, int k, int d0, int L, int D,
                        int R, long long dt_rs, long long b_rs, long long c_rs) {
  const int f = k / 2, j = k % 2;
  const long long seq = (((long long)b * 2 + f) * 2 + j) * L;
  Seq q;
  q.u = layouts + ((long long)b * 2 + j) * L * D + d0;
  q.dtr = dts_raw + seq * dt_rs;
  q.Bm = Bs + seq * b_rs;
  q.Cm = Cs + seq * c_rs;
  q.dy = dy + ((long long)b * 4 + k) * L * D + d0;
  q.dt_rs = dt_rs;
  q.b_rs = b_rs;
  q.c_rs = c_rs;
  q.L = L;
  q.D = D;
  q.R = R;
  q.s0 = blockIdx.z * kSeg;
  q.T = min(kSeg, L - q.s0);
  q.rev = f == 1;
  return q;
}

// Shared memory of both segment kernels, in floats. Per-channel and per-n
// rows run along the steps with a pitch of kP = kSeg + 4 (16-byte aligned rows,
// four channels of a warp on distinct banks). `scratch` holds dt_raw while
// dt is computed; the walk then reuses it for its sub-chunk states.
constexpr int kP = kSeg + 4;  // row pitch

struct SegSmem {
  float *dtwT, *dtb, *dt, *u, *dy, *B, *C, *scratch;
};

__host__ __device__ size_t head_floats(int R) {  // a multiple of 4
  return (size_t)R * kDB + kDB + (size_t)(3 * kDB + 2 * kN) * kP;
}

__device__ SegSmem carve_seg(float* p, int R) {
  SegSmem m;
  m.dtwT = p;  p += R * kDB;  // [R][kDB]: conflict-free reads across channels
  m.dtb = p;   p += kDB;
  m.dt = p;    p += kDB * kP;  // [kDB][kP]
  m.u = p;     p += kDB * kP;
  m.dy = p;    p += kDB * kP;
  m.B = p;     p += kN * kP;   // [kN][kP]
  m.C = p;     p += kN * kP;
  m.scratch = p;  // dt_raw [kSeg][R]
  return m;
}

__host__ __device__ size_t summaries_floats(int R) { return head_floats(R) + (size_t)kSeg * R; }

constexpr size_t kCarFloats = (size_t)(kSeg / kT) * kThreads * kNP;

__host__ __device__ size_t walk_floats(int R) {
  const size_t scratch = kCarFloats > (size_t)kSeg * R ? kCarFloats : (size_t)kSeg * R;
  return head_floats(R) + scratch + 2 * kT * kWarps * 32 + 2 * kT * kDB * 2;
}

// dt of rows s = warp, warp + kWarps, ... < Tpad for channel `lane`, the
// projection's weights held in registers (kR of them; 0: any R, from
// shared memory). Rows past T get dt = 0.
template <int kR>
__device__ void dt_rows(const float* dtr, const SegSmem& m, int R, int T, int Tpad, int lane,
                        int warp) {
  float w[kR > 0 ? kR : 1];
#pragma unroll
  for (int r = 0; r < kR; ++r) w[r] = m.dtwT[r * kDB + lane];
  const float bias = m.dtb[lane];
  for (int s = warp; s < Tpad; s += kWarps) {
    float dt = 0.f;
    if (s < T) {
      float z = bias;
      if (kR > 0) {
#pragma unroll
        for (int r = 0; r < kR; r += 4) {
          const float4 x = ld4(dtr + s * kR + r);
          z = fmaf(x.x, w[r], z);
          z = fmaf(x.y, w[r + 1], z);
          z = fmaf(x.z, w[r + 2], z);
          z = fmaf(x.w, w[r + 3], z);
        }
      } else {
        for (int r = 0; r < R; ++r) z = fmaf(dtr[s * R + r], m.dtwT[r * kDB + lane], z);
      }
      dt = softplus(z);
    }
    m.dt[lane * kP + s] = dt;
  }
}

// Stage the segment with cp.async: group 1 dt_raw, B, u (and the dt
// weights); group 2 C, dy. Steps [T, Tpad) of a ragged segment are zeros:
// dt = 0 makes them no-ops of every recurrence (a = 1, no input, no q), so
// the loops run whole 8-step sub-chunks without a guard per step. Waits for
// group 1, computes dt into shared memory and ends synchronised; group 2
// may still be in flight.
__device__ void stage_segment(const Seq& q, int k, int d0, const float* dt_w, const float* dt_b,
                              const SegSmem& m) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int R = q.R, T = q.T, P = kP;
  const int Tpad = (T + kT - 1) / kT * kT;
  const long long dir = q.rev ? -1 : 1;  // global rows run backwards for k >= 2
  float* dtr = m.scratch;
  for (int i = tid; i < kDB * R; i += kThreads) {
    const int dd = i / R, r = i % R;
    cp_async4(&m.dtwT[r * kDB + dd], &dt_w[((long long)k * q.D + d0) * R + i]);
  }
  if (tid < kDB) cp_async4(&m.dtb[tid], &dt_b[(long long)k * q.D + d0 + tid]);
  // rows of u, dy and dt_raw: one step per warp; rows of B and C: two per warp
  const long long t_w = q.t_of(q.s0 + warp), t_h = q.t_of(q.s0 + 2 * warp + lane / kN);
  const int nl = lane % kN;
  {
    const float* gu = q.u + t_w * q.D + lane;
    const float* gr = q.dtr + t_w * q.dt_rs + lane;
    const float* gb = q.Bm + t_h * q.b_rs + nl;
    for (int s = warp; s < T; s += kWarps, gu += dir * kWarps * q.D, gr += dir * kWarps * q.dt_rs) {
      if (lane < R) cp_async4(&dtr[s * R + lane], gr);
      if (lane + 32 < R) cp_async4(&dtr[s * R + lane + 32], gr + 32);
      cp_async4(&m.u[lane * P + s], gu);
    }
    for (int s = 2 * warp + lane / kN; s < T; s += 2 * kWarps, gb += dir * 2 * kWarps * q.b_rs)
      cp_async4(&m.B[nl * P + s], gb);
  }
  cp_async_commit();
  {
    const float* gy = q.dy + t_w * q.D + lane;
    const float* gc = q.Cm + t_h * q.c_rs + nl;
    for (int s = warp; s < T; s += kWarps, gy += dir * kWarps * q.D) cp_async4(&m.dy[lane * P + s], gy);
    for (int s = 2 * warp + lane / kN; s < T; s += 2 * kWarps, gc += dir * 2 * kWarps * q.c_rs)
      cp_async4(&m.C[nl * P + s], gc);
  }
  cp_async_commit();
  for (int s = T + warp; s < Tpad; s += kWarps) {
    m.u[lane * P + s] = 0.f;
    m.dy[lane * P + s] = 0.f;
    if (lane < kN) {
      m.B[lane * P + s] = 0.f;
      m.C[lane * P + s] = 0.f;
    }
  }
  cp_async_wait<1>();
  __syncthreads();
  switch (R) {  // the model's widths: 8, 16, 32
    case 8: dt_rows<8>(dtr, m, R, T, Tpad, lane, warp); break;
    case 16: dt_rows<16>(dtr, m, R, T, Tpad, lane, warp); break;
    case 32: dt_rows<32>(dtr, m, R, T, Tpad, lane, warp); break;
    default: dt_rows<0>(dtr, m, R, T, Tpad, lane, warp);
  }
  __syncthreads();
}

// Each thread: channel dl = 8 warp + lane / 4, lanes n = 4j .. 4j + 3 (j = lane % 4).
struct Lanes {
  int lane, warp, dl, j, n0;
};

__device__ Lanes lanes_of_thread() {
  Lanes t;
  t.lane = threadIdx.x % 32;
  t.warp = threadIdx.x / 32;
  t.dl = t.warp * kCPW + t.lane / kTPC;
  t.j = t.lane % kTPC;
  t.n0 = kNP * t.j;
  return t;
}

__global__ void __launch_bounds__(kThreads, 6) ss2d_summaries_kernel(
    const float* __restrict__ layouts, const float* __restrict__ dts_raw,
    const float* __restrict__ Bs, const float* __restrict__ Cs, const float* __restrict__ dt_w,
    const float* __restrict__ dt_b, const float* __restrict__ A, const float* __restrict__ dy,
    float* __restrict__ hloc, float* __restrict__ rsum, float* __restrict__ sdt, int L, int D,
    int R, long long dt_rs, long long b_rs, long long c_rs) {
  extern __shared__ __align__(16) float smem[];
  const SegSmem m = carve_seg(smem, R);
  const int d0 = blockIdx.x * kDB, bk = blockIdx.y, b = bk / 4, k = bk % 4;
  const Lanes th = lanes_of_thread();
  const int S = gridDim.z;
  const Seq q = make_seq(layouts, dts_raw, Bs, Cs, dy, b, k, d0, L, D, R, dt_rs, b_rs, c_rs);
  const float4 A4 = ld4(&A[((long long)k * D + d0 + th.dl) * kN + th.n0]);
  float a2[kNP];
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) a2[mm] = at(A4, mm) * kLog2e;
  stage_segment(q, k, d0, dt_w, dt_b, m);
  cp_async_wait<0>();
  __syncthreads();
  const float *dtp = m.dt + th.dl * kP, *up = m.u + th.dl * kP, *dyp = m.dy + th.dl * kP;
  const float *B0 = m.B + th.n0 * kP, *C0 = m.C + th.n0 * kP;
  float h[kNP], P[kNP], r[kNP], sum_dt = 0.f;
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) h[mm] = 0.f, P[mm] = 1.f, r[mm] = 0.f;
#pragma unroll 2
  for (int s4 = 0; s4 < q.T; s4 += 4) {  // steps past T are zeros: no-ops
    const float4 dt4 = ld4(dtp + s4), u4 = ld4(up + s4), dy4 = ld4(dyp + s4);
    float4 Bq[kNP], Cq[kNP];
#pragma unroll
    for (int mm = 0; mm < kNP; ++mm) Bq[mm] = ld4(B0 + mm * kP + s4), Cq[mm] = ld4(C0 + mm * kP + s4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dt = at(dt4, i), dtu = dt * at(u4, i), dyv = at(dy4, i);
#pragma unroll
      for (int mm = 0; mm < kNP; ++mm) {
        const float a = ex2(dt * a2[mm]);
        h[mm] = fmaf(a, h[mm], dtu * at(Bq[mm], i));
        P[mm] *= a;
        r[mm] = fmaf(P[mm], at(Cq[mm], i) * dyv, r[mm]);
      }
      sum_dt += dt;
    }
  }
  const long long row = ((long long)bk * S + blockIdx.z) * D + d0 + th.dl;
  *reinterpret_cast<float4*>(&hloc[row * kN + th.n0]) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(&rsum[row * kN + th.n0]) = make_float4(r[0], r[1], r[2], r[3]);
  if (th.j == 0) sdt[row] = sum_dt;
}

// Two threads per (b, k, d, n), each serial over the S segments, in place:
// the first turns hloc into h_in, the second rsum into c. Loads go 8
// segments ahead of the chain.
constexpr int kAhead = 8;

__global__ void __launch_bounds__(256, 4) ss2d_combine_kernel(
    const float* __restrict__ A, const float* __restrict__ sdt, float* __restrict__ hloc,
    float* __restrict__ rsum, int B, int D, int S) {
  const long long lanes = (long long)B * 4 * D * kN;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * lanes) return;
  const bool carry = idx >= lanes;  // warp-uniform: lanes is a multiple of 512
  if (carry) idx -= lanes;
  const long long DN = (long long)D * kN, bk = idx / DN, rem = idx % DN;
  const int k = (int)(bk % 4), d = (int)(rem / kN);
  const float a2 = A[(long long)k * DN + rem] * kLog2e;
  float* p = (carry ? rsum : hloc) + bk * S * DN + rem;
  const float* sp = sdt + bk * S * D + d;
  // h: j = 0, 1, ..., S-1 (v_{j+1} = E_j v_j + loc_j); c: j = S-1, ..., 0
  // (v_{j-1} = E_j v_j + loc_j); each slot receives the v entering it
  const int j0 = carry ? S - 1 : 0, dj = carry ? -1 : 1;
  float v = 0.f;
  int c = 0;
  for (; c + kAhead <= S; c += kAhead) {
    float loc[kAhead], E[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int j = j0 + dj * (c + i);
      loc[i] = p[j * DN];
      E[i] = ex2(a2 * sp[(long long)j * D]);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      p[(j0 + dj * (c + i)) * DN] = v;
      v = fmaf(E[i], v, loc[i]);
    }
  }
  for (; c < S; ++c) {
    const int j = j0 + dj * c;
    const float loc = p[j * DN], E = ex2(a2 * sp[(long long)j * D]);
    p[j * DN] = v;
    v = fmaf(E, v, loc);
  }
}

__global__ void __launch_bounds__(kThreads, 4) ss2d_walk_kernel(
    const float* __restrict__ layouts, const float* __restrict__ dts_raw,
    const float* __restrict__ Bs, const float* __restrict__ Cs, const float* __restrict__ dt_w,
    const float* __restrict__ dt_b, const float* __restrict__ A, const float* __restrict__ dy,
    const float* __restrict__ h_in, const float* __restrict__ carry, float* __restrict__ du,
    float* __restrict__ dz, float* __restrict__ dBp, float* __restrict__ dCp,
    float* __restrict__ dAp, int L, int D, int R, long long dt_rs, long long b_rs,
    long long c_rs) {
  extern __shared__ __align__(16) float smem[];
  const SegSmem m = carve_seg(smem, R);
  float* s_car = m.scratch;  // [kSeg/kT][kThreads][kNP], after dt_raw is consumed
  float* s_red = smem + walk_floats(R) - 2 * kT * kWarps * 32 - 2 * kT * kDB * 2;  // [2][kT][kWarps][32]
  float* s_gd = s_red + 2 * kT * kWarps * 32;  // [2][kT][kDB][2]: sum_n gB, sum_n ddA A

  const int d0 = blockIdx.x * kDB, bk = blockIdx.y, b = bk / 4, k = bk % 4;
  const Lanes th = lanes_of_thread();
  const int tid = threadIdx.x, S = gridDim.z;
  const Seq q = make_seq(layouts, dts_raw, Bs, Cs, dy, b, k, d0, L, D, R, dt_rs, b_rs, c_rs);
  const float4 A4 = ld4(&A[((long long)k * D + d0 + th.dl) * kN + th.n0]);
  float a_dn[kNP], a2[kNP];
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) a_dn[mm] = at(A4, mm), a2[mm] = at(A4, mm) * kLog2e;
  const long long o = (((long long)bk * S + blockIdx.z) * D + d0 + th.dl) * kN + th.n0;
  const float4 hin4 = ld4(&h_in[o]), c4 = ld4(&carry[o]);
  stage_segment(q, k, d0, dt_w, dt_b, m);
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
  float* du_c = du + (long long)bk * L * D + d0 + c + t_first * D;
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
        du_c[ds * D] = gB * dt;
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

int segments(int L) { return (L + kSeg - 1) / kSeg; }

bool shapes_ok(int B, int L, int D, int R, int N) {
  return N == kN && D % kDB == 0 && R >= 1 && R <= 64 && L >= 1 && B >= 1 && segments(L) <= 65535 &&
         4 * B <= 65535;
}

static_assert(kNP == 4 && kDB == 32 && kT * kDB % kThreads == 0, "the reductions are written for 4 lanes a thread");
static_assert(kSeg % kT == 0, "segments are whole sub-chunks");

}  // namespace

// hloc, rsum (B, 4, S, D, 16) and sdt (B, 4, S, D), S = ceil(L / kSeg): per
// segment, the local end state from h = 0, r, and the sum of dt.
extern "C" int ss2d_scan_bwd_summaries(
    const float* layouts, const float* dts_raw, const float* Bs, const float* Cs,
    const float* dt_w, const float* dt_b, const float* A, const float* dy, float* hloc,
    float* rsum, float* sdt, int B, int L, int D, int R, int N, long long dt_rs,
    long long b_rs, long long c_rs, void* stream) {
  if (!shapes_ok(B, L, D, R, N)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * summaries_floats(R);
  cudaError_t err = cudaFuncSetAttribute(ss2d_summaries_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(D / kDB, 4 * B, segments(L));
  ss2d_summaries_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      layouts, dts_raw, Bs, Cs, dt_w, dt_b, A, dy, hloc, rsum, sdt, L, D, R, dt_rs, b_rs, c_rs);
  return (int)cudaGetLastError();
}

// In place: hloc -> the state entering each segment, rsum -> the carry c
// entering each segment's last step.
extern "C" int ss2d_scan_bwd_combine(const float* A, const float* sdt, float* hloc, float* rsum,
                                     int B, int L, int D, int N, void* stream) {
  if (!shapes_ok(B, L, D, 1, N)) return (int)cudaErrorInvalidValue;
  const long long threads = 2LL * B * 4 * D * kN;
  ss2d_combine_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      A, sdt, hloc, rsum, B, D, segments(L));
  return (int)cudaGetLastError();
}

// du, dz (B, 4, L, D) natural order; dBp, dCp (B, 4, D/32, L, 16) partial
// sums over each block's 32 channels; dAp (B, 4, S, D, 16) per segment.
extern "C" int ss2d_scan_bwd_walk(
    const float* layouts, const float* dts_raw, const float* Bs, const float* Cs,
    const float* dt_w, const float* dt_b, const float* A, const float* dy, const float* h_in,
    const float* carry, float* du, float* dz, float* dBp, float* dCp, float* dAp, int B, int L,
    int D, int R, int N, long long dt_rs, long long b_rs, long long c_rs, void* stream) {
  if (!shapes_ok(B, L, D, R, N)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * walk_floats(R);
  cudaError_t err = cudaFuncSetAttribute(ss2d_walk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(D / kDB, 4 * B, segments(L));
  ss2d_walk_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      layouts, dts_raw, Bs, Cs, dt_w, dt_b, A, dy, h_in, carry, du, dz, dBp, dCp, dAp, L, D, R,
      dt_rs, b_rs, c_rs);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of (summaries, combine, walk) at R, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int ss2d_scan_bwd_occupancy(int R, int* out) {
  const size_t s_sum = sizeof(float) * summaries_floats(R);
  const size_t s_walk = sizeof(float) * walk_floats(R);
  cudaError_t err = cudaFuncSetAttribute(ss2d_summaries_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_sum);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ss2d_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s_walk);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], ss2d_summaries_kernel, kThreads,
                                                        s_sum);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], ss2d_combine_kernel, 256, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], ss2d_walk_kernel, kThreads,
                                                        s_walk);
  return (int)err;
}
