// Device code that the SS2D scan's forward (`ss2d_scan_fwd.cu`, B1) and
// backward (`ss2d_scan_bwd.cu`, B3) share: both cut each direction's walk
// into segments of kSeg steps and run one 128-thread block per (32
// channels, image, direction, segment).
//
// For direction k (row-fwd, col-fwd, row-rev, col-rev), step s of the walk
// reads t = s (k < 2) or t = L-1-s (k >= 2), and per (d, n)
//     dt_s = softplus(dt_raw_s . dt_w[k, d] + dt_b[k, d]),  a_s = exp(dt_s A[k, d, n])
//     h_s  = a_s h_{s-1} + dt_s u_s B_s[n]
// dts_raw, Bs and Cs are read in place as (B, 2, 2, L, *) views with a row
// stride; layouts is (B, 2, L, D); the reversed directions walk t backwards
// over the same layouts, no flipped copies.
//
// What is here:
//   - staging: a block copies its segment of dt_raw, B, u (and C, dy where
//     the kernel needs them) into shared memory with cp.async, in rows along
//     the steps (a thread later reads four steps with one 16-byte load), and
//     computes dt there (the dt projection and a precise softplus). Ragged
//     segments are padded with zeros: dt = 0 makes a padded step a no-op
//     (a = 1, no input, no q), so no step is guarded;
//   - the summaries kernel (B3a's, and B1's first launch): from h = 0, the
//     segment's local end state h_loc and sum dt; the segment's decay is
//     E = prod a_s = exp(A sum dt). With kR (the backward) it also reads C
//     and dy and computes r = sum_s (prod_{i=first..s} a_i) C_s dy_s;
//   - the combine across segments, per (b, k, d, n) serial over the S
//     segments, in place: h_in[j+1] = E_j h_in[j] + h_loc[j] from
//     h_in[0] = 0; with kCarry (the backward) also c[j-1] = E_j c[j] + r[j]
//     from c[S-1] = 0. A block of the sequence-parallel scan
//     (`parallel/seq_scan.py`) seeds it (`CombineEnds`): h_in[0] and c[S-1]
//     are then the state and carry entering the block from its neighbours,
//     and the combine can report what leaves the block (h past its last
//     segment, c before its first) and its decay exp(A sum dt), with or
//     without writing the segments (a dry run gives the block's summary
//     before the seeds are known). Without seeds or ends it is the plain
//     combine, instruction for instruction on the chain.
// Threads: channel dl = 8 warp + lane / 4 and four state lanes
// n = 4j .. 4j + 3 (j = lane % 4) each: per-channel work (loads of dt and
// u, their product) is shared by four lanes. exp is ex2.approx.ftz of
// dt (A log2 e).
//
// Sequence dtype E: the kernels are templates on the type of layouts,
// dts_raw, Bs, Cs and dy (float or __nv_bfloat16; dt_w, dt_b, A and Ds are
// float). Staging widens each element to fp32 in shared memory (float by
// cp.async; bf16 by a 2-byte load and a conversion, cp.async moving no less
// than 4 bytes), so everything after staging, the state included, is fp32
// and the same code for both. Outputs in E (the forward's y, the walk's du)
// are rounded once at their store.

#pragma once

#include <cuda_bf16.h>
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
constexpr int kT = 8;                  // segments are padded to whole kT-step sub-chunks
constexpr int kSeg = 48;               // steps per segment (SEG_STEPS in kernels/selective_scan.py)
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kNP == 4 && kDB == 32, "the reductions are written for 4 lanes a thread");
static_assert(kSeg % kT == 0, "segments are whole sub-chunks");

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

// one sequence element into shared memory as fp32 (see the header)
__device__ __forceinline__ void stage1(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void stage1(float* dst, const __nv_bfloat16* src) { *dst = __bfloat162float(*src); }

// a sequence output element, rounded once to its type
__device__ __forceinline__ void store_seq(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_seq(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Per-block view of one (b, k) sequence and one segment of it, E the
// sequence dtype.
template <typename E>
struct Seq {
  const E* u;    // layouts[b, k % 2] + d0, row stride D
  const E* dtr;  // dts_raw[b, k / 2, k % 2], row stride dt_rs
  const E* Bm;   // Bs[b, k / 2, k % 2], row stride b_rs
  const E* Cm;   // Cs[b, k / 2, k % 2], row stride c_rs
  const E* dy;   // dy[b, k] + d0, row stride D (the backward only)
  long long dt_rs, b_rs, c_rs;
  int L, D, R;
  int s0, T;  // the segment: steps [s0, s0 + T)
  bool rev;
  __device__ long long t_of(int s) const { return rev ? L - 1 - s : s; }
};

template <typename E>
__device__ Seq<E> make_seq(const E* layouts, const E* dts_raw, const E* Bs, const E* Cs, const E* dy,
                           int b, int k, int d0, int L, int D, int R, long long dt_rs, long long b_rs,
                           long long c_rs) {
  const int f = k / 2, j = k % 2;
  const long long seq = (((long long)b * 2 + f) * 2 + j) * L;
  Seq<E> q;
  q.u = layouts + ((long long)b * 2 + j) * L * D + d0;
  q.dtr = dts_raw + seq * dt_rs;
  q.Bm = Bs + seq * b_rs;
  q.Cm = Cs ? Cs + seq * c_rs : nullptr;
  q.dy = dy ? dy + ((long long)b * 4 + k) * L * D + d0 : nullptr;
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

// Shared memory of the segment kernels, in floats. Per-channel and per-n
// rows run along the steps with a pitch of kP = kSeg + 4 (16-byte aligned
// rows, four channels of a warp on distinct banks). With kCDy the layout
// also holds rows of C and a per-channel row block `dy` (the backward's dy;
// the forward's output stages y there). `scratch` holds dt_raw while dt is
// computed; the backward's walk then reuses it for its sub-chunk states.
constexpr int kP = kSeg + 4;  // row pitch

struct SegSmem {
  float *dtwT, *dtb, *dt, *u, *B, *C, *dy, *scratch;
};

template <bool kCDy>
__host__ __device__ size_t head_floats(int R) {  // a multiple of 4
  return (size_t)R * kDB + kDB + (size_t)((kCDy ? 3 : 2) * kDB + (kCDy ? 2 : 1) * kN) * kP;
}

template <bool kCDy>
__device__ SegSmem carve_seg(float* p, int R) {
  SegSmem m;
  m.dtwT = p;  p += R * kDB;  // [R][kDB]: conflict-free reads across channels
  m.dtb = p;   p += kDB;
  m.dt = p;    p += kDB * kP;  // [kDB][kP]
  m.u = p;     p += kDB * kP;
  m.B = p;     p += kN * kP;   // [kN][kP]
  m.C = m.dy = nullptr;
  if (kCDy) {
    m.C = p;   p += kN * kP;
    m.dy = p;  p += kDB * kP;
  }
  m.scratch = p;  // dt_raw [kSeg][R]
  return m;
}

template <bool kCDy>
__host__ __device__ size_t summaries_floats(int R) { return head_floats<kCDy>(R) + (size_t)kSeg * R; }

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
// weights); group 2 C (kC) and dy (kDy), possibly empty. Steps [T, Tpad) of
// a ragged segment are zeros: dt = 0 makes them no-ops of every recurrence,
// so the loops run whole sub-chunks without a guard per step. Waits for
// group 1, computes dt into shared memory and ends synchronised; group 2
// may still be in flight.
template <bool kC, bool kDy, typename E>
__device__ void stage_segment(const Seq<E>& q, int k, int d0, const float* dt_w, const float* dt_b,
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
    const E* gu = q.u + t_w * q.D + lane;
    const E* gr = q.dtr + t_w * q.dt_rs + lane;
    const E* gb = q.Bm + t_h * q.b_rs + nl;
    for (int s = warp; s < T; s += kWarps, gu += dir * kWarps * q.D, gr += dir * kWarps * q.dt_rs) {
      if (lane < R) stage1(&dtr[s * R + lane], gr);
      if (lane + 32 < R) stage1(&dtr[s * R + lane + 32], gr + 32);
      stage1(&m.u[lane * P + s], gu);
    }
    for (int s = 2 * warp + lane / kN; s < T; s += 2 * kWarps, gb += dir * 2 * kWarps * q.b_rs)
      stage1(&m.B[nl * P + s], gb);
  }
  cp_async_commit();
  if (kDy) {
    const E* gy = q.dy + t_w * q.D + lane;
    for (int s = warp; s < T; s += kWarps, gy += dir * kWarps * q.D) stage1(&m.dy[lane * P + s], gy);
  }
  if (kC) {
    const E* gc = q.Cm + t_h * q.c_rs + nl;
    for (int s = 2 * warp + lane / kN; s < T; s += 2 * kWarps, gc += dir * 2 * kWarps * q.c_rs)
      stage1(&m.C[nl * P + s], gc);
  }
  cp_async_commit();
  for (int s = T + warp; s < Tpad; s += kWarps) {
    m.u[lane * P + s] = 0.f;
    if (kDy) m.dy[lane * P + s] = 0.f;
    if (lane < kN) {
      m.B[lane * P + s] = 0.f;
      if (kC) m.C[lane * P + s] = 0.f;
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

// The segment summaries. hloc (B, 4, S, D, 16) and sdt (B, 4, S, D); with
// kR also rsum (B, 4, S, D, 16) from C and dy (Cs, dy unread without).
template <bool kR, typename E>
__global__ void __launch_bounds__(kThreads, 6) ss2d_summaries_kernel(
    const E* __restrict__ layouts, const E* __restrict__ dts_raw,
    const E* __restrict__ Bs, const E* __restrict__ Cs, const float* __restrict__ dt_w,
    const float* __restrict__ dt_b, const float* __restrict__ A, const E* __restrict__ dy,
    float* __restrict__ hloc, float* __restrict__ rsum, float* __restrict__ sdt, int L, int D,
    int R, long long dt_rs, long long b_rs, long long c_rs) {
  extern __shared__ __align__(16) float smem[];
  const SegSmem m = carve_seg<kR>(smem, R);
  const int d0 = blockIdx.x * kDB, bk = blockIdx.y, b = bk / 4, k = bk % 4;
  const Lanes th = lanes_of_thread();
  const int S = gridDim.z;
  const Seq<E> q = make_seq(layouts, dts_raw, Bs, Cs, dy, b, k, d0, L, D, R, dt_rs, b_rs, c_rs);
  const float4 A4 = ld4(&A[((long long)k * D + d0 + th.dl) * kN + th.n0]);
  float a2[kNP];
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) a2[mm] = at(A4, mm) * kLog2e;
  stage_segment<kR, kR>(q, k, d0, dt_w, dt_b, m);
  cp_async_wait<0>();
  __syncthreads();
  const float *dtp = m.dt + th.dl * kP, *up = m.u + th.dl * kP, *B0 = m.B + th.n0 * kP;
  float h[kNP], P[kNP], r[kNP], sum_dt = 0.f;
#pragma unroll
  for (int mm = 0; mm < kNP; ++mm) h[mm] = 0.f, P[mm] = 1.f, r[mm] = 0.f;
#pragma unroll 2
  for (int s4 = 0; s4 < q.T; s4 += 4) {  // steps past T are zeros: no-ops
    const float4 dt4 = ld4(dtp + s4), u4 = ld4(up + s4);
    float4 Bq[kNP], Cq[kNP], dy4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int mm = 0; mm < kNP; ++mm) Bq[mm] = ld4(B0 + mm * kP + s4);
    if constexpr (kR) {
      dy4 = ld4(m.dy + th.dl * kP + s4);
#pragma unroll
      for (int mm = 0; mm < kNP; ++mm) Cq[mm] = ld4(m.C + (th.n0 + mm) * kP + s4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dt = at(dt4, i), dtu = dt * at(u4, i);
#pragma unroll
      for (int mm = 0; mm < kNP; ++mm) {
        const float a = ex2(dt * a2[mm]);
        h[mm] = fmaf(a, h[mm], dtu * at(Bq[mm], i));
        if constexpr (kR) {
          P[mm] *= a;
          r[mm] = fmaf(P[mm], at(Cq[mm], i) * at(dy4, i), r[mm]);
        }
      }
      sum_dt += dt;
    }
  }
  const long long row = ((long long)bk * S + blockIdx.z) * D + d0 + th.dl;
  *reinterpret_cast<float4*>(&hloc[row * kN + th.n0]) = make_float4(h[0], h[1], h[2], h[3]);
  if constexpr (kR)
    *reinterpret_cast<float4*>(&rsum[row * kN + th.n0]) = make_float4(r[0], r[1], r[2], r[3]);
  if (th.j == 0) sdt[row] = sum_dt;
}

// The optional ends of a combine, each (B, 4, D, 16) for B1 and B3 and
// (G, Din, N) for B6, null by default: seed_h, the state entering the walk's
// first segment (else 0); seed_c, the carry entering its last segment's
// last step (else 0; B3 only); leave_h, the state past the last segment;
// leave_c, the carry leaving the first segment (B3 only); decay,
// exp(A sum dt) over the whole walk. store = false leaves the segments as
// they are and writes only the ends.
struct CombineEnds {
  const float* seed_h;
  const float* seed_c;
  float* leave_h;
  float* leave_c;
  float* decay;
  bool store;
};

// The combine, serial over the S segments, in place: one thread per
// (b, k, d, n) turns hloc into h_in; with kCarry a second one turns rsum
// into c. Loads go 8 segments ahead of the chain.
constexpr int kAhead = 8;
constexpr int kCombineThreads = 256;

template <bool kCarry>
__global__ void __launch_bounds__(kCombineThreads, 4) ss2d_combine_kernel(
    const float* __restrict__ A, const float* __restrict__ sdt, float* __restrict__ hloc,
    float* __restrict__ rsum, int B, int D, int S, CombineEnds ends) {
  const long long lanes = (long long)B * 4 * D * kN;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (kCarry ? 2 : 1) * lanes) return;
  const bool carry = kCarry && idx >= lanes;  // warp-uniform: lanes is a multiple of 512
  if (carry) idx -= lanes;
  const long long DN = (long long)D * kN, bk = idx / DN, rem = idx % DN;
  const int k = (int)(bk % 4), d = (int)(rem / kN);
  const float a2 = A[(long long)k * DN + rem] * kLog2e;
  float* p = (carry ? rsum : hloc) + bk * S * DN + rem;
  const float* sp = sdt + bk * S * D + d;
  // h: j = 0, 1, ..., S-1 (v_{j+1} = E_j v_j + loc_j); c: j = S-1, ..., 0
  // (v_{j-1} = E_j v_j + loc_j); each slot receives the v entering it
  const int j0 = carry ? S - 1 : 0, dj = carry ? -1 : 1;
  const float* seed = carry ? ends.seed_c : ends.seed_h;
  float v = seed != nullptr ? seed[idx] : 0.f;
  float sum_dt = 0.f;
  int c = 0;
  for (; c + kAhead <= S; c += kAhead) {
    float loc[kAhead], E[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int j = j0 + dj * (c + i);
      loc[i] = p[j * DN];
      const float sdt_j = sp[(long long)j * D];
      E[i] = ex2(a2 * sdt_j);
      sum_dt += sdt_j;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (ends.store) p[(j0 + dj * (c + i)) * DN] = v;
      v = fmaf(E[i], v, loc[i]);
    }
  }
  for (; c < S; ++c) {
    const int j = j0 + dj * c;
    const float loc = p[j * DN], sdt_j = sp[(long long)j * D], E = ex2(a2 * sdt_j);
    if (ends.store) p[j * DN] = v;
    v = fmaf(E, v, loc);
    sum_dt += sdt_j;
  }
  float* leave = carry ? ends.leave_c : ends.leave_h;
  if (leave != nullptr) leave[idx] = v;
  if (!carry && ends.decay != nullptr) ends.decay[idx] = ex2(a2 * sum_dt);
}

int segments(int L) { return (L + kSeg - 1) / kSeg; }

bool shapes_ok(int B, int L, int D, int R, int N) {
  return N == kN && D % kDB == 0 && R >= 1 && R <= 64 && L >= 1 && B >= 1 && segments(L) <= 65535 &&
         4 * B <= 65535;
}

template <bool kR, typename E>
cudaError_t launch_summaries(const E* layouts, const E* dts_raw, const E* Bs, const E* Cs,
                             const float* dt_w, const float* dt_b, const float* A, const E* dy,
                             float* hloc, float* rsum, float* sdt, int B, int L, int D, int R,
                             long long dt_rs, long long b_rs, long long c_rs, cudaStream_t stream) {
  const size_t smem = sizeof(float) * summaries_floats<kR>(R);
  cudaError_t err = cudaFuncSetAttribute(ss2d_summaries_kernel<kR, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(D / kDB, 4 * B, segments(L));
  ss2d_summaries_kernel<kR, E><<<grid, kThreads, smem, stream>>>(
      layouts, dts_raw, Bs, Cs, dt_w, dt_b, A, dy, hloc, rsum, sdt, L, D, R, dt_rs, b_rs, c_rs);
  return cudaGetLastError();
}

// launch_summaries on sequence tensors of float (bf16 == 0) or bf16 type
template <bool kR>
cudaError_t launch_summaries_of(int bf16, const void* layouts, const void* dts_raw, const void* Bs,
                                const void* Cs, const float* dt_w, const float* dt_b, const float* A,
                                const void* dy, float* hloc, float* rsum, float* sdt, int B, int L,
                                int D, int R, long long dt_rs, long long b_rs, long long c_rs,
                                cudaStream_t stream) {
  using H = __nv_bfloat16;
  if (bf16)
    return launch_summaries<kR>((const H*)layouts, (const H*)dts_raw, (const H*)Bs, (const H*)Cs, dt_w,
                                dt_b, A, (const H*)dy, hloc, rsum, sdt, B, L, D, R, dt_rs, b_rs, c_rs,
                                stream);
  return launch_summaries<kR>((const float*)layouts, (const float*)dts_raw, (const float*)Bs,
                              (const float*)Cs, dt_w, dt_b, A, (const float*)dy, hloc, rsum, sdt, B, L,
                              D, R, dt_rs, b_rs, c_rs, stream);
}

template <bool kCarry>
cudaError_t launch_combine(const float* A, const float* sdt, float* hloc, float* rsum, int B, int L,
                           int D, CombineEnds ends, cudaStream_t stream) {
  const long long threads = (kCarry ? 2LL : 1LL) * B * 4 * D * kN;
  ss2d_combine_kernel<kCarry><<<(unsigned)((threads + kCombineThreads - 1) / kCombineThreads),
                                kCombineThreads, 0, stream>>>(A, sdt, hloc, rsum, B, D, segments(L), ends);
  return cudaGetLastError();
}

// Resident blocks per SM of the summaries (out[0]) and the combine (out[1]) at R.
template <bool kR>
cudaError_t shared_occupancy(int R, int* out) {
  const size_t smem = sizeof(float) * summaries_floats<kR>(R);
  cudaError_t err = cudaFuncSetAttribute(ss2d_summaries_kernel<kR, float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], ss2d_summaries_kernel<kR, float>, kThreads,
                                                        smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], ss2d_combine_kernel<kR>, kCombineThreads, 0);
  return err;
}

}  // namespace
