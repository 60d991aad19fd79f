// Deformable-attention bilinear pair gather, forward: value and out in fp32
// or bf16, weights and sums fp32.
//
// Replaces the TPU kernel
// `tamtr_tpu/kernels/deform_scatter.py:_gather_pairs_kernel` (launched by
// `_gather_acc_pairs`, reached through `bilinear_gather`). For each batch b,
// query q and head h:
//     out[b, q, h, :] = sum_{j < ppq} wa * value[b, i, h, :] + wb * value[b, i + 1, h, :]
// with u = q * ppq + j, i = idx2[b, u, h] and (wa, wb) = w_pairs[b, u, h, :].
// A pair is the two x-corners of one bilinear row of a sample point; they are
// consecutive flat positions, so its two rows lie nh * c floats apart.
//
// Caller contract (`tamtr_torch/nn/decoder.py:deform_sampling_pairs`): a pair
// with x0 < 0 arrives with its weights swapped, and a level's bottom-right
// pair may read row 0 of the next level with weight exactly 0. A pair that
// starts on the global last row Lv-1 is shifted up one row with its weights
// swapped here, so no read passes the end of value.
//
// Design: value (B, Lv, nh, c) is read in place (no head-major copy). One
// warp per (b, q, h), eight to a block (one query's heads when nh = 8, so
// the block's index and weight loads share L1 lines):
//   1. lane t loads pair t's start and weight pair (one load each across the
//      warp, up to 32 pairs at a time) and applies the last-row shift itself;
//   2. the pairs are broadcast with __shfl_sync, so every row load of the
//      query-head is independent of the others and all of them are in
//      flight at once (ppq = 24 is a compile-time case, fully unrolled; any
//      ppq >= 1 takes a runtime loop over chunks of 32 pairs. One body fully
//      unrolled over a whole chunk for every ppq was tried: it holds 16
//      pairs' rows a lane, 158-181 registers, and was slower than this one
//      at the training shapes, `PERF.md` section 6);
//   3. with c % 4 == 0 (and 16-byte aligned value and out) a half-warp covers
//      c <= 64 with one float4 a lane, the two half-warps take the even and
//      the odd pairs, and __shfl_xor_sync(., 16) adds their sums; otherwise
//      (c even) the whole warp covers c with float2 and takes every pair.
// Order of each output's sum, fixed (no atomics, so two calls are bitwise
// equal): S_even over the pairs j = 0, 2, 4, ... in turn and S_odd over
// j = 1, 3, 5, ..., each pair adding fma(wa, row i) then fma(wb, row i + 1);
// out = S_even + S_odd (float4 path). The float2 path sums every j in turn.
//
// bf16 value (`tamtr_tpu/kernels/deform_scatter.py:203-204, 259-263`): the
// rows are read half-width (four bf16 a lane on the float4 path, two on
// the float2 path) and widened in registers; the weights and the sums are
// fp32, in the order above, and out is rounded to bf16 once, at its store.
//
// Bound on the card: by bytes, the value rows the sample points touch plus
// the indices, weights and output; at the serve shape (B = 1, Q = 100,
// nh = 8, ppq = 24) ~8 MB, ~2.4 us at 3.35 TB/s, under what one launch
// costs; at the training shape (B = 4, Q = 700) ~0.13 GB of value's 275 MB
// on uniform pairs, ~40 us (`chip_smoke.py:gather_fwd_bound`). The first
// design ran each pair as a chain (a scalar index load, then its two row
// loads), four chains in flight a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kModelPairs = 24;  // the model's ppq: 3 levels x 4 points x 2 rows

__device__ __forceinline__ void fma_row(float4& acc, float w, const float4& r) {
  acc.x = fmaf(w, r.x, acc.x);
  acc.y = fmaf(w, r.y, acc.y);
  acc.z = fmaf(w, r.z, acc.z);
  acc.w = fmaf(w, r.w, acc.w);
}
__device__ __forceinline__ void fma_row(float2& acc, float w, const float2& r) {
  acc.x = fmaf(w, r.x, acc.x);
  acc.y = fmaf(w, r.y, acc.y);
}
__device__ __forceinline__ float4 add_half(float4 a) {  // a + the other half-warp's a
  a.x += __shfl_xor_sync(0xffffffffu, a.x, 16);
  a.y += __shfl_xor_sync(0xffffffffu, a.y, 16);
  a.z += __shfl_xor_sync(0xffffffffu, a.z, 16);
  a.w += __shfl_xor_sync(0xffffffffu, a.w, 16);
  return a;
}
__device__ __forceinline__ float2 add_half(float2 a) { return a; }  // one group: nothing to add

template <int kVec> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };

// a row's kVec elements at p as floats, and back (rounded once for bf16).
// A bf16 is the high half of its float: the two of a 32-bit word widen by
// a shift and a mask, in registers.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ void load_row(float4& r, const float* p) { r = *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void load_row(float2& r, const float* p) { r = *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void load_row(float4& r, const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  r = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
}
__device__ __forceinline__ void load_row(float2& r, const __nv_bfloat16* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  r = make_float2(bf16_lo(w), bf16_hi(w));
}
__device__ __forceinline__ void store_row(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store_row(float* p, const float2& v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float4& v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float2& v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// kVec elements a lane (4: half-warps split the pairs; 2: the whole warp);
// kP pairs per query at compile time, 0 for a runtime ppq; E the element
// type of value and out.
template <int kVec, int kP, typename E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) bilinear_gather_fwd_kernel(
    const E* __restrict__ value, const int* __restrict__ idx2,
    const float* __restrict__ w_pairs, E* __restrict__ out,
    int B, int Lv, int nh, int c, int Q, int ppq) {
  using V = typename VecOf<kVec>::T;
  constexpr int kLanesPerRow = 64 / kVec;     // lanes covering c <= 64
  constexpr int kGroups = 32 / kLanesPerRow;  // groups splitting the pairs: 2 or 1
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (warp >= (long long)B * Q * nh) return;
  const int lane = threadIdx.x % 32;
  const int grp = lane / kLanesPerRow;
  const int h = warp % nh;
  const long long bq = warp / nh;  // b * Q + q
  const int b = bq / Q;
  const int ch = kVec * (lane % kLanesPerRow);
  const bool active = ch < c;
  const long long row_stride = (long long)nh * c;
  const E* v_b = value + (long long)b * Lv * row_stride + (long long)h * c + ch;
  const int P = kP > 0 ? kP : ppq;
  const long long u0 = bq * P;  // (b * Q + q) * ppq == b * nU2 + q * ppq

  V acc = {};
  for (int j0 = 0; j0 < P; j0 += 32) {
    // 1. lane t holds pair j0 + t, shifted off the global last row
    int i = 0;
    float wa = 0.f, wb = 0.f;
    if (j0 + lane < P) {
      const long long p = (u0 + j0 + lane) * nh + h;
      i = idx2[p];
      const float2 w = *reinterpret_cast<const float2*>(w_pairs + 2 * p);
      wa = w.x;
      wb = w.y;
      if (i >= Lv - 1) {  // read rows Lv-2, Lv-1 instead
        i = Lv - 2;
        wa = w.y;
        wb = w.x;
      }
    }
    const int n = min(32, P - j0);
    // 2-3. group g takes pairs j0 + g, j0 + g + kGroups, ...; all row loads
    // go out before the sums
    if constexpr (kP > 0) {
      constexpr int kK = (kP < 32 ? kP : 32) / kGroups;  // pairs per group in a chunk
      static_assert(kP % kGroups == 0 && kP <= 32, "the compile-time case is one chunk");
      V r0[kK], r1[kK];
      float a[kK], bw[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const int src = kGroups * k + grp;
        const int ii = __shfl_sync(0xffffffffu, i, src);
        a[k] = __shfl_sync(0xffffffffu, wa, src);
        bw[k] = __shfl_sync(0xffffffffu, wb, src);
        if (active) {
          load_row(r0[k], v_b + (long long)ii * row_stride);
          load_row(r1[k], v_b + (long long)(ii + 1) * row_stride);
        }
      }
      if (active) {
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          fma_row(acc, a[k], r0[k]);
          fma_row(acc, bw[k], r1[k]);
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < n; k += kGroups) {
        const int src = k + grp;  // past n only in the last step of an odd chunk
        const int ii = __shfl_sync(0xffffffffu, i, src);
        const float a = __shfl_sync(0xffffffffu, wa, src);
        const float bw = __shfl_sync(0xffffffffu, wb, src);
        if (active && src < n) {
          V r0, r1;
          load_row(r0, v_b + (long long)ii * row_stride);
          load_row(r1, v_b + (long long)(ii + 1) * row_stride);
          fma_row(acc, a, r0);
          fma_row(acc, bw, r1);
        }
      }
    }
  }
  acc = add_half(acc);
  if (active && grp == 0) store_row(out + warp * c + ch, acc);
}

template <int kVec, typename E>
cudaError_t launch(const E* value, const int* idx2, const float* w_pairs, E* out, int B,
                   int Lv, int nh, int c, int Q, int ppq, cudaStream_t stream) {
  const long long warps = (long long)B * Q * nh;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (ppq == kModelPairs)
    bilinear_gather_fwd_kernel<kVec, kModelPairs, E><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq);
  else
    bilinear_gather_fwd_kernel<kVec, 0, E><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_any(const E* value, const int* idx2, const float* w_pairs, E* out, int B, int Lv, int nh,
                       int c, int Q, int ppq, cudaStream_t s) {
  const bool vec4 = c % 4 == 0 && ((uintptr_t)value % 16) == 0 && ((uintptr_t)out % 16) == 0;
  return vec4 ? launch<4>(value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq, s)
              : launch<2>(value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq, s);
}

}  // namespace

// c even and <= 64, Lv >= 2, ppq >= 1; w_pairs 8-byte aligned; value and
// out float (bf16 == 0) or bf16.
extern "C" int bilinear_gather_fwd(
    const void* value, const int* idx2, const float* w_pairs, void* out,
    int B, int Lv, int nh, int c, int Q, int ppq, int bf16, void* stream) {
  if (c % 2 != 0 || c > 64 || Lv < 2 || B < 1 || Q < 1 || nh < 1 || ppq < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  using H = __nv_bfloat16;
  return (int)(bf16 ? launch_any((const H*)value, idx2, w_pairs, (H*)out, B, Lv, nh, c, Q, ppq, s)
                    : launch_any((const float*)value, idx2, w_pairs, (float*)out, B, Lv, nh, c, Q, ppq, s));
}
