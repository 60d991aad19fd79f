// Deformable-attention bilinear pair gather, forward, fp32.
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
// Bound on the card: by bytes, the value rows the sample points touch plus
// the indices, weights and output; at the serve shape (B = 1, Q = 100,
// nh = 8, ppq = 24) ~8 MB, ~2.4 us at 3.35 TB/s, under what one launch
// costs; at the training shape (B = 4, Q = 700) ~0.13 GB of value's 275 MB
// on uniform pairs, ~40 us (`chip_smoke.py:gather_fwd_bound`). The first
// design ran each pair as a chain (a scalar index load, then its two row
// loads), four chains in flight a warp.

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

// kVec floats a lane (4: half-warps split the pairs; 2: the whole warp);
// kP pairs per query at compile time, 0 for a runtime ppq.
template <int kVec, int kP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) bilinear_gather_fwd_kernel(
    const float* __restrict__ value, const int* __restrict__ idx2,
    const float* __restrict__ w_pairs, float* __restrict__ out,
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
  const float* v_b = value + (long long)b * Lv * row_stride + (long long)h * c + ch;
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
          r0[k] = *reinterpret_cast<const V*>(v_b + (long long)ii * row_stride);
          r1[k] = *reinterpret_cast<const V*>(v_b + (long long)(ii + 1) * row_stride);
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
          const V r0 = *reinterpret_cast<const V*>(v_b + (long long)ii * row_stride);
          const V r1 = *reinterpret_cast<const V*>(v_b + (long long)(ii + 1) * row_stride);
          fma_row(acc, a, r0);
          fma_row(acc, bw, r1);
        }
      }
    }
  }
  acc = add_half(acc);
  if (active && grp == 0) *reinterpret_cast<V*>(out + warp * c + ch) = acc;
}

template <int kVec>
cudaError_t launch(const float* value, const int* idx2, const float* w_pairs, float* out, int B,
                   int Lv, int nh, int c, int Q, int ppq, cudaStream_t stream) {
  const long long warps = (long long)B * Q * nh;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (ppq == kModelPairs)
    bilinear_gather_fwd_kernel<kVec, kModelPairs><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq);
  else
    bilinear_gather_fwd_kernel<kVec, 0><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq);
  return cudaGetLastError();
}

}  // namespace

// c even and <= 64, Lv >= 2, ppq >= 1; w_pairs 8-byte aligned.
extern "C" int bilinear_gather_fwd(
    const float* value, const int* idx2, const float* w_pairs, float* out,
    int B, int Lv, int nh, int c, int Q, int ppq, void* stream) {
  if (c % 2 != 0 || c > 64 || Lv < 2 || B < 1 || Q < 1 || nh < 1 || ppq < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = c % 4 == 0 && ((uintptr_t)value % 16) == 0 && ((uintptr_t)out % 16) == 0;
  return (int)(vec4 ? launch<4>(value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq, s)
                    : launch<2>(value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq, s));
}
