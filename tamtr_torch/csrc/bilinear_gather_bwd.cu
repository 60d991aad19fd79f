// Deformable-attention bilinear pair gather, backward, fp32.
//
// Replaces the TPU kernel
// `tamtr_tpu/kernels/deform_scatter.py:_scatter_dw_pairs_kernel` (launched by
// `_scatter_dw_acc_pairs`, reached through `_bilinear_bwd`). The forward
// (`bilinear_gather_fwd.cu`) is, for each batch b, query q and head h,
//     out[b, q, h, :] = sum_{j < ppq} wa * value[b, i, h, :] + wb * value[b, i + 1, h, :]
// with u = q * ppq + j, i = idx2[b, u, h], (wa, wb) = w_pairs[b, u, h, :].
// Given dout (B, Q, nh, c), one pass computes
//     dvalue[b, i]     += wa * dout[b, q, h]      dvalue[b, i + 1] += wb * dout[b, q, h]
//     dw[b, u, h, 0]    = value[b, i] . dout[b, q, h]
//     dw[b, u, h, 1]    = value[b, i + 1] . dout[b, q, h]
// A pair that starts on the global last row Lv-1 is shifted up one row with
// its weights swapped, as in the forward, and its dw is swapped back, so dw
// is in the caller's slot order. (The JAX package's custom_vjp runs its
// Pallas backward on the unshifted indices; this kernel does not.)
//
// Design: one warp per (b, q, h), each lane owning two channels, as in the
// forward; value and dvalue are (B, Lv, nh, c) in place. The dout row is
// loaded once per warp. dw is a warp-shuffle dot product per pair row.
// dvalue is scattered with fp32 atomicAdd into a zeroed output: rows shared
// by many sample points are summed in an order that changes from run to
// run, so dvalue is not bitwise deterministic (dw is).
//
// Bound on the card: by bytes: the value rows the sample points touch read
// once, dout, idx2 and w_pairs read once, dvalue (the whole (B, Lv, nh, c)
// block) and dw written once; at 640 px, Q=700 and batch 4 that is ~0.3 GB,
// ~0.1 ms at 3.35 TB/s. The atomics to the same rows and the dependent
// index-then-row loads make this simple design latency bound.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32) bilinear_gather_bwd_kernel(
    const float* __restrict__ value, const int* __restrict__ idx2,
    const float* __restrict__ w_pairs, const float* __restrict__ dout,
    float* __restrict__ dvalue, float* __restrict__ dw,
    int B, int Lv, int nh, int c, int Q, int ppq) {
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (warp >= (long long)B * Q * nh) return;
  const int lane = threadIdx.x % 32;
  const int h = warp % nh;
  const long long bq = warp / nh;  // b * Q + q
  const int b = bq / Q;
  const int ch = 2 * lane;
  const bool active = ch < c;
  const long long row_stride = (long long)nh * c;
  const long long off_b = (long long)b * Lv * row_stride + (long long)h * c + ch;
  const float* v_b = value + off_b;
  float* dv_b = dvalue + off_b;
  const float2 d = active ? *reinterpret_cast<const float2*>(dout + warp * c + ch)
                          : make_float2(0.f, 0.f);

  const long long u0 = bq * ppq;
  for (int jj = 0; jj < ppq; ++jj) {
    const long long p = (u0 + jj) * nh + h;
    int i = idx2[p];
    float wa = w_pairs[2 * p], wb = w_pairs[2 * p + 1];
    const bool shifted = i >= Lv - 1;
    if (shifted) {  // global last row: rows Lv-2, Lv-1 with the weights swapped
      i = Lv - 2;
      const float t = wa;
      wa = wb;
      wb = t;
    }
    float s0 = 0.f, s1 = 0.f;
    if (active) {
      const float2 r0 = *reinterpret_cast<const float2*>(v_b + (long long)i * row_stride);
      const float2 r1 = *reinterpret_cast<const float2*>(v_b + (long long)(i + 1) * row_stride);
      s0 = r0.x * d.x + r0.y * d.y;
      s1 = r1.x * d.x + r1.y * d.y;
      float* a0 = dv_b + (long long)i * row_stride;
      float* a1 = a0 + row_stride;
      atomicAdd(a0, wa * d.x);
      atomicAdd(a0 + 1, wa * d.y);
      atomicAdd(a1, wb * d.x);
      atomicAdd(a1 + 1, wb * d.y);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      dw[2 * p] = shifted ? s1 : s0;
      dw[2 * p + 1] = shifted ? s0 : s1;
    }
  }
}

}  // namespace

// dvalue must arrive zeroed; dw (B, nU2, nh, 2) is written in full.
extern "C" int bilinear_gather_bwd(
    const float* value, const int* idx2, const float* w_pairs, const float* dout,
    float* dvalue, float* dw, int B, int Lv, int nh, int c, int Q, int ppq, void* stream) {
  if (c % 2 != 0 || c > 64 || Lv < 2 || B < 1 || Q < 1 || nh < 1 || ppq < 1)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * Q * nh;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  bilinear_gather_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      value, idx2, w_pairs, dout, dvalue, dw, B, Lv, nh, c, Q, ppq);
  return (int)cudaGetLastError();
}
