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
// warp per (b, q, h); each lane owns two channels as a float2, loops over the
// ppq pairs and writes its part of the output row once.
//
// Bound on the card: by bytes, the value rows the sample points touch plus
// the indices and weights; at 640 px (Q=100, nh=8, ppq=24) that is a few MB,
// a few microseconds at 3.35 TB/s. The dependent index-then-row loads make
// this simple design latency bound.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32) bilinear_gather_fwd_kernel(
    const float* __restrict__ value, const int* __restrict__ idx2,
    const float* __restrict__ w_pairs, float* __restrict__ out,
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
  const float* v_b = value + (long long)b * Lv * row_stride + (long long)h * c + ch;

  float2 acc = make_float2(0.f, 0.f);
  const long long u0 = bq * ppq;  // (b * Q + q) * ppq == b * nU2 + q * ppq
#pragma unroll 4
  for (int jj = 0; jj < ppq; ++jj) {
    const long long p = (u0 + jj) * nh + h;
    int i = idx2[p];
    float wa = w_pairs[2 * p], wb = w_pairs[2 * p + 1];
    if (i >= Lv - 1) {  // global last row: read rows Lv-2, Lv-1 instead
      i = Lv - 2;
      const float t = wa;
      wa = wb;
      wb = t;
    }
    if (active) {
      const float2 r0 = *reinterpret_cast<const float2*>(v_b + (long long)i * row_stride);
      const float2 r1 = *reinterpret_cast<const float2*>(v_b + (long long)(i + 1) * row_stride);
      acc.x += wa * r0.x + wb * r1.x;
      acc.y += wa * r0.y + wb * r1.y;
    }
  }
  if (active) *reinterpret_cast<float2*>(out + warp * c + ch) = acc;
}

}  // namespace

extern "C" int bilinear_gather_fwd(
    const float* value, const int* idx2, const float* w_pairs, float* out,
    int B, int Lv, int nh, int c, int Q, int ppq, void* stream) {
  if (c % 2 != 0 || c > 64 || Lv < 2 || B < 1 || Q < 1 || nh < 1 || ppq < 1)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * Q * nh;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  bilinear_gather_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      value, idx2, w_pairs, out, B, Lv, nh, c, Q, ppq);
  return (int)cudaGetLastError();
}
