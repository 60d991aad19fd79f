// Row and pair scatter-accumulate, fp32: the backward of the generic
// weighted gather (kernel B7) and the pair scatter without dw (kernel B8).
//
// scatter_acc (B7) replaces the TPU kernel
// `tamtr_tpu/kernels/deform_scatter.py:_scatter_kernel` (launched by
// `_scatter_acc`, reached through the backward of `weighted_gather`). The
// forward `out[b, q, h] = sum_{j < p4} w[b, u, h] value[b, idx[b, u, h], h]`,
// u = q p4 + j, has the value gradient
//     dvalue[b, idx[b, u, h], h, :] += w[b, u, h] * dout[b, q, h, :]
// JAX's kernel works head-major on (B nh, L, c) copies; this one reads idx,
// w (B, nU, nh) and dout (B, Q, nh, c) and writes dvalue (B, L, nh, c) in
// place.
//
// scatter_acc_pairs (B8) replaces the TPU kernel
// `tamtr_tpu/kernels/deform_scatter.py:_scatter_pairs_kernel` (launched by
// `_scatter_acc_pairs`): for every group g and pair u of query
// q = u / (nU2 / Q),
//     out[g, idx2[g, u]]     += wa[g, u] * dout[g, q, :]
//     out[g, idx2[g, u] + 1] += wb[g, u] * dout[g, q, :]
// with idx2, wa, wb (G, nU2), dout (G, Q, c), out (G, L2, c).
//
// Indices are the caller's to keep in range ([0, L) for B7, pair starts in
// [0, L2 - 1) for B8); a row outside the output is skipped, never written.
//
// Design: one warp per (b, q, head) for B7 and per (g, q) for B8, as the
// gather backward B4 (`bilinear_gather_bwd.cu`): the warp walks the query's
// updates, its lanes over the channels, and adds into a zeroed output with
// fp32 atomicAdd. Rows shared by several updates are summed in an order that
// changes from run to run, so neither output is bitwise deterministic (the
// TPU kernels, which add one update at a time, are).
//
// Bound on the card: by bytes: the whole output written once (it is zeroed,
// then every row any update reaches is added to), dout, the indices and the
// weights read once; at the 640 px decoder shapes (B7: value
// (4, 33600, 8, 64), Q = 700, p4 = 48; B8: G = 32, L2 = 33600, c = 64,
// Q = 700, 24 pairs per query) ~0.29 GB, ~0.09 ms at 3.35 TB/s. The
// zeroing pass and the dependent index-then-atomic chains make this simple
// design latency bound.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32) scatter_acc_kernel(
    const int* __restrict__ idx, const float* __restrict__ w, const float* __restrict__ dout,
    float* __restrict__ dvalue, int B, int L, int nh, int c, int Q, int p4) {
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (warp >= (long long)B * Q * nh) return;
  const int lane = threadIdx.x % 32;
  const int h = warp % nh;
  const long long bq = warp / nh;  // b * Q + q
  const long long b = bq / Q;
  const long long row_stride = (long long)nh * c;
  const float* d_row = dout + warp * c;
  float* dv_b = dvalue + b * L * row_stride + (long long)h * c;
  for (int j = 0; j < p4; ++j) {
    const long long p = (bq * p4 + j) * nh + h;
    const int i = idx[p];
    if ((unsigned)i >= (unsigned)L) continue;
    const float wt = w[p];
    float* row = dv_b + (long long)i * row_stride;
    for (int ch = lane; ch < c; ch += 32) atomicAdd(row + ch, wt * d_row[ch]);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32) scatter_acc_pairs_kernel(
    const int* __restrict__ idx2, const float* __restrict__ wa, const float* __restrict__ wb,
    const float* __restrict__ dout, float* __restrict__ out, int G, int L2, int c, int Q,
    int per_q) {
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (warp >= (long long)G * Q) return;
  const int lane = threadIdx.x % 32;
  const long long g = warp / Q;
  const float* d_row = dout + warp * c;
  float* out_g = out + g * L2 * c;
  for (int j = 0; j < per_q; ++j) {
    const long long p = warp * per_q + j;  // g * nU2 + q * per_q + j
    const int i = idx2[p];
    const float a = wa[p], bw = wb[p];
    const bool in0 = (unsigned)i < (unsigned)L2, in1 = (unsigned)(i + 1) < (unsigned)L2;
    float* r0 = out_g + (long long)i * c;
    for (int ch = lane; ch < c; ch += 32) {
      const float v = d_row[ch];
      if (in0) atomicAdd(r0 + ch, a * v);
      if (in1) atomicAdd(r0 + c + ch, bw * v);
    }
  }
}

unsigned blocks_for(long long warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// dvalue (B, L, nh, c) must arrive zeroed.
extern "C" int scatter_acc(const int* idx, const float* w, const float* dout, float* dvalue, int B,
                           int L, int nh, int c, int Q, int p4, void* stream) {
  if (B < 1 || L < 1 || nh < 1 || c < 1 || Q < 1 || p4 < 1) return (int)cudaErrorInvalidValue;
  scatter_acc_kernel<<<blocks_for((long long)B * Q * nh), kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(idx, w, dout, dvalue, B, L, nh, c, Q, p4);
  return (int)cudaGetLastError();
}

// out (G, L2, c) must arrive zeroed.
extern "C" int scatter_acc_pairs(const int* idx2, const float* wa, const float* wb,
                                 const float* dout, float* out, int G, int L2, int c, int Q,
                                 int per_q, void* stream) {
  if (G < 1 || L2 < 1 || c < 1 || Q < 1 || per_q < 1) return (int)cudaErrorInvalidValue;
  scatter_acc_pairs_kernel<<<blocks_for((long long)G * Q), kWarpsPerBlock * 32, 0,
                             (cudaStream_t)stream>>>(idx2, wa, wb, dout, out, G, L2, c, Q, per_q);
  return (int)cudaGetLastError();
}
