// Row and pair scatter-accumulate, fp32: the backward of the generic
// weighted gather (kernel B7) and the pair scatter without dw (kernel B8),
// each two launches with no float atomics, every output row written once.
//
// scatter_acc (B7) replaces the TPU kernel
// `tamtr_tpu/kernels/deform_scatter.py:_scatter_kernel` (launched by
// `_scatter_acc`, reached through the backward of `weighted_gather`). The
// forward `out[b, q, h] = sum_{j < p4} w[b, u, h] value[b, idx[b, u, h], h]`,
// u = q p4 + j, has the value gradient
//     dvalue[b, idx[b, u, h], h, :] += w[b, u, h] * dout[b, q, h, :]
// JAX's kernel works head-major on (B nh, L, c) copies; this one reads idx,
// w (B, nU, nh) and dout (B, Q, nh, c) and writes dvalue (B, L, nh, c).
//
// scatter_acc_pairs (B8) replaces the TPU kernel
// `tamtr_tpu/kernels/deform_scatter.py:_scatter_pairs_kernel` (launched by
// `_scatter_acc_pairs`): for every group g and pair u of query
// q = u / (nU2 / Q),
//     out[g, idx2[g, u]]     += wa[g, u] * dout[g, q, :]
//     out[g, idx2[g, u] + 1] += wb[g, u] * dout[g, q, :]
// with idx2, wa, wb (G, nU2), dout (G, Q, c), out (G, L2, c): the value half
// of the gather backward B4 with one head, no dw and no last-row shift.
//
// A row outside the output is skipped, never written: B7's idx outside
// [0, L); B8's rows outside [0, L2), so a start of L2 - 1 writes row L2 - 1
// only and a start of -1 row 0 only.
//
// The TPU kernels add one update at a time, in update order, into a VMEM
// block. Both run here on the two launches of `row_buckets.cuh`, which B4
// uses too: the buckets launch sorts each group's updates stably by first
// row (a radix sort spread over a cluster of blocks) and lists the rows of
// more than 16 terms in 32-term segments; the rows pass sums each row in a
// fixed order and writes it once, zeros where no update lands, so the
// output needs no zero fill and is bitwise repeatable:
//   - B7: row r sums w dout over its updates in update order u (within a
//     segment, the TPU kernel's own order);
//   - B8: row r sums wa dout over the pairs starting on r, then wb dout
//     over those starting on r - 1, each in pair order;
// in segments of 32 terms summed from zero and added in turn, every product
// and add __fmul_rn / __fadd_rn, as `scatter_acc_rows_ref` and
// `scatter_acc_pairs_rows_ref` (kernels/deform_scatter.py) transcribe.
// Launch 2 takes c <= 64 channels of rows whose stride is cs; the wrapper
// launches it once per 64 channels.
//
// Bound on the card: by bytes: the whole output written once, dout, the
// indices and the weights read once; at the 640 px decoder shapes (B7: value
// (4, 33600, 8, 64), Q = 700, p4 = 48; B8: G = 32, L2 = 33600, c = 64,
// Q = 700, 24 pairs per query) ~0.29 GB, ~0.09 ms at 3.35 TB/s. The buckets
// add 11-13 MB of traffic (offsets, order, weights in bucket order; the
// sort's passes stay in L2). What holds the rows pass back: each term waits on a
// dependent L2 load of its dout row.

#include "row_buckets.cuh"

namespace {

using RowsRule = Rule</*pairs=*/false, /*skip=*/true, /*dw=*/false>;   // B7
using PairsRule = Rule</*pairs=*/true, /*skip=*/true, /*dw=*/false>;   // B8

}  // namespace

// B7 launch 1. idx (B, n, nh) int32, w (B, n, nh) fp32 -> offsets
// (B, nh, L + 1) int32, order (B, nh, n) int32, upd_w (B, nh, n) fp32 (w in
// bucket order), and the long rows' segments: items (B nh ceil(n / 8), 4)
// int32 with their count n_items (1,), done (as items' rows) int32.
// Scratch: bufs (B nh, 2, n, 2) and keys (B nh, n) int32.
extern "C" int scatter_acc_buckets(const int* idx, const float* w, int* offsets, int* order, float* upd_w,
                                   int* items, int* done, int* n_items, int* bufs, int* keys, int B, int n, int nh,
                                   int L, void* stream) {
  if (B < 1 || n < 1 || nh < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const BucketArgs a{idx, w, nullptr, 1, offsets, order, upd_w, reinterpret_cast<int4*>(items), done, n_items,
                     reinterpret_cast<int2*>(bufs), keys, n, nh, L, L, 0, 0, 0, 0};
  return (int)launch_buckets<RowsRule>(a, B * nh, (cudaStream_t)stream);
}

// B8 launch 1. idx2, wa, wb (G, n) -> offsets (G, L2 + 2) int32 (bucket
// s + 1 holds the pairs starting on s), order (G, n) int32, upd_w (G, n, 2)
// fp32 ((wa, wb) in bucket order), the segments and scratch as B7's.
extern "C" int scatter_acc_pairs_buckets(const int* idx2, const float* wa, const float* wb, int* offsets,
                                         int* order, float* upd_w, int* items, int* done, int* n_items, int* bufs,
                                         int* keys, int G, int n, int L2, void* stream) {
  if (G < 1 || n < 1 || L2 < 1) return (int)cudaErrorInvalidValue;
  const BucketArgs a{idx2, wa, wb, 1, offsets, order, upd_w, reinterpret_cast<int4*>(items), done, n_items,
                     reinterpret_cast<int2*>(bufs), keys, n, 1, L2, L2 + 1, 0, 0, 0, 0};
  return (int)launch_buckets<PairsRule>(a, G, (cudaStream_t)stream);
}

// Launch 2 of either, on its launch 1's buckets and segments: dout
// (B, Q, nh, cs) -> out (B, rows, nh, cs), channels [0, c), both float
// (bf16 == 0) or bf16 (read widened, summed in fp32, each row rounded once
// at its store), partials (as items' rows, c) fp32 scratch. Every row is
// written. B8's groups are its G rows of (G, Q, c): B = G, nh = 1.
static int rows_pass(bool pairs, const void* dout, const int* offsets, const int* order, const float* upd_w,
                     const int* items, int* done, const int* n_items, float* partials, void* out, int B, int rows,
                     int nh, int c, int cs, int Q, int ppq, int bf16, void* stream) {
  if (B < 1 || nh < 1) return (int)cudaErrorInvalidValue;
  RowArgs a{nullptr, nullptr, dout, offsets, order, upd_w, reinterpret_cast<const int4*>(items), done, n_items,
            partials, out, nullptr, B * nh, rows, rows + (pairs ? 1 : 0), nh, c, cs, Q, ppq, 0.f, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  using H = __nv_bfloat16;
  if (pairs) return (int)(bf16 ? launch_rows<PairsRule, H>(a, s) : launch_rows<PairsRule, float>(a, s));
  return (int)(bf16 ? launch_rows<RowsRule, H>(a, s) : launch_rows<RowsRule, float>(a, s));
}

extern "C" int scatter_acc(const void* dout, const int* offsets, const int* order, const float* upd_w,
                           const int* items, int* done, const int* n_items, float* partials, void* dvalue, int B,
                           int L, int nh, int c, int cs, int Q, int p4, int bf16, void* stream) {
  return rows_pass(false, dout, offsets, order, upd_w, items, done, n_items, partials, dvalue, B, L, nh, c, cs, Q, p4,
                   bf16, stream);
}

extern "C" int scatter_acc_pairs(const void* dout, const int* offsets, const int* order, const float* upd_w,
                                 const int* items, int* done, const int* n_items, float* partials, void* out, int G,
                                 int L2, int nh, int c, int cs, int Q, int per_q, int bf16, void* stream) {
  return rows_pass(true, dout, offsets, order, upd_w, items, done, n_items, partials, out, G, L2, nh, c, cs, Q,
                   per_q, bf16, stream);
}
