// Deformable-attention bilinear pair gather, backward: two launches, no
// float atomics, every dvalue row written once; value, dout and dvalue in
// fp32 or bf16, the sums and dw in fp32.
//
// Replaces the TPU kernel
// `tamtr_tpu/kernels/deform_scatter.py:_scatter_dw_pairs_kernel` (launched by
// `_scatter_dw_acc_pairs`, reached through `_bilinear_bwd`). The forward
// (`bilinear_gather_fwd.cu`) is, for each batch b, query q and head h,
//     out[b, q, h, :] = sum_{j < ppq} wa * value[b, i, h, :] + wb * value[b, i + 1, h, :]
// with u = q * ppq + j, i = idx2[b, u, h], (wa, wb) = w_pairs[b, u, h, :].
// Given dout (B, Q, nh, c) the backward is
//     dvalue[b, i]     += wa * dout[b, q, h]      dvalue[b, i + 1] += wb * dout[b, q, h]
//     dw[b, u, h, 0]    = value[b, i] . dout[b, q, h]
//     dw[b, u, h, 1]    = value[b, i + 1] . dout[b, q, h]
// A pair that starts on the global last row Lv-1 is shifted up one row with
// its weights swapped, as in the forward, and its dw is swapped back, so dw
// is in the caller's slot order.
//
// The TPU kernel walks the pairs of one (b, h) in order and adds each pair's
// two updates into a VMEM block. On the card, a scatter from the pairs' side
// needs atomics into a zeroed (B, Lv, nh, c) output (275 MB at 640 px, 5.5x
// the L2), and the order of their adds changes from run to run. This design
// turns the scatter into a gather from the rows' side, with every row's sum
// in a fixed order, on the two launches of `row_buckets.cuh` (shared with
// the row and pair scatters B7 and B8) under B4's rule: pairs, the last-row
// shift, and dw:
//   1. `buckets_kernel`: `order` (B, nh, nU2) is the pair ids sorted stably
//      by shifted start row, the sort of each (b, h) spread over a cluster
//      of blocks; the row offsets (B, nh, Lv + 1); the rows of more than 16
//      terms listed in segments of 32; `pair_w` the pairs' (wa, wb) in
//      bucket order.
//   2. `rows_kernel`. A row's terms, in a fixed order: wa dout over bucket r
//      (the pairs whose first row is r) in pair order, then wb dout over
//      bucket r - 1 (second row r) in pair order, long rows (a training
//      step's decoder puts hundreds of pairs on a few hundred rows of the
//      coarse level) in segments summed from zero and added in turn; so
//      `bilinear_gather_bwd_rows_ref` transcribes the sums bitwise. Each row
//      is written once, zeros where no pair touches it, so the output needs
//      no zero fill. A touched row (or segment) loads value[b, r, h] once
//      and writes each of its pairs' dw slot for row r.
// dvalue is bitwise repeatable; value rows are read once per segment and
// only where touched; dvalue and dw are written once.
//
// bf16 (`tamtr_tpu/kernels/deform_scatter.py:289-297, 322, 439-458`):
// value and dout are read in bf16 and widened, every term and sum is fp32
// (the same order as at fp32), and each dvalue row is rounded to bf16 once,
// at its store, as the TPU kernel's fp32 scratch rounds once; dw is fp32.
//
// Bound on the card: by bytes: the touched value rows, dout, idx2 and
// w_pairs read once, dvalue (the whole (B, Lv, nh, c) block) and dw written
// once; at 640 px, Q=700 and batch 4 about 0.41 GB, 0.123 ms at 3.35 TB/s.
// The buckets add ~11 MB of traffic (offsets, order, pair_w). What holds the
// rows pass back: the touched rows are scattered, and each term waits on a
// dependent L2 load of its dout row.

#include "row_buckets.cuh"

namespace {

using B4Rule = Rule</*pairs=*/true, /*skip=*/false, /*dw=*/true>;

}  // namespace

// Launch 1. idx2 (B, nU2, nh) int32, w_pairs (B, nU2, nh, 2) fp32 ->
// offsets (B, nh, Lv + 1) int32, order (B, nh, nU2) int32, pair_w
// (B, nh, nU2, 2) fp32, and the long rows' segments: items (B nh ceil(nU2 /
// 8), 4) int32 with their count n_items (1,) int32, done (as items' rows)
// int32. Scratch: bufs (B nh, 2, nU2, 2) and keys (B nh, nU2) int32.
extern "C" int pair_buckets(const int* idx2, const float* w_pairs, int* offsets, int* order, float* pair_w,
                            int* items, int* done, int* n_items, int* bufs, int* keys, int B, int nU2, int nh,
                            int Lv, void* stream) {
  if (B < 1 || nU2 < 1 || nh < 1 || Lv < 2) return (int)cudaErrorInvalidValue;
  const BucketArgs a{idx2, w_pairs, w_pairs + 1, 2, offsets, order, pair_w, reinterpret_cast<int4*>(items), done,
                     n_items, reinterpret_cast<int2*>(bufs), keys, nU2, nh, Lv, Lv, 0, 0, 0, 0};
  return (int)launch_buckets<B4Rule>(a, B * nh, (cudaStream_t)stream);
}

// Launch 2, on launch 1's buckets and segments; partials (as items' rows,
// c) fp32 scratch. dvalue (B, Lv, nh, c) and dw (B, nU2, nh, 2) are written
// in full. value, dout and dvalue are float (bf16 == 0) or bf16; dw float.
extern "C" int bilinear_gather_bwd(const void* value, const int* idx2, const void* dout, const int* offsets,
                                   const int* order, const float* pair_w, const int* items, int* done,
                                   const int* n_items, float* partials, void* dvalue, float* dw, int B, int Lv,
                                   int nh, int c, int Q, int ppq, int bf16, void* stream) {
  if (Lv < 2 || B < 1) return (int)cudaErrorInvalidValue;
  RowArgs a{value, idx2, dout, offsets, order, pair_w, reinterpret_cast<const int4*>(items), done, n_items,
            partials, dvalue, dw, B * nh, Lv, Lv, nh, c, c, Q, ppq, 0.f, 0};
  return (int)(bf16 ? launch_rows<B4Rule, __nv_bfloat16>(a, (cudaStream_t)stream)
                    : launch_rows<B4Rule, float>(a, (cudaStream_t)stream));
}
