"""Deformable-attention gathers and scatters: CUDA kernels and plain versions.

Forward: `bilinear_gather` replaces the TPU kernel
`tamtr_tpu/kernels/deform_scatter.py:_gather_pairs_kernel` (via
`_gather_acc_pairs` and `bilinear_gather`). On a CUDA tensor it launches
`csrc/bilinear_gather_fwd.cu`, which reads the pair starts `idx2`; on a CPU
tensor it runs `bilinear_gather_ref`, the plain 4-corner gather of
`_gather_fwd_impl`, which reads the corner indices `idx4`;
`bilinear_gather_pairs_ref` is the same sum in the pair form the kernel
reads, from `idx2` alone.

Backward: `bilinear_gather` is a `torch.autograd.Function` whose backward is
`bilinear_gather_bwd`, replacing `_scatter_dw_pairs_kernel` (via
`_scatter_dw_acc_pairs` and `_bilinear_bwd`) with the two launches of
`csrc/bilinear_gather_bwd.cu` on CUDA tensors: `pair_buckets` sorts each
(b, h)'s pairs stably by shifted start row, then each dvalue row sums its
terms in a fixed order (the pairs starting on it, then those starting on
the row above, each in pair order; a row of more than `SEG_TERMS` terms in
segments of that many, their sums added in turn) and is written once, with
its pairs' dw. `pair_buckets_ref` and `bilinear_gather_bwd_rows_ref`
transcribe the two launches (the rows bitwise); on CPU tensors the backward
is `bilinear_gather_bwd_ref`, the plain scatter-add form, which adds in the
same order and so equals the kernel bitwise on every row of at most
`SEG_TERMS` terms.
All apply the last-row shift of the forward and swap dw back for shifted
pairs, so gradients reach the value and the weights of the pair the caller
gave.

Generic gather: `weighted_gather` (the JAX package's op of that name) is a
`torch.autograd.Function` whose forward is the plain 4-corner gather and
einsum (XLA in the JAX package too) and whose backward scatters dvalue with
`scatter_acc`, replacing `_scatter_kernel` (via `_scatter_acc`): kernel B7 in
`csrc/deform_scatter.cu` on CUDA tensors, `scatter_acc_ref` on CPU ones.
`scatter_acc_pairs` replaces `_scatter_pairs_kernel` (via
`_scatter_acc_pairs`), kernel B8 in the same source; nothing in either
package calls it on a model path. B7 and B8 run on B4's two launches
(`csrc/row_buckets.cuh`): buckets (`scatter_acc_buckets`,
`scatter_acc_pairs_buckets`, transcribed by their `_ref`s), then each row
summed in a fixed order and written once (`scatter_acc_rows_ref`,
`scatter_acc_pairs_rows_ref`, bitwise). A row outside the output is skipped
by the kernels and the plain versions alike.

Arguments of `bilinear_gather`, as in the JAX package:
  value (B, Lv, nh, c) multi-level features; idx4 (B, Q*P*4, nh) clipped flat
  corner rows; w_pairs (B, Q*P*2, nh, 2) corner weights times attention
  weight, one pair per bilinear row, pre-swapped by the caller when x0 < 0;
  idx2 (B, Q*P*2, nh) pair starts (rows idx2 and idx2 + 1); P = levels x
  points per query and head. Returns (B, Q, nh, c). Gradients flow to value
  and w_pairs; the indices get none.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch

from tamtr_torch.kernels import _build
from tamtr_torch.kernels.selective_scan import _aligned

# terms of an output row summed as one sequence in B4, B7 and B8
# (`kSegTerms` in csrc/row_buckets.cuh); a longer row sums such segments in turn
SEG_TERMS = 32
# the rows pass takes at most this many channels a launch
ROW_CHANNELS = 64


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _shift_last_row(idx2: torch.Tensor, w_pairs: torch.Tensor, Lv: int):
    """A pair starting on the global last row moves up one row with its
    weights swapped, so its second row stays inside value (the kernels apply
    the same rule themselves). Also returns which pairs moved."""
    at_end = idx2 >= Lv - 1
    return (torch.where(at_end, Lv - 2, idx2), torch.where(at_end[..., None], w_pairs.flip(-1), w_pairs),
            at_end)


def bilinear_gather_ref(value, idx4, w_pairs, idx2, P: int) -> torch.Tensor:
    """Plain version: gather the 4 corners of every sample point and weight them."""
    B, Lv, nh, c = value.shape
    _, w_pairs, _ = _shift_last_row(idx2, w_pairs, Lv)
    nU = idx4.shape[1]
    w4 = w_pairs.transpose(2, 3).reshape(B, nU, nh)  # (B, nU2, 2, nh) -> corners
    g = torch.gather(value, 1, idx4.long()[..., None].expand(B, nU, nh, c))
    g = g.view(B, nU // (P * 4), P * 4, nh, c)
    return torch.einsum("bqpnc,bqpn->bqnc", g, w4.view(B, nU // (P * 4), P * 4, nh))


def bilinear_gather_pairs_ref(value, idx2, w_pairs, ppq: int) -> torch.Tensor:
    """Plain version of the pair form B2 reads, from the pair starts alone:
    out[b, q, h] = sum_j wa value[i] + wb value[i + 1] over the query's ppq
    pairs, after the last-row shift. value (B, Lv, nh, c); idx2 (B, Q*ppq,
    nh); w_pairs (B, Q*ppq, nh, 2) -> (B, Q, nh, c). The same function as
    `bilinear_gather_ref`, for callers that hold no idx4 (a training step's
    recorded pairs)."""
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    i0, w, _ = _shift_last_row(idx2, w_pairs, Lv)
    idx = i0.long()[..., None].expand(B, nU2, nh, c)
    rows = w[..., :1] * value.gather(1, idx) + w[..., 1:] * value.gather(1, idx + 1)
    return rows.view(B, nU2 // ppq, ppq, nh, c).sum(2)


def bilinear_gather_bwd_ref(value, idx2, w_pairs, dout):
    """Plain backward in the pair form the kernel uses: dvalue gets
    (wa, wb) x dout at rows (idx2, idx2 + 1), dw the two row . dout dots.

    value (B, Lv, nh, c); idx2 (B, nU2, nh); w_pairs (B, nU2, nh, 2);
    dout (B, Q, nh, c) -> dvalue (B, Lv, nh, c), dw (B, nU2, nh, 2).
    """
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    i0, w, at_end = _shift_last_row(idx2, w_pairs, Lv)
    d = dout.repeat_interleave(nU2 // dout.shape[1], 1)  # pair u belongs to query u // ppq
    idx = i0.long()[..., None].expand(B, nU2, nh, c)
    dw = torch.stack([(value.gather(1, idx) * d).sum(-1), (value.gather(1, idx + 1) * d).sum(-1)], -1)
    dw = torch.where(at_end[..., None], dw.flip(-1), dw)
    dvalue = torch.zeros_like(value)
    dvalue.scatter_add_(1, idx, w[..., :1] * d).scatter_add_(1, idx + 1, w[..., 1:] * d)
    return dvalue, dw


def _pair_dw(value, idx2, dout):
    """dw (B, nU2, nh, 2) in the caller's slot order: each pair's two
    shifted rows dotted with its query's dout row, swapped back for shifted
    pairs."""
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    at_end = idx2 >= Lv - 1
    idx = torch.where(at_end, Lv - 2, idx2).long()[..., None].expand(B, nU2, nh, c)
    d = dout.repeat_interleave(nU2 // dout.shape[1], 1)
    dw = torch.stack([(value.gather(1, idx) * d).sum(-1), (value.gather(1, idx + 1) * d).sum(-1)], -1)
    return torch.where(at_end[..., None], dw.flip(-1), dw)


def _sorted_buckets_ref(keys, n_buckets: int):
    """keys (G, n) in [0, n_buckets] (n_buckets: the update reaches no row)
    -> offsets (G, n_buckets + 1) int32, the exclusive scan of the buckets'
    counts, and order (G, n) int64, the update ids sorted stably by key (by
    the unique key * n + id)."""
    G, n = keys.shape
    counts = torch.zeros((G, n_buckets + 1), dtype=torch.long, device=keys.device).scatter_add_(
        1, keys, torch.ones_like(keys))
    offsets = torch.cat([counts.new_zeros((G, 1)), counts[:, :n_buckets].cumsum(1)], 1)
    return offsets.to(torch.int32), torch.argsort(keys * n + torch.arange(n, device=keys.device), dim=1)


def pair_buckets_ref(idx2, w_pairs, Lv: int):
    """Plain version of B4's first launch: each (b, h)'s pairs bucketed by
    shifted start row. idx2 (B, nU2, nh), w_pairs (B, nU2, nh, 2) ->
    offsets (B, nh, Lv + 1) int32, the exclusive scan of the pairs per start
    row; order (B, nh, nU2) int32, the pair ids sorted stably by start row
    (by the unique key start * nU2 + id); pair_w (B, nh, nU2, 2), the pairs'
    weights (as given, unshifted) in that order."""
    B, nU2, nh = idx2.shape
    s = torch.where(idx2 >= Lv - 1, Lv - 2, idx2).transpose(1, 2).reshape(B * nh, nU2).long()
    offsets, order = _sorted_buckets_ref(s, Lv)
    pair_w = w_pairs.transpose(1, 2).reshape(B * nh, nU2, 2).gather(1, order[..., None].expand(B * nh, nU2, 2))
    return offsets.view(B, nh, Lv + 1), order.to(torch.int32).view(B, nh, nU2), pair_w.view(B, nh, nU2, 2)


def scatter_acc_buckets_ref(idx, w, L: int):
    """Plain version of B7's first launch: each (b, h)'s updates bucketed by
    row. idx, w (B, n, nh) -> offsets (B, nh, L + 1) int32 (bucket r: the
    updates on row r; an update outside [0, L) sorts after them all, in no
    bucket), order (B, nh, n) int32, the update ids sorted stably by row,
    and w in that order (B, nh, n)."""
    B, n, nh = idx.shape
    i = idx.transpose(1, 2).reshape(B * nh, n).long()
    offsets, order = _sorted_buckets_ref(torch.where((i >= 0) & (i < L), i, L), L)
    upd_w = w.transpose(1, 2).reshape(B * nh, n).gather(1, order)
    return offsets.view(B, nh, L + 1), order.to(torch.int32).view(B, nh, n), upd_w.view(B, nh, n)


def scatter_acc_pairs_buckets_ref(idx2, wa, wb, L2: int):
    """Plain version of B8's first launch: each group's pairs bucketed by
    start. idx2, wa, wb (G, n) -> offsets (G, L2 + 2) int32 (bucket s + 1:
    the pairs starting on s, for s in [-1, L2 - 1]; a pair that reaches no
    row sorts after them all), order (G, n) int32, the pair ids sorted
    stably by start, and (wa, wb) in that order (G, n, 2)."""
    G, n = idx2.shape
    k = idx2.long() + 1
    offsets, order = _sorted_buckets_ref(torch.where((k >= 0) & (k <= L2), k, L2 + 1), L2 + 1)
    upd_w = torch.stack([wa, wb], -1).gather(1, order[..., None].expand(G, n, 2))
    return offsets, order.to(torch.int32), upd_w


def _rows_pass_ref(idx, wa, wb, dout, rows: int):
    """Plain version of the rows pass of B4, B7 and B8
    (`csrc/row_buckets.cuh`). Update u of group (b, h), of query
    u // (n / Q), adds wa dout[b, q, h] to row idx and, where wb is given
    (pairs), wb dout[b, q, h] to row idx + 1; a row outside [0, rows) is
    skipped. Row r of each group has its terms in a fixed order: the
    first-row terms of the updates starting on r, then (pairs) the
    second-row terms of those starting on r - 1, each in update order. They
    are cut into segments of `SEG_TERMS`, each summed from zero with one
    multiply and one add a term; the row is its first segment's sum plus
    each further one's in turn, zeros where no term lands. So a row of at
    most `SEG_TERMS` terms is the sum in scatter order (`scatter_acc_ref`,
    `scatter_acc_pairs_ref`, `bilinear_gather_bwd_ref`), bitwise.
    idx (B, n, nh) int; wa, wb (B, n, nh), wb None for one row an update;
    dout (B, Q, nh, c) -> (B, rows, nh, c) fp32."""
    B, n, nh = idx.shape
    c = dout.shape[-1]
    G, dev = B * nh, dout.device
    per_g = lambda t: t.transpose(1, 2).reshape(G, n)  # noqa: E731
    start = per_g(idx).long()
    ws = torch.stack([per_g(t).float() for t in ((wa,) if wb is None else (wa, wb))])  # (terms an update, G, n)
    d = dout.float().permute(0, 2, 1, 3).reshape(G, -1, c)
    ppq = n // dout.shape[1]
    # every term (group, row, slot, update), sorted by (group, row, slot, update)
    k = len(ws)
    row = torch.cat([start + j for j in range(k)], 1)
    slot = torch.arange(k, device=dev).repeat_interleave(n).expand(G, k * n)
    upd = torch.arange(n, device=dev).repeat(k).expand(G, k * n)
    grp = torch.arange(G, device=dev)[:, None].expand(G, k * n)
    keep = (row >= 0) & (row < rows)
    flat, slot, upd, grp = grp[keep] * rows + row[keep], slot[keep], upd[keep], grp[keep]
    key = torch.argsort((flat * k + slot) * n + upd)
    flat, slot, upd, grp = (t[key] for t in (flat, slot, upd, grp))
    n_row = torch.zeros(G * rows, dtype=torch.long, device=dev).scatter_add_(0, flat, torch.ones_like(flat))
    rank = torch.arange(flat.numel(), device=dev) - (n_row.cumsum(0) - n_row)[flat]
    n_seg = (n_row + SEG_TERMS - 1) // SEG_TERMS
    seg = (n_seg.cumsum(0) - n_seg)[flat] + rank // SEG_TERMS  # the segment of each term
    wt = ws[slot, grp, upd]
    dt_rows = d[grp, upd // ppq]
    part = d.new_zeros((int(n_seg.sum()), c))
    pos = rank % SEG_TERMS
    for t in range(min(SEG_TERMS, int(n_row.max()) if flat.numel() else 0)):
        j = torch.nonzero(pos == t).squeeze(1)  # the t-th term of every segment
        part[seg[j]] = part[seg[j]] + wt[j, None] * dt_rows[j]
    acc = d.new_zeros((G * rows, c))
    first = n_seg.cumsum(0) - n_seg
    for s in range(int(n_seg.max()) if flat.numel() else 0):
        r = torch.nonzero(n_seg > s).squeeze(1)
        acc[r] = part[first[r]] if s == 0 else acc[r] + part[first[r] + s]
    return acc.view(B, nh, rows, c).permute(0, 2, 1, 3).contiguous()


def bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout):
    """Plain version of B4's second launch: dvalue as `_rows_pass_ref` on
    the shifted pairs (row r: wa' dout over the pairs of bucket r, then
    wb' dout over those of bucket r - 1, each in pair order, wa', wb' the
    shifted weights), so bitwise the scatter-add form's sum
    (`bilinear_gather_bwd_ref`) on every row of at most `SEG_TERMS` terms;
    dw as `_pair_dw`. Same arguments and results as
    `bilinear_gather_bwd_ref`."""
    start, w, _ = _shift_last_row(idx2, w_pairs, value.shape[1])
    dvalue = _rows_pass_ref(start, w[..., 0], w[..., 1], dout, value.shape[1]).to(value.dtype)
    return dvalue, _pair_dw(value, idx2, dout)


def scatter_acc_rows_ref(idx, w, dout, L: int) -> torch.Tensor:
    """Plain version of B7's rows pass (see `_rows_pass_ref`): row r sums
    w dout over its updates in update order, in segments of `SEG_TERMS`.
    Same arguments and result as `scatter_acc_ref`."""
    return _rows_pass_ref(idx, w, None, dout, L)


def scatter_acc_pairs_rows_ref(idx2, wa, wb, dout, L2: int) -> torch.Tensor:
    """Plain version of B8's rows pass (see `_rows_pass_ref`): row r sums
    wa dout over the pairs starting on r, then wb dout over those starting
    on r - 1, each in pair order, in segments of `SEG_TERMS`. Same
    arguments and result as `scatter_acc_pairs_ref`."""
    return _rows_pass_ref(idx2[..., None], wa[..., None], wb[..., None], dout[:, :, None], L2)[:, :, 0]


def _check_cuda(name, value, idx2, w_pairs, per: int):
    """Validate the kernels' inputs (nU2 a multiple of `per`); return them contiguous."""
    if value.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {value.device}")
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    if value.dtype != torch.float32 or w_pairs.dtype != torch.float32 or idx2.dtype != torch.int32:
        raise TypeError(f"{name}: value/w_pairs must be float32 and idx2 int32")
    if tuple(idx2.shape) != (B, nU2, nh) or tuple(w_pairs.shape) != (B, nU2, nh, 2) or nU2 % per:
        raise ValueError(f"{name}: inconsistent shapes")
    if c % 2 or c > 64 or Lv < 2:
        raise ValueError(f"{name}: the kernel needs an even c <= 64 and Lv >= 2, got c={c}")
    if idx2.device != value.device or w_pairs.device != value.device:
        raise ValueError(f"{name}: inputs on different devices")
    return value.contiguous(), idx2.contiguous(), w_pairs.contiguous()


def _gather_fwd_cuda(value, idx2, w_pairs, P: int) -> torch.Tensor:
    """Launch kernel B2."""
    ppq = 2 * P
    value, idx2, w_pairs = _check_cuda("bilinear_gather", value, idx2, w_pairs, ppq)
    value, w_pairs = _aligned(value), _aligned(w_pairs)  # float4 rows, float2 weight pairs
    B, Lv, nh, c = value.shape
    Q = idx2.shape[1] // ppq
    out = torch.empty((B, Q, nh, c), dtype=torch.float32, device=value.device)
    rc = _entry("bilinear_gather_fwd", "bilinear_gather_fwd")(
        value.data_ptr(), idx2.data_ptr(), w_pairs.data_ptr(), out.data_ptr(),
        B, Lv, nh, c, Q, ppq, _stream(value),
    )
    _build.check(rc, "bilinear_gather_fwd")
    bilinear_gather.launches += 1
    return out


class _Buckets:
    """The buckets launch's outputs and scratch for G groups of n updates,
    in one int32 allocation, 16-byte aligned parts in the order its C entry
    takes them: offsets (G, n_buckets + 1), order (G, n), the weights in
    bucket order (float32, (G, n, 2) for pairs, else (G, n)), the long rows'
    segments (items (cap, 4), done (cap,), n_items (1,): a group lists at
    most n / 8, see csrc/row_buckets.cuh), and the sort's (key, id) passes
    (G, 2, n, 2) and sorted keys (G, n). The launches take the parts'
    addresses (`ptrs`); `part` views one."""

    def __init__(self, G: int, n: int, n_buckets: int, pairs: bool, device):
        self.cap = G * -(-n // 8)
        self.shapes = [(G, n_buckets + 1), (G, n), (G, n, 2) if pairs else (G, n), (self.cap, 4), (self.cap,), (1,),
                       (G, 2, n, 2), (G, n)]
        self.starts = [0, *itertools.accumulate(-(-math.prod(s) // 4) * 4 for s in self.shapes)]
        self.buf = torch.empty(self.starts[-1], dtype=torch.int32, device=device)
        self.ptrs = [self.buf.data_ptr() + 4 * s for s in self.starts[:-1]]

    def part(self, k: int) -> torch.Tensor:
        t = self.buf.narrow(0, self.starts[k], math.prod(self.shapes[k])).view(self.shapes[k])
        return t.view(torch.float32) if k == 2 else t


def _launch_buckets(source: str, fn_name: str, inputs, ints, b: _Buckets, counter) -> _Buckets:
    rc = _entry(source, fn_name)(*(t.data_ptr() for t in inputs), *b.ptrs, *ints, _stream(inputs[0]))
    _build.check(rc, fn_name)
    counter.launches += 1
    return b


def _pair_buckets_cuda(idx2, w_pairs, Lv: int) -> _Buckets:
    """Launch 1 of B4: the buckets of `pair_buckets_ref` (offsets, order,
    pair_w) and the long rows' segments for launch 2."""
    if idx2.device.type != "cuda":
        raise RuntimeError(f"pair_buckets: no kernel for device {idx2.device}")
    if idx2.dtype != torch.int32 or idx2.dim() != 3 or Lv < 2:
        raise ValueError("pair_buckets: idx2 must be an int32 (B, nU2, nh) tensor, Lv >= 2")
    B, nU2, nh = idx2.shape
    if tuple(w_pairs.shape) != (B, nU2, nh, 2) or w_pairs.dtype != torch.float32 or w_pairs.device != idx2.device:
        raise ValueError("pair_buckets: w_pairs must be float32 (B, nU2, nh, 2) on idx2's device")
    return _launch_buckets("bilinear_gather_bwd", "pair_buckets", (idx2.contiguous(), w_pairs.contiguous()),
                           (B, nU2, nh, Lv), _Buckets(B * nh, nU2, Lv, True, idx2.device), pair_buckets)


def pair_buckets(idx2, w_pairs, Lv: int):
    """B4's first launch (see `pair_buckets_ref`): the kernel for CUDA
    tensors, the plain version for CPU ones. Returns (offsets, order, pair_w)."""
    if idx2.device.type == "cpu":
        return pair_buckets_ref(idx2, w_pairs, Lv)
    B, nU2, nh = idx2.shape
    b = _pair_buckets_cuda(idx2, w_pairs, Lv)
    return b.part(0).view(B, nh, Lv + 1), b.part(1).view(B, nh, nU2), b.part(2).view(B, nh, nU2, 2)


def bilinear_gather_bwd(value, idx2, w_pairs, dout):
    """(dvalue, dw) of the pair gather given dout (B, Q, nh, c): kernel B4's
    two launches (`pair_buckets`, then the rows pass) for CUDA tensors,
    `bilinear_gather_bwd_ref` for CPU ones. The kernel's dvalue is bitwise
    repeatable: each row is summed in a fixed order (see
    `bilinear_gather_bwd_rows_ref`)."""
    if value.device.type == "cpu":
        return bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    B, Q = dout.shape[:2]
    value, idx2, w_pairs = _check_cuda("bilinear_gather_bwd", value, idx2, w_pairs, Q)
    _, Lv, nh, c = value.shape
    if tuple(dout.shape) != (B, Q, nh, c) or dout.dtype != torch.float32 or dout.device != value.device:
        raise ValueError("bilinear_gather_bwd: dout must be float32 (B, Q, nh, c) on value's device")
    value, dout = _aligned(value), _aligned(dout.contiguous())
    b = _pair_buckets_cuda(idx2, w_pairs, Lv)
    partials = torch.empty((b.cap, c), dtype=torch.float32, device=value.device)
    dvalue = torch.empty_like(value)
    dw = torch.empty_like(w_pairs)
    rc = _entry("bilinear_gather_bwd", "bilinear_gather_bwd")(
        value.data_ptr(), idx2.data_ptr(), dout.data_ptr(), *b.ptrs[:6], partials.data_ptr(),
        dvalue.data_ptr(), dw.data_ptr(), B, Lv, nh, c, Q, idx2.shape[1] // Q, _stream(value),
    )
    _build.check(rc, "bilinear_gather_bwd")
    bilinear_gather_bwd.launches += 1
    return dvalue, dw


class _BilinearGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, idx4, w_pairs, idx2, P):
        ctx.save_for_backward(value, w_pairs, idx2)
        if value.device.type == "cpu":
            return bilinear_gather_ref(value, idx4, w_pairs, idx2, P)
        return _gather_fwd_cuda(value, idx2, w_pairs, P)

    @staticmethod
    def backward(ctx, dout):
        value, w_pairs, idx2 = ctx.saved_tensors
        dvalue, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
        return dvalue, None, dw, None, None


def bilinear_gather(value, idx4, w_pairs, idx2, P: int) -> torch.Tensor:
    """The pair gather: kernel B2 for CUDA tensors, the plain version for CPU
    ones; differentiable in value and w_pairs through `bilinear_gather_bwd`."""
    if value.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"bilinear_gather: no kernel for device {value.device}")
    return _BilinearGather.apply(value, idx4, w_pairs, idx2, P)


def weighted_gather_ref(value, idx, w, p4: int) -> torch.Tensor:
    """Plain generic gather (`_gather_fwd_impl`): value (B, L, nh, c); idx
    (B, nU, nh) in [0, L); w (B, nU, nh); nU = Q p4 -> (B, Q, nh, c) in
    value's dtype."""
    B, _, nh, c = value.shape
    nU = idx.shape[1]
    g = torch.gather(value, 1, idx.long()[..., None].expand(B, nU, nh, c))
    return torch.einsum("bqpnc,bqpn->bqnc", g.view(B, nU // p4, p4, nh, c),
                        w.to(value.dtype).view(B, nU // p4, p4, nh))


def scatter_acc_ref(idx, w, dout, L: int) -> torch.Tensor:
    """Plain row scatter: dvalue (B, L, nh, c) fp32 with
    dvalue[b, idx[b, u, h], h] += w[b, u, h] dout[b, u // p4, h]; idx, w
    (B, nU, nh), dout (B, Q, nh, c), p4 = nU / Q. An update outside [0, L)
    is skipped, as the kernel skips it."""
    B, nU, nh = idx.shape
    c = dout.shape[-1]
    upd = w.float()[..., None] * dout.float().repeat_interleave(nU // dout.shape[1], 1)
    i = idx.long()
    keep = (i >= 0) & (i < L)
    bi = torch.arange(B, device=idx.device)[:, None, None].expand_as(i)
    hi = torch.arange(nh, device=idx.device)[None, None, :].expand_as(i)
    return dout.new_zeros((B, L, nh, c), dtype=torch.float32).index_put_((bi[keep], i[keep], hi[keep]), upd[keep],
                                                                        accumulate=True)


def _check_scatter(name, idx, ws, dout=None, rows: int = 1):
    """Validate B7's or B8's inputs: idx int32, the weights float32 of its
    shape, dout (where given) float32 of idx's groups with Q dividing the
    updates, all on one CUDA device, fewer than 2^24 updates a group, at
    least one output row."""
    if idx.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {idx.device}")
    if idx.dtype != torch.int32 or any(t.dtype != torch.float32 for t in ws):
        raise TypeError(f"{name}: the index must be int32, the weights float32")
    if any(t.shape != idx.shape for t in ws) or rows < 1:
        raise ValueError(f"{name}: inconsistent shapes")
    if idx.shape[1] >= 1 << 24:
        raise ValueError(f"{name}: the kernel takes fewer than 2^24 updates a group, got {idx.shape[1]}")
    if any(t.device != idx.device for t in ws):
        raise ValueError(f"{name}: inputs on different devices")
    if dout is not None:
        if dout.dtype != torch.float32:
            raise TypeError(f"{name}: dout must be float32")
        if dout.dim() != idx.dim() + 1 or dout.shape[0] != idx.shape[0] \
                or tuple(dout.shape[2:-1]) != tuple(idx.shape[2:]) or idx.shape[1] % dout.shape[1]:
            raise ValueError(f"{name}: inconsistent shapes")
        if dout.device != idx.device:
            raise ValueError(f"{name}: inputs on different devices")


def _scatter_rows_cuda(fn_name: str, b: _Buckets, dout, rows: int, ppq: int, counter) -> torch.Tensor:
    """The rows pass of B7 or B8 on its buckets: dout (B, Q, nh, c) ->
    (B, rows, nh, c) fp32, every row written. One launch per `ROW_CHANNELS`
    channels; an odd c is padded to even (the kernel reads rows as float2)."""
    B, Q, nh, c = dout.shape
    cs = c + c % 2
    d = _aligned(dout.contiguous() if cs == c else torch.nn.functional.pad(dout, (0, 1)))
    out = torch.empty((B, rows, nh, cs), dtype=torch.float32, device=dout.device)
    partials = torch.empty((b.cap, min(cs, ROW_CHANNELS)), dtype=torch.float32, device=dout.device)
    fn = _entry("deform_scatter", fn_name)
    for c0 in range(0, cs, ROW_CHANNELS):
        if c0:
            b.part(4).zero_()  # the previous launch left its rows' arrival counts at their segment counts
        rc = fn(d.data_ptr() + 4 * c0, *b.ptrs[:6], partials.data_ptr(), out.data_ptr() + 4 * c0, B, rows, nh,
                min(ROW_CHANNELS, cs - c0), cs, Q, ppq, _stream(dout))
        _build.check(rc, fn_name)
        counter.launches += 1
    return out if cs == c else out[..., :c].contiguous()


def _scatter_acc_buckets_cuda(idx, w, L: int) -> _Buckets:
    B, n, nh = idx.shape
    return _launch_buckets("deform_scatter", "scatter_acc_buckets", (idx.contiguous(), w.contiguous()),
                           (B, n, nh, L), _Buckets(B * nh, n, L, False, idx.device), scatter_acc_buckets)


def scatter_acc_buckets(idx, w, L: int):
    """B7's first launch (see `scatter_acc_buckets_ref`): the kernel for CUDA
    tensors, the plain version for CPU ones. Returns (offsets, order, upd_w)."""
    if idx.device.type == "cpu":
        return scatter_acc_buckets_ref(idx, w, L)
    _check_scatter("scatter_acc_buckets", idx, (w,), rows=L)
    B, n, nh = idx.shape
    b = _scatter_acc_buckets_cuda(idx, w, L)
    return b.part(0).view(B, nh, L + 1), b.part(1).view(B, nh, n), b.part(2).view(B, nh, n)


def scatter_acc(idx, w, dout, L: int) -> torch.Tensor:
    """The value gradient of `weighted_gather` (see `scatter_acc_ref`):
    kernel B7's two launches (`scatter_acc_buckets`, then the rows pass) for
    CUDA tensors, the plain version for CPU ones. The kernel sums each row
    in a fixed order (`scatter_acc_rows_ref`, bitwise), so it is bitwise
    repeatable, and equal to the plain version bitwise on every row of at
    most `SEG_TERMS` updates."""
    if idx.device.type == "cpu":
        return scatter_acc_ref(idx, w, dout, L)
    _check_scatter("scatter_acc", idx, (w,), dout, L)
    b = _scatter_acc_buckets_cuda(idx, w, L)
    return _scatter_rows_cuda("scatter_acc", b, dout, L, idx.shape[1] // dout.shape[1], scatter_acc)


class _WeightedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, idx, w, p4):
        ctx.save_for_backward(value, idx, w)
        ctx.p4 = p4
        return weighted_gather_ref(value, idx, w, p4)

    @staticmethod
    def backward(ctx, dout):
        value, idx, w = ctx.saved_tensors
        B, L, nh, c = value.shape
        dout32 = dout.float()
        dvalue = scatter_acc(idx.to(torch.int32), w.float(), dout32, L)
        g = torch.gather(value, 1, idx.long()[..., None].expand(B, idx.shape[1], nh, c)).float()
        dw = torch.einsum("bqpnc,bqnc->bqpn", g.view(B, dout.shape[1], ctx.p4, nh, c), dout32)
        return dvalue.to(value.dtype), None, dw.reshape(w.shape).to(w.dtype), None


def weighted_gather(value, idx, w, p4: int) -> torch.Tensor:
    """The generic weighted gather of `tamtr_tpu/kernels/deform_scatter.py`
    (see `weighted_gather_ref`), differentiable in value and w: dvalue by
    `scatter_acc` (kernel B7 on the card, bitwise repeatable) in value's
    dtype, dw by the plain gather and einsum in w's dtype. idx gets no
    gradient."""
    if value.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"weighted_gather: no kernel for device {value.device}")
    return _WeightedGather.apply(value, idx, w, p4)


def scatter_acc_pairs_ref(idx2, wa, wb, dout, L2: int) -> torch.Tensor:
    """Plain pair scatter: idx2 (G, nU2) pair starts; rows idx2 and
    idx2 + 1 get wa dout and wb dout of query u // (nU2 / Q); wa, wb
    (G, nU2); dout (G, Q, c) -> (G, L2, c) fp32. A row outside [0, L2) is
    skipped, as the kernel skips it (the JAX package's callers keep the
    starts in [0, L2 - 1))."""
    G, nU2 = idx2.shape
    d = dout.float().repeat_interleave(nU2 // dout.shape[1], 1)
    rows = torch.cat([idx2, idx2 + 1], 1).long()
    upd = torch.cat([wa.float()[..., None] * d, wb.float()[..., None] * d], 1)
    g = torch.arange(G, device=idx2.device)[:, None].expand_as(rows)
    keep = (rows >= 0) & (rows < L2)
    return dout.new_zeros((G, L2, dout.shape[-1]), dtype=torch.float32).index_put_((g[keep], rows[keep]), upd[keep],
                                                                                  accumulate=True)


def _scatter_acc_pairs_buckets_cuda(idx2, wa, wb, L2: int) -> _Buckets:
    G, n = idx2.shape
    return _launch_buckets("deform_scatter", "scatter_acc_pairs_buckets",
                           (idx2.contiguous(), wa.contiguous(), wb.contiguous()), (G, n, L2),
                           _Buckets(G, n, L2 + 1, True, idx2.device), scatter_acc_pairs_buckets)


def scatter_acc_pairs_buckets(idx2, wa, wb, L2: int):
    """B8's first launch (see `scatter_acc_pairs_buckets_ref`): the kernel
    for CUDA tensors, the plain version for CPU ones. Returns (offsets,
    order, upd_w)."""
    if idx2.device.type == "cpu":
        return scatter_acc_pairs_buckets_ref(idx2, wa, wb, L2)
    _check_scatter("scatter_acc_pairs_buckets", idx2, (wa, wb), rows=L2)
    b = _scatter_acc_pairs_buckets_cuda(idx2, wa, wb, L2)
    return b.part(0), b.part(1), b.part(2)


def scatter_acc_pairs(idx2, wa, wb, dout, L2: int) -> torch.Tensor:
    """The pair scatter of `_scatter_acc_pairs` (see `scatter_acc_pairs_ref`):
    kernel B8's two launches (`scatter_acc_pairs_buckets`, then the rows
    pass) for CUDA tensors, the plain version for CPU ones. The kernel sums
    each row in a fixed order (`scatter_acc_pairs_rows_ref`, bitwise), so
    it is bitwise repeatable, and equal to the plain version bitwise on
    every row of at most `SEG_TERMS` terms."""
    if idx2.device.type == "cpu":
        return scatter_acc_pairs_ref(idx2, wa, wb, dout, L2)
    _check_scatter("scatter_acc_pairs", idx2, (wa, wb), dout, L2)
    b = _scatter_acc_pairs_buckets_cuda(idx2, wa, wb, L2)
    out = _scatter_rows_cuda("scatter_acc_pairs", b, dout[:, :, None], L2, idx2.shape[1] // dout.shape[1],
                             scatter_acc_pairs)
    return out.view(out.shape[0], L2, -1)


# kernel launches since the last reset, one counter per kernel
bilinear_gather.launches = 0
pair_buckets.launches = 0
bilinear_gather_bwd.launches = 0
scatter_acc_buckets.launches = 0
scatter_acc.launches = 0  # B7's rows pass
scatter_acc_pairs_buckets.launches = 0
scatter_acc_pairs.launches = 0  # B8's rows pass

# entry point: (pointer arguments, int arguments), then the stream
_SIGNATURES = {"bilinear_gather_fwd": (4, 6), "pair_buckets": (10, 4), "bilinear_gather_bwd": (12, 6),
               "scatter_acc_buckets": (10, 4), "scatter_acc": (9, 7),
               "scatter_acc_pairs_buckets": (11, 3), "scatter_acc_pairs": (9, 7)}


def _entry(source: str, fn_name: str):
    """Entry point `fn_name` of the library built from `csrc/<source>.cu`, typed."""
    fn = getattr(_build.load(source), fn_name)
    if fn.argtypes is None:
        n_ptr, n_int = _SIGNATURES[fn_name]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
