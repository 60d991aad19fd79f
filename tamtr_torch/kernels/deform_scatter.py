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
package calls it on a model path.

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

import torch

from tamtr_torch.kernels import _build
from tamtr_torch.kernels.selective_scan import _aligned

# terms of a dvalue row summed as one sequence in B4 (`kSegTerms` in
# csrc/bilinear_gather_bwd.cu); a longer row sums such segments in turn
SEG_TERMS = 32


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


def pair_buckets_ref(idx2, w_pairs, Lv: int):
    """Plain version of B4's first launch: each (b, h)'s pairs bucketed by
    shifted start row. idx2 (B, nU2, nh), w_pairs (B, nU2, nh, 2) ->
    offsets (B, nh, Lv + 1) int32, the exclusive scan of the pairs per start
    row; order (B, nh, nU2) int32, the pair ids sorted stably by start row
    (by the unique key start * nU2 + id); pair_w (B, nh, nU2, 2), the pairs'
    weights (as given, unshifted) in that order."""
    B, nU2, nh = idx2.shape
    s = torch.where(idx2 >= Lv - 1, Lv - 2, idx2).transpose(1, 2).long()  # (B, nh, nU2)
    counts = torch.zeros((B, nh, Lv), dtype=torch.long, device=idx2.device).scatter_add_(2, s, torch.ones_like(s))
    offsets = torch.cat([counts.new_zeros((B, nh, 1)), counts.cumsum(2)], 2)
    order = torch.argsort(s * nU2 + torch.arange(nU2, device=idx2.device), dim=2)
    pair_w = w_pairs.transpose(1, 2).gather(2, order[..., None].expand(B, nh, nU2, 2))
    return offsets.to(torch.int32), order.to(torch.int32), pair_w


def bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout, order=None):
    """Plain version of B4's second launch, on the buckets of
    `pair_buckets_ref` (made here when `order` is None). Row r of each
    (b, h) has its terms in a fixed order: wa' dout from the pairs of bucket
    r in pair order, then wb' dout from those of bucket r - 1 in pair order
    (wa', wb' the shifted weights). They are cut into segments of
    `SEG_TERMS`, each summed from zero with one multiply and one add a term;
    the row is its first segment's sum plus each further one's in turn. So
    a row of at most `SEG_TERMS` terms is the scatter-add form's sum
    (`bilinear_gather_bwd_ref`), bitwise. dw as `_pair_dw`. Same arguments
    and results as `bilinear_gather_bwd_ref`."""
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    dev = value.device
    if order is None:
        order = pair_buckets_ref(idx2, w_pairs, Lv)[1]
    start, w, _ = _shift_last_row(idx2, w_pairs, Lv)
    w = w.permute(0, 2, 1, 3).reshape(B * nh, nU2, 2)
    d = dout.permute(0, 2, 1, 3).reshape(B * nh, -1, c)
    ppq = nU2 // dout.shape[1]
    # the terms of every row sorted by (row, slot, pair): the bucketed pair
    # at order[j] gives (row s, slot 0) and (row s + 1, slot 1)
    pair = order.long().reshape(B * nh, nU2)
    start = start.transpose(1, 2).reshape(B * nh, nU2).long().gather(1, pair)
    rows, pair = torch.cat([start, start + 1], 1), torch.cat([pair, pair], 1)
    slot = torch.cat([torch.zeros_like(start), torch.ones_like(start)], 1)
    key = torch.argsort((rows * 2 + slot) * nU2 + pair, dim=1)
    rows, pair, slot = (t.gather(1, key) for t in (rows, pair, slot))
    grp = torch.arange(B * nh, device=dev)[:, None].expand_as(rows)
    flat = (grp * Lv + rows).reshape(-1)  # the row of each term, over all groups
    n_row = torch.zeros(B * nh * Lv, dtype=torch.long, device=dev).scatter_add_(0, flat, torch.ones_like(flat))
    rank = torch.arange(flat.numel(), device=dev) - (n_row.cumsum(0) - n_row)[flat]
    n_seg = (n_row + SEG_TERMS - 1) // SEG_TERMS
    seg = (n_seg.cumsum(0) - n_seg)[flat] + rank // SEG_TERMS  # the segment of each term
    wt = w[grp.reshape(-1), pair.reshape(-1), slot.reshape(-1)]
    dt_rows = d[grp.reshape(-1), pair.reshape(-1) // ppq]
    part = value.new_zeros((int(n_seg.sum()), c))
    pos = rank % SEG_TERMS
    for t in range(min(SEG_TERMS, int(n_row.max()) if flat.numel() else 0)):
        j = torch.nonzero(pos == t).squeeze(1)  # the t-th term of every segment
        part[seg[j]] = part[seg[j]] + wt[j, None] * dt_rows[j]
    acc = value.new_zeros((B * nh * Lv, c))
    first = n_seg.cumsum(0) - n_seg
    for k in range(int(n_seg.max()) if flat.numel() else 0):
        r = torch.nonzero(n_seg > k).squeeze(1)
        acc[r] = part[first[r]] if k == 0 else acc[r] + part[first[r] + k]
    return acc.view(B, nh, Lv, c).permute(0, 2, 1, 3).contiguous(), _pair_dw(value, idx2, dout)


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


def _pair_buckets_cuda(idx2, w_pairs, Lv: int):
    """Launch 1 of B4: (offsets, order, pair_w) as `pair_buckets_ref`, and
    the long rows' segments (items, done, n_items) for launch 2."""
    if idx2.device.type != "cuda":
        raise RuntimeError(f"pair_buckets: no kernel for device {idx2.device}")
    if idx2.dtype != torch.int32 or idx2.dim() != 3 or Lv < 2:
        raise ValueError("pair_buckets: idx2 must be an int32 (B, nU2, nh) tensor, Lv >= 2")
    B, nU2, nh = idx2.shape
    if tuple(w_pairs.shape) != (B, nU2, nh, 2) or w_pairs.dtype != torch.float32 or w_pairs.device != idx2.device:
        raise ValueError("pair_buckets: w_pairs must be float32 (B, nU2, nh, 2) on idx2's device")
    idx2, w_pairs = idx2.contiguous(), w_pairs.contiguous()
    new = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device=idx2.device)  # noqa: E731
    offsets, order, pair_w = new(B, nh, Lv + 1), new(B, nh, nU2), new(B, nh, nU2, 2, dtype=torch.float32)
    # a group lists at most nU2 / 8 segments (see the kernel)
    cap = B * nh * -(-nU2 // 8)
    items, done, n_items = new(cap, 4), new(cap), new(1)
    # the sort's starts and order, then the row counts, where shared memory is short
    scratch = new(B * nh * (-(-max(Lv + 1, 3 * nU2) // 4) * 4))
    rc = _entry("bilinear_gather_bwd", "pair_buckets")(
        idx2.data_ptr(), w_pairs.data_ptr(), offsets.data_ptr(), order.data_ptr(), pair_w.data_ptr(),
        items.data_ptr(), done.data_ptr(), n_items.data_ptr(), scratch.data_ptr(),
        B, nU2, nh, Lv, _stream(idx2),
    )
    _build.check(rc, "pair_buckets")
    pair_buckets.launches += 1
    return offsets, order, pair_w, (items, done, n_items)


def pair_buckets(idx2, w_pairs, Lv: int):
    """B4's first launch (see `pair_buckets_ref`): the kernel for CUDA
    tensors, the plain version for CPU ones. Returns (offsets, order, pair_w)."""
    if idx2.device.type == "cpu":
        return pair_buckets_ref(idx2, w_pairs, Lv)
    return _pair_buckets_cuda(idx2, w_pairs, Lv)[:3]


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
    offsets, order, pair_w, (items, done, n_items) = _pair_buckets_cuda(idx2, w_pairs, Lv)
    partials = torch.empty((items.shape[0], c), dtype=torch.float32, device=value.device)
    dvalue = torch.empty_like(value)
    dw = torch.empty_like(w_pairs)
    rc = _entry("bilinear_gather_bwd", "bilinear_gather_bwd")(
        value.data_ptr(), idx2.data_ptr(), dout.data_ptr(), offsets.data_ptr(), order.data_ptr(),
        pair_w.data_ptr(), items.data_ptr(), done.data_ptr(), n_items.data_ptr(), partials.data_ptr(),
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
    (B, nU, nh), dout (B, Q, nh, c), p4 = nU / Q."""
    B, nU, nh = idx.shape
    c = dout.shape[-1]
    upd = w.float()[..., None] * dout.float().repeat_interleave(nU // dout.shape[1], 1)
    rows = (torch.arange(B, device=idx.device)[:, None, None], idx.long(),
            torch.arange(nh, device=idx.device)[None, None, :])
    return dout.new_zeros((B, L, nh, c), dtype=torch.float32).index_put_(rows, upd, accumulate=True)


def scatter_acc(idx, w, dout, L: int) -> torch.Tensor:
    """The value gradient of `weighted_gather` (see `scatter_acc_ref`):
    kernel B7 for CUDA tensors, the plain version for CPU ones. Both sum
    colliding rows; the kernel with fp32 atomics, so its sums over shared
    rows are not bitwise the same from run to run."""
    if idx.device.type == "cpu":
        return scatter_acc_ref(idx, w, dout, L)
    if idx.device.type != "cuda":
        raise RuntimeError(f"scatter_acc: no kernel for device {idx.device}")
    B, nU, nh = idx.shape
    Q, c = dout.shape[1], dout.shape[-1]
    if idx.dtype != torch.int32 or w.dtype != torch.float32 or dout.dtype != torch.float32:
        raise TypeError("scatter_acc: idx must be int32, w and dout float32")
    if tuple(w.shape) != (B, nU, nh) or tuple(dout.shape) != (B, Q, nh, c) or nU % Q:
        raise ValueError("scatter_acc: inconsistent shapes")
    if w.device != idx.device or dout.device != idx.device:
        raise ValueError("scatter_acc: inputs on different devices")
    idx, w, dout = idx.contiguous(), w.contiguous(), dout.contiguous()
    dvalue = torch.zeros((B, L, nh, c), dtype=torch.float32, device=idx.device)
    rc = _entry("deform_scatter", "scatter_acc")(
        idx.data_ptr(), w.data_ptr(), dout.data_ptr(), dvalue.data_ptr(), B, L, nh, c, Q, nU // Q,
        _stream(idx),
    )
    _build.check(rc, "scatter_acc")
    scatter_acc.launches += 1
    return dvalue


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
    `scatter_acc` (kernel B7 on the card; not bitwise deterministic there,
    see `scatter_acc`) in value's dtype, dw by the plain gather and einsum
    in w's dtype. idx gets no gradient."""
    if value.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"weighted_gather: no kernel for device {value.device}")
    return _WeightedGather.apply(value, idx, w, p4)


def scatter_acc_pairs_ref(idx2, wa, wb, dout, L2: int) -> torch.Tensor:
    """Plain pair scatter: idx2 (G, nU2) pair starts in [0, L2 - 1); rows
    idx2 and idx2 + 1 get wa dout and wb dout of query u // (nU2 / Q); wa, wb
    (G, nU2); dout (G, Q, c) -> (G, L2, c) fp32."""
    G, nU2 = idx2.shape
    d = dout.float().repeat_interleave(nU2 // dout.shape[1], 1)
    rows = torch.cat([idx2, idx2 + 1], 1).long()
    upd = torch.cat([wa.float()[..., None] * d, wb.float()[..., None] * d], 1)
    g = torch.arange(G, device=idx2.device)[:, None]
    return dout.new_zeros((G, L2, dout.shape[-1]), dtype=torch.float32).index_put_((g, rows), upd,
                                                                                  accumulate=True)


def scatter_acc_pairs(idx2, wa, wb, dout, L2: int) -> torch.Tensor:
    """The pair scatter of `_scatter_acc_pairs` (see `scatter_acc_pairs_ref`):
    kernel B8 for CUDA tensors, the plain version for CPU ones. The caller
    keeps the starts in range, as in the JAX package; the kernel skips a row
    outside (G, L2) rather than write it. Its fp32 atomics make the sums over
    shared rows not bitwise the same from run to run."""
    if idx2.device.type == "cpu":
        return scatter_acc_pairs_ref(idx2, wa, wb, dout, L2)
    if idx2.device.type != "cuda":
        raise RuntimeError(f"scatter_acc_pairs: no kernel for device {idx2.device}")
    G, nU2 = idx2.shape
    _, Q, c = dout.shape
    if idx2.dtype != torch.int32 or any(t.dtype != torch.float32 for t in (wa, wb, dout)):
        raise TypeError("scatter_acc_pairs: idx2 must be int32, wa, wb and dout float32")
    if tuple(wa.shape) != (G, nU2) or tuple(wb.shape) != (G, nU2) or dout.shape[0] != G or nU2 % Q:
        raise ValueError("scatter_acc_pairs: inconsistent shapes")
    if any(t.device != idx2.device for t in (wa, wb, dout)):
        raise ValueError("scatter_acc_pairs: inputs on different devices")
    idx2, wa, wb, dout = (t.contiguous() for t in (idx2, wa, wb, dout))
    out = torch.zeros((G, L2, c), dtype=torch.float32, device=idx2.device)
    rc = _entry("deform_scatter", "scatter_acc_pairs")(
        idx2.data_ptr(), wa.data_ptr(), wb.data_ptr(), dout.data_ptr(), out.data_ptr(), G, L2, c, Q,
        nU2 // Q, _stream(idx2),
    )
    _build.check(rc, "scatter_acc_pairs")
    scatter_acc_pairs.launches += 1
    return out


# kernel launches since the last reset, one counter per kernel
bilinear_gather.launches = 0
pair_buckets.launches = 0
bilinear_gather_bwd.launches = 0
scatter_acc.launches = 0
scatter_acc_pairs.launches = 0

# entry point: (pointer arguments, int arguments), then the stream
_SIGNATURES = {"bilinear_gather_fwd": (4, 6), "pair_buckets": (9, 4), "bilinear_gather_bwd": (12, 6),
               "scatter_acc": (4, 6), "scatter_acc_pairs": (5, 5)}


def _entry(source: str, fn_name: str):
    """Entry point `fn_name` of the library built from `csrc/<source>.cu`, typed."""
    fn = getattr(_build.load(source), fn_name)
    if fn.argtypes is None:
        n_ptr, n_int = _SIGNATURES[fn_name]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
