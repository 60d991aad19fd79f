"""Sequence-parallel selective scans: the token axis cut into blocks over a
process group (the port of `tamtr_tpu/parallel/seq_scan.py`:
`selective_scan_sp`, `ss2d_scan_sp`).

The S6 recurrence h_t = a_t h_{t-1} + b_t is associative, so a walk cut
into n blocks runs as a two-phase blocked scan:

  1. each block scans from a zero state and keeps its summary: the decay
     a_blk = exp(A sum dt) and the state leaving it, h_blk;
  2. one all-gather of the summaries; every block folds those of the blocks
     before it in the walk into the state entering it (forward directions
     enter from the blocks to the left, the reversed ones from the right);
  3. each block scans again from that state and writes its outputs.

On the card the blocks run kernels B1 and B6 (`csrc/ss2d_scan_fwd.cu`,
`csrc/selective_scan_fwd.cu`): the summaries once, the combine across
segments twice (dry for the summary, then seeded with the entering state,
`CombineEnds` in `csrc/ss2d_scan_seg.cuh`), the output once. On CPU tensors
they run the plain versions, seeded the same way; `ss2d_scan_sp_ref` and
`selective_scan_sp_ref` run those on any device, to hold the kernels'
blocks against.

The backward of `ss2d_scan_sp` is the same algebra in reverse: B3a's
summaries, one all-gather of the carries leaving each block (with zero
carry in) and the decays, the suffix in walk order gives each block the
carry entering its last step, then B3's combine seeded with the forward's
entering state and that carry, and B3b's walk as it is. Seeded, the walk
gives the whole sequence's gradients on the block's steps: the seeds are
constants, not part of the graph. The parameters' gradients are summed over
the blocks and the inputs' gathered back to the full length. The backward
of `selective_scan_sp` is plain torch on both devices, as the unsplit
scan's is (no backward kernel for B6 in either package).

The exchange is one argument, `blocks`: `GroupBlocks(group)` runs this
process's block and meets the others through collectives over `group`;
`LocalBlocks(n)` runs all n blocks in this process, the all-gather a stack
of a list (the CPU tests and the card's one-process check).

Every block holds the whole sequence on entry and on exit (the sp ranks
compute the same activations outside the scan, as in the JAX package,
where only the scan is manual over `sp`); each slices its own block.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from tamtr_torch.kernels.selective_scan import (
    SCAN1D_MAX_DIN, SCAN1D_MAX_G, SCAN1D_STATES, SCAN_CHUNK, SEG_CHANNELS, _check_cuda, _direction_inputs,
    bwd_from_summaries, leaving_carry, selective_scan_bwd_ref, selective_scan_fwd_combine,
    selective_scan_fwd_output, selective_scan_fwd_summaries, selective_scan_ref, ss2d_pieces, ss2d_scan_bwd_ref,
    ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
    ss2d_scan_ref,
)


class LocalBlocks:
    """All n blocks of the sequence in this process: the all-gather is a
    stack of the blocks' tensors, the sum a sum over them."""

    def __init__(self, n: int):
        self.n, self.blocks = n, tuple(range(n))

    def gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack(list(xs))

    def sum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return total


class GroupBlocks:
    """This process's block of the sequence, one per rank of `group` (None:
    the default group), in rank order."""

    def __init__(self, group=None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.blocks = (dist.get_rank(group),)

    def gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        (x,) = xs
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(out, x, group=self.group)
        return torch.stack(out)

    def sum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        (x,) = xs
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x


def _fold(decay: torch.Tensor, state: torch.Tensor, order) -> torch.Tensor:
    """v = decay[j] v + state[j] over the blocks j in `order`, from v = 0:
    the state (or carry) that enters a block from those blocks."""
    v = torch.zeros_like(state[0])
    for j in order:
        v = decay[j] * v + state[j]
    return v


def _entering(summaries: torch.Tensor, r: int, backward: bool) -> torch.Tensor:
    """The (B, 4, D, N) state (or, `backward`, carry) entering block r of
    n, from the gathered (n, 2, B, 4, D, N) summaries (decay, leaving).
    Forward directions (k = 0, 1) walk the blocks left to right, reversed
    ones (k = 2, 3) right to left; the state comes from the blocks before r
    in the walk, the carry from those after it."""
    n = summaries.shape[0]
    left, right = range(r), range(n - 1, r, -1)
    fwd, rev = (right, left) if backward else (left, right)
    a, s = summaries[:, 0], summaries[:, 1]
    return torch.cat([_fold(a[:, :, :2], s[:, :, :2], fwd), _fold(a[:, :, 2:], s[:, :, 2:], rev)], 1).contiguous()


def _block(t: torch.Tensor, dim: int, r: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size)


def _ss2d_block_args(args, r: int, n: int):
    layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds = args
    return [_block(layouts, 2, r, n), _block(dts_raw, 3, r, n), dt_w, dt_b, A, _block(Bs, 3, r, n),
            _block(Cs, 3, r, n), Ds]


def _direction_summaries(args, last) -> torch.Tensor:
    """(2, B, 4, D, N): each direction's walk decay exp(A sum dt) and
    `last(k, u, dt, A_k, B_k, C_k)`, with torch ops."""
    layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, _ = args
    B, D, N = layouts.shape[0], A.shape[1], A.shape[2]
    decay, leave = [], []
    for k in range(4):
        u, dt, Bk, Ck = _direction_inputs(layouts, dts_raw, dt_w, dt_b, Bs, Cs, k)
        Ak = A[k].expand(B, D, N)
        decay.append(torch.exp(dt.sum(1)[..., None] * Ak))
        leave.append(last(k, u, dt, Ak, Bk, Ck))
    return torch.stack([torch.stack(decay, 1), torch.stack(leave, 1)])


class _Phases:
    """One block's phases of `ss2d_scan_sp`: the kernels (`cuda`) or the
    plain versions. `summary` returns (what the block keeps for its second
    phase, its (2, B, 4, D, N) summary)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def summary(self, args):
        if not self.cuda:
            return None, _direction_summaries(
                args, lambda k, u, dt, Ak, Bk, Ck: selective_scan_ref(u, dt, Ak, Bk, Ck, return_final=True)[1])
        args = _check_cuda("ss2d_scan_sp", *args, SEG_CHANNELS)
        h_loc, sdt = ss2d_scan_fwd_summaries(*args[:7])
        leave, decay = ss2d_scan_fwd_combine(args[4], h_loc, sdt, args[0].shape[2], dry=True)
        return (args, h_loc, sdt), torch.stack([decay, leave])

    def output(self, args, kept, seed, y_dtype):
        if not self.cuda:
            return ss2d_scan_ref(*args, y_dtype, h0=seed)
        args, h_loc, sdt = kept
        h_in = ss2d_scan_fwd_combine(args[4], h_loc, sdt, args[0].shape[2], seed=seed)
        return ss2d_scan_fwd_output(*args, h_in, y_dtype)

    def carry_summary(self, args, dy):
        if not self.cuda:
            def last(k, u, dt, Ak, Bk, Ck):
                dyk = dy[:, k].float()
                return leaving_carry(dt, Ak, Ck, dyk.flip(1) if k >= 2 else dyk)
            return None, _direction_summaries(args, last)
        args = _check_cuda("ss2d_scan_sp", *args, SEG_CHANNELS)
        summ = ss2d_scan_carriers(*args[:7], dy)
        leave_c, decay = ss2d_scan_combine(args[4], *summ, args[0].shape[2], dry=True)
        return (args, summ), torch.stack([decay, leave_c])

    def grads(self, args, dy, kept, h0, carry):
        if not self.cuda:
            return ss2d_scan_bwd_ref(*args, dy, h0=h0, carry=carry)
        args, summ = kept
        return bwd_from_summaries(args, dy, summ, seed_h=h0, seed_c=carry)


def _to_full(blocks, parts: List[torch.Tensor], dim: int) -> torch.Tensor:
    """The full-length tensor from this process's blocks along `dim`."""
    g = blocks.gather(parts)  # (n, ...)
    return torch.cat(g.unbind(0), dim)


class _SS2DScanSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, plain, layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype=None):
        args = (layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)
        ph = _Phases(not plain)
        mine = [_ss2d_block_args(args, r, blocks.n) for r in blocks.blocks]
        first = [ph.summary(a) for a in mine]
        summaries = blocks.gather([s for _, s in first])
        seeds = [_entering(summaries, r, backward=False) for r in blocks.blocks]
        ys = [ph.output(a, kept, seed, y_dtype) for a, (kept, _), seed in zip(mine, first, seeds)]
        ctx.blocks, ctx.plain, ctx.seeds = blocks, plain, seeds
        ctx.save_for_backward(*args)
        return _to_full(blocks, ys, 2)

    @staticmethod
    def backward(ctx, dy):
        blocks, args = ctx.blocks, ctx.saved_tensors
        ph = _Phases(not ctx.plain)
        dy = dy.to(args[0].dtype)
        mine = [_ss2d_block_args(args, r, blocks.n) for r in blocks.blocks]
        dys = [_block(dy, 2, r, blocks.n).contiguous() for r in blocks.blocks]
        first = [ph.carry_summary(a, d) for a, d in zip(mine, dys)]
        summaries = blocks.gather([s for _, s in first])
        carries = [_entering(summaries, r, backward=True) for r in blocks.blocks]
        grads = [ph.grads(a, d, kept, h0, c)
                 for a, d, (kept, _), h0, c in zip(mine, dys, first, ctx.seeds, carries)]
        d_layouts, d_dts, d_dtw, d_dtb, dA, dBs, dCs, d_Ds = zip(*grads)
        return (None, None, _to_full(blocks, d_layouts, 2), _to_full(blocks, d_dts, 3), blocks.sum(d_dtw),
                blocks.sum(d_dtb), blocks.sum(dA), _to_full(blocks, dBs, 3), _to_full(blocks, dCs, 3),
                blocks.sum(d_Ds), None)


def ss2d_scan_sp(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, blocks):
    """Sequence-parallel 4-direction SS2D scan: the contract of
    `kernels.selective_scan.ss2d_scan` (layouts (B, 2, L, D); dts_raw
    (B, 2, 2, L, R); dt_w (4, D, R); dt_b (4, D); A (4, D, N); Bs, Cs
    (B, 2, 2, L, N); Ds (4, D) -> y (B, 4, L, D) in the sequence dtype,
    fp32 or bf16, the seeds and summaries fp32), with the token axis
    cut into `blocks.n` blocks (L must divide by it), each direction's walk
    the two-phase blocked scan. Differentiable; on CUDA tensors at any N
    and D through `ss2d_pieces`, on CPU tensors by the plain versions."""
    if layouts.device.type == "cpu":
        return ss2d_scan_sp_ref(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, blocks)
    if layouts.device.type != "cuda":
        raise RuntimeError(f"ss2d_scan_sp: no kernel for device {layouts.device}")
    _check_blocks(layouts.shape[2], blocks)
    scan = lambda *a: _SS2DScanSP.apply(blocks, False, *a)  # noqa: E731
    return ss2d_pieces(scan, layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)


def ss2d_scan_sp_ref(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, blocks):
    """The plain version of `ss2d_scan_sp`, on any device: the same blocks
    and exchange, each block's phases the plain seeded scans
    (`ss2d_scan_ref(h0=)`, `ss2d_scan_bwd_ref(h0=, carry=)`)."""
    _check_blocks(layouts.shape[2], blocks)
    return _SS2DScanSP.apply(blocks, True, layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)


def _check_blocks(L: int, blocks) -> None:
    if L % blocks.n:
        raise ValueError(f"token axis {L} must divide over {blocks.n} blocks")


def _scan1d_cuda_summary(u, delta, A, Bs):
    """B6's summaries and a dry combine of one block: (kept, (2, G, Din, N))."""
    h_loc, sdt = selective_scan_fwd_summaries(u, delta, A, Bs)
    leave, decay = selective_scan_fwd_combine(A, h_loc, sdt, u.shape[1], dry=True)
    return (h_loc, sdt), torch.stack([decay, leave])


class _SelectiveScanSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, chunk, plain, u, delta, A, Bs, Cs, D):
        cuda = not plain
        n = blocks.n
        N = A.shape[-1]
        mine = [(_block(u, 1, r, n), _block(delta, 1, r, n), _block(Bs, 1, r, n), _block(Cs, 1, r, n))
                for r in blocks.blocks]
        if cuda:
            # a state size the kernels are compiled for: padded lanes (A = -1,
            # B = C = 0) stay 0 and add nothing to y
            Np = next(k for k in SCAN1D_STATES if k >= N)
            pad = torch.nn.functional.pad
            Ak = pad(A, (0, Np - N), value=-1.0).contiguous()
            mine = [(ub.contiguous(), db.contiguous(), pad(bb, (0, Np - N)).contiguous(),
                     pad(cb, (0, Np - N)).contiguous()) for ub, db, bb, cb in mine]
            first = [_scan1d_cuda_summary(ub, db, Ak, bb) for ub, db, bb, _ in mine]
        else:
            first = [(None, torch.stack([torch.exp(db.sum(1)[..., None] * A),
                                         selective_scan_ref(ub, db, A, bb, cb, chunk=chunk, return_final=True)[1]]))
                     for ub, db, bb, cb in mine]
        summaries = blocks.gather([s for _, s in first])
        seeds = [_fold(summaries[:, 0], summaries[:, 1], range(r)).contiguous() for r in blocks.blocks]
        ys = []
        for (ub, db, bb, cb), (kept, _), seed in zip(mine, first, seeds):
            if cuda:
                h_in = selective_scan_fwd_combine(Ak, kept[0], kept[1], ub.shape[1], seed=seed)
                ys.append(selective_scan_fwd_output(ub, db, Ak, bb, cb, D, h_in))
            else:
                ys.append(selective_scan_ref(ub, db, A, bb, cb, D, chunk=chunk, h0=seed))
        ctx.blocks, ctx.chunk = blocks, chunk
        ctx.seeds = [s[..., :N] for s in seeds]
        ctx.save_for_backward(u, delta, A, Bs, Cs, D)
        return _to_full(blocks, ys, 1)

    @staticmethod
    def backward(ctx, dy):
        blocks, chunk = ctx.blocks, ctx.chunk
        u, delta, A, Bs, Cs, D = ctx.saved_tensors
        n = blocks.n
        mine = [[_block(t, 1, r, n) for t in (u, delta, Bs, Cs, dy)] for r in blocks.blocks]
        summaries = blocks.gather([torch.stack([torch.exp(db.sum(1)[..., None] * A),
                                                leaving_carry(db, A, cb, dyb, chunk)]) for _, db, _, cb, dyb in mine])
        grads = []
        for r, (ub, db, bb, cb, dyb), h0 in zip(blocks.blocks, mine, ctx.seeds):
            carry = _fold(summaries[:, 0], summaries[:, 1], range(n - 1, r, -1))
            grads.append(selective_scan_bwd_ref(ub, db, A, bb, cb, D, dyb, chunk=chunk, h0=h0, carry=carry))
        du, ddelta, dA, dB, dC, dD = zip(*grads)
        return (None, None, None, _to_full(blocks, du, 1), _to_full(blocks, ddelta, 1), blocks.sum(dA),
                _to_full(blocks, dB, 1), _to_full(blocks, dC, 1), None if D is None else blocks.sum(dD))


def selective_scan_sp(u, delta, A, Bs, Cs, D, blocks, chunk: int = SCAN_CHUNK):
    """Sequence-parallel one-direction S6 scan: the contract of
    `kernels.selective_scan.selective_scan` (u, delta (G, L, Din); A
    (G, Din, N); Bs, Cs (G, L, N); D (G, Din) or None -> y (G, L, Din), from
    zero state), with L cut into `blocks.n` blocks (L must divide by it).
    fp32 maths and state; y and the cotangents in the inputs' dtypes. On
    CUDA tensors the forward runs kernel B6 per block (N <= 32, G and Din
    within one launch); the backward is `selective_scan_bwd_ref`, seeded,
    on both devices. `chunk` sets the plain versions' working set."""
    G, L, Din = u.shape
    if u.device.type == "cpu":
        return selective_scan_sp_ref(u, delta, A, Bs, Cs, D, blocks, chunk)
    if u.device.type != "cuda":
        raise RuntimeError(f"selective_scan_sp: no kernel for device {u.device}")
    if A.shape[-1] > max(SCAN1D_STATES) or G > SCAN1D_MAX_G or Din > SCAN1D_MAX_DIN:
        raise ValueError(f"selective_scan_sp: a block's kernel takes N <= {max(SCAN1D_STATES)}, G <= "
                         f"{SCAN1D_MAX_G} and Din <= {SCAN1D_MAX_DIN}, got N={A.shape[-1]}, G={G}, Din={Din}")
    return _scan1d_sp(u, delta, A, Bs, Cs, D, blocks, chunk, plain=False)


def selective_scan_sp_ref(u, delta, A, Bs, Cs, D, blocks, chunk: int = SCAN_CHUNK):
    """The plain version of `selective_scan_sp`, on any device: the same
    blocks and exchange, each block's forward `selective_scan_ref(h0=)`."""
    return _scan1d_sp(u, delta, A, Bs, Cs, D, blocks, chunk, plain=True)


def _scan1d_sp(u, delta, A, Bs, Cs, D, blocks, chunk, plain: bool):
    _check_blocks(u.shape[1], blocks)
    f32 = [t.float() if t is not None else None for t in (u, delta, A, Bs, Cs, D)]
    return _SelectiveScanSP.apply(blocks, chunk, plain, *f32).to(u.dtype)
