"""The seeded combines of kernels B1, B3 and B6 (`csrc/ss2d_scan_seg.cuh`
`CombineEnds`, `csrc/selective_scan_fwd.cu`) on the card, through the
sequence-parallel scans with their blocks in one process (`LocalBlocks`):
against the same scans on the CPU's plain versions (1e-4 forward, 2e-3
backward), bitwise over two calls, and the dry combine leaving the segment
states as they were.

Marked `cuda`; each test asks the `card` fixture, which skips when no CUDA
device is present. Run on a machine with an H100:
`python -m pytest tests/test_torch_cuda_seq_parallel.py --noconftest -m cuda`.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def scan_args(B, L, C, seed=3):
    """SS2D scan inputs on the CPU (as `tests/test_torch_cuda.py` makes
    them) and a dy."""
    g = torch.Generator().manual_seed(seed)
    D, R, N = 2 * C, math.ceil(C / 16), 16
    layouts = torch.randn(B, 2, L, D, generator=g)
    dts_raw, Bs, Cs = (torch.randn(B, 2, 2, L, R + 2 * N, generator=g) * 0.6).split([R, N, N], -1)
    dt_w = (torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5
    dt_b = torch.rand(4, D, generator=g) * -5 - 2
    A = -torch.exp(torch.rand(4, D, N, generator=g) * math.log(N))
    Ds = torch.randn(4, D, generator=g)
    return [layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds], torch.randn(B, 4, L, D, generator=g)


def fwd_bwd(fn, args, dy):
    ts = [a.detach().requires_grad_() for a in args]
    y = fn(*ts)
    return y.detach(), torch.autograd.grad(y, ts, dy)


# (B, L, C, n): one segment a block; one step past; ragged blocks of 100;
# one token a block; level 2's shape at 4 blocks
CASES = [(2, 96, 16, 2), (1, 98, 32, 2), (2, 400, 64, 4), (1, 3, 16, 3), (1, 1600, 512, 4)]


@pytest.mark.parametrize("B,L,C,n", CASES)
def test_ss2d_scan_sp_on_the_card_matches_the_plain_blocks(card, B, L, C, n):
    from tamtr_torch.kernels import selective_scan as ks
    from tamtr_torch.parallel.seq_scan import LocalBlocks, ss2d_scan_sp

    args, dy = scan_args(B, L, C)
    sp = lambda *a: ss2d_scan_sp(*a, LocalBlocks(n))  # noqa: E731
    want_y, want_g = fwd_bwd(sp, args, dy)
    counters = (ks.ss2d_scan_fwd_summaries, ks.ss2d_scan_fwd_combine, ks.ss2d_scan_fwd_output,
                ks.ss2d_scan_carriers, ks.ss2d_scan_combine, ks.ss2d_scan_bwd_walk)
    before = [f.launches for f in counters]
    on_card = [a.to(card) for a in args]
    y, grads = fwd_bwd(sp, on_card, dy.to(card))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [n, 2 * n, n, n, 2 * n, n]
    torch.testing.assert_close(y.cpu(), want_y, atol=1e-4, rtol=1e-4)
    for g, w in zip(grads, want_g):
        torch.testing.assert_close(g.cpu(), w, atol=2e-3, rtol=2e-3)
    y2, grads2 = fwd_bwd(sp, on_card, dy.to(card))
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_dry_combines_keep_the_segments_and_report_the_block(card):
    """dry=True leaves the summaries bitwise as they were; the reported
    decay and leaving state (or carry) are the plain block summary's."""
    from tamtr_torch.kernels.selective_scan import (
        _check_cuda, leaving_carry, selective_scan_ref, ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_fwd_combine,
        ss2d_scan_fwd_summaries,
    )
    from tamtr_torch.parallel.seq_scan import _direction_summaries

    args, dy = scan_args(2, 200, 32, seed=7)
    want = _direction_summaries(args, lambda k, u, dt, Ak, Bk, Ck: selective_scan_ref(
        u, dt, Ak, Bk, Ck, return_final=True)[1])
    want_c = _direction_summaries(args, lambda k, u, dt, Ak, Bk, Ck: leaving_carry(
        dt, Ak, Ck, dy[:, k].flip(1) if k >= 2 else dy[:, k]))
    c_args = _check_cuda("test", *[a.to(card) for a in args], 32)
    h_loc, sdt = ss2d_scan_fwd_summaries(*c_args[:7])
    kept = h_loc.clone()
    leave, decay = ss2d_scan_fwd_combine(c_args[4], h_loc, sdt, 200, dry=True)
    summ = ss2d_scan_carriers(*c_args[:7], dy.to(card))
    kept_b = [t.clone() for t in summ[:2]]
    leave_c, decay_b = ss2d_scan_combine(c_args[4], *summ, 200, dry=True)
    torch.cuda.synchronize()
    assert torch.equal(h_loc, kept) and all(torch.equal(a, b) for a, b in zip(summ[:2], kept_b))
    torch.testing.assert_close(decay.cpu(), want[0], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(decay_b, decay)
    torch.testing.assert_close(leave.cpu(), want[1], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(leave_c.cpu(), want_c[1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("G,L,Din,N,n", [(4, 96, 64, 16, 2), (2, 300, 40, 8, 3), (3, 64, 33, 5, 4)])
def test_selective_scan_sp_on_the_card_matches_the_plain_blocks(card, G, L, Din, N, n):
    """B6 per block (N = 5 padded to 8 on the card), seeded; the backward
    is plain torch on both devices."""
    from tamtr_torch.kernels import selective_scan as ks
    from tamtr_torch.parallel.seq_scan import LocalBlocks, selective_scan_sp

    g = torch.Generator().manual_seed(G + L)
    args = [torch.randn(G, L, Din, generator=g), torch.rand(G, L, Din, generator=g) * 0.1,
            -torch.rand(G, Din, N, generator=g) - 0.1, torch.randn(G, L, N, generator=g),
            torch.randn(G, L, N, generator=g), torch.randn(G, Din, generator=g)]
    dy = torch.randn(G, L, Din, generator=g)
    sp = lambda *a: selective_scan_sp(*a, LocalBlocks(n))  # noqa: E731
    want_y, want_g = fwd_bwd(sp, args, dy)
    before = [f.launches for f in (ks.selective_scan_fwd_summaries, ks.selective_scan_fwd_combine)]
    y, grads = fwd_bwd(sp, [a.to(card) for a in args], dy.to(card))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip((ks.selective_scan_fwd_summaries, ks.selective_scan_fwd_combine),
                                           before)] == [n, 2 * n]
    torch.testing.assert_close(y.cpu(), want_y, atol=1e-4, rtol=1e-4)
    for a, w in zip(grads, want_g):
        torch.testing.assert_close(a.cpu(), w, atol=2e-3, rtol=2e-3)
