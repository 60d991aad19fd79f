"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test asks the `card` fixture, which skips when no CUDA
device is present (as on CPU-only machines). Run on a machine with an H100:
`python -m pytest tests/test_torch_cuda.py -m cuda`.
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


@pytest.mark.parametrize("B,Q,P,c,shapes", [
    (2, 9, 4, 64, [(6, 7), (3, 4), (2, 3)]),  # ppq = 24, the compile-time case; float4 rows
    (2, 9, 1, 64, [(6, 7), (3, 4), (2, 3)]),  # ppq = 6 over 3 levels: the general path
    (2, 9, 2, 64, [(6, 7), (3, 4), (2, 3)]),  # ppq = 12
    (2, 9, 4, 34, [(6, 7), (3, 4), (2, 3)]),  # c % 4 == 2: float2 rows, one group
    (1, 5, 1, 64, [(5, 6)]),  # one level, P = 1: ppq = 2
    (1, 5, 2, 64, [(5, 6)]),  # one level, P = 2: ppq = 4
    (2, 9, 8, 64, [(6, 7), (3, 4), (2, 3)]),  # ppq = 48: a full chunk of 32 pairs, then 16; float4 rows
    (2, 9, 8, 34, [(6, 7), (3, 4), (2, 3)]),  # ppq = 48 with float2 rows
    (4, 700, 4, 64, [(160, 160), (80, 80), (40, 40)]),  # the 640 px training shape
])
def test_bilinear_gather_kernel_matches_plain(card, B, Q, P, c, shapes):
    """B2 against the plain 4-corner gather at 1e-5 and against itself
    bitwise over two calls, with a sample point in the global last pixel
    cell (its pair is shifted up one row), at the model's 24 pairs per query
    and at other counts (the kernel's general path)."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_pairs_ref, bilinear_gather_ref
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    g = torch.Generator().manual_seed(1)
    nh, nl = 8, len(shapes)
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g).to(card)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.4 - 0.2
    H, W = shapes[-1]
    loc[0, 0, 0, nl - 1, 0] = torch.tensor([1 - 0.2 / W, 1 - 0.2 / H])  # last pixel cell
    loc = loc.to(card)
    w_att = torch.rand(B, Q, nh, nl, P, generator=g).to(card)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    assert int(idx2.max()) == Lv - 1
    before = bilinear_gather.launches
    out, again = bilinear_gather(value, idx4, w_pairs, idx2, nl * P), bilinear_gather(value, idx4, w_pairs, idx2, nl * P)
    torch.cuda.synchronize()
    assert bilinear_gather.launches == before + 2
    assert torch.equal(out, again)
    want = bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bilinear_gather_pairs_ref(value, idx2, w_pairs, 2 * nl * P), want, atol=1e-5, rtol=1e-5)


def test_model_runs_through_both_kernels(card):
    from tamtr_torch import TAMTR
    from tamtr_torch.kernels.deform_scatter import bilinear_gather
    from tamtr_torch.kernels.selective_scan import (
        ss2d_scan, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
    )

    det = TAMTR("tamtr-nano.yaml", nc=4, device=card, imgsz=64)
    counters = (ss2d_scan, ss2d_scan_fwd_summaries, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, bilinear_gather)
    before = [f.launches for f in counters]
    res = det.predict(torch.rand(2, 64, 64, 3), torch.randn(4, 128), conf=0.0)
    assert len(res) == 2
    assert [f.launches - b for f, b in zip(counters, before)] == [3, 3, 3, 3, 3]


def _scan_bwd_args(card, B, H, W, C, seed=3):
    g = torch.Generator().manual_seed(seed)
    L, D, R, N = H * W, 2 * C, math.ceil(C / 16), 16
    layouts = torch.randn(B, 2, L, D, generator=g).to(card)
    dts_raw, Bs, Cs = (torch.randn(B, 2, 2, L, R + 2 * N, generator=g) * 0.6).to(card).split([R, N, N], -1)
    dt_w = ((torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5).to(card)
    dt_b = (torch.rand(4, D, generator=g) * -5 - 2).to(card)
    A = -torch.exp(torch.rand(4, D, N, generator=g) * math.log(N)).to(card)
    Ds = torch.randn(4, D, generator=g).to(card)
    dy = torch.randn(B, 4, L, D, generator=g).to(card)
    return (layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds), dy


SEGMENT_CASES = [
    (1, 1, 32, 1),  # L = 1
    (5, 7, 32, 2),  # L = 35, below one segment of SEG_STEPS = 48
    (6, 8, 32, 1),  # L = 48, one whole segment
    (7, 7, 32, 2),  # L = 49, one step past a segment
    (1, 97, 32, 2),  # L = 97, one step past two segments
    (20, 20, 128, 2),  # L = 400, a ragged last segment of 16
    (40, 40, 512, 1),  # level 2's shape, a ragged last segment of 16
    (40, 40, 512, 2),
]


@pytest.mark.parametrize("H,W,C,B", SEGMENT_CASES)
def test_ss2d_scan_kernel_matches_plain(card, H, W, C, B):
    """B1's three launches (summaries, combine, output) against the plain
    scan at 1e-4, each launch counted once and `ss2d_scan` once per call."""
    from tamtr_torch.kernels.selective_scan import (
        ss2d_scan, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, ss2d_scan_fwd_summaries, ss2d_scan_ref,
    )

    args, _ = _scan_bwd_args(card, B, H, W, C, seed=2)
    counters = (ss2d_scan, ss2d_scan_fwd_summaries, ss2d_scan_fwd_combine, ss2d_scan_fwd_output)
    before = [f.launches for f in counters]
    y = ss2d_scan(*args)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
    torch.testing.assert_close(y, ss2d_scan_ref(*args), atol=1e-4, rtol=1e-4)


def test_ss2d_scan_kernel_is_bitwise_deterministic(card):
    """Two calls of B1 on the same inputs give bitwise-equal outputs."""
    from tamtr_torch.kernels.selective_scan import ss2d_scan

    args, _ = _scan_bwd_args(card, 2, 20, 20, 128, seed=5)
    first, second = ss2d_scan(*args), ss2d_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("H,W,C,B", SEGMENT_CASES)
def test_ss2d_scan_bwd_kernels_match_plain(card, H, W, C, B):
    """B3a, the combine and B3b against the plain backward, gradients of
    all eight inputs at 2e-3."""
    from tamtr_torch.kernels.selective_scan import (
        ss2d_scan_bwd, ss2d_scan_bwd_ref, ss2d_scan_bwd_walk, ss2d_scan_carriers, ss2d_scan_combine,
    )

    args, dy = _scan_bwd_args(card, B, H, W, C)
    counters = (ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_bwd_walk)
    before = [f.launches for f in counters]
    got = ss2d_scan_bwd(*args, dy)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    for gk, wk in zip(got, ss2d_scan_bwd_ref(*args, dy)):
        torch.testing.assert_close(gk, wk, atol=2e-3, rtol=2e-3)


def test_ss2d_scan_bwd_kernels_are_bitwise_deterministic(card):
    """Two calls on the same inputs give bitwise-equal gradients: dB, dC
    and dA are partial sums added in a fixed order, no atomics."""
    from tamtr_torch.kernels.selective_scan import ss2d_scan_bwd

    args, dy = _scan_bwd_args(card, 2, 20, 20, 128, seed=4)
    first = ss2d_scan_bwd(*args, dy)
    second = ss2d_scan_bwd(*args, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bilinear_gather_bwd_kernel_matches_plain(card):
    """B4 against the plain backward at 1e-5, with a pair in the global
    last pixel cell, one at x0 < 0 and one on a level boundary; and the
    gradient to locations and attention weights through the core."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather_bwd, bilinear_gather_bwd_ref, pair_buckets
    from tamtr_torch.nn.decoder import deform_sampling_pairs, ms_deform_attn_core

    shapes = [(6, 7), (3, 4), (2, 3)]
    g = torch.Generator().manual_seed(4)
    B, Q, nh, c, nl, P = 2, 9, 8, 64, 3, 4
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.4 - 0.2
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / 3, 1 - 0.2 / 2])  # last pixel cell
    loc[0, 1, 1, 0, 2] = torch.tensor([0.2 / 7, 0.5])  # x0 < 0
    loc[1, 2, 0, 0, 3] = torch.tensor([1 - 0.3 / 7, 1 - 0.3 / 6])  # level boundary
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    dout = torch.randn(B, Q, nh, c, generator=g)
    value, loc, w_att, dout = (t.to(card) for t in (value, loc, w_att, dout))
    _, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    assert int(idx2.max()) == Lv - 1
    before = (pair_buckets.launches, bilinear_gather_bwd.launches)
    dv, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    torch.cuda.synchronize()
    assert (pair_buckets.launches, bilinear_gather_bwd.launches) == (before[0] + 1, before[1] + 1)
    dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    torch.testing.assert_close(dv, dv_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw, dw_ref, atol=1e-5, rtol=1e-5)

    grads = []
    for dev in (card, "cpu"):
        ts = [t.detach().to(dev).requires_grad_() for t in (value, loc, w_att)]
        (ms_deform_attn_core(ts[0], shapes, ts[1], ts[2]) * dout.to(dev).reshape(B, Q, -1)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("c,hot", [(64, False), (64, True), (34, True)])
def test_bilinear_gather_bwd_kernel_is_bitwise_repeatable(card, c, hot):
    """B4's two launches: the buckets equal `pair_buckets_ref`; dvalue is
    bitwise equal over two calls and to the plain row-owned version (the
    same multiply and add per term, in the same order); dw within 1e-5. With
    `hot`, all 24 pairs of 60 queries of one image and head start on one row
    (1440 terms there and on the row below: 45 segments each, their
    partials summed by the last to arrive); c = 34 leaves lanes of a row
    idle."""
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref, pair_buckets, pair_buckets_ref,
    )
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(16, 20), (8, 10), (4, 5)]
    g = torch.Generator().manual_seed(11)
    B, Q, nh, nl, P = 2, 60, 4, 3, 4
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.2 - 0.1
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / 5, 1 - 0.2 / 4])  # last pixel cell
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    dout = torch.randn(B, Q, nh, c, generator=g)
    _, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    if hot:
        idx2[1, :, 2] = 123
    value, w_pairs, idx2, dout = (t.to(card) for t in (value, w_pairs, idx2, dout))
    buckets, buckets_ref = pair_buckets(idx2, w_pairs, Lv), pair_buckets_ref(idx2, w_pairs, Lv)
    assert all(torch.equal(a, b) for a, b in zip(buckets, buckets_ref))
    dv, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    dv2, dw2 = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    torch.cuda.synchronize()
    assert torch.equal(dv, dv2) and torch.equal(dw, dw2)
    dv_rows, dw_rows = bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)
    assert torch.equal(dv, dv_rows)
    torch.testing.assert_close(dw, dw_rows, atol=1e-5, rtol=1e-5)
    dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    torch.testing.assert_close(dw, dw_ref, atol=1e-5, rtol=1e-5)
    if not hot:
        torch.testing.assert_close(dv, dv_ref, atol=1e-5, rtol=1e-5)


def test_auction_kernel_matches_plain_with_over_full_images(card):
    """B5 against the plain auction: identical assignments, an over-full
    image (more gts than queries) and a contested one included."""
    from tamtr_torch.kernels.auction import auction_assignment, auction_match, auction_match_ref

    g = torch.Generator().manual_seed(5)
    B, nq, M = 4, 100, 300
    cost = torch.randn(B, nq, M, generator=g)
    mask = torch.arange(M)[None] < torch.tensor([[30], [250], [80], [0]])
    before = auction_match.launches, auction_assignment.launches
    got = auction_match(cost.to(card), mask.to(card))
    assert (auction_match.launches, auction_assignment.launches) == (before[0] + 1, before[1])
    assert torch.equal(got.cpu(), auction_match_ref(cost, mask))
    got = auction_assignment(cost.to(card), mask.to(card))
    assert (auction_match.launches, auction_assignment.launches) == (before[0] + 1, before[1] + 1)  # one launch
    assert torch.equal(got.cpu(), auction_assignment(cost, mask))


def test_train_step_runs_through_every_kernel(card):
    from tamtr_torch import TAMTR
    from tamtr_torch.kernels.auction import auction_assignment, auction_match
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_bwd, pair_buckets
    from tamtr_torch.kernels.selective_scan import (
        ss2d_scan, ss2d_scan_bwd_walk, ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_fwd_combine,
        ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
    )
    from tamtr_torch.train.trainer import TrainConfig

    det = TAMTR("tamtr-nano.yaml", nc=4, device=card, imgsz=64, max_gt=8)
    tr = det.trainer(TrainConfig(batch_size=2, accumulate=1))
    counters = (ss2d_scan, ss2d_scan_fwd_summaries, ss2d_scan_fwd_combine, ss2d_scan_fwd_output,
                ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_bwd_walk, bilinear_gather, pair_buckets,
                bilinear_gather_bwd, auction_assignment, auction_match)
    before = [f.launches for f in counters]
    g = torch.Generator().manual_seed(6)
    mask = torch.arange(8)[None] < torch.tensor([[3], [8]])
    batch = {"img": torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=g),
             "txt_feats": torch.randn(1, 4, 128, generator=g), "cls": torch.randint(0, 4, (2, 8), generator=g),
             "bboxes": torch.rand(2, 8, 4, generator=g) * 0.4 + 0.1, "mask": mask}
    m = tr.step(batch)
    assert all(math.isfinite(v) for v in m.values()) and m["stepped"] == 1.0
    assert [f.launches - b for f, b in zip(counters, before)] == [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 1, 0]


@pytest.mark.parametrize("G,L,Din,N,with_d", [
    (4, 1000, 256, 16, True),
    (2, 77, 40, 4, False),
    (1, 1, 40, 16, True),  # L = 1
    (3, 35, 40, 8, False),  # L = 35, below one segment of SEG_STEPS = 48
    (2, 48, 1024, 32, True),  # one whole segment
    (2, 49, 40, 32, False),  # one step past a segment
    (1, 97, 1024, 4, True),  # one step past two segments
    (4, 400, 40, 16, False),  # a ragged last segment of 16
    (1, 400, 1024, 32, False),
    (2, 1600, 1024, 16, True),
    (2, 1600, 40, 8, True),
])
def test_selective_scan_kernel_matches_plain(card, G, L, Din, N, with_d):
    """B6's three launches (summaries, combine, output) against the plain
    scan at 1e-4 (ragged last segments, a ragged last block of channels when
    Din = 40, D None), each launch counted once and `selective_scan` once a
    call, two calls bitwise equal; the backward (torch ops on both devices)
    against autodiff of the plain version at 2e-3."""
    from tamtr_torch.kernels.selective_scan import (
        selective_scan, selective_scan_fwd_combine, selective_scan_fwd_output, selective_scan_fwd_summaries,
        selective_scan_ref,
    )

    g = torch.Generator().manual_seed(7)
    u, dy = torch.randn(G, L, Din, generator=g), torch.randn(G, L, Din, generator=g)
    delta = torch.rand(G, L, Din, generator=g) * 0.1
    A = -torch.exp(torch.rand(G, Din, N, generator=g) * math.log(N))
    Bs, Cs = torch.randn(G, L, N, generator=g), torch.randn(G, L, N, generator=g)
    D = torch.randn(G, Din, generator=g) if with_d else None
    args = [t.to(card).requires_grad_() if t is not None else None for t in (u, delta, A, Bs, Cs, D)]
    counters = (selective_scan, selective_scan_fwd_summaries, selective_scan_fwd_combine, selective_scan_fwd_output)
    before = [f.launches for f in counters]
    y = selective_scan(*args)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
    assert torch.equal(y, selective_scan(*args))
    want = selective_scan_ref(*args)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4)
    live = [t for t in args if t is not None]
    for a, b in zip(torch.autograd.grad(y, live, dy.to(card)), torch.autograd.grad(want, live, dy.to(card))):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-3)


def _within_fp32_sum_bound(got, rows, upd, shape):
    """got (fp32) against the fp64 sum of the updates `upd` (n, c) scattered
    to `rows` (n,) of a (rows, c) view of `shape`: every entry within its
    row's fp32 summation bound n_row * 2**-24 * sum |update|."""
    n_rows = math.prod(shape[:-1])
    ref = torch.zeros(n_rows, shape[-1], dtype=torch.float64, device=upd.device).index_add_(0, rows, upd.double())
    mag = torch.zeros_like(ref).index_add_(0, rows, upd.double().abs())
    ones = torch.ones_like(rows, dtype=torch.float64)
    count = torch.zeros(n_rows, dtype=torch.float64, device=upd.device).index_add_(0, rows, ones)
    err = (got.reshape(n_rows, -1).double() - ref).abs()
    return bool((err <= count[:, None] * 2.0**-24 * mag).all()), int(count.max())


def test_weighted_gather_bwd_kernel_matches_plain(card):
    """B7 (dvalue of `weighted_gather`: buckets, then the rows pass, two
    launches a call) bitwise equal to its rows transcription and over two
    calls; it and its plain scatter against the fp64 sum of the updates,
    each entry within its row's fp32 summation bound (n 2^-24 sum |w dout|,
    n the row's updates), with a row that 1440 updates hit (all 30 queries
    x 48 of one image and head); on rows of at most SEG_TERMS updates
    bitwise the plain scatter; dw against the plain version at 1e-5."""
    from tamtr_torch.kernels.deform_scatter import (
        SEG_TERMS, scatter_acc, scatter_acc_buckets, scatter_acc_ref, scatter_acc_rows_ref, weighted_gather,
        weighted_gather_ref,
    )

    g = torch.Generator().manual_seed(8)
    B, L, nh, c, Q, p4 = 2, 500, 8, 64, 30, 48
    value = torch.randn(B, L, nh, c, generator=g).to(card).requires_grad_()
    idx = torch.randint(0, L, (B, Q * p4, nh), generator=g, dtype=torch.int32)
    idx[1, :, 3] = L - 1
    idx = idx.to(card)
    w = torch.randn(B, Q * p4, nh, generator=g).to(card).requires_grad_()
    dout = torch.randn(B, Q, nh, c, generator=g).to(card)
    before = scatter_acc.launches, scatter_acc_buckets.launches
    dv, dw = torch.autograd.grad(weighted_gather(value, idx, w, p4), (value, w), dout)
    torch.cuda.synchronize()
    assert (scatter_acc.launches, scatter_acc_buckets.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(dv, scatter_acc(idx, w.detach(), dout, L))
    assert torch.equal(dv, scatter_acc_rows_ref(idx, w.detach(), dout, L))
    bi = torch.arange(B, device=card)[:, None, None]
    hi = torch.arange(nh, device=card)[None, None, :]
    rows = ((bi * L + idx.long()) * nh + hi).reshape(-1)
    upd = (w.detach()[..., None] * dout.repeat_interleave(p4, 1)).reshape(-1, c)
    plain = scatter_acc_ref(idx, w.detach(), dout, L)
    for got in (dv, plain):
        ok, hottest = _within_fp32_sum_bound(got, rows, upd, (B, L, nh, c))
        assert ok and hottest == Q * p4
    n_row = torch.zeros(B * L * nh, device=card).index_add_(0, rows, torch.ones_like(rows, dtype=torch.float32))
    short = (n_row <= SEG_TERMS).view(B, L, nh, 1).expand_as(dv)
    assert torch.equal(dv[short], plain[short])
    dw_ref = torch.autograd.grad(weighted_gather_ref(value, idx, w, p4), w, dout)[0]
    torch.testing.assert_close(dw, dw_ref, atol=1e-5, rtol=1e-5)


def test_scatter_acc_pairs_kernel_matches_plain(card):
    """B8 (buckets, then the rows pass, two launches a call) against the
    plain pair scatter at 1e-5 and bitwise against its rows transcription,
    pairs at start L2 - 2 and repeated; starts of -1, L2 - 1 and L2 follow
    the skip rule as the plain version does (row 0 alone, row L2 - 1 alone,
    nothing). Then a hot row: all 1440 pairs of one group start on one row,
    and the kernel and the plain version hold against the fp64 sum within
    each row's fp32 summation bound (n 2^-24 sum |w dout|)."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc_pairs, scatter_acc_pairs_buckets, scatter_acc_pairs_ref, scatter_acc_pairs_rows_ref,
    )

    g = torch.Generator().manual_seed(9)
    G, L2, c, Q, per_q = 16, 700, 64, 40, 24
    idx2 = torch.randint(0, L2 - 1, (G, Q * per_q), generator=g, dtype=torch.int32)
    idx2[0, :5] = L2 - 2
    idx2[1, 10:60] = idx2[1, 9]
    wa, wb = torch.randn(G, Q * per_q, generator=g), torch.randn(G, Q * per_q, generator=g)
    dout = torch.randn(G, Q, c, generator=g)
    args = [t.to(card) for t in (idx2, wa, wb, dout)]
    before = scatter_acc_pairs.launches, scatter_acc_pairs_buckets.launches
    out = scatter_acc_pairs(*args, L2)
    torch.cuda.synchronize()
    assert (scatter_acc_pairs.launches, scatter_acc_pairs_buckets.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, scatter_acc_pairs_ref(*args, L2), atol=1e-5, rtol=1e-5)
    assert torch.equal(out, scatter_acc_pairs_rows_ref(*args, L2))
    edge = args[0].clone()
    edge[2, :3] = torch.tensor([-1, L2 - 1, L2], dtype=torch.int32)
    out = scatter_acc_pairs(edge, *args[1:], L2)
    torch.cuda.synchronize()
    assert torch.equal(out, scatter_acc_pairs_rows_ref(edge, *args[1:], L2))
    torch.testing.assert_close(out, scatter_acc_pairs_ref(edge, *args[1:], L2), atol=1e-5, rtol=1e-5)
    rest = edge.clone()
    rest[2, :3] = 5
    wa0, wb0 = args[1].clone(), args[2].clone()
    wa0[2, :3] = wb0[2, :3] = 0.0
    want = scatter_acc_pairs_ref(rest, wa0, wb0, args[3], L2)
    want[2, 0] += args[2][2, 0] * args[3][2, 0]
    want[2, L2 - 1] += args[1][2, 1] * args[3][2, 0]
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)

    Q = 60  # 1440 pairs a group
    idx2 = torch.randint(0, L2 - 1, (G, Q * per_q), generator=g, dtype=torch.int32)
    idx2[5] = 333
    wa, wb = torch.randn(G, Q * per_q, generator=g), torch.randn(G, Q * per_q, generator=g)
    dout = torch.randn(G, Q, c, generator=g)
    args = [t.to(card) for t in (idx2, wa, wb, dout)]
    gi = torch.arange(G, device=card)[:, None] * L2
    rows = torch.cat([gi + args[0].long(), gi + args[0].long() + 1], 1).reshape(-1)
    d = args[3].repeat_interleave(per_q, 1)
    upd = torch.cat([args[1][..., None] * d, args[2][..., None] * d], 1).reshape(-1, c)
    out = scatter_acc_pairs(*args, L2)
    assert torch.equal(out, scatter_acc_pairs(*args, L2)) and torch.equal(out, scatter_acc_pairs_rows_ref(*args, L2))
    for got in (out, scatter_acc_pairs_ref(*args, L2)):
        ok, hottest = _within_fp32_sum_bound(got, rows, upd, (G, L2, c))
        assert ok and hottest == Q * per_q


def _decoder_points(g, B, Q, shapes, clustered, nh=8, P=4):
    """Sampling points and attention weights at the decoder's shapes, one in
    the global last pixel cell; `clustered` snaps the last level's points to
    3 x 3 cell centres (hundreds of pairs on a start row)."""
    nl = len(shapes)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.1 - 0.05
    if clustered:
        loc[:, :, :, nl - 1] = (torch.floor(loc[:, :, :, nl - 1].clamp(0, 0.999) * 3) + 0.5) / 3
    H, W = shapes[-1]
    loc[0, 0, 0, nl - 1, 0] = torch.tensor([1 - 0.2 / W, 1 - 0.2 / H])
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    return loc, w_att / w_att.sum((-1, -2), keepdim=True)


@pytest.mark.parametrize("clustered", [False, True])
def test_row_scatters_and_buckets_at_the_decoder_shapes(card, clustered):
    """At value (4, 33600, 8, 64), Q = 700 (the 640 px decoder with its dn
    queries), on uniform and clustered points: B7 on the corner rows and
    weights and B8 on the shifted pairs (G = 32), each bitwise equal to its
    rows transcription and over two calls, its buckets equal to their plain
    version; B4's buckets launch equal to `pair_buckets_ref` on the pairs."""
    from tamtr_torch.kernels.deform_scatter import (
        _shift_last_row, pair_buckets, pair_buckets_ref, scatter_acc, scatter_acc_buckets, scatter_acc_buckets_ref,
        scatter_acc_pairs, scatter_acc_pairs_buckets, scatter_acc_pairs_buckets_ref, scatter_acc_pairs_rows_ref,
        scatter_acc_rows_ref,
    )
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(160, 160), (80, 80), (40, 40)]
    B, Q, nh, c = 4, 700, 8, 64
    Lv = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(13 + clustered)
    loc, w_att = _decoder_points(g, B, Q, shapes, clustered)
    dout = torch.randn(B, Q, nh, c, generator=g).to(card)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc.to(card), w_att.to(card))
    assert all(torch.equal(a, b) for a, b in zip(pair_buckets(idx2, w_pairs, Lv), pair_buckets_ref(idx2, w_pairs, Lv)))

    w4 = w_pairs.transpose(2, 3).reshape(B, idx4.shape[1], nh).contiguous()
    got = scatter_acc(idx4, w4, dout, Lv)
    assert torch.equal(got, scatter_acc(idx4, w4, dout, Lv))
    assert torch.equal(got, scatter_acc_rows_ref(idx4, w4, dout, Lv))
    assert all(torch.equal(a, b) for a, b in zip(scatter_acc_buckets(idx4, w4, Lv),
                                                 scatter_acc_buckets_ref(idx4, w4, Lv)))
    del got

    i2, wp, _ = _shift_last_row(idx2, w_pairs, Lv)
    per_g = lambda t: t.transpose(1, 2).reshape(B * nh, -1).contiguous()  # noqa: E731
    pairs = (per_g(i2), per_g(wp[..., 0]), per_g(wp[..., 1]), dout.transpose(1, 2).reshape(B * nh, Q, c).contiguous())
    got = scatter_acc_pairs(*pairs, Lv)
    assert torch.equal(got, scatter_acc_pairs(*pairs, Lv))
    assert torch.equal(got, scatter_acc_pairs_rows_ref(*pairs, Lv))
    assert all(torch.equal(a, b) for a, b in zip(scatter_acc_pairs_buckets(*pairs[:3], Lv),
                                                 scatter_acc_pairs_buckets_ref(*pairs[:3], Lv)))


@pytest.mark.parametrize("c", [33, 130])
def test_row_scatters_any_channels(card, c):
    """B7 and B8 at an odd c (padded to even) and at c > 64 (a rows launch
    per 64 channels, the arrival counts reset between them), with rows of
    more than SEG_TERMS terms: bitwise their rows transcriptions, and two
    launches a call per 64 channels."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc, scatter_acc_buckets, scatter_acc_pairs, scatter_acc_pairs_buckets, scatter_acc_pairs_rows_ref,
        scatter_acc_rows_ref,
    )

    g = torch.Generator().manual_seed(c)
    B, L, nh, Q, p4 = 2, 300, 4, 50, 24
    idx = torch.randint(0, L, (B, Q * p4, nh), generator=g, dtype=torch.int32)
    idx[0, :200, 1] = 17  # a row of 200 terms: 7 segments
    w, dout = torch.randn(B, Q * p4, nh, generator=g), torch.randn(B, Q, nh, c, generator=g)
    idx, w, dout = (t.to(card) for t in (idx, w, dout))
    before = scatter_acc.launches, scatter_acc_buckets.launches
    got = scatter_acc(idx, w, dout, L)
    torch.cuda.synchronize()
    assert (scatter_acc.launches, scatter_acc_buckets.launches) == (before[0] + -(-c // 64), before[1] + 1)
    assert got.shape == (B, L, nh, c) and torch.equal(got, scatter_acc_rows_ref(idx, w, dout, L))

    pairs = (idx[..., 0].contiguous(), w[..., 0].contiguous(), w[..., 1].contiguous(), dout[:, :, 0].contiguous())
    before = scatter_acc_pairs.launches, scatter_acc_pairs_buckets.launches
    got = scatter_acc_pairs(*pairs, L)
    torch.cuda.synchronize()
    assert (scatter_acc_pairs.launches, scatter_acc_pairs_buckets.launches) == (before[0] + -(-c // 64), before[1] + 1)
    assert got.shape == (B, L, c) and torch.equal(got, scatter_acc_pairs_rows_ref(*pairs, L))


@pytest.mark.parametrize("n,rows", [
    (131077, 1_000_000),  # the share and the bucket range beyond shared memory: global passes, binary searches
    (5003, 2_000_000),  # shares staged, offsets by binary search
    (200_003, 1000),  # shares from global memory, offsets counted
])
def test_row_scatters_beyond_shared_memory(card, n, rows):
    """B7 and B8 on one group whose share of the sort or range of buckets
    does not fit a block's shared memory (the kernel's global-memory paths):
    buckets equal to their plain versions, outputs bitwise their rows
    transcriptions, with out-of-range starts."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc, scatter_acc_buckets, scatter_acc_buckets_ref, scatter_acc_pairs, scatter_acc_pairs_buckets,
        scatter_acc_pairs_buckets_ref, scatter_acc_pairs_rows_ref, scatter_acc_rows_ref,
    )

    g = torch.Generator().manual_seed(n % 97)
    c = 8
    idx = torch.randint(-1, rows + 1, (1, n), generator=g, dtype=torch.int32)
    idx[0, : n // 4] = rows // 3  # a hot row
    w, w2 = torch.randn(1, n, generator=g), torch.randn(1, n, generator=g)
    dout = torch.randn(1, n, c, generator=g)
    idx, w, w2, dout = (t.to(card) for t in (idx, w, w2, dout))
    assert all(torch.equal(a, b) for a, b in zip(scatter_acc_pairs_buckets(idx, w, w2, rows),
                                                 scatter_acc_pairs_buckets_ref(idx, w, w2, rows)))
    assert torch.equal(scatter_acc_pairs(idx, w, w2, dout, rows), scatter_acc_pairs_rows_ref(idx, w, w2, dout, rows))
    i7, w7, d7 = idx[..., None], w[..., None], dout[:, :, None]
    assert all(torch.equal(a, b) for a, b in zip(scatter_acc_buckets(i7, w7, rows), scatter_acc_buckets_ref(i7, w7, rows)))
    assert torch.equal(scatter_acc(i7, w7, d7, rows), scatter_acc_rows_ref(i7, w7, d7, rows))


@pytest.mark.parametrize("G,L,Din,N", [
    (3, 100, 40, 1),  # padded to 4 state lanes
    (2, 77, 64, 3),  # padded to 4
    (2, 130, 40, 12),  # padded to 16
    (2, 50, 64, 48),  # two state groups: 32 and 16
    (70000, 5, 8, 4),  # G beyond the grid's y: two launches' pieces
])
def test_selective_scan_kernel_any_shape(card, G, L, Din, N):
    """B6 on shapes its kernels are not compiled for: the state padded and
    split, G cut into pieces (`scan1d_pieces`), against the plain scan at
    1e-4; three launches a piece."""
    from tamtr_torch.kernels.selective_scan import (
        SCAN1D_MAX_G, selective_scan, selective_scan_fwd_summaries, selective_scan_ref,
    )

    g = torch.Generator().manual_seed(G + N)
    u, delta = torch.randn(G, L, Din, generator=g), torch.rand(G, L, Din, generator=g) * 0.1
    A = -torch.exp(torch.rand(G, Din, N, generator=g) * math.log(N + 1))
    Bs, Cs = torch.randn(G, L, N, generator=g), torch.randn(G, L, N, generator=g)
    D = torch.randn(G, Din, generator=g)
    args = [t.to(card) for t in (u, delta, A, Bs, Cs, D)]
    before = selective_scan.launches, selective_scan_fwd_summaries.launches
    y = selective_scan(*args)
    torch.cuda.synchronize()
    pieces = -(-N // 32) * -(-G // SCAN1D_MAX_G)
    assert (selective_scan.launches, selective_scan_fwd_summaries.launches) == (before[0] + 1, before[1] + pieces)
    torch.testing.assert_close(y, selective_scan_ref(*args), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,M", [(160, 300), (6, 600)])
def test_auction_kernel_any_batch_and_size(card, B, M):
    """B5 at more problems than the card has SMs, and at M = 600, whose
    value block exceeds a block's shared memory: identical assignments,
    over-full problems (batch-wide stop) included."""
    from tamtr_torch.kernels.auction import auction_match, auction_match_ref

    g = torch.Generator().manual_seed(10)
    nq = 100
    cost = torch.rand(B, nq, M, generator=g)
    n_valid = torch.randint(0, M + 1, (B,), generator=g)
    n_valid[0], n_valid[-1] = M, 70
    mask = torch.arange(M)[None] < n_valid[:, None]
    before = auction_match.launches
    got = auction_match(cost.to(card), mask.to(card))
    torch.cuda.synchronize()
    assert auction_match.launches == before + 1
    assert torch.equal(got.cpu(), auction_match_ref(cost, mask))


@pytest.mark.parametrize("B,M", [(16, 300), (160, 300), (6, 600)])
def test_auction_assignment_kernel_any_batch_and_size(card, B, M):
    """B5's one-launch assignment against the CPU's (`auction_assignment_ref`,
    equal to JAX's): identical at the train cost's size, at more problems
    than the card has SMs and at M = 600 (value beyond a block's shared
    memory), with over-full, contested and empty images; and no host sync
    (`torch.cuda.set_sync_debug_mode("error")`)."""
    from tamtr_torch.kernels.auction import auction_assignment, auction_assignment_ref

    g = torch.Generator().manual_seed(12)
    nq = 100
    cost = torch.rand(B, nq, M, generator=g)
    n_valid = torch.randint(0, M + 1, (B,), generator=g)
    n_valid[0], n_valid[1], n_valid[2], n_valid[-1] = M, 70, 0, 101
    mask = torch.arange(M)[None] < n_valid[:, None]
    C, m = cost.to(card), mask.to(card)
    before = auction_assignment.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = auction_assignment(C, m)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert auction_assignment.launches == before + 1
    assert torch.equal(got.cpu(), auction_assignment_ref(cost, mask))


def test_engine_trains_and_validates_on_a_dataset(card, tmp_path):
    """One epoch of `Engine.train` on the generated dataset of
    `tools/smoke_train_torch.py` at 128 px with the full-width model, then
    `Engine.val` on the `best` checkpoint, all on the card: the scan and
    gather forward and backward kernels and the auction launch in training,
    the forward kernels in val."""
    import sys
    from pathlib import Path

    from tamtr_torch.engine.model import Engine
    from tamtr_torch.kernels.auction import auction_assignment
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_bwd, pair_buckets
    from tamtr_torch.kernels.selective_scan import ss2d_scan, ss2d_scan_bwd_walk, ss2d_scan_carriers

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from smoke_train_torch import make_dataset

    data = str(make_dataset(tmp_path / "data", 8, 4, 128))
    train_kernels = (ss2d_scan, bilinear_gather, ss2d_scan_carriers, ss2d_scan_bwd_walk, pair_buckets,
                     bilinear_gather_bwd, auction_assignment)
    for f in train_kernels:
        f.launches = 0
    eng = Engine("tamtr.yaml")
    res = eng.train(data=data, epochs=1, batch=4, imgsz=128, max_gt=16, workers=2, warmup_epochs=2, conf=0.05,
                    plots=False, project=str(tmp_path / "runs"), name="run")
    assert all(f.launches > 0 for f in train_kernels), {f.__name__: f.launches for f in train_kernels}
    assert all(0.0 <= res[k] <= 1.0 for k in ("mAP50", "mAP50-95", "precision", "recall"))
    for f in train_kernels:
        f.launches = 0
    val = Engine("tamtr.yaml").load(tmp_path / "runs" / "run" / "weights" / "best.pt").val(
        data=data, imgsz=128, batch=4, conf=0.05, plots=False)
    assert ss2d_scan.launches == 3 and bilinear_gather.launches == 3  # one forward of the 4 val images
    assert all(f.launches == 0 for f in train_kernels[2:])
    assert val["mAP50"] == pytest.approx(res["mAP50"], abs=1e-6)


def _pieces_args(card, N, D, B=2, L=63, seed=6):
    g = torch.Generator().manual_seed(seed)
    R = math.ceil(D / 32)
    layouts = torch.randn(B, 2, L, D, generator=g)
    dts_raw, Bs, Cs = (torch.randn(B, 2, 2, L, R + 2 * N, generator=g) * 0.6).split([R, N, N], -1)
    dt_w = (torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5
    dt_b = torch.rand(4, D, generator=g) * -2 - 2
    A = -torch.exp(torch.rand(4, D, N, generator=g) * 1.5)
    Ds = torch.randn(4, D, generator=g)
    dy = torch.randn(B, 4, L, D, generator=g)
    return [t.to(card) for t in (layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)], dy.to(card)


@pytest.mark.parametrize("N", [1, 8, 12, 24, 48])
@pytest.mark.parametrize("D", [40, 96])
def test_ss2d_scan_any_state_size_and_width(card, N, D):
    """`ss2d_scan` on the card at state sizes and widths B1 and B3 are not
    compiled for, on the pieces of `ss2d_pieces` (one B1 call per group of
    16 state lanes): the forward within 1e-4 and the eight gradients
    within 2e-3 of the plain scan and its plain backward."""
    from tamtr_torch.kernels.selective_scan import ss2d_scan, ss2d_scan_bwd_ref, ss2d_scan_carriers, ss2d_scan_ref

    args, dy = _pieces_args(card, N, D)
    ts = [t.detach().clone().requires_grad_(True) for t in args]
    before, before_bwd = ss2d_scan.launches, ss2d_scan_carriers.launches
    y = ss2d_scan(*ts)
    y.backward(dy)
    torch.cuda.synchronize()
    groups = -(-N // 16)
    assert (ss2d_scan.launches - before, ss2d_scan_carriers.launches - before_bwd) == (groups, groups)
    torch.testing.assert_close(y.detach(), ss2d_scan_ref(*args), atol=1e-4, rtol=1e-4)
    for t, want in zip(ts, ss2d_scan_bwd_ref(*args, dy)):
        torch.testing.assert_close(t.grad, want, atol=2e-3, rtol=2e-3)


def test_jpeg_fixtures_decode_to_their_cv2_digests(card):
    """The committed JPEG fixtures decode, on the card's machine (no cv2
    there), to the sha256 digests cv2 gave when they were written
    (`tools/make_jpeg_fixtures_torch.py`)."""
    import hashlib
    import json
    from pathlib import Path

    from tamtr_torch.data.image_io import imread, jpeg_shape

    root = Path(__file__).resolve().parent / "torch_data" / "jpeg"
    expected = json.loads((root / "expected.json").read_text())
    for name, want in expected.items():
        img = imread(root / name)
        assert list(img.shape) == want["shape"] and tuple(jpeg_shape(root / name)) == img.shape[:2], name
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], name


def test_jpeg_fixtures_encode_to_their_cv2_digests(card):
    """Each committed fixture's decode, encoded on the card's machine by the
    host encoder at quality 95, gives the sha256 of the bytes
    `cv2.imencode(".jpg", ...)` gave when the fixtures were written."""
    import hashlib
    import json
    from pathlib import Path

    from tamtr_torch.data.image_io import encode_jpeg, imread

    root = Path(__file__).resolve().parent / "torch_data" / "jpeg"
    expected = json.loads((root / "expected.json").read_text())
    assert any(name.startswith("prog") for name in expected)
    for name, want in expected.items():
        assert hashlib.sha256(encode_jpeg(imread(root / name))).hexdigest() == want["imencode_sha256"], name


@torch.no_grad()
def _spread_scores(model, seed: int):
    """Small random values in the zero-initialised head layers and a zero
    contrastive bias (as `chip_smoke.py:spread_scores`), so that scores
    spread and boxes move."""
    g = torch.Generator().manual_seed(seed)
    head = model.model[-1]
    for mlp in [head.enc_bbox_head, *head.dec_bbox_head]:
        mlp.layers[-1].weight.copy_(torch.randn(mlp.layers[-1].weight.shape, generator=g) * 0.05)
    for layer in head.decoder["layers"]:
        for lin in (layer.cross_attn.sampling_offsets, layer.cross_attn.attention_weights):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    for sh in head.dec_score_head:
        sh.bias.zero_()


@pytest.mark.parametrize("tracker,kw", [("bytetrack", {}), ("botsort", {"gmc_method": "none", "with_reid": True})])
def test_track_on_the_card_matches_the_cpu(card, tmp_path, tracker, kw):
    """`TAMTR.track` of the nano model over 6 generated JPEG frames at 64 px
    on the card and on the CPU (the same weights, classes and tracker): the
    same track ids, boxes at 1e-3 of the frame; B1 and B2 once per frame."""
    import numpy as np

    from tamtr_torch.api import TAMTR
    from tamtr_torch.data.image_io import imwrite
    from tamtr_torch.kernels.deform_scatter import bilinear_gather
    from tamtr_torch.kernels.selective_scan import ss2d_scan
    from tamtr_torch.trackers.byte_tracker import Track

    rng = np.random.default_rng(9)
    for f in range(6):
        frame = rng.integers(0, 50, (96, 128, 3), dtype=np.uint8)
        for k in range(3):
            x, y = 8 + 30 * k + 5 * f, 10 + 20 * k + 2 * f
            frame[y:y + 24, x:x + 30] = (60 + 60 * k, 200 - 50 * k, 90)
        imwrite(tmp_path / f"{f:03d}.jpg", frame)
    text = rng.standard_normal((3, 128)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    results = {}
    for dev in ("cpu", "cuda"):
        det = TAMTR("tamtr-nano.yaml", nc=3, device=dev, imgsz=64, seed=2)
        _spread_scores(det.model, seed=2)
        det.set_classes(["a", "b", "c"], text)
        Track.reset_id()
        ss2d_scan.launches = bilinear_gather.launches = 0
        results[dev] = det.track(str(tmp_path), tracker=tracker, conf=0.05, **kw)
        assert (ss2d_scan.launches, bilinear_gather.launches) == ((0, 0) if dev == "cpu" else (18, 18))
    assert sum(len(r.track_ids) for r in results["cpu"]) > 0
    for g, w in zip(results["cuda"], results["cpu"], strict=True):
        np.testing.assert_array_equal(g.track_ids, w.track_ids)
        np.testing.assert_allclose(g.boxes.xyxy / 128, w.boxes.xyxy / 128, rtol=0, atol=1e-3)


def test_fused_forward_matches_unfused_on_the_card(card):
    """The fused twin (`nn/fuse.py`) of the full-width model against the
    unfused model on the card at 128 px, batch 2: within 1e-4 as a
    tie-robust set; B1 and B2 launch as often in both."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from tamtr_torch.kernels.deform_scatter import bilinear_gather
    from tamtr_torch.kernels.selective_scan import ss2d_scan
    from tamtr_torch.nn.fuse import fuse_model
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    model = TAMTRModel.from_cfg("tamtr.yaml", nc=10)
    init_parameters(model, 0)
    _spread_scores(model, seed=0)
    model = model.to(card).eval()
    g = torch.Generator().manual_seed(3)
    img = torch.rand(2, 128, 128, 3, generator=g).to(card)
    txt = torch.nn.functional.normalize(torch.randn(1, 10, 512, generator=g), dim=-1).to(card)
    fused = fuse_model(model)
    with torch.inference_mode():
        ss2d_scan.launches = bilinear_gather.launches = 0
        want = model(img, txt)["pred"].cpu().numpy()
        plain = (ss2d_scan.launches, bilinear_gather.launches)
        got = fused(img, txt)["pred"].cpu().numpy()
    assert (ss2d_scan.launches, bilinear_gather.launches) == (2 * plain[0], 2 * plain[1]) and plain[0] > 0
    for b in range(2):
        dist = np.abs(got[b][:, None] - want[b][None]).max(-1)
        r, c = linear_sum_assignment(dist)
        assert (dist[r, c] < 1e-4).sum() >= len(r) - 2, np.sort(dist[r, c])[-3:]


def test_autobatch_train_on_the_card(card):
    """`autobatch_train` of the nano model at 64 px fits a batch in [1, 64]
    from two probe training steps, and leaves the caller's RNG as it was."""
    from tamtr_torch.utils.autobatch import autobatch_train

    state = torch.random.get_rng_state()
    b = autobatch_train("tamtr-nano.yaml", nc=3, imgsz=64, max_gt=8, device=card, max_batch=64)
    assert 1 <= b <= 64
    assert torch.equal(torch.random.get_rng_state(), state)


# ---------------------------------------------------------------------------
# bf16 I/O of B1, B3, B2 and B4: each kernel against its plain bf16 version
# (fp32 maths, rounded once), and bitwise over two calls
# ---------------------------------------------------------------------------

BF16_SCAN_CASES = [
    (1, 1, 32, 1),  # L = 1
    (5, 7, 32, 2),  # L = 35
    (6, 8, 32, 1),  # L = 48
    (7, 7, 32, 2),  # L = 49
    (1, 97, 32, 2),  # L = 97
    (20, 20, 128, 2),  # L = 400
    (40, 40, 512, 2),  # L = 1600
]


def _bf16_seq(args):
    """The scan's sequence tensors (layouts, dts_raw, Bs, Cs) in bf16, the
    parameters fp32."""
    return [t.to(torch.bfloat16) if i in (0, 1, 5, 6) else t for i, t in enumerate(args)]


def _within_bf16_steps(got, want, steps: float, floor: float):
    """|got - want| within `steps` bf16 steps (2^-7 of the larger
    magnitude's power of two) beyond an absolute floor."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    unit = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    worst = float(((got - want).abs() - floor).clamp(min=0).div(unit).max())
    assert worst <= steps, worst


@pytest.mark.parametrize("H,W,C,B", BF16_SCAN_CASES)
def test_ss2d_scan_kernels_bf16_match_plain(card, H, W, C, B):
    """B1 and B3 at bf16 sequence I/O against the plain scan and backward
    at bf16: y within one bf16 step beyond 2^-10 absolute (both compute in
    fp32 and round once); every gradient in its primal's dtype, the bf16
    ones (d_layouts, d_dts, dBs, dCs) within 2e-2 of the plain ones and the
    fp32 ones within 2e-3; two calls bitwise equal."""
    from tamtr_torch.kernels.selective_scan import (
        ss2d_scan, ss2d_scan_bwd, ss2d_scan_bwd_ref, ss2d_scan_carriers, ss2d_scan_ref,
    )

    args, dy = _scan_bwd_args(card, B, H, W, C, seed=7)
    args, dy = _bf16_seq(args), dy.to(torch.bfloat16)
    before = (ss2d_scan.launches, ss2d_scan_carriers.launches)
    y, y2 = ss2d_scan(*args), ss2d_scan(*args)
    got, got2 = ss2d_scan_bwd(*args, dy), ss2d_scan_bwd(*args, dy)
    torch.cuda.synchronize()
    assert (ss2d_scan.launches - before[0], ss2d_scan_carriers.launches - before[1]) == (2, 2)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
    _within_bf16_steps(y, ss2d_scan_ref(*args), 1.0, 2.0**-10)
    for i, (g, want, primal) in enumerate(zip(got, ss2d_scan_bwd_ref(*args, dy), args)):
        assert g.dtype == want.dtype == primal.dtype, i
        tol = 2e-2 if g.dtype == torch.bfloat16 else 2e-3
        torch.testing.assert_close(g.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("N,D", [(8, 40), (24, 96)])
def test_ss2d_scan_bf16_any_state_size_and_width(card, N, D):
    """bf16 sequence I/O through `ss2d_pieces` (padded lanes and channels):
    y within one bf16 step beyond 2^-10 of the unsplit plain scan at every
    N (several groups of 16 lanes write y in fp32 and the sum is rounded
    once, as the unsplit scan rounds); the gradients against the same
    pieces on the CPU's plain scan and plain backward (`_SS2DScan` there:
    du rounded to bf16 before the D-skip, as the kernels do), the fp32 ones
    within 2e-3, the bf16 ones within 2e-2 relative and 4e-2 absolute
    (autograd adds the groups' bf16 gradients in bf16)."""
    from tamtr_torch.kernels.selective_scan import _SS2DScan, ss2d_pieces, ss2d_scan, ss2d_scan_ref

    args, dy = _pieces_args(card, N, D)
    args, dy = _bf16_seq(args), dy.to(torch.bfloat16)
    ts = [t.detach().clone().requires_grad_(True) for t in args]
    y = ss2d_scan(*ts)
    y.backward(dy)
    refs = [t.detach().cpu().requires_grad_(True) for t in args]
    ss2d_pieces(_SS2DScan.apply, *refs).backward(dy.cpu())
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    _within_bf16_steps(y.detach(), ss2d_scan_ref(*args), 1.0, 2.0**-10)
    for t, r in zip(ts, refs):
        assert t.grad.dtype == t.dtype
        atol, rtol = (4e-2, 2e-2) if t.dtype == torch.bfloat16 else (2e-3, 2e-3)
        torch.testing.assert_close(t.grad.float().cpu(), r.grad.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,Q,P,c,shapes", [
    (2, 9, 4, 64, [(6, 7), (3, 4), (2, 3)]),  # ppq = 24, four bf16 a lane
    (2, 9, 1, 64, [(6, 7), (3, 4), (2, 3)]),  # the general path
    (2, 9, 4, 34, [(6, 7), (3, 4), (2, 3)]),  # two bf16 a lane
    (4, 700, 4, 64, [(160, 160), (80, 80), (40, 40)]),  # the 640 px training shape
])
def test_bilinear_gather_kernel_bf16_matches_plain(card, B, Q, P, c, shapes):
    """B2 on bf16 value rows: out bf16, within 2e-2 of the plain gather at
    bf16 (fp32 sums, rounded once), bitwise over two calls, with a sample
    point in the global last pixel cell."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_ref
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    g = torch.Generator().manual_seed(2)
    nh, nl = 8, len(shapes)
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g).to(card, torch.bfloat16)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.4 - 0.2
    H, W = shapes[-1]
    loc[0, 0, 0, nl - 1, 0] = torch.tensor([1 - 0.2 / W, 1 - 0.2 / H])
    w_att = torch.rand(B, Q, nh, nl, P, generator=g).to(card)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc.to(card), w_att)
    assert int(idx2.max()) == Lv - 1
    out, again = bilinear_gather(value, idx4, w_pairs, idx2, nl * P), bilinear_gather(value, idx4, w_pairs, idx2, nl * P)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    torch.testing.assert_close(out.float(), bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("c,hot", [(64, False), (64, True), (34, True)])
def test_bilinear_gather_bwd_kernel_bf16_is_bitwise_the_rows_version(card, c, hot):
    """B4 on bf16 value and dout: dvalue bf16, bitwise equal over two calls
    and to `bilinear_gather_bwd_rows_ref` at bf16 (the same fp32 terms and
    sums, rounded once at the row's store), within 3e-2 of the scatter-add
    form; dw fp32 within 1e-4 of both."""
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref,
    )
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(16, 20), (8, 10), (4, 5)]
    g = torch.Generator().manual_seed(12)
    B, Q, nh, nl, P = 2, 60, 4, 3, 4
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.2 - 0.1
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / 5, 1 - 0.2 / 4])  # last pixel cell
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    dout = torch.randn(B, Q, nh, c, generator=g)
    _, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    if hot:
        idx2[1, :, 2] = 123
    value, dout = (t.to(card, torch.bfloat16) for t in (value, dout))
    w_pairs, idx2 = w_pairs.to(card), idx2.to(card)
    dv, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    dv2, dw2 = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    torch.cuda.synchronize()
    assert dv.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert torch.equal(dv, dv2) and torch.equal(dw, dw2)
    dv_rows, dw_rows = bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)
    assert torch.equal(dv, dv_rows)
    dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    torch.testing.assert_close(dw, dw_rows, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dw, dw_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dv.float(), dv_ref.float(), atol=3e-2, rtol=3e-2)


def test_kernels_refuse_other_dtypes(card):
    """A dtype the kernels do not take raises; nothing falls back."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather
    from tamtr_torch.kernels.selective_scan import ss2d_scan

    args, _ = _scan_bwd_args(card, 1, 5, 7, 32)
    with pytest.raises(TypeError):
        ss2d_scan(*[t.half() if i in (0, 1, 5, 6) else t for i, t in enumerate(args)])
    with pytest.raises(TypeError):
        ss2d_scan(*_bf16_seq(args)[:1], *args[1:])  # layouts bf16, the rest fp32
    value = torch.randn(1, 30, 8, 64, device=card, dtype=torch.half)
    idx2 = torch.zeros(1, 24, 8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        bilinear_gather(value, idx2.repeat(1, 2, 1), torch.rand(1, 24, 8, 2, device=card), idx2, 12)


def test_half_model_runs_through_the_bf16_kernels(card):
    """A nano model computing in bf16 on the card: its forward launches B1
    and B2 on bf16 tensors, and a training step B3 and B4 too."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_bwd
    from tamtr_torch.kernels.selective_scan import ss2d_scan, ss2d_scan_bwd_walk
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import Trainer, TrainConfig
    from tamtr_torch.weights import init_parameters

    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=4, max_gt=8, dtype=torch.bfloat16)
    init_parameters(model, 0)
    counters = (ss2d_scan, bilinear_gather, ss2d_scan_bwd_walk, bilinear_gather_bwd)
    before = [f.launches for f in counters]
    tr = Trainer(model, TrainConfig(batch_size=2), device=card)
    g = torch.Generator().manual_seed(0)
    m = tr.step({"img": torch.rand(2, 64, 64, 3, generator=g), "txt_feats": torch.randn(2, 4, 128, generator=g),
                 "cls": torch.zeros(2, 8, dtype=torch.long), "bboxes": torch.rand(2, 8, 4, generator=g) * 0.3 + 0.2,
                 "mask": torch.ones(2, 8, dtype=torch.bool)})
    with torch.no_grad():
        pred = tr.ema.eval()(torch.rand(1, 64, 64, 3, device=card), torch.randn(1, 4, 128, device=card))["pred"]
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [6, 6, 3, 3]
    assert math.isfinite(m["loss"]) and pred.dtype == torch.float32 and bool(torch.isfinite(pred).all())
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_row_scatters_bf16_are_bitwise_the_rows_versions(card):
    """B7 and B8 on a bf16 dout: the output bf16, bitwise equal over two
    calls and to the plain rows transcriptions at bf16 (the same fp32 terms
    and sums, each row rounded once at its store), within 1e-2 of the
    plain scatters; `weighted_gather`'s dvalue for a bf16 value comes from
    B7 at bf16, with a row that 1440 updates hit."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc, scatter_acc_pairs, scatter_acc_pairs_ref, scatter_acc_pairs_rows_ref, scatter_acc_ref,
        scatter_acc_rows_ref, weighted_gather,
    )

    g = torch.Generator().manual_seed(18)
    B, L, nh, c, Q, p4 = 2, 500, 8, 64, 30, 48
    idx = torch.randint(0, L, (B, Q * p4, nh), generator=g, dtype=torch.int32)
    idx[1, :, 3] = L - 1
    w = torch.randn(B, Q * p4, nh, generator=g)
    dout = torch.randn(B, Q, nh, c, generator=g)
    idx, w, d16 = idx.to(card), w.to(card), dout.to(card, torch.bfloat16)
    out, again = scatter_acc(idx, w, d16, L), scatter_acc(idx, w, d16, L)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    assert torch.equal(out, scatter_acc_rows_ref(idx, w, d16, L))
    torch.testing.assert_close(out.float(), scatter_acc_ref(idx, w, d16, L).float(), atol=1e-2, rtol=1e-2)
    value = torch.randn(B, L, nh, c, generator=g).to(card, torch.bfloat16).requires_grad_()
    before = scatter_acc.launches
    (dv,) = torch.autograd.grad(weighted_gather(value, idx, w, p4), value, d16)
    torch.cuda.synchronize()
    assert scatter_acc.launches == before + 1 and dv.dtype == torch.bfloat16 and torch.equal(dv, out)

    G, L2, Q, per_q = 16, 700, 40, 24
    idx2 = torch.randint(0, L2 - 1, (G, Q * per_q), generator=g, dtype=torch.int32)
    idx2[1, 10:60] = idx2[1, 9]
    wa, wb = torch.randn(G, Q * per_q, generator=g), torch.randn(G, Q * per_q, generator=g)
    dout = torch.randn(G, Q, c, generator=g)
    args = [t.to(card) for t in (idx2, wa, wb)] + [dout.to(card, torch.bfloat16)]
    out, again = scatter_acc_pairs(*args, L2), scatter_acc_pairs(*args, L2)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    assert torch.equal(out, scatter_acc_pairs_rows_ref(*args, L2))
    torch.testing.assert_close(out.float(), scatter_acc_pairs_ref(*args, L2).float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("G,L,Din,N", [(4, 97, 40, 16), (2, 400, 256, 8), (1, 1, 32, 32), (2, 97, 40, 48)])
def test_selective_scan_kernel_bf16_matches_plain(card, G, L, Din, N):
    """B6 on bf16 u, delta, Bs and Cs (A and D fp32): y bf16 within one bf16
    step beyond 2^-10 of the plain scan on the same values (fp32 maths,
    rounded once; past 32 state lanes each group of `scan1d_pieces` writes
    y in fp32 and the sum is rounded once), two calls bitwise equal, three
    launches a call and group of 32 lanes."""
    from tamtr_torch.kernels.selective_scan import (
        selective_scan, selective_scan_fwd_output, selective_scan_fwd_summaries, selective_scan_ref,
    )

    g = torch.Generator().manual_seed(19)
    u = torch.randn(G, L, Din, generator=g)
    delta = torch.rand(G, L, Din, generator=g) * 0.2
    A = -torch.exp(torch.rand(G, Din, N, generator=g))
    Bs, Cs = torch.randn(G, L, N, generator=g), torch.randn(G, L, N, generator=g)
    D = torch.randn(G, Din, generator=g)
    seq = [t.to(card, torch.bfloat16) for t in (u, delta, Bs, Cs)]
    A, D = A.to(card), D.to(card)
    before = (selective_scan_fwd_summaries.launches, selective_scan_fwd_output.launches)
    y, again = selective_scan(seq[0], seq[1], A, seq[2], seq[3], D), selective_scan(seq[0], seq[1], A, seq[2], seq[3], D)
    torch.cuda.synchronize()
    n = 2 * -(-N // 32)
    assert (selective_scan_fwd_summaries.launches - before[0], selective_scan_fwd_output.launches - before[1]) == (n, n)
    assert y.dtype == torch.bfloat16 and torch.equal(y, again)
    want = selective_scan_ref(seq[0].float(), seq[1].float(), A, seq[2].float(), seq[3].float(), D)
    _within_bf16_steps(y, want.to(torch.bfloat16), 1.0, 2.0**-10)


# ---------------------------------------------------------------------------
# The YOLO Detect family and the DETR loss variants on the card
# ---------------------------------------------------------------------------


def _port_launches():
    from tamtr_torch.kernels.auction import auction_assignment, auction_match
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_bwd, pair_buckets
    from tamtr_torch.kernels.selective_scan import (
        ss2d_scan, ss2d_scan_bwd_walk, ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_fwd_combine,
        ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
    )

    return (ss2d_scan, ss2d_scan_fwd_summaries, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, bilinear_gather,
            ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_bwd_walk, pair_buckets, bilinear_gather_bwd,
            auction_assignment, auction_match)


def test_detect_forward_and_step_on_the_card_match_the_cpu(card):
    """The narrow Detect model (`tests/torch_engine_data.py:yolo_narrow_cfg`,
    heads spread) at 128 px, batch 2: the eval pred, boxes over the input
    size, card = CPU within 1e-4; one training forward and v8 loss: TAL's
    assignment equal on both, and with the CPU's given, the loss within
    1e-4 and the gradient within 2x the CPU's fp32-vs-fp64 distance. No
    kernel of the port launches on the Detect path."""
    import copy

    from torch_engine_data import yolo_narrow_cfg

    from tamtr_torch.engine.model import normalized_pred
    from tamtr_torch.losses.v8_loss import V8LossConfig, v8_detection_loss
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    base = TAMTRModel(yolo_narrow_cfg(3), max_gt=6)
    init_parameters(base, 0)
    with torch.no_grad():
        for b, c in zip(base.model[-1].cv2, base.model[-1].cv3):
            b[2].bias.copy_((-2.0 * (torch.arange(16.0) - 1.5).abs()).repeat(4))
            c[2].bias.zero_()
    g = torch.Generator().manual_seed(5)
    img = torch.rand(2, 128, 128, 3, generator=g)
    txt = torch.zeros(1, 3, 512)
    counters = _port_launches()
    before = [f.launches for f in counters]
    with torch.inference_mode():
        want = normalized_pred(base, base.eval()(img, txt)["pred"], (128, 128))
        got = normalized_pred(base, copy.deepcopy(base).to(card)(img.to(card), txt.to(card))["pred"], (128, 128))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    tg = {"cls": torch.randint(0, 3, (2, 6), generator=g), "mask": torch.arange(6)[None] < torch.tensor([[6], [4]]),
          "bboxes": torch.cat([torch.rand(2, 6, 2, generator=g) * 0.6 + 0.2, torch.rand(2, 6, 2, generator=g) * 0.3 + 0.1], -1)}

    def step(d, dtype=torch.float32, assign=None):
        model = copy.deepcopy(base).to(d, dtype).train()
        t = {k: v.to(d, dtype) if v.is_floating_point() else v.to(d) for k, v in tg.items()}
        loss, items = v8_detection_loss(model(img.to(d, dtype), txt.to(d, dtype)), t, V8LossConfig(nc=3, imgsz=128),
                                        assign=assign if assign is None else {k: v.to(d) for k, v in assign.items()})
        loss.backward()
        return loss.item(), {k: v.cpu() for k, v in items["assign"].items()}, torch.cat(
            [p.grad.flatten().double().cpu() for p in model.parameters()])

    loss_cpu, assign, g_cpu = step("cpu")
    _, card_assign, _ = step(card)
    assert assign["fg_mask"].sum() > 0
    assert torch.equal(card_assign["fg_mask"], assign["fg_mask"]) and torch.equal(card_assign["target_gt"],
                                                                                  assign["target_gt"])
    loss_card, _, g_card = step(card, assign=assign)
    _, _, g64 = step("cpu", torch.float64, assign=assign)
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    assert (g_card - g_cpu).norm() <= 2 * (g_cpu - g64).norm()
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("switch", ["use_sl", "use_svfl", "nwd_loss", "use_wiseiou"])
def test_loss_variant_step_on_the_card(card, switch):
    """One nano `Trainer.step` at 64 px with each DETR loss switch: finite,
    B1-B5 launched as on the default loss's step (3 scans and 3 gathers
    forward and backward, one assignment)."""
    import numpy as np

    from tamtr_torch import TAMTR
    from tamtr_torch.losses.detr_loss import DETRLossConfig
    from tamtr_torch.train.trainer import TrainConfig, Trainer

    det = TAMTR("tamtr-nano.yaml", nc=4, device=card, imgsz=64, max_gt=8)
    tr = Trainer(det.model, TrainConfig(batch_size=2, accumulate=1),
                 loss_cfg=DETRLossConfig(nc=4, **{switch: True}), device=card)
    rng = np.random.default_rng(3)
    mask = np.arange(8)[None] < np.array([[5], [3]])
    batch = {"img": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             "txt_feats": rng.standard_normal((1, 4, 128)).astype(np.float32),
             "cls": rng.integers(0, 4, (2, 8)).astype(np.int32), "mask": mask,
             "bboxes": (np.concatenate([rng.uniform(0.2, 0.8, (2, 8, 2)), rng.uniform(0.05, 0.3, (2, 8, 2))], -1)
                        * mask[..., None]).astype(np.float32)}
    counters = _port_launches()
    before = [f.launches for f in counters]
    m = tr.step(batch)
    assert all(math.isfinite(m[k]) for k in ("loss", "giou", "class", "bbox", "grad_norm"))
    assert [f.launches - b for f, b in zip(counters, before)] == [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 1, 0]


RTDETR_LEVELS = [(160, 160), (80, 80), (40, 40)]  # rtdetr.yaml's levels at 640 px (strides 4, 8, 16)


def _rtdetr_pairs(card, seed, B=4, Q=900, c=32, nh=8, P=4):
    """RT-DETR's sampling at 640 px: head width c = 32 (hd 256 over 8
    heads), Q = 900 (300 queries and 600 CDN queries at max_gt 300), with a
    point in the global last pixel cell, one at x0 < 0 and one on a level
    boundary."""
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    g = torch.Generator().manual_seed(seed)
    nl, shapes = 3, RTDETR_LEVELS
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.1 - 0.05
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / 40, 1 - 0.2 / 40])  # last pixel cell
    loc[0, 1, 1, 0, 2] = torch.tensor([0.2 / 160, 0.5])  # x0 < 0
    loc[1, 2, 0, 0, 3] = torch.tensor([1 - 0.3 / 160, 1 - 0.3 / 160])  # level boundary
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    w_att = w_att / w_att.sum((-1, -2), keepdim=True)
    dout = torch.randn(B, Q, nh, c, generator=g)
    value, loc, w_att, dout = (t.to(card) for t in (value, loc, w_att, dout))
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    assert int(idx2.max()) == Lv - 1
    return value, idx4, w_pairs, idx2, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_gather_kernel_at_rtdetr_width(card, dtype):
    """B2 at c = 32, where half of the 16 lanes a row is given hold no data,
    at (4, Q = 900) on the 640 px levels: against the plain gather at 1e-5
    (fp32) or 2e-2 (bf16 value rows, fp32 sums rounded once), bitwise over
    two calls."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_ref

    value, idx4, w_pairs, idx2, _ = _rtdetr_pairs(card, 21)
    value = value.to(dtype)
    before = bilinear_gather.launches
    out, again = bilinear_gather(value, idx4, w_pairs, idx2, 12), bilinear_gather(value, idx4, w_pairs, idx2, 12)
    torch.cuda.synchronize()
    assert bilinear_gather.launches == before + 2 and out.dtype == dtype and out.shape == (4, 900, 8, 32)
    assert torch.equal(out, again)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), bilinear_gather_ref(value, idx4, w_pairs, idx2, 12).float(), atol=tol,
                               rtol=tol)


def test_bilinear_gather_bwd_kernel_at_rtdetr_width(card):
    """B4 at c = 32, (4, Q = 900) on the 640 px levels: the buckets equal
    `pair_buckets_ref`; dvalue bitwise over two calls and bitwise
    `bilinear_gather_bwd_rows_ref`; dvalue and dw within 1e-5 of the plain
    backward."""
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref, pair_buckets, pair_buckets_ref,
    )

    value, _, w_pairs, idx2, dout = _rtdetr_pairs(card, 22)
    Lv = value.shape[1]
    assert all(torch.equal(a, b) for a, b in zip(pair_buckets(idx2, w_pairs, Lv), pair_buckets_ref(idx2, w_pairs, Lv)))
    before = bilinear_gather_bwd.launches
    dv, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    dv2, dw2 = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    torch.cuda.synchronize()
    assert bilinear_gather_bwd.launches == before + 2
    assert torch.equal(dv, dv2) and torch.equal(dw, dw2)
    assert torch.equal(dv, bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)[0])
    dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    torch.testing.assert_close(dv, dv_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw, dw_ref, atol=1e-5, rtol=1e-5)


def test_auction_at_the_rtdetr_cost(card):
    """B5 at RT-DETR's training cost, (28, 300, 300): 7 matched layers x 4
    images of 300 queries against 300 gt slots with 250, 80, 30 and 60
    valid (the value block, 300 x 301 fp32, exceeds a block's opt-in shared
    memory: the kernel's global-memory path). The matcher's cost of random
    predictions; `auction_assignment` (one launch) identical to the CPU's
    and `auction_match` identical to the plain auction."""
    from tamtr_torch.kernels.auction import auction_assignment, auction_assignment_ref, auction_match, auction_match_ref
    from tamtr_torch.losses.matcher import match_cost

    g = torch.Generator().manual_seed(23)
    layers, B, nq, M, nc = 7, 4, 300, 300, 10
    n = layers * B
    n_valid = torch.tensor([250, 80, 30, 60]).repeat(layers)
    mask = torch.arange(M)[None] < n_valid[:, None]
    gt_b = torch.cat([torch.rand(n, M, 2, generator=g) * 0.94 + 0.03, torch.rand(n, M, 2, generator=g) * 0.075 + 0.005],
                     -1) * mask[..., None]
    gt_c = torch.randint(0, nc, (n, M), generator=g)
    pred_b = torch.cat([torch.rand(n, nq, 2, generator=g), torch.rand(n, nq, 2, generator=g) * 0.1 + 0.005], -1)
    pred_s = torch.randn(n, nq, nc, generator=g) * 2 - 3
    cost = match_cost(pred_b.to(card), pred_s.to(card), gt_b.to(card), gt_c.to(card))
    m = mask.to(card)
    assert cost.shape == (n, nq, M)
    before = auction_assignment.launches
    got = auction_assignment(cost, m)
    torch.cuda.synchronize()
    assert auction_assignment.launches == before + 1
    assert torch.equal(got.cpu(), auction_assignment_ref(cost.cpu(), mask))
    assert torch.equal(auction_match(cost, m), auction_match_ref(cost, m))
