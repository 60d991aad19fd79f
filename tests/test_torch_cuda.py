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
