"""Kernels B7 (row scatter) and B8 (pair scatter) as redesigned for the H100,
on B4's buckets, and B6's pieces, on the CPU: the plain versions that
transcribe each launch, against the plain forms and the JAX package on the
same numpy inputs.

- The rows transcriptions (`scatter_acc_rows_ref`, `scatter_acc_pairs_rows_ref`:
  each row's terms in update order, B8's first-row terms before its
  second-row ones, in segments of `SEG_TERMS` summed from zero and added in
  turn) against JAX's Pallas `_scatter_acc` and `_scatter_acc_pairs`
  (interpret mode) at 1e-5, with colliding indices, a row of 1440 terms and
  starts at L2 - 2; bitwise against the plain scatters (`scatter_acc_ref`,
  `scatter_acc_pairs_ref`, index_put_ in update order) on every row of at
  most `SEG_TERMS` terms, and against a term-by-term loop everywhere.
- The skip rule, on both plain versions and both transcriptions: B7 skips an
  index of -1 or L; B8 writes row 0 alone for a start of -1, row L2 - 1
  alone for a start of L2 - 1, nothing for L2.
- The buckets: `scatter_acc_buckets_ref` and `scatter_acc_pairs_buckets_ref`
  are stable sorts by first row (out-of-range updates last), and the
  placement of `csrc/row_buckets.cuh:buckets_kernel` (per-block digit starts
  exchanged across a cluster of K blocks, each warp placing its run) gives
  that stable order for K = 1, 2, 4 and 8.
- B6 on any shape: `scan1d_pieces` (the state padded to a compiled size,
  N > 32 split into groups whose outputs add, G and Din cut into launches)
  run on `selective_scan_ref` equals the unpadded scan at 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamtr_tpu.kernels.deform_scatter as jds
from tamtr_torch.kernels.deform_scatter import (
    SEG_TERMS, scatter_acc, scatter_acc_buckets, scatter_acc_buckets_ref, scatter_acc_pairs,
    scatter_acc_pairs_buckets, scatter_acc_pairs_buckets_ref, scatter_acc_pairs_ref, scatter_acc_pairs_rows_ref,
    scatter_acc_ref, scatter_acc_rows_ref,
)
from tamtr_torch.kernels.selective_scan import scan1d_pieces, selective_scan_ref


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows_inputs(seed, B=2, L=50, nh=3, c=8, Q=40, p4=36):
    """B7's inputs: Q p4 updates a (b, h) over L rows (tens of terms a row,
    1440 by default), five colliding updates of one query, and every update
    of the last image and head on row 7."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, L, (B, Q * p4, nh)).astype(np.int32)
    idx[0, :5, 0] = idx[0, 5, 0]
    idx[-1, :, -1] = 7
    w = rng.standard_normal((B, Q * p4, nh)).astype(np.float32)
    dout = rng.standard_normal((B, Q, nh, c)).astype(np.float32)
    return idx, w, dout, L


def _pairs_inputs(seed, G=3, L2=60, c=8, Q=60, per_q=24):
    """B8's inputs: 1440 pairs a group with starts in [0, L2 - 1), three at
    L2 - 2, a run of repeated pairs, and every pair of group 2 starting on
    L2 - 2 (1440 terms on rows L2 - 2 and L2 - 1)."""
    rng = np.random.default_rng(seed)
    idx2 = rng.integers(0, L2 - 1, (G, Q * per_q)).astype(np.int32)
    idx2[0, :3] = L2 - 2
    idx2[1, 4:40] = idx2[1, 3]
    idx2[2] = L2 - 2
    wa, wb = (rng.standard_normal((G, Q * per_q)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((G, Q, c)).astype(np.float32)
    return idx2, wa, wb, dout, L2


def _loop_rows(idx, w, dout, L):
    """B7's order, a term at a time: row r sums w dout over its updates in
    update order, segments of SEG_TERMS summed from zero, then added in turn."""
    B, n, nh = idx.shape
    p4 = n // dout.shape[1]
    out = torch.zeros(B, L, nh, dout.shape[-1])
    for b in range(B):
        for h in range(nh):
            for r in range(L):
                terms = [w[b, u, h] * dout[b, u // p4, h] for u in range(n) if int(idx[b, u, h]) == r]
                for k in range(0, len(terms), SEG_TERMS):
                    acc = torch.zeros(dout.shape[-1])
                    for t in terms[k:k + SEG_TERMS]:
                        acc = acc + t
                    out[b, r, h] = acc if k == 0 else out[b, r, h] + acc
    return out


def _terms_per_row(rows, n_rows):
    return np.bincount(rows[(rows >= 0) & (rows < n_rows)].ravel(), minlength=n_rows)


def test_rows_transcriptions_match_jax_pallas_scatters():
    """Both transcriptions against JAX's Pallas kernels (interpret mode, one
    update at a time in update order) at 1e-5, rows of 1440 terms included."""
    idx, w, dout, L = _rows_inputs(1)
    B, n, nh = idx.shape
    Q, c = dout.shape[1], dout.shape[-1]
    want = jds._scatter_acc(jnp.asarray(idx.transpose(0, 2, 1).reshape(B * nh, n)),
                            jnp.asarray(w.transpose(0, 2, 1).reshape(B * nh, n)),
                            jnp.asarray(dout.transpose(0, 2, 1, 3).reshape(B * nh, Q, c)), L)
    want = np.asarray(want).reshape(B, nh, L, c).transpose(0, 2, 1, 3)
    got = scatter_acc_rows_ref(*(torch.from_numpy(a) for a in (idx, w, dout)), L)
    assert got.shape == (B, L, nh, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert int(_terms_per_row(idx[-1, :, -1], L).max()) == n

    idx2, wa, wb, dout2, L2 = _pairs_inputs(2)
    want = np.asarray(jds._scatter_acc_pairs(*(jnp.asarray(a) for a in (idx2, wa, wb, dout2)), L2))
    got = scatter_acc_pairs_rows_ref(*(torch.from_numpy(a) for a in (idx2, wa, wb, dout2)), L2)
    assert got.shape == (idx2.shape[0], L2, dout2.shape[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.abs(want[2, L2 - 1]).sum() > 0


def test_rows_transcriptions_equal_the_plain_scatters_on_short_rows():
    """Bitwise on every row of at most SEG_TERMS terms (the same multiply and
    add per term in the same order), the CPU wrappers being the plain
    versions; B7's transcription bitwise a term-by-term loop everywhere."""
    idx, w, dout, L = _rows_inputs(3, B=1, L=40, nh=3, Q=12, p4=30)
    ti, tw, td = (torch.from_numpy(a) for a in (idx, w, dout))
    rows, plain = scatter_acc_rows_ref(ti, tw, td, L), scatter_acc(ti, tw, td, L)
    assert torch.equal(plain, scatter_acc_ref(ti, tw, td, L))
    assert torch.equal(rows, _loop_rows(ti, tw, td, L))
    n_row = torch.from_numpy(np.stack([_terms_per_row(idx[0, :, h], L) for h in range(idx.shape[2])], 1))[None]
    short = (n_row <= SEG_TERMS)[..., None].expand_as(rows)
    assert short.any() and (~short).any()
    assert torch.equal(rows[short], plain[short])

    idx2, wa, wb, dout2, L2 = _pairs_inputs(4)
    args = [torch.from_numpy(a) for a in (idx2, wa, wb, dout2)]
    rows, plain = scatter_acc_pairs_rows_ref(*args, L2), scatter_acc_pairs(*args, L2)
    assert torch.equal(plain, scatter_acc_pairs_ref(*args, L2))
    n_row = torch.from_numpy(np.stack([_terms_per_row(np.concatenate([s, s + 1]), L2) for s in idx2]))
    short = (n_row <= SEG_TERMS)[..., None].expand_as(rows)
    assert short.any() and (~short).any()
    assert torch.equal(rows[short], plain[short])


def test_skip_rule_on_plain_versions_and_transcriptions():
    """B7: an index of -1 or L adds nothing. B8: a start of -1 adds wb dout
    to row 0 alone, L2 - 1 adds wa dout to row L2 - 1 alone, L2 nothing."""
    idx, w, dout, L = _rows_inputs(5, B=1, L=20, nh=2, Q=4, p4=6)
    ti, tw, td = (torch.from_numpy(a) for a in (idx, w, dout))
    edge = ti.clone()
    edge[0, 0, 0], edge[0, 7, 1] = -1, L
    dropped = tw.clone()
    dropped[0, 0, 0] = dropped[0, 7, 1] = 0.0
    for fn in (scatter_acc_ref, scatter_acc_rows_ref):
        got, want = fn(edge, tw, td, L), fn(ti, dropped, td, L)
        assert got.shape == (1, L, 2, dout.shape[-1])
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)

    G, L2, c, Q, per_q = 2, 12, 4, 3, 4
    rng = np.random.default_rng(6)
    idx2 = torch.from_numpy(rng.integers(1, L2 - 2, (G, Q * per_q)).astype(np.int32))  # rows 1 .. L2 - 2
    idx2[0, :3] = torch.tensor([-1, L2 - 1, L2])
    wa, wb = (torch.from_numpy(rng.standard_normal((G, Q * per_q)).astype(np.float32)) for _ in range(2))
    d = torch.from_numpy(rng.standard_normal((G, Q, c)).astype(np.float32))
    for fn in (scatter_acc_pairs_ref, scatter_acc_pairs_rows_ref):
        got = fn(idx2, wa, wb, d, L2)
        assert got.shape == (G, L2, c)
        assert torch.equal(got[0, 0], wb[0, 0] * d[0, 0])  # start -1: row 0 only
        assert torch.equal(got[0, L2 - 1], wa[0, 1] * d[0, 0])  # start L2 - 1: row L2 - 1 only
        assert not got[1, 0].any() and not got[1, L2 - 1].any()
        rest = idx2.clone()
        rest[0, :3] = 5
        wa0, wb0 = wa.clone(), wb.clone()
        wa0[0, :3] = wb0[0, :3] = 0.0
        torch.testing.assert_close(got[:, 1:L2 - 1], fn(rest, wa0, wb0, d, L2)[:, 1:L2 - 1], atol=1e-6, rtol=1e-6)


def test_row_buckets_ref_is_a_stable_sort_by_row():
    """B7's buckets: each (b, h)'s update ids sorted stably by row, an
    out-of-range update after them all; offsets the exclusive scan of the
    rows' counts; the weights in that order. B8's: by start + 1, the starts
    -1 .. L2 - 1 in buckets 0 .. L2. The CPU wrappers are these."""
    idx, w, _, L = _rows_inputs(7)
    idx[0, 3, 1], idx[1, 9, 0] = -1, L
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    offsets, order, upd_w = scatter_acc_buckets_ref(ti, tw, L)
    assert offsets.dtype == order.dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(scatter_acc_buckets(ti, tw, L), (offsets, order, upd_w)))
    B, n, nh = idx.shape
    keys = torch.where((ti >= 0) & (ti < L), ti, L).transpose(1, 2).long()
    _, want = torch.sort(keys, dim=2, stable=True)
    assert torch.equal(order.long(), want)
    assert torch.equal(upd_w, torch.stack([tw[b, want[b, h], h] for b in range(B) for h in range(nh)]).view(B, nh, n))
    counts = torch.stack([torch.bincount(k, minlength=L + 1) for k in keys.reshape(B * nh, n)]).view(B, nh, L + 1)
    assert torch.equal(offsets[..., 1:].long(), counts[..., :L].cumsum(2)) and (offsets[..., 0] == 0).all()
    assert int(offsets[0, 1, L]) == n - 1 and int(order[0, 1, -1]) == 3  # the skipped update, last
    assert int(counts.max()) == n  # the hot row

    idx2, wa, wb, _, L2 = _pairs_inputs(8)
    idx2[0, :2] = [-1, L2 - 1]
    idx2[1, 0] = L2
    args = [torch.from_numpy(a) for a in (idx2, wa, wb)]
    offsets, order, upd_w = scatter_acc_pairs_buckets_ref(*args, L2)
    assert all(torch.equal(a, b) for a, b in zip(scatter_acc_pairs_buckets(*args, L2), (offsets, order, upd_w)))
    keys = torch.where(args[0] + 1 <= L2, args[0] + 1, L2 + 1).long()
    _, want = torch.sort(keys, dim=1, stable=True)
    assert torch.equal(order.long(), want) and offsets.shape == (idx2.shape[0], L2 + 2)
    assert torch.equal(upd_w, torch.stack([args[1], args[2]], -1).gather(1, want[..., None].expand(-1, -1, 2)))
    assert int(offsets[0, 1]) == 1 and int(order[0, 0]) == 0  # start -1: bucket 0
    assert int(offsets[1, L2 + 1]) == idx2.shape[1] - 1  # start L2: in no bucket


def _cluster_placement(keys, K, warps=32, bits=8):
    """`csrc/row_buckets.cuh:buckets_kernel`'s order, serially: in each pass
    block k of the cluster owns the k-th share of the current order, warp w
    a run of 32-multiples of it; a block counts its (digit, warp) pairs and
    scans them digit-major; the blocks' digit starts E_k(d) put block k's
    run of digit d after every block's smaller digits and after blocks
    0..k-1's digit d; each warp places its run in order at its cursors."""
    n = len(keys)
    passes = 1
    while passes < 4 and int(max(keys)) >> (bits * passes):
        passes += 1
    cur = [(int(k), i) for i, k in enumerate(keys)]
    share = -(-n // K)
    for p in range(passes):
        digit = lambda e: (e[0] >> (bits * p)) & ((1 << bits) - 1)  # noqa: E731
        blocks = []
        for k in range(K):
            blo = min(k * share, n)
            bhi = min(blo + share, n)
            run = -(-(bhi - blo) // (32 * warps)) * 32
            runs = [(min(blo + w * run, bhi), min(min(blo + w * run, bhi) + run, bhi)) for w in range(warps)]
            hist = np.zeros((1 << bits, warps + 1), np.int64)
            for w, (lo, hi) in enumerate(runs):
                for i in range(lo, hi):
                    hist[digit(cur[i]), w] += 1
            cursor = (np.cumsum(hist.ravel()) - hist.ravel()).reshape(hist.shape)
            blocks.append((runs, cursor, np.append(cursor[:, 0], bhi - blo)))
        dst = [None] * n
        for k, (runs, cursor, pub) in enumerate(blocks):
            adj = sum(b[2][:-1] for b in blocks) - pub[:-1] + sum((b[2][1:] - b[2][:-1] for b in blocks[:k]), 0)
            for w, (lo, hi) in enumerate(runs):
                for i in range(lo, hi):
                    d = digit(cur[i])
                    dst[cursor[d, w] + adj[d]] = cur[i]
                    cursor[d, w] += 1
        cur = dst
    return [e[1] for e in cur]


@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_cluster_placement_is_the_stable_sort(K):
    """Keys of two 8-bit digits, a hot key and a share per block that is not
    a whole number of warps' runs."""
    rng = np.random.default_rng(K)
    keys = rng.integers(0, 700, 5003)
    keys[100:1600] = 333
    keys[-3:] = 700  # the out-of-range bucket
    want = np.argsort(keys * len(keys) + np.arange(len(keys)))
    assert _cluster_placement(keys, K) == want.tolist()


@pytest.mark.parametrize("G,L,Din,N,max_g,max_din", [
    (3, 20, 40, 1, 3, 64),  # N = 1, padded to 4
    (3, 20, 40, 3, 2, 16),  # padded to 4, cut over G and Din
    (2, 9, 40, 12, 1, 32),  # padded to 16
    (2, 9, 40, 48, 2, 40),  # two state groups: 32 and 16
    (5, 7, 8, 70, 2, 8),  # three: 32, 32 and 6 padded to 8
])
def test_scan1d_pieces_are_exact(G, L, Din, N, max_g, max_din):
    """The plain scan on `scan1d_pieces` equals it on the whole input at
    1e-6, D given (it enters once), each piece a compiled state size within
    the cut."""
    g = torch.Generator().manual_seed(G * N)
    u, delta = torch.randn(G, L, Din, generator=g), torch.rand(G, L, Din, generator=g) * 0.1
    A = -torch.exp(torch.rand(G, Din, N, generator=g))
    Bs, Cs = torch.randn(G, L, N, generator=g), torch.randn(G, L, N, generator=g)
    D = torch.randn(G, Din, generator=g)
    pieces = []

    def scan(*args):
        pieces.append((args[0].shape, args[2].shape[-1]))
        return selective_scan_ref(*args)

    got = scan1d_pieces(scan, u, delta, A, Bs, Cs, D, max_g=max_g, max_din=max_din)
    torch.testing.assert_close(got, selective_scan_ref(u, delta, A, Bs, Cs, D), atol=1e-6, rtol=1e-6)
    assert all(n in (4, 8, 16, 32) and s[0] <= max_g and s[2] <= max_din for s, n in pieces)
    assert len(pieces) == -(-N // 32) * -(-G // max_g) * -(-Din // max_din)
