"""Kernels B4 (gather backward) and B5 (auction) as redesigned for the H100,
on the CPU: the plain versions that transcribe each launch, against the
plain forms and the JAX package on the same numpy inputs.

- B4: `pair_buckets_ref` (pairs bucketed by shifted start row) equals a
  stable `torch.sort` per (b, h). The row-owned `bilinear_gather_bwd_rows_ref`
  equals a term-by-term loop over its order bit for bit: each row sums the
  pairs starting on it, then those starting on the row above, each in pair
  order, in segments of `SEG_TERMS` terms (one multiply and one add a term
  from zero), the segments' sums added in turn. On rows of at most
  `SEG_TERMS` terms that is the scatter-add form's sum
  (`bilinear_gather_bwd_ref`), bitwise; both, and JAX's Pallas
  `_scatter_dw_acc_pairs` (interpret mode, on the shifted pairs), agree
  within 1e-6 on rows of tens of terms and within the fp32 summation bound
  of the fp64 sum on a row of 1440 terms, with a last-row pair, empty rows
  and three levels. JAX's is not bitwise the same: the TPU kernel adds each
  pair's two rows in turn (so a row's two kinds of terms interleave in pair
  order), and XLA on the CPU fuses each multiply into its add.
- B5: `auction_assignment_ref` (each image in its own orientation to its
  own stop) equals JAX's `auction_assignment` exactly; the team scan of the
  kernel's rounds (8 lanes, each every 8th object, partials merged with
  shuffles) equals the serial scan bit for bit; the in-block setup
  (`_oriented_setup`) equals `auction_setup` bit for bit in both
  orientations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamtr_tpu.kernels.deform_scatter as jds
from tamtr_torch.kernels.auction import (
    NEG, _oriented_setup, auction_assignment, auction_assignment_ref, auction_setup,
)
from tamtr_torch.kernels.deform_scatter import (
    SEG_TERMS, bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref, pair_buckets_ref,
)
from tamtr_torch.nn.decoder import deform_sampling_pairs

SHAPES = [(6, 7), (3, 4), (2, 3)]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pairs(seed, B=2, Q=60, nh=2, c=8, P=4, hot=True):
    """Pairs over three levels with a sample point in the global last pixel
    cell (its pair starts on the last row), attention weights summing to 1
    per query and head as the model's softmax gives; with `hot`, every pair
    of image 1, head 1 starts on row 5 (1440 terms there and 1440 on row 6)."""
    rng = np.random.default_rng(seed)
    nl = len(SHAPES)
    Lv = sum(h * w for h, w in SHAPES)
    value = rng.standard_normal((B, Lv, nh, c)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Q, nh, nl, P, 2)).astype(np.float32)
    loc[0, 0, 0, 2, 0] = [1 - 0.2 / SHAPES[2][1], 1 - 0.2 / SHAPES[2][0]]
    w_att = rng.random((B, Q, nh, nl, P)).astype(np.float32)
    w_att /= w_att.sum((-1, -2), keepdims=True)
    dout = rng.standard_normal((B, Q, nh, c)).astype(np.float32)
    _, w_pairs, idx2 = deform_sampling_pairs(SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    assert int(idx2.max()) == Lv - 1
    if hot:
        idx2[1, :, 1] = 5
    return torch.from_numpy(value), idx2, w_pairs, torch.from_numpy(dout)


def test_pair_buckets_ref_is_a_stable_sort_by_shifted_start():
    value, idx2, w_pairs, _ = _pairs(1)
    B, Lv, nh, _ = value.shape
    offsets, order, pair_w = pair_buckets_ref(idx2, w_pairs, Lv)
    starts = torch.where(idx2 >= Lv - 1, Lv - 2, idx2).transpose(1, 2).long()
    sorted_starts, want = torch.sort(starts, dim=2, stable=True)
    assert offsets.dtype == order.dtype == torch.int32
    assert torch.equal(order.long(), want)
    assert torch.equal(pair_w, torch.stack([w_pairs[b, want[b, h], h] for b in range(B) for h in range(nh)]).view(
        B, nh, -1, 2))
    counts = torch.stack([torch.bincount(s, minlength=Lv) for s in starts.reshape(B * nh, -1)]).view(B, nh, Lv)
    assert torch.equal(offsets[..., 1:].long(), counts.cumsum(2)) and (offsets[..., 0] == 0).all()
    assert (counts[..., Lv - 1] == 0).all() and (counts == 0).any()  # the last row, and empty rows
    assert int(counts.max()) == idx2.shape[1]  # the hot row's bucket


def _rows_loop(value, idx2, w_pairs, dout):
    """dvalue of the row-owned order, a term at a time: row r's terms are
    the pairs starting on r (their first weight) and then those starting
    on r - 1 (their second), each in pair order, after the last-row shift;
    segments of SEG_TERMS summed from zero, then added in turn."""
    B, Lv, nh, c = value.shape
    nU2, Q = idx2.shape[1], dout.shape[1]
    out = torch.zeros_like(value)
    for b in range(B):
        for h in range(nh):
            s = [min(int(i), Lv - 2) for i in idx2[b, :, h]]
            w = [w_pairs[b, u, h].flip(0) if int(idx2[b, u, h]) >= Lv - 1 else w_pairs[b, u, h] for u in range(nU2)]
            for r in range(Lv):
                terms = [(u, 0) for u in range(nU2) if s[u] == r] + [(u, 1) for u in range(nU2) if s[u] == r - 1]
                parts = []
                for k in range(0, len(terms), SEG_TERMS):
                    acc = torch.zeros(c)
                    for u, slot in terms[k:k + SEG_TERMS]:
                        acc = acc + w[u][slot] * dout[b, u // (nU2 // Q), h]
                    parts.append(acc)
                for k, p in enumerate(parts):
                    out[b, r, h] = p if k == 0 else out[b, r, h] + p
    return out


@pytest.mark.parametrize("hot", [False, True])
def test_gather_bwd_rows_ref_transcribes_its_order(hot):
    value, idx2, w_pairs, dout = _pairs(3, B=2, Q=6, hot=hot)
    assert torch.equal(bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)[0], _rows_loop(value, idx2, w_pairs, dout))


def test_gather_bwd_rows_ref_equals_scatter_form_and_jax_pallas():
    """The row-owned backward against the scatter-add form (dvalue bitwise
    on rows of at most SEG_TERMS terms; elsewhere, and dw, within 1e-6) and
    the JAX Pallas kernel in interpret mode on the shifted pairs (1e-6); on
    the hot rows (1440 terms), all three within the fp32 summation bound
    n 2^-24 sum |w dout| of the fp64 sum."""
    value, idx2, w_pairs, dout = _pairs(2)
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    dv, dw = bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)
    dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    torch.testing.assert_close(dw, dw_ref, atol=1e-6, rtol=1e-6)
    assert torch.equal(bilinear_gather_bwd(value, idx2, w_pairs, dout)[0], dv_ref)  # the CPU path

    # the terms of each row, its fp64 sum and its summation bound
    starts = torch.where(idx2 >= Lv - 1, Lv - 2, idx2).long()
    n_start = torch.zeros((B, Lv + 1, nh)).scatter_add_(1, starts + 1, torch.ones(starts.shape))  # row r at r + 1
    n_row = (n_start[:, 1:] + n_start[:, :-1])[..., None]  # buckets r and r - 1
    dv64 = bilinear_gather_bwd_ref(value.double(), idx2, w_pairs.double(), dout.double())[0]
    mag = bilinear_gather_bwd_ref(value, idx2, w_pairs.abs(), dout.abs())[0].double()
    bound = n_row * 2.0**-24 * mag
    hot = (n_row == nU2).expand_as(dv)
    assert int(hot.sum()) == 2 * c and int(n_row.max()) == nU2  # rows 5 and 6 of image 1, head 1
    short = (n_row <= SEG_TERMS).expand_as(dv)
    assert short.any() and torch.equal(dv[short], dv_ref[short])
    torch.testing.assert_close(dv[~hot], dv_ref[~hot], atol=1e-6, rtol=1e-6)

    # JAX's kernel on the shifted pairs, grid g = b * nh + h
    at_end = idx2 >= Lv - 1
    w = torch.where(at_end[..., None], w_pairs.flip(-1), w_pairs)
    grid = lambda t: jnp.asarray(t.transpose(1, 2).reshape(B * nh, *t.shape[1:2], *t.shape[3:]).numpy())  # noqa: E731
    acc, dw_g = jds._scatter_dw_acc_pairs(
        grid(torch.where(at_end, Lv - 2, idx2)), grid(w[..., 0]), grid(w[..., 1]), grid(value), grid(dout))
    dv_jax = torch.from_numpy(np.array(acc)).view(B, nh, Lv, c).transpose(1, 2)
    dw_jax = torch.from_numpy(np.array(dw_g)).view(B, nh, nU2, 2).transpose(1, 2)
    dw_jax = torch.where(at_end[..., None], dw_jax.flip(-1), dw_jax)
    torch.testing.assert_close(dv[~hot], dv_jax[~hot], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dw, dw_jax, atol=1e-6, rtol=1e-6)
    for got in (dv, dv_ref, dv_jax):
        assert ((got.double() - dv64).abs() <= bound)[hot].all()


def _jax_assignment(C, mask, max_rounds):
    """JAX's `auction_assignment` with its solves' `max_rounds` set (its
    body, with JAX's `auction_match`)."""
    from tamtr_tpu.losses.matcher import auction_assignment as jax_assignment
    from tamtr_tpu.losses.matcher import auction_match as jax_match

    C, mask = jnp.asarray(C), jnp.asarray(mask)
    if max_rounds == 300:
        return np.asarray(jax_assignment(C, mask))
    B, nq, M = C.shape
    fwd = np.asarray(jax_match(C, mask, max_rounds=max_rounds))
    per_query = np.asarray(jax_match(jnp.swapaxes(C, 1, 2), jnp.ones((B, nq), bool), max_rounds=max_rounds,
                                     row_mask=mask))
    rev = np.full((B, M + 1), -1, np.int32)
    for b in range(B):
        rev[b, np.where(per_query[b] >= 0, per_query[b], M)] = np.arange(nq)
    overfull = np.asarray(mask).sum(1) > nq
    return np.where(overfull[:, None], rev[:, :M], fwd)


@pytest.mark.parametrize("n_valid,max_rounds", [
    ([5, 12, 14, 3], 300),  # no over-full image; 14 of 20 is contested
    ([30, 14, 8, 25], 300),  # over-full and contested
    ([30, 25, 21, 40], 300),  # all over-full
    ([0, 0, 7, 0], 300),  # n_valid = 0
    ([30, 14, 8, 25], 3),  # cut at max_rounds
])
def test_auction_assignment_ref_equals_jax(n_valid, max_rounds):
    B, nq, M = 4, 20, 40
    rng = np.random.default_rng(sum(n_valid) + max_rounds)
    cost = rng.normal(size=(B, nq, M)).astype(np.float32)
    mask = np.arange(M)[None] < np.asarray(n_valid)[:, None]
    want = _jax_assignment(cost, mask, max_rounds)
    got = auction_assignment_ref(torch.from_numpy(cost), torch.from_numpy(mask), max_rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if max_rounds == 300:
        np.testing.assert_array_equal(auction_assignment(torch.from_numpy(cost), torch.from_numpy(mask)).numpy(), want)


def _serial_scan(net):
    """The serial scan of one bidder's row (the JAX argmax and runner-up):
    w1 the first maximum, j1 its index, w2 the maximum of the rest and NEG."""
    w1, j1, w2 = np.float32(-np.inf), np.iinfo(np.int32).max, np.float32(NEG)
    for o, v in enumerate(net):
        if v > w1:
            w2, w1, j1 = np.maximum(w2, w1), v, o
        else:
            w2 = np.maximum(w2, v)
    return w1, j1, w2


def _team_scan(net, T):
    """`csrc/auction.cu:auction_round`'s team: lane t scans objects t, t + T,
    ..., then an xor butterfly over the lanes merges (w1, j1, w2), ties to
    the lower index; every lane ends with the merged result."""
    parts = []
    for t in range(T):
        w1, j1, w2 = _serial_scan(net[t::T])
        parts.append((w1, j1 * T + t if j1 != np.iinfo(np.int32).max else j1, w2))
    off = T // 2
    while off:
        merged = []
        for t in range(T):
            (w1, j1, w2), (ow1, oj1, ow2) = parts[t], parts[t ^ off]
            mine = w1 > ow1 or (w1 == ow1 and j1 < oj1)
            merged.append((w1, j1, np.maximum(w2, ow1)) if mine else (ow1, oj1, np.maximum(ow2, w1)))
        parts, off = merged, off // 2
    assert all(p == parts[0] for p in parts)
    return parts[0]


@pytest.mark.parametrize("O", [1, 3, 100, 300, 301])
def test_team_scan_equals_serial_scan_bitwise(O):
    T = 8  # lanes a bidder in csrc/auction.cu
    rng = np.random.default_rng(O * T)
    rows = rng.integers(-3, 3, (40, O)).astype(np.float32)  # small integers: ties
    rows[rng.random(rows.shape) < 0.2] = NEG
    rows[0] = NEG  # all NEG
    rows[1] = 2.0  # all tied
    rows[2, ::2] = -0.0
    price = rng.integers(0, 3, O).astype(np.float32) * np.float32(0.5)
    for row in rows:
        net = (row - price).astype(np.float32)
        want, got = _serial_scan(net), _team_scan(net, T)
        assert got[1] == want[1]
        assert np.float32(got[0]).tobytes() == np.float32(want[0]).tobytes()
        assert np.float32(got[2]) == np.float32(want[2])  # NEG floor included; +0 and -0 compare equal
        bid = lambda w1, j1, w2: np.float32(np.float32(price[j1] + np.float32(w1 - w2)) + np.float32(0.01))  # noqa
        if want[0] > NEG / 2:
            assert bid(*got).tobytes() == bid(*want).tobytes()


@pytest.mark.parametrize("n_valid", [[0, 7, 14, 40], [20, 21, 40, 40]])
def test_oriented_setup_equals_auction_setup_bitwise(n_valid):
    B, nq, M = 4, 20, 40
    rng = np.random.default_rng(len(n_valid) + sum(n_valid))
    C = torch.from_numpy(rng.normal(size=(B, nq, M)).astype(np.float32) * 3)
    mask = torch.arange(M)[None] < torch.tensor(n_valid)[:, None]
    value, pv, eps, target = _oriented_setup(C, mask, transposed=False)
    want = auction_setup(C, mask)
    assert torch.equal(value.transpose(1, 2), want[0]) and torch.equal(pv, mask)
    assert torch.equal(eps, want[1]) and torch.equal(target, want[2])
    value, pv, eps, target = _oriented_setup(C, mask, transposed=True)
    want = auction_setup(C.transpose(1, 2), torch.ones((B, nq), dtype=torch.bool), row_mask=mask)
    assert torch.equal(value.transpose(1, 2), want[0]) and pv.all()
    assert torch.equal(eps, want[1]) and torch.equal(target, want[2])
