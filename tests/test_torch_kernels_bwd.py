"""The port's backward kernels' plain versions and its auction on the CPU,
against the JAX package on the same numpy inputs.

- B3 SS2D scan backward: gradients of all eight inputs through the port's
  autograd.Function (which runs `ss2d_scan_bwd_ref` on the CPU) against
  `jax.grad` of `ss2d_scan_xla` and of the Pallas `ss2d_scan` with its
  Pallas backward in interpret mode, at an odd L, within 2e-3.
- B4 gather backward: dvalue and dw against the JAX XLA path (the 4-corner
  autodiff, which is correct; its Pallas path reads past the block for
  pairs on the last row) with a sample point in the global last pixel cell,
  and the gradient to sampling locations and attention weights through
  `ms_deform_attn_core`, within 1e-5.
- B5 auction: `auction_match_ref` and `auction_assignment` give the JAX
  package's assignments exactly on tie-free costs, over-full images
  included; the Pallas kernel (interpret) and scipy agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamtr_tpu.kernels.deform_scatter as jds
from tamtr_torch.kernels.auction import auction_match, auction_match_ref
from tamtr_torch.kernels.deform_scatter import (
    bilinear_gather, bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_ref,
)
from tamtr_torch.kernels.selective_scan import (
    ss2d_scan, ss2d_scan_bwd, ss2d_scan_bwd_ref, ss2d_scan_bwd_walk, ss2d_scan_carriers, ss2d_scan_combine,
    ss2d_scan_ref,
)
from tamtr_torch.losses.matcher import _solve_host, auction_assignment, hungarian_match
from tamtr_torch.nn.decoder import deform_sampling_pairs, ms_deform_attn_core

NAMES = ["layouts", "dts_raw", "dt_w", "dt_b", "A", "Bs", "Cs", "Ds"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ss2d_inputs(seed, B, H, W, D, N=16, R=4):
    rng = np.random.default_rng(seed)
    L = H * W
    xm = rng.standard_normal((B, H, W, D)).astype(np.float32)
    layouts = np.stack([xm.reshape(B, L, D), xm.transpose(0, 2, 1, 3).reshape(B, L, D)], 1)
    A = -np.exp(rng.uniform(0.0, np.log(N), (4, D, N))).astype(np.float32)
    return [
        layouts,
        (rng.standard_normal((B, 2, 2, L, R)) * 0.5).astype(np.float32),
        (rng.standard_normal((4, D, R)) * 0.5).astype(np.float32),
        (rng.standard_normal((4, D)) * 0.1 - 1.0).astype(np.float32),
        A,
        rng.standard_normal((B, 2, 2, L, N)).astype(np.float32),
        rng.standard_normal((B, 2, 2, L, N)).astype(np.float32),
        rng.standard_normal((4, D)).astype(np.float32),
    ], rng.standard_normal((B, 4, L, D)).astype(np.float32)


def _torch_scan_grads(args, dy):
    targs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in args]
    (ss2d_scan(*targs) * torch.from_numpy(dy)).sum().backward()
    return [t.grad.numpy() for t in targs]


@pytest.fixture(scope="module")
def scan_case():
    """Odd 5x7 (L=35): no multiple of either side's chunk."""
    return _ss2d_inputs(1, 2, 5, 7, D=16)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_ss2d_scan_grads_match_jax(scan_case, jax_impl):
    import tamtr_tpu.kernels.selective_scan as ssk

    args, dy = scan_case
    jargs = [jnp.asarray(a) for a in args]
    if jax_impl == "xla":
        loss = lambda *a: (ssk.ss2d_scan_xla(*a, chunk=8) * dy).sum()  # noqa: E731
    else:
        ssk.set_ss2d_bwd_impl("pallas")
        loss = lambda *a: (ssk.ss2d_scan(*a, 16) * dy).sum()  # noqa: E731
    want = jax.grad(loss, argnums=tuple(range(8)))(*jargs)
    got = _torch_scan_grads(args, dy)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, rtol=2e-3, err_msg=name)


def test_ss2d_scan_bwd_ref_equals_autodiff_of_the_forward():
    """The explicit backward is the gradient of the plain forward (chunk 4
    on L=15: a ragged last chunk and state carried across chunks)."""
    args, dy = _ss2d_inputs(2, 1, 3, 5, D=8)
    targs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in args]
    (ss2d_scan_ref(*targs, chunk=4) * torch.from_numpy(dy)).sum().backward()
    got = ss2d_scan_bwd_ref(*[t.detach() for t in targs], torch.from_numpy(dy), chunk=4)
    for name, g, t in zip(NAMES, got, targs):
        torch.testing.assert_close(g, t.grad, atol=1e-4, rtol=1e-4, msg=name)


def test_ss2d_scan_grads_through_split_views():
    """dts_raw/Bs/Cs arrive as views split from one x_proj result; their
    gradients come back in the views' shapes and land in that result."""
    args, dy = _ss2d_inputs(3, 1, 4, 3, D=8)
    want = _torch_scan_grads(args, dy)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    R = t[1].shape[-1]
    x_dbl = torch.cat([t[1], t[5], t[6]], -1).requires_grad_()
    dts_raw, Bs, Cs = x_dbl.split([R, 16, 16], -1)
    (ss2d_scan(t[0], dts_raw, t[2], t[3], t[4], Bs, Cs, t[7]) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(x_dbl.grad.numpy(), np.concatenate([want[1], want[5], want[6]], -1),
                               atol=1e-6, rtol=1e-6)


SHAPES = [(6, 7), (3, 4), (2, 3)]


def _deform_inputs(seed=5, B=2, Q=6, nh=2, c=8, P=4):
    rng = np.random.default_rng(seed)
    nl = len(SHAPES)
    Lv = sum(h * w for h, w in SHAPES)
    value = rng.standard_normal((B, Lv, nh, c)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, nh, nl, P, 2)).astype(np.float32)
    H2, W2 = SHAPES[2]
    # last pixel cell of the last level: the pair starts on the global last row
    loc[0, 0, 0, 2, 0] = [1 - 0.2 / W2, 1 - 0.2 / H2]
    loc[1, 3, 1, 2, 1] = [1 - 0.45 / W2, 1 - 0.01 / H2]
    # x0 < 0 with a valid right corner
    loc[0, 1, 1, 0, 2] = [0.2 / SHAPES[0][1], 0.5]
    # bottom-right cell of level 0: its second row is level 1's row 0
    loc[1, 2, 0, 0, 3] = [1 - 0.3 / SHAPES[0][1], 1 - 0.3 / SHAPES[0][0]]
    w_att = rng.random((B, Q, nh, nl, P)).astype(np.float32)
    w_att /= w_att.sum((-1, -2), keepdims=True)
    dout = rng.standard_normal((B, Q, nh, c)).astype(np.float32)
    return value, loc, w_att, dout, P * nl, Lv


def test_bilinear_gather_grads_match_jax_xla_path(monkeypatch):
    monkeypatch.setattr(jds, "FORCE_PALLAS", False)
    value, loc, w_att, dout, P, Lv = _deform_inputs()
    idx4, w_pairs, idx2 = deform_sampling_pairs(SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    assert int(idx2.max()) == Lv - 1  # the last-row shift is exercised
    _, vjp = jax.vjp(lambda v, w: jds.bilinear_gather(v, jnp.asarray(idx4.numpy()), w,
                                                      jnp.asarray(idx2.numpy()), P),
                     jnp.asarray(value), jnp.asarray(w_pairs.numpy()))
    dv_want, dw_want = (np.asarray(a) for a in vjp(jnp.asarray(dout)))
    v = torch.from_numpy(value).requires_grad_()
    w = w_pairs.clone().requires_grad_()
    bilinear_gather(v, idx4, w, idx2, P).backward(torch.from_numpy(dout))
    np.testing.assert_allclose(v.grad.numpy(), dv_want, atol=1e-5, rtol=1e-5)
    # slots with a live corner; a dead slot's dw is unspecified and meets a
    # zero derivative upstream (see the end-to-end test below)
    live = w_pairs.numpy() != 0
    np.testing.assert_allclose(w.grad.numpy()[live], dw_want[live], atol=1e-5, rtol=1e-5)
    # the shifted last-row pair: its live slot's dw is value[Lv-1] . dout
    b, u, h = (int(i[0]) for i in torch.nonzero(idx2 == Lv - 1, as_tuple=True))
    q = u // (2 * P)
    slot = int(np.flatnonzero(live[b, u, h])[0])
    assert slot == 0
    np.testing.assert_allclose(w.grad[b, u, h, 0].item(), float(value[b, Lv - 1, h] @ dout[b, q, h]), rtol=1e-5)


def test_deform_attn_grads_to_locations_match_jax(monkeypatch):
    from tamtr_tpu.nn.decoder import ms_deform_attn_core as jax_core

    monkeypatch.setattr(jds, "FORCE_PALLAS", False)
    value, loc, w_att, dout, _, _ = _deform_inputs(seed=9)
    B, Q, nh, c = dout.shape
    d2 = dout.reshape(B, Q, nh * c)
    want = jax.grad(lambda v, lc, wa: (jax_core(v, SHAPES, lc, wa) * d2).sum(), argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w_att))
    ts = [torch.from_numpy(a).requires_grad_() for a in (value, loc, w_att)]
    (ms_deform_attn_core(ts[0], SHAPES, ts[1], ts[2]) * torch.from_numpy(d2)).sum().backward()
    for name, t, w in zip(["value", "loc", "w_att"], ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


def test_gather_bwd_ref_is_the_gradient_of_the_forward():
    """The pair-form backward against autodiff of the 4-corner forward:
    dvalue everywhere, dw on the live slots."""
    value, loc, w_att, dout, P, _ = _deform_inputs(seed=13)
    idx4, w_pairs, idx2 = deform_sampling_pairs(SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    v = torch.from_numpy(value).requires_grad_()
    w = w_pairs.clone().requires_grad_()
    bilinear_gather_ref(v, idx4, w, idx2, P).backward(torch.from_numpy(dout))
    dv, dw = bilinear_gather_bwd_ref(torch.from_numpy(value), idx2, w_pairs, torch.from_numpy(dout))
    torch.testing.assert_close(dv, v.grad, atol=1e-6, rtol=1e-6)
    live = w_pairs != 0
    torch.testing.assert_close(dw[live], w.grad[live], atol=1e-6, rtol=1e-6)
    assert bilinear_gather_bwd(torch.from_numpy(value), idx2, w_pairs, torch.from_numpy(dout))[1].equal(dw)


def _costs(seed, B, nq, M, n_valid):
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(B, nq, M)).astype(np.float32)
    mask = np.arange(M)[None] < np.asarray(n_valid)[:, None]
    return cost, mask


@pytest.mark.parametrize("B,nq,M,n_valid", [
    (4, 50, 30, [20, 20, 5, 30]),
    (2, 100, 300, [40, 95]),  # lightly contested and contested (>= 0.7 nq)
    (3, 20, 40, [10, 30, 20]),  # an over-full image saturates and churns
    (2, 20, 20, [20, 0]),
])
def test_auction_match_ref_equals_jax(B, nq, M, n_valid):
    from tamtr_tpu.losses.matcher import auction_match as jax_auction

    cost, mask = _costs(B * 100 + nq, B, nq, M, n_valid)
    want = np.asarray(jax_auction(jnp.asarray(cost), jnp.asarray(mask)))
    got = auction_match_ref(torch.from_numpy(cost), torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(auction_match(torch.from_numpy(cost), torch.from_numpy(mask)).numpy(), want)


def test_auction_match_ref_transposed_with_row_mask_equals_jax():
    from tamtr_tpu.losses.matcher import auction_match as jax_auction

    cost, qmask = _costs(7, 3, 40, 12, [12, 12, 12])  # rows = gts, columns = queries
    rows = np.arange(40)[None] < np.array([[25], [40], [12]])
    want = np.asarray(jax_auction(jnp.asarray(cost), jnp.asarray(qmask), row_mask=jnp.asarray(rows)))
    got = auction_match_ref(torch.from_numpy(cost), torch.from_numpy(qmask), row_mask=torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_auction_assignment_with_over_full_images_equals_jax():
    from tamtr_tpu.losses.matcher import auction_assignment as jax_assignment

    cost, mask = _costs(11, 4, 16, 30, [8, 25, 12, 30])  # two over-full, one contested
    want = np.asarray(jax_assignment(jnp.asarray(cost), jnp.asarray(mask)))
    got = auction_assignment(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1] >= 0).sum() == 16 and len(set(got[1][got[1] >= 0])) == 16


@pytest.mark.parametrize("B,nq,M,nv", [(4, 50, 30, 20), (2, 100, 300, 95), (2, 20, 20, 20)])
def test_auction_match_ref_equals_pallas_kernel(B, nq, M, nv):
    """As `tests/test_auction_kernel.py` holds the Pallas kernel (interpret
    mode here) against the XLA auction."""
    from tamtr_tpu.kernels.auction import auction_match_pallas

    cost, mask = _costs(B * 1000 + nv, B, nq, M, [nv] * B)
    want = np.asarray(auction_match_pallas(jnp.asarray(cost), jnp.asarray(mask)))
    np.testing.assert_array_equal(auction_match_ref(torch.from_numpy(cost), torch.from_numpy(mask)).numpy(), want)


def test_auction_near_optimal_and_scipy_oracle_equals_jax():
    """<= 1% of scipy's optimum at the production shape (nq=100, M=300),
    as `tests/test_auction_kernel.py`; the port's scipy path equals JAX's."""
    from tamtr_tpu.losses.matcher import _solve_host as jax_solve

    rng = np.random.default_rng(7)
    B, nq, M, nv = 4, 100, 300, 80
    cost = (rng.normal(size=(B, nq, M)) * 3.0).astype(np.float32)
    mask = np.arange(M)[None].repeat(B, 0) < nv
    got = auction_match_ref(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    opt = _solve_host(cost, mask.sum(1))
    np.testing.assert_array_equal(opt, jax_solve(cost, mask.sum(1)))

    def total(a):
        return sum(float(cost[b][a[b][a[b] >= 0], np.flatnonzero(a[b] >= 0)].sum()) for b in range(B))

    assert (got >= 0).sum() == (opt >= 0).sum()
    assert total(got) <= total(opt) + 0.01 * abs(total(opt))


def test_hungarian_match_equals_jax_on_both_solvers():
    """The cost matrix (focal class + L1 + RIOU) and both solvers, with an
    over-full image."""
    from tamtr_tpu.losses.matcher import hungarian_match as jax_match

    rng = np.random.default_rng(3)
    B, nq, M, nc = 3, 12, 16, 5
    pb = np.concatenate([rng.uniform(0.2, 0.8, (B, nq, 2)), rng.uniform(0.05, 0.3, (B, nq, 2))], -1)
    gb = np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)), rng.uniform(0.05, 0.3, (B, M, 2))], -1)
    ps = rng.standard_normal((B, nq, nc))
    cls = rng.integers(0, nc, (B, M)).astype(np.int32)
    mask = np.arange(M)[None] < np.array([[5], [16], [9]])
    args = [a.astype(np.float32) if a.dtype == np.float64 else a for a in (pb, ps, gb, cls, mask)]
    for method in ("auction", "scipy"):
        want = np.asarray(jax_match(*(jnp.asarray(a) for a in args), method=method))
        got = hungarian_match(*(torch.from_numpy(a) for a in args), method=method).numpy()
        np.testing.assert_array_equal(got, want, err_msg=method)


def test_backward_wrappers_and_auction_raise_without_a_kernel():
    meta = torch.empty((1, 2, 4, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_bwd(meta, *([meta] * 8))
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_carriers(meta, *([meta] * 7))
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_combine(meta, meta, meta, meta, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_bwd_walk(meta, *([meta] * 9))
    with pytest.raises(RuntimeError, match="no kernel"):
        bilinear_gather_bwd(torch.empty((1, 4, 1, 8), device="meta"), None, None,
                            torch.empty((1, 1, 1, 8), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        auction_match(torch.empty((1, 2, 3), device="meta"), None)


def test_cpu_backward_counts_no_launches():
    counters = (ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_bwd_walk, bilinear_gather_bwd, auction_match)
    before = [f.launches for f in counters]
    args, dy = _ss2d_inputs(4, 1, 2, 3, D=8)
    _torch_scan_grads(args, dy)
    value, loc, w_att, dout, P, _ = _deform_inputs()
    idx4, w_pairs, idx2 = deform_sampling_pairs(SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    v = torch.from_numpy(value).requires_grad_()
    bilinear_gather(v, idx4, w_pairs, idx2, P).sum().backward()
    cost, mask = _costs(1, 1, 4, 3, [3])
    auction_match(torch.from_numpy(cost), torch.from_numpy(mask))
    assert [f.launches for f in counters] == before
