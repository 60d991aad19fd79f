"""The port's one-direction scan, generic gather, scatters and auction on the
CPU, against the JAX package on the same numpy inputs.

- B6 `selective_scan` (the plain version on the CPU) against the Pallas
  `selective_scan_pallas` (interpret mode), forward and all six gradients at
  1e-4, odd L, Din above the JAX kernel's 512-wide block, D None and given,
  bf16 inputs; the plain version's `h0` / `return_final` against
  `selective_scan_xla`.
- B7 `weighted_gather` forward and its (value, w) gradients against JAX's
  with the Pallas scatter forced (`FORCE_PALLAS`, interpret mode) at 1e-5,
  colliding indices included; `scatter_acc` against `_scatter_acc`.
- B8 `scatter_acc_pairs` against `_scatter_acc_pairs` at 1e-5, with pairs at
  start L2 - 2 and repeated pairs.
- B5 `auction_match_ref` against JAX's `auction_match` on more than 132
  problems (the H100's SM count) with over-full ones: identical assignments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamtr_tpu.kernels.deform_scatter as jds
from tamtr_torch.kernels.auction import auction_match, auction_match_ref
from tamtr_torch.kernels.deform_scatter import (
    scatter_acc, scatter_acc_pairs, weighted_gather, weighted_gather_ref,
)
from tamtr_torch.nn.ssm import selective_scan, selective_scan_ref

SCAN_NAMES = ["u", "delta", "A", "Bs", "Cs", "D"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scan_inputs(seed, G, L, Din, N):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((G, L, Din)).astype(np.float32),
        (np.abs(rng.standard_normal((G, L, Din))) * 0.1).astype(np.float32),
        (-np.abs(rng.standard_normal((G, Din, N)))).astype(np.float32),
        rng.standard_normal((G, L, N)).astype(np.float32),
        rng.standard_normal((G, L, N)).astype(np.float32),
        rng.standard_normal((G, Din)).astype(np.float32),
    ], rng.standard_normal((G, L, Din)).astype(np.float32)


def _jax_scan(args, dy, with_d, chunk):
    from tamtr_tpu.kernels.selective_scan import selective_scan_pallas

    jargs = [jnp.asarray(a) for a in args[:5]]
    d = jnp.asarray(args[5]) if with_d else None

    def loss(*xs):
        y = selective_scan_pallas(*xs[:5], xs[5] if with_d else d, chunk)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy)), y

    argnums = tuple(range(6 if with_d else 5))
    (_, y), grads = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(*jargs, d)
    return y, grads


def _torch_scan(args, dy, with_d, chunk):
    ts = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in args[:5]]
    if with_d:
        ts.append(torch.from_numpy(np.asarray(args[5])).requires_grad_())
    y = selective_scan(*ts[:5], ts[5] if with_d else None, chunk=chunk)
    grads = torch.autograd.grad((y.float() * torch.from_numpy(dy)).sum(), ts)
    return y, grads


@pytest.mark.parametrize("G,L,Din,N,with_d", [
    (2, 100, 8, 4, True),     # odd L: no multiple of either chunk
    (1, 45, 520, 4, False),   # Din above the JAX kernel's 512-wide block, D None
    (2, 33, 16, 16, True),    # the model's state size
])
def test_selective_scan_matches_pallas(G, L, Din, N, with_d):
    args, dy = _scan_inputs(G * L + Din, G, L, Din, N)
    y_j, g_j = _jax_scan(args, dy, with_d, 32)
    y_t, g_t = _torch_scan(args, dy, with_d, 16)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=1e-4, rtol=1e-4)
    assert len(g_t) == len(g_j)
    for name, gt, gj in zip(SCAN_NAMES, g_t, g_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, rtol=1e-4, err_msg=name)


def test_selective_scan_bf16_inputs_match_pallas():
    """bf16 u, delta, Bs, Cs: the maths runs in fp32 on both sides, y comes
    back in bf16 and each cotangent in its input's dtype. Both round the same
    fp32 values to bf16, so they agree to one bf16 step (2^-8 relative)."""
    args, dy = _scan_inputs(7, 1, 24, 8, 4)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) if i in (0, 1, 3, 4) else jnp.asarray(a)
          for i, a in enumerate(args)]
    y_j, g_j = _jax_scan(bf, dy, True, 16)
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) if i in (0, 1, 3, 4)
          else torch.from_numpy(np.array(a)) for i, a in enumerate(bf)]
    ts = [t.requires_grad_() for t in tb]
    y_t = selective_scan(*ts, chunk=8)
    g_t = torch.autograd.grad((y_t.float() * torch.from_numpy(dy)).sum(), ts)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().detach().numpy(), np.asarray(y_j.astype(jnp.float32)),
                               atol=1e-2, rtol=2**-8)
    for name, t, gt, gj in zip(SCAN_NAMES, ts, g_t, g_j):
        assert gt.dtype == t.dtype, name
        assert bool(torch.isfinite(gt.float()).all()), name
        np.testing.assert_allclose(gt.float().numpy(), np.asarray(gj.astype(jnp.float32)),
                                   atol=1e-2, rtol=2**-8, err_msg=name)


@pytest.mark.parametrize("with_d", [True, False])
def test_selective_scan_ref_h0_and_final_state_match_xla(with_d):
    from tamtr_tpu.nn.ssm import selective_scan_xla

    args, _ = _scan_inputs(9, 2, 53, 12, 4)
    h0 = np.random.default_rng(10).standard_normal((2, 12, 4)).astype(np.float32)
    d = args[5] if with_d else None
    y_j, h_j = selective_scan_xla(*[jnp.asarray(a) for a in args[:5]], None if d is None else jnp.asarray(d),
                                  chunk=16, h0=jnp.asarray(h0), return_final=True)
    tt = [torch.from_numpy(a) for a in args]
    y_t, h_t = selective_scan_ref(*tt[:5], tt[5] if with_d else None, chunk=8, h0=torch.from_numpy(h0),
                                  return_final=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-4, rtol=1e-4)
    y_plain = selective_scan_xla(*[jnp.asarray(a) for a in args[:5]], None if d is None else jnp.asarray(d), chunk=16)
    np.testing.assert_allclose(selective_scan_ref(*tt[:5], tt[5] if with_d else None).numpy(),
                               np.asarray(y_plain), atol=1e-4, rtol=1e-4)


def _gather_inputs(seed, colliding, B=2, L=60, nh=3, c=8, Q=7, p4=16):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((B, L, nh, c)).astype(np.float32)
    if colliding:
        idx = np.zeros((B, Q * p4, nh), np.int32)  # every update hits row 0
    else:
        idx = rng.integers(0, L, (B, Q * p4, nh)).astype(np.int32)
    w = rng.standard_normal((B, Q * p4, nh)).astype(np.float32)
    dout = rng.standard_normal((B, Q, nh, c)).astype(np.float32)
    return value, idx, w, dout, p4


@pytest.mark.parametrize("colliding", [False, True])
def test_weighted_gather_and_grads_match_pallas_scatter(colliding, monkeypatch):
    monkeypatch.setattr(jds, "FORCE_PALLAS", True)
    value, idx, w, dout, p4 = _gather_inputs(11, colliding)

    def loss(v, ww):
        out = jds.weighted_gather(v, jnp.asarray(idx), ww, p4)
        return jnp.sum(out * jnp.asarray(dout)), out

    (_, out_j), (gv_j, gw_j) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(value), jnp.asarray(w))
    v_t, w_t = torch.from_numpy(value).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out_t = weighted_gather(v_t, torch.from_numpy(idx), w_t, p4)
    gv_t, gw_t = torch.autograd.grad(out_t, (v_t, w_t), torch.from_numpy(dout))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gv_t.numpy(), np.asarray(gv_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gw_t.numpy(), np.asarray(gw_j), atol=1e-5, rtol=1e-5)
    if colliding:
        want = np.einsum("bqph,bqhc->bhc", w.reshape(2, 7, p4, 3), dout)
        np.testing.assert_allclose(gv_t[:, 0].numpy(), want, atol=1e-5, rtol=1e-5)
        assert not gv_t[:, 1:].any()


def test_weighted_gather_bf16_value_dtype():
    value, idx, w, dout, p4 = _gather_inputs(12, False)
    v = torch.from_numpy(value).to(torch.bfloat16).requires_grad_()
    out = weighted_gather(v, torch.from_numpy(idx), torch.from_numpy(w), p4)
    (g,) = torch.autograd.grad(out.float().sum(), (v,))
    assert out.dtype == torch.bfloat16 and g.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), weighted_gather_ref(v.detach().float(), torch.from_numpy(idx),
                                                                torch.from_numpy(w), p4), atol=0.1, rtol=0.02)


def test_scatter_acc_matches_pallas_scatter_acc():
    """The kernel's contract on the port's layout ((B, L, nh, c), no
    head-major copies) against JAX's head-major `_scatter_acc`."""
    value, idx, w, dout, p4 = _gather_inputs(13, False)
    B, L, nh, c = value.shape
    Q = dout.shape[1]
    want = jds._scatter_acc(jnp.asarray(idx.transpose(0, 2, 1).reshape(B * nh, -1)),
                            jnp.asarray(w.transpose(0, 2, 1).reshape(B * nh, -1)),
                            jnp.asarray(dout.transpose(0, 2, 1, 3).reshape(B * nh, Q, c)), L)
    want = np.asarray(want).reshape(B, nh, L, c).transpose(0, 2, 1, 3)
    got = scatter_acc(torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(dout), L)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_scatter_acc_pairs_matches_pallas():
    """Starts in [0, L2 - 1) with pairs at L2 - 2 and repeated pairs."""
    rng = np.random.default_rng(14)
    G, L2, c, Q, per_q = 3, 40, 8, 5, 6
    idx2 = rng.integers(0, L2 - 1, (G, Q * per_q)).astype(np.int32)
    idx2[0, :3] = L2 - 2          # the last pair of rows, three times
    idx2[1, 4:9] = idx2[1, 3]     # one pair repeated across queries' updates
    idx2[2, -1] = L2 - 2
    wa, wb = (rng.standard_normal((G, Q * per_q)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((G, Q, c)).astype(np.float32)
    want = np.asarray(jds._scatter_acc_pairs(*(jnp.asarray(a) for a in (idx2, wa, wb, dout)), L2))
    got = scatter_acc_pairs(*(torch.from_numpy(a) for a in (idx2, wa, wb, dout)), L2)
    assert got.shape == (G, L2, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.abs(want[0, L2 - 1]).sum() > 0


def test_auction_over_132_problems_with_over_full_ones_matches_jax():
    """140 problems, more than the H100 has SMs (the old cooperative launch's
    limit); over-full ones (more valid gts than queries) keep bidding until
    the slowest problem of the batch stops, as JAX's batch-wide while_loop."""
    from tamtr_tpu.losses.matcher import auction_match as jax_auction

    rng = np.random.default_rng(15)
    B, nq, M = 140, 6, 9
    cost = rng.random((B, nq, M)).astype(np.float32)
    n_valid = rng.integers(0, M + 1, B)
    n_valid[[3, 70, 139]] = M    # over-full
    n_valid[[5, 100]] = nq       # contested: as many gts as queries
    mask = np.arange(M)[None] < n_valid[:, None]
    want = np.asarray(jax_auction(jnp.asarray(cost), jnp.asarray(mask)))
    got = auction_match_ref(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(auction_match(torch.from_numpy(cost), torch.from_numpy(mask)).numpy(), want)
    # the batch-wide stop matters here: run alone, some over-full problem
    # stops at its own target with another assignment
    alone = [auction_match_ref(torch.from_numpy(cost[[b]]), torch.from_numpy(mask[[b]])).numpy()[0]
             for b in (3, 70, 139)]
    assert any(not np.array_equal(a, want[b]) for a, b in zip(alone, (3, 70, 139)))


def test_plain_versions_count_no_launches_and_other_devices_raise():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; a tensor on a device without a kernel raises."""
    args, dy = _scan_inputs(16, 1, 9, 8, 4)
    value, idx, w, dout, p4 = _gather_inputs(17, False)
    idx2 = np.zeros((2, 12), np.int32)
    counters = (selective_scan, scatter_acc, scatter_acc_pairs)
    before = [f.launches for f in counters]
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    torch.autograd.grad(selective_scan(*ts), ts, torch.from_numpy(dy))
    v = torch.from_numpy(value).requires_grad_()
    torch.autograd.grad(weighted_gather(v, torch.from_numpy(idx), torch.from_numpy(w), p4), v, torch.from_numpy(dout))
    scatter_acc_pairs(torch.from_numpy(idx2), torch.ones(2, 12), torch.ones(2, 12), torch.ones(2, 3, 4), 5)
    assert [f.launches for f in counters] == before
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        selective_scan(meta(1, 4, 8), meta(1, 4, 8), meta(1, 8, 4), meta(1, 4, 4), meta(1, 4, 4))
    with pytest.raises(RuntimeError, match="no kernel"):
        weighted_gather(meta(1, 4, 1, 8), torch.zeros(1, 4, 1, dtype=torch.int32, device="meta"), meta(1, 4, 1), 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        scatter_acc(torch.zeros(1, 4, 1, dtype=torch.int32, device="meta"), meta(1, 4, 1), meta(1, 1, 1, 8), 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        scatter_acc_pairs(torch.zeros(1, 4, dtype=torch.int32, device="meta"), meta(1, 4), meta(1, 4), meta(1, 1, 8), 4)
