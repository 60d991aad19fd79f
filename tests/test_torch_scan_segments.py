"""The segment algebra of the SS2D scan's CUDA kernels, on the CPU.

`tamtr_torch/csrc/ss2d_scan_bwd.cu` cuts each direction's walk into
segments of `seg` steps and runs three phases: per-segment summaries (the
local end state from h = 0, r = sum_s (prod_{i<=s} a_i) q_s, and the decay
exp(A sum dt)), a combine across segments (the state entering each segment
and the carry entering its last step), and a backward walk of each segment
from those, with a dA partial per segment. `ss2d_scan_fwd.cu` runs the state
half of the first two (no r, no carry) and then rebuilds each segment from
its entering state to write y. This file transcribes the phases with plain
torch ops, one helper for the state half that both share, and holds the
results against the plain versions (`ss2d_scan_ref`, and all eight
gradients of `ss2d_scan_bwd_ref`, 1e-5) and once each against JAX
(`ss2d_scan_xla` 1e-4, its autodiff 2e-3): L = 1, L below one segment,
L = 35 and L one step past a multiple of the segment length, segments of 4
and 16 steps, all four directions, B = 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.kernels.selective_scan import _assemble_grads, _direction_inputs, ss2d_scan_bwd_ref, ss2d_scan_ref

NAMES = ["layouts", "dts_raw", "dt_w", "dt_b", "A", "Bs", "Cs", "Ds"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, B, H, W, D, N=16, R=4):
    rng = np.random.default_rng(seed)
    L = H * W
    xm = rng.standard_normal((B, H, W, D)).astype(np.float32)
    layouts = np.stack([xm.reshape(B, L, D), xm.transpose(0, 2, 1, 3).reshape(B, L, D)], 1)
    return [
        layouts,
        (rng.standard_normal((B, 2, 2, L, R)) * 0.5).astype(np.float32),
        (rng.standard_normal((4, D, R)) * 0.5).astype(np.float32),
        (rng.standard_normal((4, D)) * 0.1 - 1.0).astype(np.float32),
        -np.exp(rng.uniform(0.0, np.log(N), (4, D, N))).astype(np.float32),
        rng.standard_normal((B, 2, 2, L, N)).astype(np.float32),
        rng.standard_normal((B, 2, 2, L, N)).astype(np.float32),
        rng.standard_normal((4, D)).astype(np.float32),
    ], rng.standard_normal((B, 4, L, D)).astype(np.float32)


def _recurrence(u, dt, A, Bk, seg):
    """a = exp(dt A) and b = dt u B (B, L, D, N), and the segments' steps."""
    a = torch.exp(dt[..., None] * A)
    b = (dt * u)[..., None] * Bk[:, :, None, :]
    return a, b, [range(s0, min(u.shape[1], s0 + seg)) for s0 in range(0, u.shape[1], seg)]


def _rebuild(a, b, h, sl):
    """The states of steps `sl`, by step, from the state h entering them."""
    hs = {}
    for s in sl:
        h = hs[s] = a[:, s] * h + b[:, s]
    return hs


def _segment_states(a, b, dt, A, segs):
    """Phases 1-2, the state half both kernels share. Summaries: per segment
    the local end state from h = 0 and the decay E = exp(A sum dt); combine:
    h_in[j + 1] = E_j h_in[j] + h_loc[j] from h_in[0] = 0. Returns h_in and E,
    one (B, D, N) per segment each."""
    h_in, E = [torch.zeros_like(a[:, 0])], []
    for sl in segs:
        h_loc = _rebuild(a, b, torch.zeros_like(a[:, 0]), sl)[sl[-1]]
        E.append(torch.exp(dt[:, sl.start : sl.stop].sum(1)[..., None] * A))
        h_in.append(E[-1] * h_in[-1] + h_loc)
    return h_in[:-1], E


def _segment_fwd_one(u, dt, A, Bk, Ck, seg):
    """One direction's y without the D skip, in walk order: u, dt (B, L, D);
    A (D, N); Bk, Ck (B, L, N). The forward kernels' three phases."""
    a, b, segs = _recurrence(u, dt, A, Bk, seg)
    h_in, _ = _segment_states(a, b, dt, A, segs)
    # 3. output: each segment rebuilt from its entering state
    y = torch.empty_like(u)
    for j, sl in enumerate(segs):
        for s, h in _rebuild(a, b, h_in[j], sl).items():
            y[:, s] = (h * Ck[:, s, None, :]).sum(-1)
    return y


def segment_fwd(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, seg):
    """The fused scan's y (B, 4, L, D) through the forward's segment phases."""
    ys = []
    for k in range(4):
        u, dt, Bk, Ck = _direction_inputs(layouts, dts_raw, dt_w, dt_b, Bs, Cs, k)
        y = _segment_fwd_one(u, dt, A[k], Bk, Ck, seg)
        ys.append((y.flip(1) if k >= 2 else y) + layouts[:, k % 2] * Ds[k])
    return torch.stack(ys, 1)


def _segment_bwd_one(u, dt, A, Bk, Ck, dy, seg):
    """One direction in walk order: u, dt, dy (B, L, D); A (D, N); Bk, Ck
    (B, L, N). The kernels' three phases; returns du_core, ddt (B, L, D),
    dB, dC (B, L, N), the per-segment dA partials (S, B, D, N) and the
    combine's carries, one (B, D, N) per segment."""
    a, b, segs = _recurrence(u, dt, A, Bk, seg)
    q = dy[..., None] * Ck[:, :, None, :]
    zero = torch.zeros_like(a[:, 0])

    # 1-2, the state half: h_in and the decays
    h_in, E = _segment_states(a, b, dt, A, segs)

    # 1. r: from g = 0 past the segment's end
    r = []
    for sl in segs:
        P, acc = torch.ones_like(zero), zero
        for s in sl:
            P = P * a[:, s]
            acc = acc + P * q[:, s]
        r.append(acc)

    # 2. combine, the carry half: c[j - 1] = E_j c[j] + r[j]
    carry = [zero] * len(segs)
    for j in range(len(segs) - 1, 0, -1):
        carry[j - 1] = E[j] * carry[j] + r[j]

    # 3. walk: each segment backwards from h_in and the carry (a_next = 1)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bk), torch.empty_like(Ck)
    dA_parts = []
    for j, sl in enumerate(segs):
        hs = _rebuild(a, b, h_in[j], sl)
        g, a_next, dA = carry[j], torch.ones_like(zero), zero
        for s in reversed(sl):
            g = a_next * g + q[:, s]
            h_prev = hs[s - 1] if s > sl.start else h_in[j]
            ddA = g * h_prev * a[:, s]
            dA = dA + ddA * dt[:, s, :, None]
            gB = (g * Bk[:, s, None, :]).sum(-1)
            du[:, s] = gB * dt[:, s]
            ddt[:, s] = gB * u[:, s] + (ddA * A).sum(-1)
            dB[:, s] = (g * (dt * u)[:, s, :, None]).sum(1)
            dC[:, s] = (dy[:, s, :, None] * hs[s]).sum(1)
            a_next = a[:, s]
        dA_parts.append(dA)
    return du, ddt, dB, dC, torch.stack(dA_parts), carry


def segment_bwd(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, dy, seg):
    """The eight gradients of the fused scan through the segment phases."""
    B, _, L, D = layouts.shape
    N = A.shape[-1]
    du_core, dz = torch.empty_like(dy), torch.empty_like(dy)
    dBs, dCs = Bs.new_empty((B, 4, L, N)), Cs.new_empty((B, 4, L, N))
    dA = torch.empty_like(A)
    for k in range(4):
        u, dt, Bk, Ck = _direction_inputs(layouts, dts_raw, dt_w, dt_b, Bs, Cs, k)
        flip = (lambda t: t.flip(1)) if k >= 2 else (lambda t: t)  # noqa: E731
        du, ddt, dBk, dCk, dA_parts, _ = _segment_bwd_one(u, dt, A[k], Bk, Ck, flip(dy[:, k]), seg)
        du_core[:, k], dz[:, k] = flip(du), flip(ddt) * (1.0 - torch.exp(-flip(dt)))
        dBs[:, k], dCs[:, k] = flip(dBk), flip(dCk)
        dA[k] = dA_parts.sum((0, 1))  # over segments, then images: a fixed order
    return _assemble_grads(layouts, dts_raw, dt_w, Ds, dy, du_core, dz,
                           dBs.view(B, 2, 2, L, N), dCs.view(B, 2, 2, L, N), dA)


@pytest.mark.parametrize("H,W,seg", [
    (1, 1, 4),  # L = 1
    (2, 3, 16),  # L = 6, below one segment
    (5, 7, 4),  # L = 35, ragged last segment of 3
    (5, 7, 16),  # L = 35, ragged last segment of 3
    (1, 17, 16),  # L = 17, one step past a segment
    (3, 3, 4),  # L = 9, one step past two segments
    (4, 4, 4),  # L = 16, whole segments only
])
def test_segment_phases_equal_plain_backward(H, W, seg):
    args, dy = _inputs(H * 100 + W * 10 + seg, 2, H, W, D=8)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = segment_bwd(*targs, torch.from_numpy(dy), seg)
    want = ss2d_scan_bwd_ref(*targs, torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=name)


def test_segment_carry_is_the_next_segments_g():
    """c[j] = a_{e+1} g_{e+1}: the combine's carry entering segment j's last
    step, against the whole-sequence reverse scan of g (the a of the next
    segment's first step, a_L = 0 after the last)."""
    args, dy = _inputs(7, 2, 3, 3, D=8)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    u, dt, Bk, Ck = _direction_inputs(*targs[:4], targs[5], targs[6], 2)  # row-rev
    A = targs[4][2]
    dyk = torch.from_numpy(dy)[:, 2].flip(1)
    a = torch.exp(dt[..., None] * A)
    q = dyk[..., None] * Ck[:, :, None, :]
    L, seg = u.shape[1], 4
    g, gs = torch.zeros_like(a[:, 0]), [None] * L
    for s in reversed(range(L)):
        g = (a[:, s + 1] * g if s + 1 < L else 0.0) + q[:, s]
        gs[s] = g
    c = _segment_bwd_one(u, dt, A, Bk, Ck, dyk, seg)[5]
    S = len(c)
    assert S == 3
    for j in range(S - 1):
        e1 = (j + 1) * seg
        torch.testing.assert_close(c[j], a[:, e1] * gs[e1], atol=1e-6, rtol=1e-5)
    assert torch.equal(c[S - 1], torch.zeros_like(g))


def test_segment_phases_match_jax_autodiff():
    import tamtr_tpu.kernels.selective_scan as ssk

    args, dy = _inputs(1, 2, 5, 7, D=16)
    want = jax.grad(lambda *a: (ssk.ss2d_scan_xla(*a, chunk=8) * dy).sum(), argnums=tuple(range(8)))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = segment_bwd(*targs, torch.from_numpy(dy), 4)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("H,W,seg", [
    (1, 1, 4),  # L = 1
    (2, 3, 16),  # L = 6, below one segment
    (5, 7, 4),  # L = 35, ragged last segment of 3
    (5, 7, 16),  # L = 35, ragged last segment of 3
    (1, 17, 16),  # L = 17, one step past a segment
    (3, 3, 4),  # L = 9, one step past two segments
    (4, 4, 4),  # L = 16, whole segments only
])
def test_forward_segment_phases_equal_plain_scan(H, W, seg):
    args, _ = _inputs(H * 100 + W * 10 + seg, 2, H, W, D=8)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    torch.testing.assert_close(segment_fwd(*targs, seg), ss2d_scan_ref(*targs), atol=1e-5, rtol=1e-5)


def test_forward_segment_phases_match_jax():
    import tamtr_tpu.kernels.selective_scan as ssk

    args, _ = _inputs(2, 2, 5, 7, D=16)
    want = ssk.ss2d_scan_xla(*[jnp.asarray(a) for a in args], chunk=8)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    np.testing.assert_allclose(segment_fwd(*targs, 4).numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
