"""The segment algebra of the SS2D scan backward's CUDA kernels, on the CPU.

`tamtr_torch/csrc/ss2d_scan_bwd.cu` cuts each direction's walk into
segments of `seg` steps and runs three phases: per-segment summaries (the
local end state from h = 0, r = sum_s (prod_{i<=s} a_i) q_s, and the decay
exp(A sum dt)), a combine across segments (the state entering each segment
and the carry entering its last step), and a backward walk of each segment
from those, with a dA partial per segment. This file transcribes the three
phases with plain torch ops and holds the result against the plain backward
`ss2d_scan_bwd_ref` (all eight gradients, 1e-5) and once against JAX's
autodiff of `ss2d_scan_xla` (2e-3): L = 1, L below one segment, L = 35 and
L one step past a multiple of the segment length, segments of 4 and 16
steps, all four directions, B = 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.kernels.selective_scan import _assemble_grads, _direction_inputs, ss2d_scan_bwd_ref

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


def _segment_bwd_one(u, dt, A, Bk, Ck, dy, seg):
    """One direction in walk order: u, dt, dy (B, L, D); A (D, N); Bk, Ck
    (B, L, N). The kernels' three phases; returns du_core, ddt (B, L, D),
    dB, dC (B, L, N), the per-segment dA partials (S, B, D, N) and the
    combine's carries, one (B, D, N) per segment."""
    Bn, L, D = u.shape
    a = torch.exp(dt[..., None] * A)  # (B, L, D, N)
    b = (dt * u)[..., None] * Bk[:, :, None, :]
    q = dy[..., None] * Ck[:, :, None, :]
    segs = [range(s0, min(L, s0 + seg)) for s0 in range(0, L, seg)]
    zero = torch.zeros_like(a[:, 0])

    # 1. summaries: from h = 0 and g = 0 past the segment's end
    h_loc, r, E = [], [], []
    for sl in segs:
        h, P, acc = zero, torch.ones_like(zero), zero
        for s in sl:
            h = a[:, s] * h + b[:, s]
            P = P * a[:, s]
            acc = acc + P * q[:, s]
        h_loc.append(h)
        r.append(acc)
        E.append(torch.exp(dt[:, sl.start : sl.stop].sum(1)[..., None] * A))

    # 2. combine: h_in[j + 1] = E_j h_in[j] + h_loc[j]; c[j - 1] = E_j c[j] + r[j]
    h_in = [zero]
    for j in range(len(segs) - 1):
        h_in.append(E[j] * h_in[j] + h_loc[j])
    carry = [zero] * len(segs)
    for j in range(len(segs) - 1, 0, -1):
        carry[j - 1] = E[j] * carry[j] + r[j]

    # 3. walk: each segment backwards from h_in and the carry (a_next = 1)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bk), torch.empty_like(Ck)
    dA_parts = []
    for j, sl in enumerate(segs):
        hs, h = {}, h_in[j]
        for s in sl:
            h = a[:, s] * h + b[:, s]
            hs[s] = h
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
