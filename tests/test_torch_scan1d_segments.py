"""The segment algebra of the one-direction scan's CUDA kernel (B6), on the CPU.

`tamtr_torch/csrc/selective_scan_fwd.cu` cuts each group's walk into
segments of `seg` steps (`SEG_STEPS` on the card) and runs three phases:
per-segment summaries (the local end state from h = 0, and the sum of delta,
whose exp(A sum delta) is the segment's decay), a combine across segments
(the state entering each segment), and an output pass that rebuilds each
segment from its entering state and writes y = C.h + D.u. This file
transcribes the phases with plain torch ops (test code only: the CPU path of
`selective_scan` stays `selective_scan_ref`) and holds them against the plain
version (1e-5) and against JAX's Pallas kernel (`selective_scan_pallas`,
interpret mode, 1e-4): L = 1, 35, 48, 49 and 97, N = 4 and 16, Din = 40,
D given and None, segments of 4, 16 and 48 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.kernels.selective_scan import (
    SEG_STEPS, selective_scan_fwd_combine, selective_scan_fwd_output, selective_scan_fwd_summaries, selective_scan_ref,
)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, G, L, Din, N):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((G, L, Din)).astype(np.float32),
        (np.abs(rng.standard_normal((G, L, Din))) * 0.1).astype(np.float32),
        (-np.abs(rng.standard_normal((G, Din, N)))).astype(np.float32),
        rng.standard_normal((G, L, N)).astype(np.float32),
        rng.standard_normal((G, L, N)).astype(np.float32),
        rng.standard_normal((G, Din)).astype(np.float32),
    ]


def _step(h, u, delta, A, Bs, s):
    """h_s = exp(delta_s A) h_{s-1} + (delta_s u_s) B_s: h (G, Din, N)."""
    return torch.exp(delta[:, s, :, None] * A) * h + (delta[:, s] * u[:, s])[..., None] * Bs[:, s, None, :]


def _segments(L, seg):
    return [range(s0, min(L, s0 + seg)) for s0 in range(0, L, seg)]


def summaries(u, delta, A, Bs, seg):
    """Phase 1: per segment, the local end state from h = 0, (G, Din, N),
    and the sum of delta, (G, Din)."""
    h_loc, sdt = [], []
    for sl in _segments(u.shape[1], seg):
        h = torch.zeros_like(A)
        for s in sl:
            h = _step(h, u, delta, A, Bs, s)
        h_loc.append(h)
        sdt.append(delta[:, sl.start:sl.stop].sum(1))
    return h_loc, sdt


def combine(A, h_loc, sdt):
    """Phase 2: h_in[0] = 0, h_in[j + 1] = exp(A sdt[j]) h_in[j] + h_loc[j]."""
    h_in = [torch.zeros_like(A)]
    for hl, sd in zip(h_loc[:-1], sdt[:-1]):
        h_in.append(torch.exp(A * sd[..., None]) * h_in[-1] + hl)
    return h_in


def output(u, delta, A, Bs, Cs, D, h_in, seg):
    """Phase 3: each segment's states rebuilt step by step from its entering
    state; y_s = sum_n C_s[n] h_s[n] + D u_s."""
    y = torch.empty_like(u)
    for h, sl in zip(h_in, _segments(u.shape[1], seg)):
        for s in sl:
            h = _step(h, u, delta, A, Bs, s)
            y[:, s] = (h * Cs[:, s, None, :]).sum(-1)
    return y if D is None else y + u * D[:, None, :]


def segment_scan(u, delta, A, Bs, Cs, D, seg):
    h_loc, sdt = summaries(u, delta, A, Bs, seg)
    return output(u, delta, A, Bs, Cs, D, combine(A, h_loc, sdt), seg)


def _torch_args(args, with_d):
    ts = [torch.from_numpy(a) for a in args]
    return ts[:5] + [ts[5] if with_d else None]


@pytest.mark.parametrize("L,N,with_d,seg", [
    (1, 4, True, 4),  # L = 1
    (35, 16, False, 4),  # ragged last segment of 3
    (35, 4, True, 16),
    (48, 16, True, 16),  # whole segments only
    (48, 4, False, SEG_STEPS),  # one whole segment of the kernel's length
    (49, 16, False, 16),  # one step past whole segments
    (49, 4, True, SEG_STEPS),  # one step past a kernel segment
    (97, 16, True, SEG_STEPS),  # one step past two kernel segments
    (97, 4, False, 16),
])
def test_scan1d_segment_phases_equal_plain_scan(L, N, with_d, seg):
    ts = _torch_args(_inputs(L * 10 + N + seg, 2, L, 40, N), with_d)
    torch.testing.assert_close(segment_scan(*ts, seg), selective_scan_ref(*ts), atol=1e-5, rtol=1e-5)


def test_scan1d_combine_gives_the_state_entering_each_segment():
    """h_in[j] is the state of the whole walk just before segment j starts."""
    u, delta, A, Bs, _, _ = _torch_args(_inputs(3, 2, 41, 40, 16), True)
    seg = 8
    h_in = combine(A, *summaries(u, delta, A, Bs, seg))
    assert len(h_in) == 6
    h = torch.zeros_like(A)
    for s in range(u.shape[1]):
        if s % seg == 0:
            torch.testing.assert_close(h_in[s // seg], h, atol=1e-6, rtol=1e-5)
        h = _step(h, u, delta, A, Bs, s)


@pytest.mark.parametrize("L,N,with_d,seg", [(97, 16, True, 16), (49, 4, False, 4)])
def test_scan1d_segment_phases_match_pallas(L, N, with_d, seg):
    from tamtr_tpu.kernels.selective_scan import selective_scan_pallas

    args = _inputs(L + N, 2, L, 40, N)
    jargs = [jnp.asarray(a) for a in args[:5]]
    want = selective_scan_pallas(*jargs, jnp.asarray(args[5]) if with_d else None, 32)
    got = segment_scan(*_torch_args(args, with_d), seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_scan1d_segment_wrappers_raise_without_a_kernel():
    """The three launch wrappers take CUDA tensors only: no plain fallback."""
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    u, A, B = meta(1, 4, 8), meta(1, 8, 4), meta(1, 4, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        selective_scan_fwd_summaries(u, u, A, B)
    with pytest.raises(RuntimeError, match="no kernel"):
        selective_scan_fwd_combine(A, meta(1, 1, 8, 4), meta(1, 1, 8), 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        selective_scan_fwd_output(u, u, A, B, B, None, meta(1, 1, 8, 4))
    cpu = [torch.zeros(s) for s in ((1, 4, 8), (1, 4, 8), (1, 8, 4), (1, 4, 4))]
    with pytest.raises(RuntimeError, match="no kernel"):
        selective_scan_fwd_summaries(*cpu)
