"""The fused SS2D scan at any state size and width (`ss2d_pieces`) on the
CPU: the pieces B1's and B3's kernels take (N = 16 state lanes, channels a
multiple of 32), with the plain scan injected where the card runs the
kernels, against the plain scan on the whole input, forward (1e-4) and
backward (2e-3); and against the JAX package's XLA scan
(`tamtr_tpu/kernels/selective_scan.py:ss2d_scan_xla`) at a width and state
size the kernels do not take."""

import math

import numpy as np
import pytest
import torch

from tamtr_torch.kernels.selective_scan import _SS2DScan, ss2d_pieces, ss2d_scan


def scan_args(N: int, D: int, B: int = 1, L: int = 30, seed: int = 0):
    """The eight inputs of the fused scan from a numpy seed, as float64
    arrays: layouts (B, 2, L, D), dts_raw, Bs, Cs (B, 2, 2, L, R|N), dt_w
    (4, D, R), dt_b (4, D), A (4, D, N) < 0, Ds (4, D)."""
    rng = np.random.default_rng(seed)
    R = math.ceil(D / 32)
    return [rng.standard_normal((B, 2, L, D)), rng.standard_normal((B, 2, 2, L, R)) * 0.6,
            rng.uniform(-1, 1, (4, D, R)) * R ** -0.5, rng.uniform(-4, -2, (4, D)),
            -np.exp(rng.uniform(0, 1.5, (4, D, N))), rng.standard_normal((B, 2, 2, L, N)) * 0.6,
            rng.standard_normal((B, 2, 2, L, N)) * 0.6, rng.standard_normal((4, D))]


def _grads(fn, args, w):
    ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in args]
    y = fn(*ts)
    (y * w).sum().backward()
    return y.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("N", [1, 12, 16, 24, 48])
@pytest.mark.parametrize("D", [40, 64, 96])
def test_ss2d_pieces_match_the_plain_scan(N, D):
    """Forward within 1e-4 and all eight gradients within 2e-3 of the plain
    scan on the whole input; every piece has 16 state lanes and a multiple
    of 32 channels, one piece per group of 16 lanes."""
    args = scan_args(N, D, seed=N * D)
    pieces = []

    def scan(*t):
        pieces.append((t[4].shape[-1], t[0].shape[-1]))
        return _SS2DScan.apply(*t)

    w = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 4, 30, D))).float()
    got, got_g = _grads(lambda *t: ss2d_pieces(scan, *t), args, w)
    want, want_g = _grads(_SS2DScan.apply, args, w)
    assert got.shape == want.shape == (1, 4, 30, D)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for name, g, h in zip(("layouts", "dts_raw", "dt_w", "dt_b", "A", "Bs", "Cs", "Ds"), got_g, want_g):
        torch.testing.assert_close(g, h, atol=2e-3, rtol=2e-3, msg=name)
    assert len(pieces) == -(-N // 16)
    assert all(n == 16 and d % 32 == 0 for n, d in pieces)


def test_ss2d_scan_at_any_shape_matches_jax():
    """`ss2d_scan` on the CPU at N = 24, D = 40 (the plain scan), and the
    same scan on the kernels' pieces, equal the JAX package's XLA scan at
    1e-4."""
    import jax.numpy as jnp

    from tamtr_tpu.kernels.selective_scan import ss2d_scan_xla

    args = [a.astype(np.float32) for a in scan_args(24, 40, B=2, seed=7)]
    want = np.asarray(ss2d_scan_xla(*(jnp.asarray(a) for a in args)))
    ts = [torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(ss2d_scan(*ts).numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ss2d_pieces(_SS2DScan.apply, *ts).numpy(), want, atol=1e-4, rtol=1e-4)
