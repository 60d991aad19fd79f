"""The port's sequence-parallel scans (`tamtr_torch/parallel/seq_scan.py`)
against the JAX package's (`tamtr_tpu/parallel/seq_scan.py`) on the
conftest's 8-device CPU mesh, at JAX's own bounds: 2e-4 forward, 5e-3 for
the SS2D scan's gradients (`tests/test_dp_sp_compose.py`) and 2e-4 for the
one-direction scan's (`tests/test_seq_parallel.py`). The port runs its n
blocks in this process (`LocalBlocks`: the exchange a stack of a list) on
the plain versions, seeded as the card's kernels are. The same inputs, from
numpy seeds, go to both. The process-group exchange (`GroupBlocks`) is run
by `tests/test_torch_parallel.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_tpu.parallel.mesh import DATA_AXIS, make_mesh
from tamtr_tpu.parallel.seq_scan import selective_scan_sp as jax_selective_scan_sp
from tamtr_tpu.parallel.seq_scan import ss2d_scan_sp as jax_ss2d_scan_sp
from tamtr_torch.kernels.selective_scan import (
    selective_scan, selective_scan_fwd_combine, ss2d_scan, ss2d_scan_combine, ss2d_scan_fwd_combine,
)
from tamtr_torch.parallel.seq_scan import LocalBlocks, selective_scan_sp, ss2d_scan_sp


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ss2d_inputs(seed, B=2, L=64, D=8, N=4, R=3):
    """`tests/test_dp_sp_compose.py`'s inputs, and a weight for the loss."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = [f(B, 2, L, D), f(B, 2, 2, L, R), f(4, D, R) * 0.1, f(4, D) * 0.1,
            -np.exp(f(4, D, N) * 0.3), f(B, 2, 2, L, N), f(B, 2, 2, L, N), f(4, D)]
    return args, f(B, 4, L, D)


def torch_grads(fn, args, w):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = fn(*ts)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ts)
    return y.detach().numpy(), [g.numpy() for g in grads]


def jax_grads(fn, args, w):
    js = [jnp.asarray(a) for a in args]
    y = fn(*js)
    grads = jax.grad(lambda *a: (fn(*a) * jnp.asarray(w)).sum(), argnums=tuple(range(len(js))))(*js)
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n,L", [(2, 64), (4, 64), (2, 74)], ids=["n2", "n4", "n2-uneven-chunk"])
def test_ss2d_scan_sp_equals_jax(n, L):
    """Forward and the gradients of all eight inputs, at n blocks; L = 74
    makes blocks of 37 tokens, not a multiple of JAX's 16-step chunk."""
    args, w = ss2d_inputs(n + L, L=L)
    mesh = make_mesh(n, sp=n)
    want_y, want_g = jax_grads(
        jax.jit(lambda *a: jax_ss2d_scan_sp(*a, mesh, axis="sp", chunk=16)), args, w)
    got_y, got_g = torch_grads(lambda *a: ss2d_scan_sp(*a, LocalBlocks(n)), args, w)
    np.testing.assert_allclose(got_y, want_y, rtol=2e-4, atol=2e-4)
    for name, g, h in zip(("layouts", "dts_raw", "dt_w", "dt_b", "A", "Bs", "Cs", "Ds"), got_g, want_g):
        np.testing.assert_allclose(g, h, rtol=5e-3, atol=5e-3, err_msg=name)


def test_ss2d_scan_sp_equals_the_unsplit_scan():
    """Against the port's own unsplit scan and its backward, tighter: the
    blocked algebra reorders sums only."""
    args, w = ss2d_inputs(5, L=48)
    want_y, want_g = torch_grads(ss2d_scan, args, w)
    for n in (2, 3, 4):
        got_y, got_g = torch_grads(lambda *a: ss2d_scan_sp(*a, LocalBlocks(n)), args, w)
        np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
        for g, h in zip(got_g, want_g):
            np.testing.assert_allclose(g, h, rtol=1e-4, atol=1e-4)


def scan1d_inputs(seed, G, L, Din, N, with_d=True):
    """`tests/test_seq_parallel.py`'s inputs."""
    rng = np.random.default_rng(seed)
    args = [rng.standard_normal((G, L, Din)).astype(np.float32),
            (np.abs(rng.standard_normal((G, L, Din))) * 0.1).astype(np.float32),
            (-np.abs(rng.standard_normal((G, Din, N)))).astype(np.float32),
            rng.standard_normal((G, L, N)).astype(np.float32),
            rng.standard_normal((G, L, N)).astype(np.float32)]
    if with_d:
        args.append(rng.standard_normal((G, Din)).astype(np.float32))
    return args, rng.standard_normal((G, L, Din)).astype(np.float32)


@pytest.mark.parametrize("n,L,with_d", [(2, 128, True), (4, 128, True), (8, 8 * 37, False)],
                         ids=["n2", "n4", "n8-no-d-uneven-chunk"])
def test_selective_scan_sp_equals_jax(n, L, with_d):
    """Forward and the gradients of every input at n blocks; 37 tokens a
    block against JAX's 16-step chunk in the last case, without D."""
    args, w = scan1d_inputs(n, 2, L, 8, 4, with_d)
    mesh = make_mesh(n)

    def jfn(*a):
        return jax_selective_scan_sp(*a, *([] if with_d else [None]), mesh=mesh, axis=DATA_AXIS, chunk=16)

    want_y, want_g = jax_grads(jax.jit(jfn), args, w)
    got_y, got_g = torch_grads(
        lambda *a: selective_scan_sp(*a, *([] if with_d else [None]), LocalBlocks(n), chunk=16), args, w)
    np.testing.assert_allclose(got_y, want_y, rtol=2e-4, atol=2e-4)
    for g, h in zip(got_g, want_g):
        np.testing.assert_allclose(g, h, rtol=2e-4, atol=2e-4)


def test_selective_scan_sp_equals_the_unsplit_scan():
    args, w = scan1d_inputs(3, 3, 96, 5, 4)
    want_y, want_g = torch_grads(selective_scan, args, w)
    for n in (2, 3, 4):
        got_y, got_g = torch_grads(lambda *a: selective_scan_sp(*a, LocalBlocks(n)), args, w)
        np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
        for g, h in zip(got_g, want_g):
            np.testing.assert_allclose(g, h, rtol=1e-4, atol=1e-4)


def test_the_token_axis_must_divide():
    args, _ = ss2d_inputs(0, L=30)
    with pytest.raises(ValueError, match="must divide over 4 blocks"):
        ss2d_scan_sp(*[torch.from_numpy(a) for a in args], LocalBlocks(4))
    args, _ = scan1d_inputs(0, 1, 30, 4, 4)
    with pytest.raises(ValueError, match="must divide over 4 blocks"):
        selective_scan_sp(*[torch.from_numpy(a) for a in args], LocalBlocks(4))


def test_sequence_parallel_routes_the_model_scans():
    """Inside `sequence_parallel` the nano model's SS2D scans run blocked
    where the token axis divides (the 64 px levels: 256, 64 and 16 tokens
    over 4 blocks), and the eval forward is the unsplit one's."""
    from tamtr_torch.kernels import selective_scan as ks
    from tamtr_torch.nn import ssm
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=3).eval()
    init_parameters(model, 0)
    g = torch.Generator().manual_seed(0)
    img, txt = torch.rand(1, 64, 64, 3, generator=g), torch.randn(1, 3, 128, generator=g)
    calls = []
    real = ssm.ss2d_scan_sp
    ssm.ss2d_scan_sp = lambda *a: calls.append(a[0].shape[2]) or real(*a)
    try:
        with torch.no_grad():
            want = model(img, txt)["pred"]
            with ssm.sequence_parallel(LocalBlocks(4)):
                got = model(img, txt)["pred"]
            with ssm.sequence_parallel(LocalBlocks(3)):  # no level divides by 3: all local
                local = model(img, txt)["pred"]
    finally:
        ssm.ss2d_scan_sp = real
    assert calls == [256, 64, 16]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(local, want)
    assert ks.ss2d_scan.launches == 0  # the plain versions on the CPU


def test_seeded_combine_wrappers_raise_without_a_kernel():
    """The combines' seeded and dry forms are CUDA only, as the plain ones;
    a seed of the wrong shape is refused before any launch."""
    meta = torch.empty((1, 4, 2, 32, 16), device="meta")
    sdt = torch.empty((1, 4, 2, 32), device="meta")
    A = torch.empty((4, 32, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_fwd_combine(A, meta, sdt, 96, seed=torch.empty((1, 4, 32, 16), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_combine(A, meta, meta, sdt, 96, dry=True)
    with pytest.raises(RuntimeError, match="no kernel"):
        selective_scan_fwd_combine(torch.empty((1, 8, 4), device="meta"), torch.empty((1, 1, 8, 4), device="meta"),
                                   torch.empty((1, 1, 8), device="meta"), 4, dry=True)
