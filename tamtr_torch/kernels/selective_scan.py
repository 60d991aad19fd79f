"""Fused 4-direction SS2D selective scan, forward: CUDA kernel and plain version.

`ss2d_scan` replaces the TPU kernel
`tamtr_tpu/kernels/selective_scan.py:_ss2d_kernel` (via `_run_ss2d_scan` and
`ss2d_scan`). On a CUDA tensor it launches `csrc/ss2d_scan_fwd.cu`; on a CPU
tensor it runs `ss2d_scan_ref`, the plain PyTorch version of
`ss2d_scan_xla` and `tamtr_tpu/nn/ssm.py:selective_scan_xla`.

Contract (as `ss2d_scan_xla`): layouts (B, 2, L, D) [row-major, col-major];
dts_raw, Bs, Cs (B, 2, 2, L, R|N) indexed [fwd/rev, layout]; dt_w (4, D, R);
dt_b (4, D); A (4, D, N); Ds (4, D). Direction k = (row-fwd, col-fwd,
row-rev, col-rev) reads layout k % 2 and slice (k // 2, k % 2). Returns
y (B, 4, L, D) per direction in natural (unflipped) order. fp32 throughout.
"""

from __future__ import annotations

import ctypes

import torch

from tamtr_torch.kernels import _build

SCAN_CHUNK = 128


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Overflow-free softplus, the same formula the kernel uses."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def selective_scan_ref(u, delta, A, Bs, Cs, chunk: int = SCAN_CHUNK):
    """Plain S6 scan: u, delta (G, L, D); A (G, D, N); Bs, Cs (G, L, N) -> y (G, L, D).

    Chunks of `chunk` steps carry h across chunks; inside a chunk a
    Hillis-Steele doubling scan composes (a, b) pairs with torch ops, so the
    working set is (G, chunk, D, N) and the version runs on the card at full L.
    """
    G, L, D = u.shape
    h = u.new_zeros((G, D, A.shape[-1]))
    ys = []
    for s0 in range(0, L, chunk):
        dt = delta[:, s0 : s0 + chunk]
        a = torch.exp(dt[..., None] * A[:, None])  # (G, S, D, N)
        b = (dt * u[:, s0 : s0 + chunk])[..., None] * Bs[:, s0 : s0 + chunk, None, :]
        step = 1
        while step < a.shape[1]:
            a_prev, b_prev = a[:, :-step], b[:, :-step]
            b = torch.cat([b[:, :step], a[:, step:] * b_prev + b[:, step:]], 1)
            a = torch.cat([a[:, :step], a[:, step:] * a_prev], 1)
            step *= 2
        h_t = a * h[:, None] + b
        ys.append(torch.einsum("gsdn,gsn->gsd", h_t, Cs[:, s0 : s0 + chunk]))
        h = h_t[:, -1]
    return torch.cat(ys, 1)


def ss2d_scan_ref(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, chunk: int = SCAN_CHUNK):
    """Plain PyTorch version of the fused scan (see the module docstring)."""
    ys = []
    for k in range(4):
        f, j = k // 2, k % 2
        lay = layouts[:, j]
        dt = softplus(torch.einsum("blr,dr->bld", dts_raw[:, f, j], dt_w[k]) + dt_b[k])
        u, Bk, Ck = lay, Bs[:, f, j], Cs[:, f, j]
        if f:
            u, dt, Bk, Ck = u.flip(1), dt.flip(1), Bk.flip(1), Ck.flip(1)
        Ak = A[k].expand(u.shape[0], *A[k].shape)
        y = selective_scan_ref(u, dt, Ak, Bk, Ck, chunk)
        if f:
            y = y.flip(1)
        ys.append(y + lay * Ds[k])
    return torch.stack(ys, 1)


def _rows_in_place(t: torch.Tensor, B: int, L: int) -> torch.Tensor:
    """t (B, 2, 2, L, w) with unit inner stride and any row stride >= w, as the
    kernel reads it; anything else is copied contiguous first."""
    rs = t.stride(3)
    if t.stride(4) == 1 and rs >= t.shape[4] and t.stride()[:3] == (4 * L * rs, 2 * L * rs, L * rs):
        return t
    return t.contiguous()


def ss2d_scan(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds):
    """The fused scan: CUDA kernel for CUDA tensors, plain version for CPU ones."""
    if layouts.device.type == "cpu":
        return ss2d_scan_ref(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)
    if layouts.device.type != "cuda":
        raise RuntimeError(f"ss2d_scan: no kernel for device {layouts.device}")
    B, _, L, D = layouts.shape
    R, N = dt_w.shape[-1], A.shape[-1]
    args = (layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)
    if any(t.dtype != torch.float32 or t.device != layouts.device for t in args):
        raise TypeError("ss2d_scan: all inputs must be float32 on one CUDA device")
    if tuple(layouts.shape) != (B, 2, L, D) or tuple(dts_raw.shape) != (B, 2, 2, L, R) \
            or tuple(Bs.shape) != (B, 2, 2, L, N) or tuple(Cs.shape) != (B, 2, 2, L, N) \
            or tuple(dt_w.shape) != (4, D, R) or tuple(A.shape) != (4, D, N) \
            or tuple(dt_b.shape) != (4, D) or tuple(Ds.shape) != (4, D):
        raise ValueError("ss2d_scan: inconsistent shapes")
    if N != 16 or D % 8:
        raise ValueError(f"ss2d_scan: the kernel needs N == 16 and D % 8 == 0, got N={N} D={D}")
    layouts = layouts.contiguous()
    dts_raw, Bs, Cs = (_rows_in_place(t, B, L) for t in (dts_raw, Bs, Cs))
    dt_w, dt_b, A, Ds = (t.contiguous() for t in (dt_w, dt_b, A, Ds))
    y = torch.empty((B, 4, L, D), dtype=torch.float32, device=layouts.device)
    lib = _lib()
    rc = lib.ss2d_scan_fwd(
        layouts.data_ptr(), dts_raw.data_ptr(), Bs.data_ptr(), Cs.data_ptr(),
        dt_w.data_ptr(), dt_b.data_ptr(), A.data_ptr(), Ds.data_ptr(), y.data_ptr(),
        B, L, D, R, N, dts_raw.stride(3), Bs.stride(3), Cs.stride(3),
        torch.cuda.current_stream(layouts.device).cuda_stream,
    )
    _build.check(rc, "ss2d_scan_fwd")
    ss2d_scan.launches += 1
    return y


ss2d_scan.launches = 0  # kernel launches since the last reset


def _lib() -> ctypes.CDLL:
    lib = _build.load("ss2d_scan_fwd")
    fn = lib.ss2d_scan_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 9 + [i] * 5 + [ll] * 3 + [p]
        fn.restype = ctypes.c_int
    return lib
