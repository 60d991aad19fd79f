"""Fused 4-direction SS2D selective scan: CUDA kernels and plain versions.

Forward: `ss2d_scan` replaces the TPU kernel
`tamtr_tpu/kernels/selective_scan.py:_ss2d_kernel` (via `_run_ss2d_scan` and
`ss2d_scan`). On CUDA tensors it launches `csrc/ss2d_scan_fwd.cu`, a
segment-parallel scan: `ss2d_scan_fwd_summaries` (per-segment local end
states), `ss2d_scan_fwd_combine` (the pass across segments) and
`ss2d_scan_fwd_output` (each segment rebuilt from its entering state, y
written). On a CPU tensor it runs `ss2d_scan_ref`, the plain PyTorch version
of `ss2d_scan_xla` and `tamtr_tpu/nn/ssm.py:selective_scan_xla`.

Backward: `ss2d_scan` is a `torch.autograd.Function`. On CUDA tensors its
backward launches `csrc/ss2d_scan_bwd.cu`, a segment-parallel scan:
`ss2d_scan_carriers` (B3a, per-segment summaries) and `ss2d_scan_combine` (the
pass across segments) replace `_carriers_kernel`; `ss2d_scan_bwd_walk` (B3b,
each segment walked backwards) replaces `_bwd_kernel` (both via
`_run_ss2d_bwd_fwddir` and `_ss2d_bwd_pallas`). On CPU tensors it runs
`ss2d_scan_bwd_ref`, the explicit backward of `selective_scan.py:641-660`
written with torch ops.

One-direction scan: `selective_scan` replaces the TPU kernel
`_scan_kernel` (via `_run_scan` and `selective_scan_pallas`). On CUDA tensors
its forward launches `csrc/selective_scan_fwd.cu` (B6), the segment-parallel
scan of B1 with delta given: `selective_scan_fwd_summaries`,
`selective_scan_fwd_combine` and `selective_scan_fwd_output`, on the pieces
of `scan1d_pieces` where the shape needs them (the state padded to a
compiled size, N > 32 split, G and Din cut to the grid). On CPU tensors
it runs `selective_scan_ref`, the plain version of `selective_scan_xla`. Its
backward is `selective_scan_bwd_ref` on both devices: the JAX package has no
backward kernel for it either (its `_bwd` is the autodiff of the XLA oracle).

Contract of the fused scan (as `ss2d_scan_xla`): layouts (B, 2, L, D) [row-major, col-major];
dts_raw, Bs, Cs (B, 2, 2, L, R|N) indexed [fwd/rev, layout]; dt_w (4, D, R);
dt_b (4, D); A (4, D, N); Ds (4, D). Direction k = (row-fwd, col-fwd,
row-rev, col-rev) reads layout k % 2 and slice (k // 2, k % 2). Returns
y (B, 4, L, D) per direction in natural (unflipped) order.

Dtypes (`tamtr_tpu/kernels/selective_scan.py:455-489, 732, 882-896`): the
sequence I/O (layouts, dts_raw, Bs, Cs, y and dy) is float32 or bfloat16,
one dtype for all; dt_w, dt_b, A and Ds are float32. The maths and the
state are fp32 in every version, and y is rounded once to the sequence
dtype. Every gradient comes back in its primal's dtype: the kernels write
du in the sequence dtype and dz, dB, dC and dA in fp32, and the torch
assembly rounds d_dts, dBs and dCs once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tamtr_torch.kernels import _build, at_least_fp32

SCAN_CHUNK = 128
SEQ_DTYPES = (torch.float32, torch.bfloat16)  # the sequence I/O the B1 and B3 kernels take
SEG_CHANNELS = 32  # channels per block of the segment kernels, forward and backward (csrc kDB)
SEG_STEPS = 48  # steps per segment of the segment-parallel scans (csrc kSeg)
SS2D_STATES = 16  # the state size B1's and B3's kernels are compiled for (`ss2d_pieces` pads to it)
# the state sizes B6's kernels are compiled for, and the groups and channels
# one launch takes (the grid's y and z, 32 channels a block);
# `_selective_scan_cuda` cuts other shapes into such pieces
SCAN1D_STATES = (4, 8, 16, 32)
SCAN1D_MAX_G = 65535
SCAN1D_MAX_DIN = 65535 * 32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Overflow-free softplus, the same formula the kernels use."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def linear_scan(a: torch.Tensor, b: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Every state of x_s = a_s x_{s-1} + b_s along dim 1, from x_{-1} = seed.

    a, b (G, S, ...); seed (G, ...). A Hillis-Steele doubling scan composes
    the (a, b) pairs with torch ops.
    """
    step = 1
    while step < a.shape[1]:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], 1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], 1)
        step *= 2
    return a * seed[:, None] + b


def _chunk_ab(u, delta, A, Bs, s0, s1):
    """The recurrence's a = exp(dt A) and b = dt u B over steps [s0, s1)."""
    dt = delta[:, s0:s1]
    a = torch.exp(dt[..., None] * A[:, None])  # (G, S, D, N)
    b = (dt * u[:, s0:s1])[..., None] * Bs[:, s0:s1, None, :]
    return a, b


def selective_scan_ref(u, delta, A, Bs, Cs, D=None, chunk: int = SCAN_CHUNK, h0=None,
                       return_final: bool = False):
    """Plain S6 scan, the contract of `tamtr_tpu/nn/ssm.py:selective_scan_xla`:
    u, delta (G, L, Din); A (G, Din, N); Bs, Cs (G, L, N); D (G, Din) or None;
    h0 (G, Din, N) initial state or None (zeros) -> y (G, L, Din) = C.h + D.u,
    or (y, h_L) when `return_final`.

    Chunks of `chunk` steps carry h across chunks, so the working set is
    (G, chunk, Din, N) and the version runs on the card at full L; the result
    does not depend on the chunk size.
    """
    G, L, Din = u.shape
    h = h0 if h0 is not None else u.new_zeros((G, Din, A.shape[-1]))
    ys = []
    for s0 in range(0, L, chunk):
        a, b = _chunk_ab(u, delta, A, Bs, s0, s0 + chunk)
        h_t = linear_scan(a, b, h)
        ys.append(torch.einsum("gsdn,gsn->gsd", h_t, Cs[:, s0 : s0 + chunk]))
        h = h_t[:, -1]
    y = torch.cat(ys, 1)
    if D is not None:
        y = y + u * D[:, None, :]
    return (y, h) if return_final else y


def _direction_inputs(layouts, dts_raw, dt_w, dt_b, Bs, Cs, k):
    """Direction k's u, dt, B, C in walk order (flipped for k >= 2), at
    least fp32."""
    f, j = k // 2, k % 2
    u = at_least_fp32(layouts[:, j])
    dt = softplus(torch.einsum("blr,dr->bld", at_least_fp32(dts_raw[:, f, j]), dt_w[k]) + dt_b[k])
    Bk, Ck = at_least_fp32(Bs[:, f, j]), at_least_fp32(Cs[:, f, j])
    if f:
        u, dt, Bk, Ck = u.flip(1), dt.flip(1), Bk.flip(1), Ck.flip(1)
    return u, dt, Bk, Ck


def ss2d_scan_ref(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype=None, chunk: int = SCAN_CHUNK, h0=None):
    """Plain PyTorch version of the fused scan (see the module docstring):
    fp32 maths, y rounded once to `y_dtype` (layouts' dtype when None).
    `h0` (B, 4, D, N), the state entering each direction's walk, or None
    (zeros)."""
    ys = []
    for k in range(4):
        u, dt, Bk, Ck = _direction_inputs(layouts, dts_raw, dt_w, dt_b, Bs, Cs, k)
        y = selective_scan_ref(u, dt, A[k].expand(u.shape[0], *A[k].shape), Bk, Ck, chunk=chunk,
                               h0=None if h0 is None else h0[:, k])
        if k >= 2:
            y = y.flip(1)
        ys.append(y + at_least_fp32(layouts[:, k % 2]) * Ds[k])
    return torch.stack(ys, 1).to(y_dtype or layouts.dtype)


def _scan_bwd_one(u, dt, A, Bs, Cs, dy, chunk: int, h0=None, carry=None):
    """Backward of one direction's S6 scan in walk order.

    u, dt, dy (G, L, D); A (G, D, N); Bs, Cs (G, L, N). Returns du_core = gB dt,
    ddt (G, L, D), dB, dC (G, L, N) and dA (G, D, N), as the formulas of
    `tamtr_tpu/kernels/selective_scan.py:641-660`: two passes, the first
    storing the state entering each chunk, the second walking the chunks in
    reverse with g = dL/dh.

    A block of a longer walk (the sequence-parallel scan) gives `h0`
    (G, D, N), the state entering it, and `carry` (G, D, N), a g of the
    step after the block times that step's a: the gradients are then the
    whole walk's on the block's steps.
    """
    G, L, D = u.shape
    starts = list(range(0, L, chunk))
    h_in, h = [], u.new_zeros((G, D, A.shape[-1])) if h0 is None else h0
    for s0 in starts:
        h_in.append(h)
        h = linear_scan(*_chunk_ab(u, dt, A, Bs, s0, s0 + chunk), h)[:, -1]
    # g and a of the step after the chunk
    g_next = torch.zeros_like(h) if carry is None else carry
    a_next = torch.zeros_like(h) if carry is None else torch.ones_like(h)
    dA = torch.zeros_like(A)
    du, ddt, dB, dC = [], [], [], []
    for ci in reversed(range(len(starts))):
        s0, s1 = starts[ci], starts[ci] + chunk
        a, b = _chunk_ab(u, dt, A, Bs, s0, s1)
        hs = linear_scan(a, b, h_in[ci])
        h_prev = torch.cat([h_in[ci][:, None], hs[:, :-1]], 1)
        dyc, dtc, uc, Bc = dy[:, s0:s1], dt[:, s0:s1], u[:, s0:s1], Bs[:, s0:s1]
        q = dyc[..., None] * Cs[:, s0:s1, None, :]
        a_shift = torch.cat([a[:, 1:], a_next[:, None]], 1)  # a_{s+1}
        g = linear_scan(a_shift.flip(1), q.flip(1), g_next).flip(1)
        dC.append(torch.einsum("gsd,gsdn->gsn", dyc, hs))
        dB.append(torch.einsum("gsdn,gsd->gsn", g, dtc * uc))
        gB = torch.einsum("gsdn,gsn->gsd", g, Bc)
        ddA = g * h_prev * a
        ddt.append(gB * uc + (ddA * A[:, None]).sum(-1))
        du.append(gB * dtc)
        dA = dA + (ddA * dtc[..., None]).sum(1)
        g_next, a_next = g[:, 0], a[:, 0]
    cat = lambda xs: torch.cat(xs[::-1], 1)  # noqa: E731
    return cat(du), cat(ddt), cat(dB), cat(dC), dA


def _assemble_grads(layouts, dts_raw, dt_w, Ds, dy, du_core, dz, dBs, dCs, dA):
    """The eight input gradients from the per-direction kernel outputs:
    du_core (B, 4, L, D) natural order, in the sequence dtype; dz, the same,
    fp32; dBs, dCs (B, 2, 2, L, N) and dA (4, D, N) fp32. The D-skip and
    the dt projection's gradients are torch ops, as the JAX package keeps
    them outside Pallas (`selective_scan.py:879-896`); each gradient comes
    back in its primal's dtype: the sequence dtype (layouts') for the
    sequence tensors (the D-skip added in it, as JAX adds it), fp32 for the
    parameters."""
    seq_dtype = layouts.dtype
    B, _, L, D = layouts.shape
    R = dt_w.shape[-1]
    du = du_core + dy * Ds[None, :, None, :].to(seq_dtype)
    d_layouts = du[:, :2] + du[:, 2:]
    d_Ds = (at_least_fp32(dy).reshape(B, 2, 2, L, D) * at_least_fp32(layouts)[:, None]).sum((0, 3)).view(4, D)
    d_dts = torch.einsum("bkld,kdr->bklr", dz, dt_w).reshape(B, 2, 2, L, R).to(seq_dtype)
    d_dtw = torch.einsum("bkld,bklr->kdr", dz, at_least_fp32(dts_raw).reshape(B, 4, L, R))
    d_dtb = dz.sum((0, 2))
    return d_layouts, d_dts, d_dtw, d_dtb, dA, dBs.to(seq_dtype), dCs.to(seq_dtype), d_Ds


def leaving_carry(delta, A, Cs, dy, chunk: int = SCAN_CHUNK):
    """The carry leaving a walk backwards from a zero carry, with torch ops:
    r = sum_s (prod_{i<=s} a_i) C_s dy_s, a_i = exp(delta_i A), (G, D, N),
    for delta, dy (G, L, D), A (G, D, N), Cs (G, L, N) in walk order."""
    G, L, D = delta.shape
    r = delta.new_zeros((G, D, A.shape[-1]))
    before = delta.new_zeros((G, D))  # sum of delta over the chunks before
    for s0 in range(0, L, chunk):
        cum = before[:, None] + delta[:, s0:s0 + chunk].cumsum(1)
        r = r + torch.einsum("gsdn,gsd,gsn->gdn", torch.exp(cum[..., None] * A[:, None]),
                             dy[:, s0:s0 + chunk], Cs[:, s0:s0 + chunk])
        before = cum[:, -1]
    return r


def ss2d_scan_bwd_ref(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, dy, chunk: int = SCAN_CHUNK,
                      h0=None, carry=None):
    """Plain backward of the fused scan: the gradients of its eight inputs
    given dy (B, 4, L, D), written with torch ops in fp32, each returned in
    its primal's dtype as the kernels return it (du_core rounded to the
    sequence dtype before the D-skip). A block of the sequence-parallel
    scan gives `h0` and `carry` (B, 4, D, N) per direction
    (`_scan_bwd_one`)."""
    B, _, L, D = layouts.shape
    N = A.shape[-1]
    seq_dtype, dy32 = layouts.dtype, at_least_fp32(dy)
    du_core, dz = torch.empty_like(dy32), torch.empty_like(dy32)
    dBs, dCs = dy32.new_empty((B, 4, L, N)), dy32.new_empty((B, 4, L, N))
    dA = torch.empty_like(A)
    for k in range(4):
        u, dt, Bk, Ck = _direction_inputs(layouts, dts_raw, dt_w, dt_b, Bs, Cs, k)
        dyk = dy32[:, k].flip(1) if k >= 2 else dy32[:, k]
        outs = _scan_bwd_one(u, dt, A[k].expand(B, D, N), Bk, Ck, dyk, chunk,
                             h0=None if h0 is None else h0[:, k], carry=None if carry is None else carry[:, k])
        du, ddt, dBk, dCk = (t.flip(1) if k >= 2 else t for t in outs[:4])
        dt_nat = dt.flip(1) if k >= 2 else dt
        du_core[:, k], dz[:, k] = du, ddt * (1.0 - torch.exp(-dt_nat))
        dBs[:, k], dCs[:, k], dA[k] = dBk, dCk, outs[4].sum(0)
    return _assemble_grads(layouts, dts_raw, dt_w, Ds, dy.to(seq_dtype), du_core.to(seq_dtype), dz,
                           dBs.view(B, 2, 2, L, N), dCs.view(B, 2, 2, L, N), dA)


def _rows_in_place(t: torch.Tensor, B: int, L: int) -> torch.Tensor:
    """t (B, 2, 2, L, w) with unit inner stride and any row stride >= w, as the
    kernels read it; anything else is copied contiguous first."""
    rs = t.stride(3)
    if t.stride(4) == 1 and rs >= t.shape[4] and t.stride()[:3] == (4 * L * rs, 2 * L * rs, L * rs):
        return t
    return t.contiguous()


def _check_cuda(name, layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, d_mult: int):
    """Validate the kernels' inputs; return them in the layouts they read."""
    if layouts.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {layouts.device}")
    B, _, L, D = layouts.shape
    R, N = dt_w.shape[-1], A.shape[-1]
    args = (layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)
    if any(t.device != layouts.device for t in args):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if layouts.dtype not in SEQ_DTYPES or any(t.dtype != layouts.dtype for t in (dts_raw, Bs, Cs)) \
            or any(t.dtype != torch.float32 for t in (dt_w, dt_b, A, Ds)):
        raise TypeError(f"{name}: layouts, dts_raw, Bs and Cs must share one dtype of {SEQ_DTYPES}, "
                        "and dt_w, dt_b, A and Ds be float32")
    if tuple(layouts.shape) != (B, 2, L, D) or tuple(dts_raw.shape) != (B, 2, 2, L, R) \
            or tuple(Bs.shape) != (B, 2, 2, L, N) or tuple(Cs.shape) != (B, 2, 2, L, N) \
            or tuple(dt_w.shape) != (4, D, R) or tuple(A.shape) != (4, D, N) \
            or tuple(dt_b.shape) != (4, D) or tuple(Ds.shape) != (4, D):
        raise ValueError(f"{name}: inconsistent shapes")
    if N != SS2D_STATES or D % d_mult:
        raise ValueError(f"{name}: the kernel needs N == {SS2D_STATES} and D % {d_mult} == 0, got N={N} D={D}")
    dts_raw, Bs, Cs = (_rows_in_place(t, B, L) for t in (dts_raw, Bs, Cs))
    return (layouts.contiguous(), dts_raw, dt_w.contiguous(), dt_b.contiguous(), A.contiguous(),
            Bs, Cs, Ds.contiguous())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if its data is 16-byte aligned (the segment kernels read A
    four lanes at a time), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _new(device, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _is_bf16(t: torch.Tensor) -> int:
    """The kernels' flag for bf16 sequence I/O (0: float32)."""
    return int(t.dtype == torch.bfloat16)


def ss2d_scan_fwd_summaries(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs):
    """Kernel B1's first launch, the segment summaries: each direction's walk
    cut into S = ceil(L / SEG_STEPS) segments, and per segment and (d, n) the
    local end state from h = 0, h_loc (B, 4, S, D, 16), and the sum of dt,
    (B, 4, S, D). CUDA tensors only."""
    layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, _ = _check_cuda(
        "ss2d_scan_fwd_summaries", layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dt_b, SEG_CHANNELS)
    B, _, L, D = layouts.shape
    R, N = dt_w.shape[-1], A.shape[-1]
    A = _aligned(A)
    S = -(-L // SEG_STEPS)
    h_loc, sdt = _new(layouts.device, B, 4, S, D, N), _new(layouts.device, B, 4, S, D)
    rc = _lib("ss2d_scan_fwd").ss2d_scan_fwd_summaries(
        layouts.data_ptr(), dts_raw.data_ptr(), Bs.data_ptr(), dt_w.data_ptr(), dt_b.data_ptr(),
        A.data_ptr(), h_loc.data_ptr(), sdt.data_ptr(), B, L, D, R, N, _is_bf16(layouts), dts_raw.stride(3),
        Bs.stride(3), _stream(layouts),
    )
    _build.check(rc, "ss2d_scan_fwd_summaries")
    ss2d_scan_fwd_summaries.launches += 1
    return h_loc, sdt


def _check_summaries(name, A, h_loc, sdt, L):
    if A.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {A.device}")
    B, _, S, D, N = h_loc.shape
    ok = (S == -(-L // SEG_STEPS) and tuple(A.shape) == (4, D, N)
          and tuple(sdt.shape) == (B, 4, S, D)
          and all(t.is_contiguous() and t.dtype == torch.float32 and t.device == A.device for t in (A, h_loc, sdt)))
    if not ok:
        raise ValueError(f"{name}: A and the summaries as the summaries kernel gives them")


def _ends(name, like, seeds, dry: bool):
    """The optional seeds checked (each like `like` or None) and, for a dry
    run, new (leave, decay) tensors of `like`'s shape, for a combine launch."""
    for t in seeds:
        if t is not None and (tuple(t.shape) != tuple(like.shape) or not t.is_contiguous()
                              or t.dtype != torch.float32 or t.device != like.device):
            raise ValueError(f"{name}: a seed must be contiguous float32 {tuple(like.shape)} on {like.device}")
    return (_new(like.device, *like.shape), _new(like.device, *like.shape)) if dry else (None, None)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def ss2d_scan_fwd_combine(A, h_loc, sdt, L: int, seed=None, dry: bool = False):
    """Kernel B1's second launch, the pass across segments, in place on the
    summaries: h_loc becomes the state entering each segment,
    h_in[j+1] = E_j h_in[j] + h_loc[j] with E_j = exp(A sum dt_j). Returns h_in.

    For a block of the sequence-parallel scan: `seed` (B, 4, D, 16) is the
    state entering each direction's walk (h_in[0]; zeros when None).
    dry=True leaves the summaries as they are and returns the block's
    summary instead: the state leaving each walk and its decay
    exp(A sum dt), each (B, 4, D, 16)."""
    _check_summaries("ss2d_scan_fwd_combine", A, h_loc, sdt, L)
    B, _, S, D, N = h_loc.shape
    leave, decay = _ends("ss2d_scan_fwd_combine", h_loc[:, :, 0], (seed,), dry)
    rc = _lib("ss2d_scan_fwd").ss2d_scan_fwd_combine(
        A.data_ptr(), sdt.data_ptr(), h_loc.data_ptr(), _ptr(seed), _ptr(leave), _ptr(decay), B, L, D, N,
        int(not dry), _stream(A))
    _build.check(rc, "ss2d_scan_fwd_combine")
    ss2d_scan_fwd_combine.launches += 1
    return (leave, decay) if dry else h_loc


def ss2d_scan_fwd_output(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, h_in, y_dtype=None):
    """Kernel B1's third launch: every segment rebuilt from its entering
    state `h_in` (`ss2d_scan_fwd_combine`), y (B, 4, L, D) in natural order,
    in `y_dtype`: the sequence dtype (None) or float32. CUDA tensors only."""
    layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds = _check_cuda(
        "ss2d_scan_fwd_output", layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, SEG_CHANNELS)
    B, _, L, D = layouts.shape
    R, N = dt_w.shape[-1], A.shape[-1]
    A = _aligned(A)
    S = -(-L // SEG_STEPS)
    if tuple(h_in.shape) != (B, 4, S, D, N) or not h_in.is_contiguous() or h_in.device != layouts.device:
        raise ValueError("ss2d_scan_fwd_output: h_in as ss2d_scan_fwd_combine gives it")
    y_dtype = y_dtype or layouts.dtype
    if y_dtype not in (layouts.dtype, torch.float32):
        raise TypeError(f"ss2d_scan_fwd_output: y is written in {layouts.dtype} or float32, not {y_dtype}")
    y = _new(layouts.device, B, 4, L, D, dtype=y_dtype)
    rc = _lib("ss2d_scan_fwd").ss2d_scan_fwd_output(
        layouts.data_ptr(), dts_raw.data_ptr(), Bs.data_ptr(), Cs.data_ptr(), dt_w.data_ptr(),
        dt_b.data_ptr(), A.data_ptr(), Ds.data_ptr(), h_in.data_ptr(), y.data_ptr(), B, L, D, R, N,
        _is_bf16(layouts), int(y.dtype != layouts.dtype), dts_raw.stride(3), Bs.stride(3), Cs.stride(3),
        _stream(layouts),
    )
    _build.check(rc, "ss2d_scan_fwd_output")
    ss2d_scan_fwd_output.launches += 1
    return y


def _scan_fwd_cuda(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype=None):
    """Kernel B1: its three launches."""
    L = layouts.shape[2]
    h_loc, sdt = ss2d_scan_fwd_summaries(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs)
    h_in = ss2d_scan_fwd_combine(A.contiguous(), h_loc, sdt, L)
    y = ss2d_scan_fwd_output(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, h_in, y_dtype)
    ss2d_scan.launches += 1
    return y


def fwd_occupancy(R: int) -> dict:
    """Resident blocks per SM of the forward's three kernels at R."""
    return _occupancy("ss2d_scan_fwd", R, ("summaries", "combine", "output"))


def _check_dy(dy, layouts):
    B, _, L, D = layouts.shape
    if tuple(dy.shape) != (B, 4, L, D) or not dy.is_contiguous() or dy.dtype != layouts.dtype \
            or dy.device.type != "cuda":
        raise ValueError("ss2d_scan backward: dy must be contiguous (B, 4, L, D) on the card, in layouts' dtype")


def ss2d_scan_carriers(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy):
    """Kernel B3a, the segment summaries: each direction's walk cut into
    S = ceil(L / SEG_STEPS) segments, and per segment and (d, n) the local end
    state from h = 0, h_loc (B, 4, S, D, 16); r = sum_s (prod_{i<=s} a_i)
    C_s dy_s over the segment, r (B, 4, S, D, 16); and the sum of dt,
    (B, 4, S, D). CUDA tensors only, in the layouts `ss2d_scan_bwd` passes
    (the plain backward keeps its own per-chunk states)."""
    layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, _ = _check_cuda(
        "ss2d_scan_carriers", layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dt_b, SEG_CHANNELS)
    B, _, L, D = layouts.shape
    R, N = dt_w.shape[-1], A.shape[-1]
    _check_dy(dy, layouts)
    A = _aligned(A)
    S = -(-L // SEG_STEPS)
    h_loc, r = _new(layouts.device, B, 4, S, D, N), _new(layouts.device, B, 4, S, D, N)
    sdt = _new(layouts.device, B, 4, S, D)
    rc = _lib("ss2d_scan_bwd").ss2d_scan_bwd_summaries(
        layouts.data_ptr(), dts_raw.data_ptr(), Bs.data_ptr(), Cs.data_ptr(), dt_w.data_ptr(),
        dt_b.data_ptr(), A.data_ptr(), dy.data_ptr(), h_loc.data_ptr(), r.data_ptr(), sdt.data_ptr(),
        B, L, D, R, N, _is_bf16(layouts), dts_raw.stride(3), Bs.stride(3), Cs.stride(3), _stream(layouts),
    )
    _build.check(rc, "ss2d_scan_bwd_summaries")
    ss2d_scan_carriers.launches += 1
    return h_loc, r, sdt


def ss2d_scan_combine(A, h_loc, r, sdt, L: int, seed_h=None, seed_c=None, dry: bool = False):
    """The pass across segments, in place on B3a's summaries: h_loc becomes
    the state entering each segment (h_in[j+1] = E_j h_in[j] + h_loc[j],
    E_j = exp(A sum dt_j)), r the carry entering each segment's last step
    (c[j-1] = E_j c[j] + r[j], c[S-1] = 0). Returns (h_in, c).

    For a block of the sequence-parallel scan: `seed_h` (B, 4, D, 16) is
    h_in[0], the state entering each direction's walk, and `seed_c` the
    carry entering the walk's last step (c[S-1]); zeros when None.
    dry=True leaves the summaries as they are and returns the block's
    summary instead: the carry leaving each walk's first segment and the
    walk's decay exp(A sum dt), each (B, 4, D, 16)."""
    _check_summaries("ss2d_scan_combine", A, h_loc, sdt, L)
    if tuple(r.shape) != tuple(h_loc.shape) or not r.is_contiguous() or r.dtype != torch.float32:
        raise ValueError("ss2d_scan_combine: r as the summaries kernel gives it")
    B, _, S, D, N = h_loc.shape
    leave, decay = _ends("ss2d_scan_combine", h_loc[:, :, 0], (seed_h, seed_c), dry)
    rc = _lib("ss2d_scan_bwd").ss2d_scan_bwd_combine(
        A.data_ptr(), sdt.data_ptr(), h_loc.data_ptr(), r.data_ptr(), _ptr(seed_h), _ptr(seed_c), _ptr(leave),
        _ptr(decay), B, L, D, N, int(not dry), _stream(A))
    _build.check(rc, "ss2d_scan_bwd_combine")
    ss2d_scan_combine.launches += 1
    return (leave, decay) if dry else (h_loc, r)


def ss2d_scan_bwd_walk(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy, h_in, carry):
    """Kernel B3b: every segment walked backwards from its entering state
    `h_in` and carry `carry` (`ss2d_scan_combine`). Returns du_core
    (B, 4, L, D) natural order in the sequence dtype, dz the same in fp32;
    dB, dC partial sums (B, 4, D/32, L, 16) over
    each block's 32 channels; dA partial sums (B, 4, S, D, 16) per segment.
    CUDA tensors only, in the layouts `ss2d_scan_bwd` passes."""
    if layouts.device.type != "cuda":
        raise RuntimeError(f"ss2d_scan_bwd_walk: no kernel for device {layouts.device}")
    B, _, L, D = layouts.shape
    R, N = dt_w.shape[-1], A.shape[-1]
    _check_dy(dy, layouts)
    S = -(-L // SEG_STEPS)
    if tuple(h_in.shape) != (B, 4, S, D, N) or tuple(carry.shape) != (B, 4, S, D, N) or D % SEG_CHANNELS:
        raise ValueError("ss2d_scan_bwd_walk: h_in and carry as ss2d_scan_combine gives them")
    A = _aligned(A.contiguous())
    nDb = D // SEG_CHANNELS
    du, dz = _new(layouts.device, B, 4, L, D, dtype=layouts.dtype), _new(layouts.device, B, 4, L, D)
    dBp, dCp = _new(layouts.device, B, 4, nDb, L, N), _new(layouts.device, B, 4, nDb, L, N)
    dAp = _new(layouts.device, B, 4, S, D, N)
    rc = _lib("ss2d_scan_bwd").ss2d_scan_bwd_walk(
        layouts.data_ptr(), dts_raw.data_ptr(), Bs.data_ptr(), Cs.data_ptr(), dt_w.data_ptr(),
        dt_b.data_ptr(), A.data_ptr(), dy.data_ptr(), h_in.data_ptr(), carry.data_ptr(), du.data_ptr(),
        dz.data_ptr(), dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), B, L, D, R, N, _is_bf16(layouts),
        dts_raw.stride(3), Bs.stride(3), Cs.stride(3), _stream(layouts),
    )
    _build.check(rc, "ss2d_scan_bwd_walk")
    ss2d_scan_bwd_walk.launches += 1
    return du, dz, dBp, dCp, dAp


def _occupancy(source: str, size: int, names) -> dict:
    """Resident blocks per SM of the three kernels of `csrc/<source>.cu` at
    `size` (the dt rank R of the SS2D scans, the state size N of B6)."""
    out = (ctypes.c_int * 3)()
    fn = getattr(_lib(source), f"{source}_occupancy")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    _build.check(fn(size, ctypes.addressof(out)), f"{source}_occupancy")
    return dict(zip(names, out))


def bwd_occupancy(R: int) -> dict:
    """Resident blocks per SM of the backward's three kernels at R."""
    return _occupancy("ss2d_scan_bwd", R, ("summaries", "combine", "walk"))


def ss2d_scan_bwd(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, dy):
    """Gradients of the fused scan's eight inputs given dy (B, 4, L, D):
    kernels B3a, the combine and B3b with segments of `SEG_STEPS` steps for
    CUDA tensors, `ss2d_scan_bwd_ref` for CPU ones."""
    if layouts.device.type == "cpu":
        return ss2d_scan_bwd_ref(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, dy)
    args = _check_cuda("ss2d_scan_bwd", layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, SEG_CHANNELS)
    dy = dy.to(layouts.dtype).contiguous()
    return bwd_from_summaries(args, dy, ss2d_scan_carriers(*args[:7], dy))


def bwd_from_summaries(args, dy, summaries, seed_h=None, seed_c=None):
    """The eight gradients from B3a's `summaries` (h_loc, r, sum dt) of the
    checked `args` and dy: the combine, seeded with `seed_h` and `seed_c`
    for a block of the sequence-parallel scan, then B3b's walk, then the
    torch assembly. CUDA tensors only."""
    layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds = args
    B, _, L, D = layouts.shape
    N = A.shape[-1]
    h_in, carry = ss2d_scan_combine(A, *summaries[:2], summaries[2], L, seed_h=seed_h, seed_c=seed_c)
    du, dz, dBp, dCp, dAp = ss2d_scan_bwd_walk(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy, h_in, carry)
    return _assemble_grads(layouts, dts_raw, dt_w, Ds, dy, du, dz,
                           dBp.sum(2).view(B, 2, 2, L, N), dCp.sum(2).view(B, 2, 2, L, N),
                           dAp.sum((0, 2)))


@torch.library.custom_op("tamtr::ss2d_scan_fwd", mutates_args=(), device_types="cpu")
def ss2d_scan_fwd_op(layouts: torch.Tensor, dts_raw: torch.Tensor, dt_w: torch.Tensor, dt_b: torch.Tensor,
                     A: torch.Tensor, Bs: torch.Tensor, Cs: torch.Tensor, Ds: torch.Tensor,
                     y_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The fused scan's forward as a torch op, so that a program captured by
    `torch.export` holds it as one node and launches kernel B1 where it
    runs: the plain version on the CPU, `_scan_fwd_cuda` (the three
    launches, counted there) on the card, no kernel on another device."""
    return ss2d_scan_ref(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype)


@ss2d_scan_fwd_op.register_kernel("cuda")
def _(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype=None):
    return _scan_fwd_cuda(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype)


@ss2d_scan_fwd_op.register_fake
def _(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype=None):
    B, _, L, D = layouts.shape
    return layouts.new_empty((B, 4, L, D), dtype=y_dtype or layouts.dtype)


class _SS2DScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype=None):
        ctx.save_for_backward(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)
        return ss2d_scan_fwd_op(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds, y_dtype)

    @staticmethod
    def backward(ctx, dy):
        return (*ss2d_scan_bwd(*ctx.saved_tensors, dy), None)


def ss2d_pieces(scan, layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds):
    """y of the fused scan, `scan(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)`
    run on pieces that B1's and B3's kernels take (N == SS2D_STATES, D a
    multiple of SEG_CHANNELS): the state lanes in groups of 16, a short group
    padded with B = C = 0 and A = -1 (a padded lane stays 0 and adds nothing
    to y), the groups' outputs added, Ds in the first group only (zeros in
    the others); the channels padded with u = 0, dt_w = dt_b = 0, A = -1 and
    Ds = 0, and y cut back. Several groups of bf16 sequences each write y in
    fp32 (`scan`'s ninth argument, y's dtype), and their sum is rounded to
    bf16 once, as the unsplit scan rounds. Autograd sums the gradients of
    the inputs the groups share; those of A, Bs and Cs are the groups'
    slices, the padding dropped. One piece, without a copy, where the inputs
    fit."""
    D, N = A.shape[1], A.shape[2]
    if N == SS2D_STATES and D % SEG_CHANNELS == 0:
        return scan(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)
    pad = torch.nn.functional.pad
    pd = -D % SEG_CHANNELS
    if pd:
        layouts, dt_b, Ds = pad(layouts, (0, pd)), pad(dt_b, (0, pd)), pad(Ds, (0, pd))
        dt_w, A = pad(dt_w, (0, 0, 0, pd)), pad(A, (0, 0, 0, pd), value=-1.0)
    y_dtype = torch.float32 if N > SS2D_STATES and layouts.dtype == torch.bfloat16 else layouts.dtype
    y = None
    for n0 in range(0, N, SS2D_STATES):
        pn = SS2D_STATES - min(SS2D_STATES, N - n0)
        A_s, B_s, C_s = (t[..., n0:n0 + SS2D_STATES] for t in (A, Bs, Cs))
        if pn:
            A_s, B_s, C_s = pad(A_s, (0, pn), value=-1.0), pad(B_s, (0, pn)), pad(C_s, (0, pn))
        part = scan(layouts, dts_raw, dt_w, dt_b, A_s, B_s, C_s, Ds if n0 == 0 else torch.zeros_like(Ds), y_dtype)
        y = part if y is None else y + part
    y = y.to(layouts.dtype)
    return y[..., :D] if pd else y


def ss2d_scan(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds):
    """The fused scan: kernel B1 for CUDA tensors (at any N and D, on the
    pieces of `ss2d_pieces`), the plain version for CPU ones; differentiable
    through `ss2d_scan_bwd`."""
    if layouts.device.type == "cuda":
        return ss2d_pieces(_SS2DScan.apply, layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)
    if layouts.device.type != "cpu":
        raise RuntimeError(f"ss2d_scan: no kernel for device {layouts.device}")
    return _SS2DScan.apply(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)


def selective_scan_bwd_ref(u, delta, A, Bs, Cs, D, dy, chunk: int = SCAN_CHUNK, h0=None, carry=None):
    """Gradients (du, ddelta, dA, dBs, dCs, dD) of `selective_scan_ref`
    (from zero state, or `h0`) given dy, with torch ops; dD is None when D
    is. `h0` and `carry` (G, Din, N) as `_scan_bwd_one` takes them."""
    du, ddelta, dB, dC, dA = _scan_bwd_one(u, delta, A, Bs, Cs, dy, chunk, h0=h0, carry=carry)
    if D is None:
        return du, ddelta, dA, dB, dC, None
    return du + dy * D[:, None, :], ddelta, dA, dB, dC, (dy * u).sum(1)


def _check_scan1d(name, u, delta, A, Bs, Cs=None, D=None):
    """Validate B6's inputs (u, delta, Bs and Cs one dtype of `SEQ_DTYPES`,
    A and D fp32, one CUDA device); return them contiguous (Cs and D may be
    None)."""
    if u.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {u.device}")
    G, L, Din = u.shape
    N = A.shape[-1]
    args = [t for t in (u, delta, A, Bs, Cs, D) if t is not None]
    if any(t.device != u.device for t in args):
        raise ValueError(f"{name}: inputs on different devices")
    seq = [t for t in (u, delta, Bs, Cs) if t is not None]
    if u.dtype not in SEQ_DTYPES or any(t.dtype != u.dtype for t in seq) \
            or any(t.dtype != torch.float32 for t in (A, D) if t is not None):
        raise TypeError(f"{name}: u, delta, Bs and Cs must share one dtype of {SEQ_DTYPES}, A and D be float32")
    if tuple(delta.shape) != (G, L, Din) or tuple(A.shape) != (G, Din, N) \
            or tuple(Bs.shape) != (G, L, N) or (Cs is not None and tuple(Cs.shape) != (G, L, N)) \
            or (D is not None and tuple(D.shape) != (G, Din)):
        raise ValueError(f"{name}: inconsistent shapes")
    if N not in SCAN1D_STATES or G > SCAN1D_MAX_G or Din > SCAN1D_MAX_DIN:
        raise ValueError(f"{name}: a launch takes N in {SCAN1D_STATES}, G <= {SCAN1D_MAX_G} and Din <= "
                         f"{SCAN1D_MAX_DIN}, got N={N}, G={G}, Din={Din} (`selective_scan` cuts any shape)")
    return [t.contiguous() if t is not None else None for t in (u, delta, A, Bs, Cs, D)]


def selective_scan_fwd_summaries(u, delta, A, Bs):
    """Kernel B6's first launch, the segment summaries: the walk cut into
    S = ceil(L / SEG_STEPS) segments, and per segment and (g, d, n) the local
    end state from h = 0, h_loc (G, S, Din, N), and the sum of delta,
    (G, S, Din). CUDA tensors only."""
    u, delta, A, Bs, _, _ = _check_scan1d("selective_scan_fwd_summaries", u, delta, A, Bs)
    G, L, Din = u.shape
    N = A.shape[-1]
    S = -(-L // SEG_STEPS)
    h_loc, sdt = _new(u.device, G, S, Din, N), _new(u.device, G, S, Din)
    rc = _lib("selective_scan_fwd").selective_scan_fwd_summaries(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bs.data_ptr(), h_loc.data_ptr(), sdt.data_ptr(),
        G, L, Din, N, _is_bf16(u), _stream(u))
    _build.check(rc, "selective_scan_fwd_summaries")
    selective_scan_fwd_summaries.launches += 1
    return h_loc, sdt


def selective_scan_fwd_combine(A, h_loc, sdt, L: int, seed=None, dry: bool = False):
    """Kernel B6's second launch, the pass across segments, in place on the
    summaries: h_loc becomes the state entering each segment,
    h_in[j+1] = E_j h_in[j] + h_loc[j] with E_j = exp(A sum delta_j). Returns h_in.

    For a block of the sequence-parallel scan: `seed` (G, Din, N) is h_in[0]
    (zeros when None). dry=True leaves the summaries as they are and returns
    the block's summary instead: the state leaving the walk and its decay
    exp(A sum delta), each (G, Din, N)."""
    if A.device.type != "cuda":
        raise RuntimeError(f"selective_scan_fwd_combine: no kernel for device {A.device}")
    G, S, Din, N = h_loc.shape
    ok = (S == -(-L // SEG_STEPS) and tuple(A.shape) == (G, Din, N) and tuple(sdt.shape) == (G, S, Din)
          and all(t.is_contiguous() and t.dtype == torch.float32 and t.device == A.device for t in (A, h_loc, sdt)))
    if not ok:
        raise ValueError("selective_scan_fwd_combine: A and the summaries as the summaries kernel gives them")
    leave, decay = _ends("selective_scan_fwd_combine", A, (seed,), dry)
    rc = _lib("selective_scan_fwd").selective_scan_fwd_combine(
        A.data_ptr(), sdt.data_ptr(), h_loc.data_ptr(), _ptr(seed), _ptr(leave), _ptr(decay), G, L, Din, N,
        int(not dry), _stream(A))
    _build.check(rc, "selective_scan_fwd_combine")
    selective_scan_fwd_combine.launches += 1
    return (leave, decay) if dry else h_loc


def selective_scan_fwd_output(u, delta, A, Bs, Cs, D, h_in, y_dtype=None):
    """Kernel B6's third launch: every segment rebuilt from its entering
    state `h_in` (`selective_scan_fwd_combine`), y (G, L, Din) in `y_dtype`:
    u's dtype (None) or float32. CUDA tensors only; D may be None."""
    u, delta, A, Bs, Cs, D = _check_scan1d("selective_scan_fwd_output", u, delta, A, Bs, Cs, D)
    G, L, Din = u.shape
    N = A.shape[-1]
    if tuple(h_in.shape) != (G, -(-L // SEG_STEPS), Din, N) or not h_in.is_contiguous() \
            or h_in.device != u.device:
        raise ValueError("selective_scan_fwd_output: h_in as selective_scan_fwd_combine gives it")
    y_dtype = y_dtype or u.dtype
    if y_dtype not in (u.dtype, torch.float32):
        raise TypeError(f"selective_scan_fwd_output: y is written in {u.dtype} or float32, not {y_dtype}")
    y = torch.empty_like(u, dtype=y_dtype)
    rc = _lib("selective_scan_fwd").selective_scan_fwd_output(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bs.data_ptr(), Cs.data_ptr(),
        D.data_ptr() if D is not None else None, h_in.data_ptr(), y.data_ptr(), G, L, Din, N, _is_bf16(u),
        int(y.dtype != u.dtype), _stream(u))
    _build.check(rc, "selective_scan_fwd_output")
    selective_scan_fwd_output.launches += 1
    return y


def scan1d_pieces(scan, u, delta, A, Bs, Cs, D, max_g: int = SCAN1D_MAX_G, max_din: int = SCAN1D_MAX_DIN):
    """y of the one-direction scan, `scan(u, delta, A, Bs, Cs, D)` run on
    pieces that B6's kernels take: the state lanes in groups of at most 32,
    each padded with zeros up to a size in `SCAN1D_STATES` (B = C = 0 and
    A = -1: a padded lane stays 0 from h = 0 and adds nothing to y), the
    groups' outputs added in turn, D in the first group only; each group's
    scan cut into launches of at most `max_g` groups and `max_din` channels.
    Several groups of bf16 sequences each write y in fp32 (`scan`'s keyword
    y_dtype) and their sum is rounded to bf16 once, as the unsplit scan
    rounds. One piece, without a copy, where the inputs fit."""
    G, L, Din = u.shape
    N = A.shape[-1]
    f32 = {"y_dtype": torch.float32} if N > 32 and u.dtype == torch.bfloat16 else {}
    y = None
    for n0 in range(0, N, 32):
        n1 = min(n0 + 32, N)
        pad = next(k for k in SCAN1D_STATES if k >= n1 - n0) - (n1 - n0)
        A_s, B_s, C_s = (t[..., n0:n1] for t in (A, Bs, Cs))
        if pad:
            A_s = torch.nn.functional.pad(A_s, (0, pad), value=-1.0)
            B_s, C_s = (torch.nn.functional.pad(t, (0, pad)) for t in (B_s, C_s))
        D_s = D if n0 == 0 else None
        blocks = []
        for g0 in range(0, G, max_g):
            g = slice(g0, g0 + max_g)
            cols = [scan(u[g, :, d0:d0 + max_din], delta[g, :, d0:d0 + max_din], A_s[g, d0:d0 + max_din], B_s[g],
                         C_s[g], None if D_s is None else D_s[g, d0:d0 + max_din], **f32)
                    for d0 in range(0, Din, max_din)]
            blocks.append(cols[0] if len(cols) == 1 else torch.cat(cols, 2))
        part = blocks[0] if len(blocks) == 1 else torch.cat(blocks, 0)
        y = part if y is None else y + part
    return y.to(u.dtype)


def _scan1d_launches(u, delta, A, Bs, Cs, D, y_dtype=None):
    """Kernel B6's three launches on one piece that they take."""
    h_loc, sdt = selective_scan_fwd_summaries(u, delta, A, Bs)
    h_in = selective_scan_fwd_combine(A.contiguous(), h_loc, sdt, u.shape[1])
    return selective_scan_fwd_output(u, delta, A, Bs, Cs, D, h_in, y_dtype)


def _selective_scan_cuda(u, delta, A, Bs, Cs, D):
    """Kernel B6 on inputs of any shape (u, delta, Bs, Cs one dtype of
    `SEQ_DTYPES`, A and D fp32): its three launches on each piece of
    `scan1d_pieces` (one piece at N in `SCAN1D_STATES`, G and Din within the
    grid)."""
    y = scan1d_pieces(_scan1d_launches, u, delta, A, Bs, Cs, D)
    selective_scan.launches += 1
    return y


def scan1d_occupancy(N: int) -> dict:
    """Resident blocks per SM of B6's three kernels at state size N."""
    return _occupancy("selective_scan_fwd", N, ("summaries", "combine", "output"))


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, A, Bs, Cs, D, chunk):
        ctx.save_for_backward(u, delta, A, Bs, Cs, D)
        ctx.chunk = chunk
        f32 = [t.float() if t is not None else None for t in (u, delta, A, Bs, Cs, D)]
        if u.device.type == "cpu":
            y = selective_scan_ref(*f32, chunk=chunk)
        elif all(t.dtype == torch.bfloat16 for t in (u, delta, Bs, Cs)):  # B6 reads bf16 as it comes
            y = _selective_scan_cuda(u, delta, f32[2], Bs, Cs, f32[5])
        else:
            y = _selective_scan_cuda(*f32)
        return y.to(u.dtype)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        f32 = [t.float() if t is not None else None for t in saved]
        grads = selective_scan_bwd_ref(*f32, dy.float(), chunk=ctx.chunk)
        return (*(g.to(t.dtype) if g is not None else None for g, t in zip(grads, saved)), None)


def selective_scan(u, delta, A, Bs, Cs, D=None, chunk: int = SCAN_CHUNK):
    """The one-direction S6 scan, the contract of `selective_scan_pallas`:
    u, delta (G, L, Din); A (G, Din, N); Bs, Cs (G, L, N); D (G, Din) or
    None -> y (G, L, Din) = C.h + D.u in u's dtype, from zero state. The
    maths and the state are fp32: B6 reads u, delta, Bs and Cs in bf16 when
    all four are bf16, and other inputs are upcast. Kernel B6 for
    CUDA tensors, `selective_scan_ref` for CPU ones; differentiable in every
    input through `selective_scan_bwd_ref`, cotangents in each input's
    dtype. `chunk` sets the plain versions' working set, not the result."""
    if u.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"selective_scan: no kernel for device {u.device}")
    return _SelectiveScan.apply(u, delta, A, Bs, Cs, D, chunk)


# kernel launches since the last reset, one counter per kernel
ss2d_scan.launches = 0  # one per call: the forward's three launches count below
ss2d_scan_fwd_summaries.launches = 0
ss2d_scan_fwd_combine.launches = 0
ss2d_scan_fwd_output.launches = 0
ss2d_scan_carriers.launches = 0
ss2d_scan_combine.launches = 0
ss2d_scan_bwd_walk.launches = 0
selective_scan.launches = 0  # one per call: its three launches count below
selective_scan_fwd_summaries.launches = 0
selective_scan_fwd_combine.launches = 0
selective_scan_fwd_output.launches = 0

_SIGNATURES = {
    "selective_scan_fwd_summaries": (6, 5, 0),
    "selective_scan_fwd_combine": (6, 5, 0),
    "selective_scan_fwd_output": (8, 6, 0),
    "ss2d_scan_fwd_summaries": (8, 6, 2),
    "ss2d_scan_fwd_combine": (6, 5, 0),
    "ss2d_scan_fwd_output": (10, 7, 3),
    "ss2d_scan_bwd_summaries": (11, 6, 3),
    "ss2d_scan_bwd_combine": (8, 5, 0),
    "ss2d_scan_bwd_walk": (15, 6, 3),
}


def _lib(source: str) -> ctypes.CDLL:
    """The library built from `csrc/<source>.cu`, its entry points typed:
    pointers, then ints, then row strides (long long), then the stream."""
    lib = _build.load(source)
    for fn_name, (n_ptr, n_int, n_ll) in _SIGNATURES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None and fn.argtypes is None:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [p] * n_ptr + [i] * n_int + [ll] * n_ll + [p]
            fn.restype = ctypes.c_int
    return lib
