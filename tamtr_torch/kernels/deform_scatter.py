"""Deformable-attention bilinear pair gather: CUDA kernels and plain versions.

Forward: `bilinear_gather` replaces the TPU kernel
`tamtr_tpu/kernels/deform_scatter.py:_gather_pairs_kernel` (via
`_gather_acc_pairs` and `bilinear_gather`). On a CUDA tensor it launches
`csrc/bilinear_gather_fwd.cu`, which reads the pair starts `idx2`; on a CPU
tensor it runs `bilinear_gather_ref`, the plain 4-corner gather of
`_gather_fwd_impl`, which reads the corner indices `idx4`.

Backward: `bilinear_gather` is a `torch.autograd.Function` whose backward is
`bilinear_gather_bwd`, replacing `_scatter_dw_pairs_kernel` (via
`_scatter_dw_acc_pairs` and `_bilinear_bwd`): `csrc/bilinear_gather_bwd.cu`
on CUDA tensors, `bilinear_gather_bwd_ref` on CPU ones. Both apply the
last-row shift of the forward and swap dw back for shifted pairs, so
gradients reach the value and the weights of the pair the caller gave.

Arguments, as in the JAX package:
  value (B, Lv, nh, c) multi-level features; idx4 (B, Q*P*4, nh) clipped flat
  corner rows; w_pairs (B, Q*P*2, nh, 2) corner weights times attention
  weight, one pair per bilinear row, pre-swapped by the caller when x0 < 0;
  idx2 (B, Q*P*2, nh) pair starts (rows idx2 and idx2 + 1); P = levels x
  points per query and head. Returns (B, Q, nh, c). Gradients flow to value
  and w_pairs; the indices get none.
"""

from __future__ import annotations

import ctypes

import torch

from tamtr_torch.kernels import _build


def _shift_last_row(idx2: torch.Tensor, w_pairs: torch.Tensor, Lv: int):
    """A pair starting on the global last row moves up one row with its
    weights swapped, so its second row stays inside value (the kernels apply
    the same rule themselves). Also returns which pairs moved."""
    at_end = idx2 >= Lv - 1
    return (torch.where(at_end, Lv - 2, idx2), torch.where(at_end[..., None], w_pairs.flip(-1), w_pairs),
            at_end)


def bilinear_gather_ref(value, idx4, w_pairs, idx2, P: int) -> torch.Tensor:
    """Plain version: gather the 4 corners of every sample point and weight them."""
    B, Lv, nh, c = value.shape
    _, w_pairs, _ = _shift_last_row(idx2, w_pairs, Lv)
    nU = idx4.shape[1]
    w4 = w_pairs.transpose(2, 3).reshape(B, nU, nh)  # (B, nU2, 2, nh) -> corners
    g = torch.gather(value, 1, idx4.long()[..., None].expand(B, nU, nh, c))
    g = g.view(B, nU // (P * 4), P * 4, nh, c)
    return torch.einsum("bqpnc,bqpn->bqnc", g, w4.view(B, nU // (P * 4), P * 4, nh))


def bilinear_gather_bwd_ref(value, idx2, w_pairs, dout):
    """Plain backward in the pair form the kernel uses: dvalue gets
    (wa, wb) x dout at rows (idx2, idx2 + 1), dw the two row . dout dots.

    value (B, Lv, nh, c); idx2 (B, nU2, nh); w_pairs (B, nU2, nh, 2);
    dout (B, Q, nh, c) -> dvalue (B, Lv, nh, c), dw (B, nU2, nh, 2).
    """
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    i0, w, at_end = _shift_last_row(idx2, w_pairs, Lv)
    d = dout.repeat_interleave(nU2 // dout.shape[1], 1)  # pair u belongs to query u // ppq
    idx = i0.long()[..., None].expand(B, nU2, nh, c)
    dw = torch.stack([(value.gather(1, idx) * d).sum(-1), (value.gather(1, idx + 1) * d).sum(-1)], -1)
    dw = torch.where(at_end[..., None], dw.flip(-1), dw)
    dvalue = torch.zeros_like(value)
    dvalue.scatter_add_(1, idx, w[..., :1] * d).scatter_add_(1, idx + 1, w[..., 1:] * d)
    return dvalue, dw


def _check_cuda(name, value, idx2, w_pairs, per: int):
    """Validate the kernels' inputs (nU2 a multiple of `per`); return them contiguous."""
    if value.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {value.device}")
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    if value.dtype != torch.float32 or w_pairs.dtype != torch.float32 or idx2.dtype != torch.int32:
        raise TypeError(f"{name}: value/w_pairs must be float32 and idx2 int32")
    if tuple(idx2.shape) != (B, nU2, nh) or tuple(w_pairs.shape) != (B, nU2, nh, 2) or nU2 % per:
        raise ValueError(f"{name}: inconsistent shapes")
    if c % 2 or c > 64 or Lv < 2:
        raise ValueError(f"{name}: the kernel needs an even c <= 64 and Lv >= 2, got c={c}")
    if idx2.device != value.device or w_pairs.device != value.device:
        raise ValueError(f"{name}: inputs on different devices")
    return value.contiguous(), idx2.contiguous(), w_pairs.contiguous()


def _gather_fwd_cuda(value, idx2, w_pairs, P: int) -> torch.Tensor:
    """Launch kernel B2."""
    ppq = 2 * P
    value, idx2, w_pairs = _check_cuda("bilinear_gather", value, idx2, w_pairs, ppq)
    B, Lv, nh, c = value.shape
    Q = idx2.shape[1] // ppq
    out = torch.empty((B, Q, nh, c), dtype=torch.float32, device=value.device)
    rc = _lib("bilinear_gather_fwd").bilinear_gather_fwd(
        value.data_ptr(), idx2.data_ptr(), w_pairs.data_ptr(), out.data_ptr(),
        B, Lv, nh, c, Q, ppq, torch.cuda.current_stream(value.device).cuda_stream,
    )
    _build.check(rc, "bilinear_gather_fwd")
    bilinear_gather.launches += 1
    return out


def bilinear_gather_bwd(value, idx2, w_pairs, dout):
    """(dvalue, dw) of the pair gather given dout (B, Q, nh, c): kernel B4
    for CUDA tensors, `bilinear_gather_bwd_ref` for CPU ones.

    The kernel scatters dvalue with fp32 atomics: its sums over shared rows
    are not bitwise the same from run to run (dw is)."""
    if value.device.type == "cpu":
        return bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    B, Q = dout.shape[:2]
    value, idx2, w_pairs = _check_cuda("bilinear_gather_bwd", value, idx2, w_pairs, Q)
    _, Lv, nh, c = value.shape
    if tuple(dout.shape) != (B, Q, nh, c) or dout.dtype != torch.float32:
        raise ValueError("bilinear_gather_bwd: dout must be float32 (B, Q, nh, c)")
    dout = dout.contiguous()
    dvalue = torch.zeros_like(value)
    dw = torch.empty_like(w_pairs)
    rc = _lib("bilinear_gather_bwd").bilinear_gather_bwd(
        value.data_ptr(), idx2.data_ptr(), w_pairs.data_ptr(), dout.data_ptr(), dvalue.data_ptr(),
        dw.data_ptr(), B, Lv, nh, c, Q, idx2.shape[1] // Q,
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    _build.check(rc, "bilinear_gather_bwd")
    bilinear_gather_bwd.launches += 1
    return dvalue, dw


class _BilinearGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, idx4, w_pairs, idx2, P):
        ctx.save_for_backward(value, w_pairs, idx2)
        if value.device.type == "cpu":
            return bilinear_gather_ref(value, idx4, w_pairs, idx2, P)
        return _gather_fwd_cuda(value, idx2, w_pairs, P)

    @staticmethod
    def backward(ctx, dout):
        value, w_pairs, idx2 = ctx.saved_tensors
        dvalue, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
        return dvalue, None, dw, None, None


def bilinear_gather(value, idx4, w_pairs, idx2, P: int) -> torch.Tensor:
    """The pair gather: kernel B2 for CUDA tensors, the plain version for CPU
    ones; differentiable in value and w_pairs through `bilinear_gather_bwd`."""
    if value.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"bilinear_gather: no kernel for device {value.device}")
    return _BilinearGather.apply(value, idx4, w_pairs, idx2, P)


# kernel launches since the last reset, one counter per kernel
bilinear_gather.launches = 0
bilinear_gather_bwd.launches = 0

_ARGS = {"bilinear_gather_fwd": 4, "bilinear_gather_bwd": 6}  # pointer arguments


def _lib(source: str) -> ctypes.CDLL:
    """The library built from `csrc/<source>.cu`, its entry point typed:
    pointers, six ints, the stream."""
    lib = _build.load(source)
    fn = getattr(lib, source)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * _ARGS[source] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib
