"""Deformable-attention bilinear pair gather, forward: CUDA kernel and plain version.

`bilinear_gather` replaces the TPU kernel
`tamtr_tpu/kernels/deform_scatter.py:_gather_pairs_kernel` (via
`_gather_acc_pairs` and `bilinear_gather`). On a CUDA tensor it launches
`csrc/bilinear_gather_fwd.cu`, which reads the pair starts `idx2`; on a CPU
tensor it runs `bilinear_gather_ref`, the plain 4-corner gather of
`_gather_fwd_impl`, which reads the corner indices `idx4`.

Arguments, as in the JAX package:
  value (B, Lv, nh, c) multi-level features; idx4 (B, Q*P*4, nh) clipped flat
  corner rows; w_pairs (B, Q*P*2, nh, 2) corner weights times attention
  weight, one pair per bilinear row, pre-swapped by the caller when x0 < 0;
  idx2 (B, Q*P*2, nh) pair starts (rows idx2 and idx2 + 1); P = levels x
  points per query and head. Returns (B, Q, nh, c).
"""

from __future__ import annotations

import ctypes

import torch

from tamtr_torch.kernels import _build


def _shift_last_row(idx2: torch.Tensor, w_pairs: torch.Tensor, Lv: int):
    """A pair starting on the global last row moves up one row with its
    weights swapped, so its second row stays inside value (the kernel applies
    the same rule itself)."""
    at_end = idx2 >= Lv - 1
    return torch.where(at_end, Lv - 2, idx2), torch.where(at_end[..., None], w_pairs.flip(-1), w_pairs)


def bilinear_gather_ref(value, idx4, w_pairs, idx2, P: int) -> torch.Tensor:
    """Plain version: gather the 4 corners of every sample point and weight them."""
    B, Lv, nh, c = value.shape
    _, w_pairs = _shift_last_row(idx2, w_pairs, Lv)
    nU = idx4.shape[1]
    w4 = w_pairs.transpose(2, 3).reshape(B, nU, nh)  # (B, nU2, 2, nh) -> corners
    g = torch.gather(value, 1, idx4.long()[..., None].expand(B, nU, nh, c))
    g = g.view(B, nU // (P * 4), P * 4, nh, c)
    return torch.einsum("bqpnc,bqpn->bqnc", g, w4.view(B, nU // (P * 4), P * 4, nh))


def bilinear_gather(value, idx4, w_pairs, idx2, P: int) -> torch.Tensor:
    """The pair gather: CUDA kernel for CUDA tensors, plain version for CPU ones."""
    if value.device.type == "cpu":
        return bilinear_gather_ref(value, idx4, w_pairs, idx2, P)
    if value.device.type != "cuda":
        raise RuntimeError(f"bilinear_gather: no kernel for device {value.device}")
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    ppq = 2 * P
    if value.dtype != torch.float32 or w_pairs.dtype != torch.float32 or idx2.dtype != torch.int32:
        raise TypeError("bilinear_gather: value/w_pairs must be float32 and idx2 int32")
    if tuple(idx2.shape) != (B, nU2, nh) or tuple(w_pairs.shape) != (B, nU2, nh, 2) or nU2 % ppq:
        raise ValueError("bilinear_gather: inconsistent shapes")
    if c % 2 or c > 64 or Lv < 2:
        raise ValueError(f"bilinear_gather: the kernel needs an even c <= 64 and Lv >= 2, got c={c}")
    if idx2.device != value.device or w_pairs.device != value.device:
        raise ValueError("bilinear_gather: inputs on different devices")
    Q = nU2 // ppq
    value, idx2, w_pairs = value.contiguous(), idx2.contiguous(), w_pairs.contiguous()
    out = torch.empty((B, Q, nh, c), dtype=torch.float32, device=value.device)
    rc = _lib().bilinear_gather_fwd(
        value.data_ptr(), idx2.data_ptr(), w_pairs.data_ptr(), out.data_ptr(),
        B, Lv, nh, c, Q, ppq, torch.cuda.current_stream(value.device).cuda_stream,
    )
    _build.check(rc, "bilinear_gather_fwd")
    bilinear_gather.launches += 1
    return out


bilinear_gather.launches = 0  # kernel launches since the last reset


def _lib() -> ctypes.CDLL:
    lib = _build.load("bilinear_gather_fwd")
    fn = lib.bilinear_gather_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib
