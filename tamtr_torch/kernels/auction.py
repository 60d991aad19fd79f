"""Jacobi auction assignment: CUDA kernel and plain version.

`auction_match` replaces the TPU kernel
`tamtr_tpu/kernels/auction.py:_auction_kernel` (via `auction_match_pallas`)
and computes the JAX package's default matcher,
`tamtr_tpu/losses/matcher.py:auction_match`: single phase from zero prices,
a per-problem eps (1e-2 of the cost spread for contested problems, else
1e-3), optional `row_mask` for the transposed solve, the stop once every
problem has min(#valid, #objects) persons assigned, and `max_rounds`. Ties
go to the first index, as `jnp.argmax` picks.

On a CUDA tensor it launches `csrc/auction.cu`, which runs every round on the
device and stops by itself: an eager torch loop would have to ask the host
after every round whether to go on. It takes any batch and problem size:
two launches keep the batch-wide stop without a cooperative launch, and
value moves from shared to device memory where it outgrows the block. On a
CPU tensor it runs `auction_match_ref`, the same rounds written with torch
ops. Both share `auction_setup`, the prologue that turns costs into values,
eps and targets.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tamtr_torch.kernels import _build

NEG = -1e9
MAX_ROUNDS = 300


def auction_setup(cost: torch.Tensor, gt_mask: torch.Tensor, row_mask: Optional[torch.Tensor] = None):
    """cost (B, nq, M) minimised; gt_mask (B, M) bool persons; row_mask
    (B, nq) bool objects -> value (B, nq, M) maximised with NEG at invalid
    pairs, eps (B,) float32, target (B,) int32 = min(#valid, #objects)."""
    B, nq, M = cost.shape
    value = torch.where(gt_mask[:, None, :], -cost.float(), NEG)
    if row_mask is not None:
        value = torch.where(row_mask[:, :, None], value, NEG)
        pair_ok = gt_mask[:, None, :] & row_mask[:, :, None]
        avail = row_mask.sum(1).to(torch.int32)
    else:
        pair_ok = gt_mask[:, None, :].expand(B, nq, M)
        avail = torch.full((B,), nq, dtype=torch.int32, device=cost.device)
    masked = torch.where(pair_ok, value, 0.0)
    spread = (masked.amax((1, 2)) - masked.amin((1, 2))).clamp(min=1.0)
    n_valid = gt_mask.sum(1).to(torch.float32)
    contested = n_valid >= 0.7 * avail.to(torch.float32)
    eps = spread * torch.where(contested, 1e-2, 1e-3).to(torch.float32)
    target = torch.minimum(n_valid.to(torch.int32), avail)
    return value.contiguous(), eps, target


def _rounds_ref(value, eps, gt_mask, target, max_rounds: int):
    """The auction rounds with torch ops, all problems in step (the JAX
    while_loop): run while any problem is short of its target. Returns the
    assignment and the number of rounds run."""
    B, nq, M = value.shape
    dev = value.device
    price = torch.zeros((B, nq), dtype=torch.float32, device=dev)
    owner = torch.full((B, nq), -1, dtype=torch.long, device=dev)
    assigned = torch.full((B, M + 1), -1, dtype=torch.long, device=dev)  # column M: dropped writes
    rows = torch.arange(nq, device=dev)
    rounds = 0
    while rounds < max_rounds and not bool(((assigned[:, :M] >= 0).sum(1) >= target).all()):
        rounds += 1
        net = value - price[:, :, None]
        j1 = net.argmax(1)  # (B, M): first index of the maximum
        w1 = net.gather(1, j1[:, None]).squeeze(1)
        w2 = net.scatter(1, j1[:, None], NEG).amax(1)
        bid = price.gather(1, j1) + (w1 - w2) + eps[:, None]
        bidding = gt_mask & (assigned[:, :M] < 0) & (w1 > NEG / 2)
        bids = torch.where((j1[:, None, :] == rows[None, :, None]) & bidding[:, None, :], bid[:, None, :], NEG)
        best_bid = bids.amax(2)
        best_person = bids.argmax(2)
        has_bid = best_bid > NEG / 2
        assigned.scatter_(1, torch.where(has_bid & (owner >= 0), owner, M), -1)
        assigned.scatter_(1, torch.where(has_bid, best_person, M), rows.expand(B, nq))
        owner = torch.where(has_bid, best_person, owner)
        price = torch.where(has_bid, best_bid, price)
    return torch.where(gt_mask, assigned[:, :M], -1).to(torch.int32), rounds


def auction_match_ref(cost, gt_mask, max_rounds: int = MAX_ROUNDS, row_mask=None) -> torch.Tensor:
    """Plain version: (B, M) int32 object (query) index per valid person
    (gt), -1 if none."""
    value, eps, target = auction_setup(cost, gt_mask, row_mask)
    return _rounds_ref(value, eps, gt_mask, target, max_rounds)[0]


def auction_match(cost, gt_mask, max_rounds: int = MAX_ROUNDS, row_mask=None) -> torch.Tensor:
    """The auction: kernel B5 for CUDA tensors, the plain version for CPU ones."""
    if cost.device.type == "cpu":
        return auction_match_ref(cost, gt_mask, max_rounds, row_mask)
    if cost.device.type != "cuda":
        raise RuntimeError(f"auction_match: no kernel for device {cost.device}")
    B, nq, M = cost.shape
    if tuple(gt_mask.shape) != (B, M) or gt_mask.dtype != torch.bool or gt_mask.device != cost.device:
        raise ValueError("auction_match: gt_mask must be a bool (B, M) tensor on the cost's device")
    value, eps, target = auction_setup(cost, gt_mask, row_mask)
    gt_mask, eps, target = gt_mask.contiguous(), eps.contiguous(), target.contiguous()
    new = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device=cost.device)  # noqa: E731
    assigned, price, owner, rounds = new(B, M), new(B, nq, dtype=torch.float32), new(B, nq), new(B)
    ctrl = torch.zeros(1, dtype=torch.int32, device=cost.device)
    rc = _lib().auction_match(
        value.data_ptr(), eps.data_ptr(), gt_mask.data_ptr(), target.data_ptr(),
        assigned.data_ptr(), price.data_ptr(), owner.data_ptr(), rounds.data_ptr(), ctrl.data_ptr(),
        B, nq, M, max_rounds, torch.cuda.current_stream(cost.device).cuda_stream,
    )
    _build.check(rc, "auction_match")
    auction_match.launches += 1
    return assigned


auction_match.launches = 0  # kernel calls (each two launches of csrc/auction.cu) since the last reset


def _lib() -> ctypes.CDLL:
    lib = _build.load("auction")
    fn = lib.auction_match
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return lib
