"""Jacobi auction assignment: CUDA kernel and plain versions.

Kernel B5, `csrc/auction.cu`, replaces the TPU kernel
`tamtr_tpu/kernels/auction.py:_auction_kernel` (via `auction_match_pallas`)
and computes the JAX package's default matcher,
`tamtr_tpu/losses/matcher.py`: single phase from zero prices, a per-problem
eps (1e-2 of the cost spread for contested problems, else 1e-3), the stop
once min(#valid, #objects) persons are assigned, and `max_rounds`. Ties go
to the first index, as `jnp.argmax` picks. Every round runs on the device,
and the kernel computes its own setup (value, eps, target) in-block: an
eager torch loop would ask the host after every round whether to go on.

- `auction_assignment` (JAX's `auction_assignment`): one launch, one block
  per image, no host read. Each block solves its image forward, or
  transposed where the image holds more valid gts than queries, to its own
  stop; the source's header says why that equals JAX's batch-wide stops.
  On a CPU tensor, `auction_assignment_ref` runs the same scheme with torch
  ops (`_oriented_setup` and `_rounds_ref` with per-problem stops).
- `auction_match` (JAX's `auction_match`): the batch-wide stop and the
  optional `row_mask`, in two launches of the same round body. On a CPU
  tensor, `auction_match_ref` (`auction_setup` and `_rounds_ref`).
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


def _rounds_ref(value, eps, gt_mask, target, max_rounds: int, own_stop: bool = False):
    """The auction rounds with torch ops, all problems in step (the JAX
    while_loop): run while any problem is short of its target. With
    `own_stop` a problem that has reached its target bids no more (the
    kernel's own stops). Returns the assignment and the number of rounds run."""
    B, nq, M = value.shape
    dev = value.device
    price = torch.zeros((B, nq), dtype=torch.float32, device=dev)
    owner = torch.full((B, nq), -1, dtype=torch.long, device=dev)
    assigned = torch.full((B, M + 1), -1, dtype=torch.long, device=dev)  # column M: dropped writes
    rows = torch.arange(nq, device=dev)
    rounds = 0
    while rounds < max_rounds:
        live = (assigned[:, :M] >= 0).sum(1) < target
        if not bool(live.any()):
            break
        rounds += 1
        net = value - price[:, :, None]
        j1 = net.argmax(1)  # (B, M): first index of the maximum
        w1 = net.gather(1, j1[:, None]).squeeze(1)
        w2 = net.scatter(1, j1[:, None], NEG).amax(1)
        bid = price.gather(1, j1) + (w1 - w2) + eps[:, None]
        bidding = gt_mask & (assigned[:, :M] < 0) & (w1 > NEG / 2)
        if own_stop:
            bidding &= live[:, None]
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


def _oriented_setup(C, gt_mask, transposed: bool):
    """The kernel's in-block setup for images solved in one orientation, as
    torch ops: forward, the gts bid for the queries; transposed, the nq
    queries bid for the valid gts. Returns value (B, persons, objects)
    person-major with NEG at invalid pairs, the valid persons, eps and
    target, equal to `auction_setup` of the oriented problem: the spread
    over the valid pairs' values and, where any pair is invalid, 0."""
    B, nq, M = C.shape
    value = -C.float()
    every_query = torch.ones((B, nq), dtype=torch.bool, device=C.device)
    if transposed:
        pv, ov = every_query, gt_mask
    else:
        pv, ov, value = gt_mask, every_query, value.transpose(1, 2)
    pair_ok = pv[:, :, None] & ov[:, None, :]
    value = torch.where(pair_ok, value, NEG)
    vmax = torch.where(pair_ok, value, -torch.inf).amax((1, 2))
    vmin = torch.where(pair_ok, value, torch.inf).amin((1, 2))
    n_pv, n_ov = pv.sum(1), ov.sum(1)
    any_invalid = (n_pv < pv.shape[1]) | (n_ov < ov.shape[1])
    vmax = torch.where(any_invalid, vmax.clamp(min=0.0), vmax)
    vmin = torch.where(any_invalid, vmin.clamp(max=0.0), vmin)
    spread = (vmax - vmin).clamp(min=1.0)
    contested = n_pv.to(torch.float32) >= 0.7 * n_ov.to(torch.float32)
    eps = spread * torch.where(contested, 1e-2, 1e-3).to(torch.float32)
    return value, pv, eps, torch.minimum(n_pv, n_ov).to(torch.int32)


def auction_assignment_ref(C, gt_mask, max_rounds: int = MAX_ROUNDS) -> torch.Tensor:
    """Plain version of `auction_assignment`: each image solved in its own
    orientation to its own stop. C (B, nq, M), gt_mask (B, M) -> (B, M)
    int32, the query of each gt, -1 if none."""
    B, nq, M = C.shape
    out = torch.full((B, M), -1, dtype=torch.int32, device=C.device)
    overfull = gt_mask.sum(1) > nq
    for transposed in (False, True):
        sel = torch.nonzero(overfull == transposed).squeeze(1)
        if sel.numel() == 0:
            continue
        value, pv, eps, target = _oriented_setup(C[sel], gt_mask[sel], transposed)
        asg = _rounds_ref(value.transpose(1, 2), eps, pv, target, max_rounds, own_stop=True)[0]
        if transposed:  # out[gt] = the query that holds it
            per_gt = torch.full((len(sel), M + 1), -1, dtype=torch.int32, device=C.device)
            queries = torch.arange(nq, dtype=torch.int32, device=C.device).expand(len(sel), nq)
            asg = per_gt.scatter_(1, torch.where(asg >= 0, asg, M).long(), queries)[:, :M]
        out[sel] = asg
    return out


def _check(name: str, cost, gt_mask):
    if cost.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {cost.device}")
    B, nq, M = cost.shape
    if cost.dtype != torch.float32:
        raise TypeError(f"{name}: cost must be float32")
    if tuple(gt_mask.shape) != (B, M) or gt_mask.dtype != torch.bool or gt_mask.device != cost.device:
        raise ValueError(f"{name}: gt_mask must be a bool (B, M) tensor on the cost's device")
    return cost.contiguous(), gt_mask.contiguous()


def auction_assignment(C, gt_mask, max_rounds: int = MAX_ROUNDS) -> torch.Tensor:
    """The assignment of JAX's `auction_assignment` on a cost C (B, nq, M)
    and gt_mask (B, M) -> (B, M) int32: kernel B5 in one launch for CUDA
    tensors (no host read), `auction_assignment_ref` for CPU ones."""
    if C.device.type == "cpu":
        return auction_assignment_ref(C, gt_mask, max_rounds)
    C, gt_mask = _check("auction_assignment", C, gt_mask)
    B, nq, M = C.shape
    out = torch.empty((B, M), dtype=torch.int32, device=C.device)
    rc = _lib().auction_assignment(C.data_ptr(), gt_mask.data_ptr(), out.data_ptr(), B, nq, M, max_rounds,
                                   torch.cuda.current_stream(C.device).cuda_stream)
    _build.check(rc, "auction_assignment")
    auction_assignment.launches += 1
    return out


def auction_match(cost, gt_mask, max_rounds: int = MAX_ROUNDS, row_mask=None) -> torch.Tensor:
    """The auction with the batch-wide stop: kernel B5 in two launches for
    CUDA tensors, `auction_match_ref` for CPU ones."""
    if cost.device.type == "cpu":
        return auction_match_ref(cost, gt_mask, max_rounds, row_mask)
    cost, gt_mask = _check("auction_match", cost, gt_mask)
    B, nq, M = cost.shape
    if row_mask is not None:
        if tuple(row_mask.shape) != (B, nq) or row_mask.dtype != torch.bool or row_mask.device != cost.device:
            raise ValueError("auction_match: row_mask must be a bool (B, nq) tensor on the cost's device")
        row_mask = row_mask.contiguous()
    new = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device=cost.device)  # noqa: E731
    assigned, price, owner, rounds = new(B, M), new(B, nq, dtype=torch.float32), new(B, nq), new(B)
    ctrl = torch.zeros(1, dtype=torch.int32, device=cost.device)
    rc = _lib().auction_match(
        cost.data_ptr(), gt_mask.data_ptr(), None if row_mask is None else row_mask.data_ptr(),
        assigned.data_ptr(), price.data_ptr(), owner.data_ptr(), rounds.data_ptr(), ctrl.data_ptr(),
        B, nq, M, max_rounds, torch.cuda.current_stream(cost.device).cuda_stream,
    )
    _build.check(rc, "auction_match")
    auction_match.launches += 1
    return assigned


# calls since the last reset: auction_assignment one launch each, auction_match two
auction_assignment.launches = 0
auction_match.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("auction")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (("auction_assignment", [p] * 3 + [i] * 4 + [p]),
                           ("auction_match", [p] * 8 + [i] * 4 + [p])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
