"""Process groups of multi-GPU training (the port of
`tamtr_tpu/parallel/mesh.py`).

The JAX package runs one program over a device mesh: the batch sharded
over a `data` axis, and with sp > 1 a 2-D (data, sp) mesh whose `sp` axis
cuts every SS2D token axis. Here each device is a process (one rank), as
the reference's DDP over NCCL runs:

- `init_distributed` joins the process group a launcher
  (`torch.distributed.run`) describes in RANK, WORLD_SIZE, LOCAL_RANK and
  MASTER_ADDR / MASTER_PORT: NCCL and `cuda:LOCAL_RANK` for the card, gloo
  only when the caller asks for the CPU;
- `make_groups(sp)` lays the ranks out as JAX's mesh lays its devices,
  rank = data_index * sp + sp_index, and returns the data group (the ranks
  of one sp index), the sp group (the ranks of one data index) and the
  data size;
- `shard_batch` gives a data rank its rows of a global batch;
- `data_parallel(groups)`, entered by the trainer around its forward,
  makes the model and the loss compute what one process computes on the
  global batch: train-mode BatchNorm takes its moments over the global
  batch (`nn/layers.py:BatchNorm2d`), the CDN noise and DropPath masks are
  drawn for the global batch and each rank keeps its rows (`batch_rows`),
  and the loss's normalisers count the global ground truth
  (`losses/detr_loss.py`). With no group every one of them is the
  one-process code.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.distributed as dist


def init_distributed(device: Union[str, torch.device, None] = None) -> Optional[torch.device]:
    """Join the launcher's process group, or the one already initialised;
    None when this process is not one rank of several (no RANK in the
    environment and no group). The backend follows the device: NCCL for
    "cuda" (the default), gloo for "cpu"; a group of the other backend
    raises. Returns this rank's device, `cuda:LOCAL_RANK` (made current)
    or the CPU."""
    device = torch.device(device or "cuda")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, but device {device} needs {backend}")
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU over gloo")
        dist.init_process_group(backend, init_method="env://")
    else:
        return None
    if device.type != "cuda":
        return torch.device("cpu")
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))
    torch.cuda.set_device(device)
    return device


@dataclass(frozen=True)
class Groups:
    """This rank's place in the (data, sp) layout: `data`, the process group
    of the ranks with its sp index (the batch is split over them); `sp`, the
    group of the ranks with its data index (the scans' token axes are cut
    over them), None when sp == 1."""

    data: Any
    sp: Any
    data_size: int
    data_rank: int


def make_groups(sp: int = 1) -> Groups:
    """The data and sp groups of the default process group, laid out as
    `tamtr_tpu/parallel/mesh.py:make_mesh` reshapes its devices: rank
    d * sp + s has data index d and sp index s. Every rank calls it (each
    group is created on all ranks, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if sp < 1 or world % sp:
        raise ValueError(f"{world} devices not divisible by sp={sp}")
    n_data = world // sp
    if sp == 1:
        return Groups(dist.group.WORLD, None, n_data, rank)
    data = [dist.new_group([d * sp + s for d in range(n_data)]) for s in range(sp)]
    seq = [dist.new_group([d * sp + s for s in range(sp)]) for d in range(n_data)]
    return Groups(data[rank % sp], seq[rank // sp], n_data, rank // sp)


def shard_batch(batch: Dict[str, Any], data_rank: int, data_size: int) -> Dict[str, Any]:
    """The rows of data rank `data_rank` of `data_size` in a global batch:
    each array's leading axis cut into equal parts (as
    `jax.make_array_from_process_local_data` places a host's rows). Arrays
    with one row (a shared text table) are kept whole."""
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n == 1:
            out[k] = v
            continue
        if n % data_size:
            raise ValueError(f"batch {n} must divide over {data_size} data-parallel devices")
        b = n // data_size
        out[k] = v[data_rank * b:(data_rank + 1) * b]
    return out


_DATA: Optional[Groups] = None  # set by `data_parallel`


class data_parallel:
    """Context manager: the model and the loss act over the global batch of
    `groups.data` (see the module docstring); None leaves them as they are."""

    def __init__(self, groups: Optional[Groups]):
        self.groups = groups

    def __enter__(self):
        global _DATA
        self.prev, _DATA = _DATA, self.groups
        return self

    def __exit__(self, *exc):
        global _DATA
        _DATA = self.prev
        return False


def data_groups() -> Optional[Groups]:
    """The groups of the innermost `data_parallel`, or None."""
    return _DATA


def batch_rows(draw: Callable[[int], torch.Tensor], rows: int) -> torch.Tensor:
    """`draw(n)` draws n rows of a random tensor. Under `data_parallel` it
    draws the global batch's rows, every rank from the same generator
    state, and keeps this rank's `rows`: the one-process draw's rows."""
    g = _DATA
    if g is None:
        return draw(rows)
    return draw(rows * g.data_size)[g.data_rank * rows:(g.data_rank + 1) * rows]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data group under `data_parallel` (not
    differentiated), else `t`."""
    g = _DATA
    if g is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=g.data)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group, differentiable: the gradient of every rank's
    input is the sum over the group of the outputs' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group`; autograd sums the gradient over it too."""
    return _AllReduceSum.apply(t, group)


def all_reduce_grads(grads, group, bucket_bytes: int = 25 << 20) -> None:
    """Sum every tensor of `grads` over `group` in place, in flat buckets of
    about `bucket_bytes` (one all-reduce each), as DDP buckets its
    gradients."""
    bucket, size = [], 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        if size >= bucket_bytes or i == len(grads) - 1:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            torch._foreach_copy_(bucket, [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in bucket]),
                                                                       bucket)])
            bucket, size = [], 0


def gather_to_rank0(obj: Any) -> Optional[list]:
    """Every rank's `obj` in rank order on rank 0 (None elsewhere)."""
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def broadcast_from_rank0(obj: Any) -> Any:
    """Rank 0's `obj` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def free_port() -> int:
    """A free TCP port on this host, for a rendezvous on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

