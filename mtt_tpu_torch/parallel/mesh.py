"""Data parallelism over processes, one device each (counterpart of
mtt_tpu/parallel/mesh.py).

JAX runs one SPMD program over a ``data`` mesh: the batch is sharded, the
parameters replicated, and GSPMD makes every batch reduction global (the
BatchNorm moments, the loss normalisers, the meters). The port runs one
process per card, as PyTorch does, and writes each of those joins out:

- ``init_distributed`` joins the process group that ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU, or gloo on a
  card that several ranks share when the caller asks for it. Every group has
  a timeout (``TIMEOUT_S`` unless the caller sets one), so a lost rank
  makes the others fail instead of hang.
- ``all_reduce_sum`` is a differentiable SUM (sum forward, sum backward):
  the BatchNorm moments and the loss normalisers go through it, so that each
  rank's loss is its share of the global one and the cotangents of the
  global statistics reach every rank's inputs.
- ``all_reduce_grads`` sums the gradients after the backward (flattened f32
  buckets; a missing gradient counts as zeros); ``broadcast_`` and
  ``all_reduce_`` move lists of tensors in one flattened collective per
  dtype.

Without a process group (or with one of a single rank) every function here
is the identity, and the port runs as one process. There is no DDP wrapper
and no quiet fallback: ``--multihost`` without torchrun's environment, or a
group that fails to form, raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 300.0          # every collective of the group, and its forming
GRAD_BUCKET = 1 << 24      # f32 values a gradient bucket (64 MiB)
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device=None, backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Joins the process group of torchrun's environment and returns this
    rank's device: ``device`` when given (``"cpu"``, or one card that
    several ranks share), else ``cuda:LOCAL_RANK``. The backend defaults to
    NCCL on a card and gloo on the CPU. A process already in a group of the
    same rank and size keeps it."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs torchrun's environment; "
                           f"{missing} not set (launch with torchrun "
                           f"--nproc_per_node N -m mtt_tpu_torch.main "
                           f"--multihost ...)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for rank "
                               f"{rank}; pass device='cpu' for a CPU run")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the environment says {rank} of "
                f"{world}")
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
        f"{os.environ['MASTER_PORT']}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def data_shard_info() -> Tuple[int, int]:
    """(num_shards, shard_index) of this process's data: (world, rank), or
    (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def barrier() -> None:
    if data_shard_info()[0] > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks; the backward sums the cotangents the same way,
    since every rank's output is the same function of every rank's
    input."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable; ``x`` itself on one
    rank."""
    if data_shard_info()[0] == 1:
        return x
    return _AllReduceSum.apply(x)


def _flat_(tensors: Sequence[torch.Tensor], collective) -> None:
    """Runs ``collective`` on one flat copy of ``tensors`` per dtype and
    device and writes the result back in place."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[at:at + n].view_as(tensors[i]))
            at += n


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sums ``tensors`` over the ranks in place (the meter states)."""
    if data_shard_info()[0] > 1 and tensors:
        _flat_(tensors, dist.all_reduce)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Copies rank ``src``'s ``tensors`` into every rank's, in place."""
    if data_shard_info()[0] > 1 and tensors:
        _flat_(tensors, lambda t: dist.broadcast(t, src))


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor],
                     bucket: int = GRAD_BUCKET) -> None:
    """Sums every parameter's gradient over the ranks, in buckets of at most
    ``bucket`` f32 values (a larger tensor is a bucket of its own). A
    parameter without a gradient adds zeros, so every rank issues the same
    collectives; it keeps no gradient only where no rank had one. The sums
    are written back in the gradients' dtype."""
    params = list(params)
    if data_shard_info()[0] == 1 or not params:
        return
    dev = params[0].device
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=dev)
    dist.all_reduce(has)
    live = [p for p, h in zip(params, has.tolist()) if h > 0]
    chunks: List[List[torch.Tensor]] = [[]]
    size = 0
    for p in live:
        if chunks[-1] and size + p.numel() > bucket:
            chunks.append([])
            size = 0
        chunks[-1].append(p)
        size += p.numel()
    for chunk in chunks:
        if not chunk:
            continue
        flat = torch.cat([
            (p.grad.reshape(-1).float() if p.grad is not None else
             torch.zeros(p.numel(), dtype=torch.float32, device=p.device))
            for p in chunk])
        dist.all_reduce(flat)
        at = 0
        for p in chunk:
            n = p.numel()
            g = flat[at:at + n].view_as(p)
            if p.grad is None:
                p.grad = g.to(p.dtype, copy=True)
            else:
                p.grad.copy_(g)
            at += n
