"""The data-parallel group the reducers run over.

Takes the place of the JAX package's mesh axis (``parallel/mesh.py``): a
``torch.distributed`` process group, or ``None`` for the default group. With
no process group initialised the world is one rank and no collective runs.
The wire moves over NCCL on the card and gloo on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

ProcessGroup = Optional["dist.ProcessGroup"]


def world_size(group: ProcessGroup = None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group: ProcessGroup = None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def all_to_all_rows(t: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """Row ``j`` of ``t (ws, ...)`` goes to rank ``j``; row ``j`` of the
    result came from rank ``j``."""
    t = t.contiguous()
    out = torch.empty_like(t)
    if t.numel():
        dist.all_to_all_single(out, t, group=group)
    return out


def all_gather_rows(t: torch.Tensor, ws: int, group: ProcessGroup = None) -> torch.Tensor:
    """Stack ``t (1, ...)`` from every rank -> ``(ws, ...)``."""
    t = t.contiguous()
    out = torch.empty((ws,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    if t.numel():
        dist.all_gather_into_tensor(out, t, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
