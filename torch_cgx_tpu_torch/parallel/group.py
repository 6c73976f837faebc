"""The data-parallel group the reducers run over.

Takes the place of the JAX package's mesh axis (``parallel/mesh.py``): a
``torch.distributed`` process group, or ``None`` for the default group. With
no process group initialised the world is one rank and no collective runs.
Every position a JAX reducer takes from ``lax.axis_index`` is :func:`rank`,
the rank within the group the collective runs over.

The wire moves over NCCL on the card and gloo on the CPU. Gloo also serves
several ranks that share one card (NCCL refuses two ranks on one device):
it takes CUDA tensors for every collective used here
(``tools/gloo_cuda_probe.py``) and stages them through host memory itself,
while the codec kernels run on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


Pending = Optional["dist.Work"]  # an asynchronous collective's handle, None: nothing moved


def all_to_all_rows(t: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """Row ``j`` of ``t (ws, ...)`` goes to rank ``j``; row ``j`` of the
    result came from rank ``j``."""
    out, work = all_to_all_rows_async(t, group)
    wait(work)
    return out


def all_to_all_rows_async(t: torch.Tensor, group: ProcessGroup = None) -> Tuple[torch.Tensor, Pending]:
    """:func:`all_to_all_rows` posted without waiting: ``(out, work)``.
    ``out`` may be read only after :func:`wait` of ``work`` (on the card
    the wait orders the current stream after the receive). In a one-rank
    world (no process group) ``out`` is a copy of ``t``."""
    t = t.contiguous()
    if world_size(group) == 1:
        return t.clone(), None
    out = torch.empty_like(t)
    if not t.numel():
        return out, None
    return out, dist.all_to_all_single(out, t, group=group, async_op=True)


def all_gather_rows(t: torch.Tensor, ws: int, group: ProcessGroup = None) -> torch.Tensor:
    """Stack ``t (1, ...)`` from every rank -> ``(ws, ...)``."""
    out, work = all_gather_rows_async(t, ws, group)
    wait(work)
    return out


def all_gather_rows_async(t: torch.Tensor, ws: int,
                          group: ProcessGroup = None) -> Tuple[torch.Tensor, Pending]:
    """:func:`all_gather_rows` posted without waiting: ``(out, work)``; in
    a one-rank world a copy of ``t``."""
    t = t.contiguous()
    if world_size(group) == 1:
        return t.clone(), None
    out = torch.empty((ws,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    if not t.numel():
        return out, None
    return out, dist.all_gather_into_tensor(out, t, group=group, async_op=True)


def wait(work: Pending) -> None:
    """Wait for an asynchronous collective (None: nothing to wait for)."""
    if work is not None:
        work.wait()


def shift_right(t: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """Send ``t`` to rank ``(i + 1) % ws`` and return what rank ``(i - 1) %
    ws`` sent: the Ring hop, ``lax.ppermute`` to the right neighbour. Built
    on ``all_to_all_single`` with one non-empty send and one non-empty
    receive, which gloo and NCCL both take (gloo's ``send``/``recv`` are not
    safe on CUDA tensors)."""
    ws, me = world_size(group), rank(group)
    if ws == 1 or not t.numel():
        return t.clone()
    send = [0] * ws
    recv = [0] * ws
    send[(me + 1) % ws] = recv[(me - 1) % ws] = t.numel()
    src = t.contiguous().view(-1)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, recv, send, group=group)
    return out.view(t.shape)


def all_reduce_sum(t: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def reduce_scatter_sum(t: torch.Tensor, ws: int, group: ProcessGroup = None) -> torch.Tensor:
    """This rank's chunk of the sum of flat ``t`` (length ``ws * chunk``)
    over the group: ``lax.psum_scatter(tiled=True)``."""
    out = torch.empty(t.shape[0] // ws, dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out
