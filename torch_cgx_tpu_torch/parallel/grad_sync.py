"""Compressed data-parallel training front end.

Counterpart of ``torch_cgx_tpu/parallel/grad_sync.py``: ``gradient_sync``
runs the quantized allreduce over a model's named gradients, and
``make_train_step`` builds the eager step that does forward, backward,
the sync and the optimizer update. Error feedback, the nonfinite guard and
the alternative compressors (PowerSGD, top-k) wait (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch
import torch.distributed as dist
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from . import group as group_mod
from .allreduce import allreduce_tree
from .group import ProcessGroup


def gradient_sync(
    grads: Mapping[str, torch.Tensor],
    *,
    group: ProcessGroup = None,
    average: bool = True,
    compress_small: bool = False,
) -> Dict[str, torch.Tensor]:
    """Quantized allreduce of named gradients. Averaging divides before
    quantization, the reference hook's order."""
    return allreduce_tree(grads, group=group, average=average, compress_small=compress_small)


def _to_device(batch: Any, dev: torch.device) -> Any:
    if isinstance(batch, torch.Tensor):
        return batch.to(dev, non_blocking=True)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, dev) for b in batch)
    if isinstance(batch, Mapping):
        return {k: _to_device(v, dev) for k, v in batch.items()}
    return batch


def make_train_step(
    model: nn.Module,
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    *,
    group: ProcessGroup = None,
    device: DeviceLike = None,
    average: bool = True,
) -> Callable[[Any], torch.Tensor]:
    """Build ``step(batch) -> loss``: forward and backward of
    ``loss_fn(model, batch)``, :func:`gradient_sync` over the named
    gradients, ``optimizer.step()``. The batch moves to ``device`` (the GPU
    unless the caller passes another device), where the model must already
    live. The returned loss is averaged over the group."""
    dev = resolve_device(device)
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    wrong = [n for n, p in params if p.device.type != dev.type]
    if wrong:
        raise ValueError(
            f"make_train_step: parameters {wrong[:3]} are not on {dev}; move the model first"
        )

    def step(batch: Any) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, _to_device(batch, dev))
        loss.backward()
        grads = {n: p.grad for n, p in params if p.grad is not None}
        synced = gradient_sync(grads, group=group, average=average)
        for n, p in params:
            if n in synced:
                p.grad = synced[n]
        optimizer.step()
        loss = loss.detach()
        ws = group_mod.world_size(group)
        if ws > 1:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
            loss = loss / ws
        return loss

    return step
