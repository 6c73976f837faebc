"""Compressed data-parallel training front end.

Counterpart of ``torch_cgx_tpu/parallel/grad_sync.py``: ``gradient_sync``
runs the quantized allreduce over a model's named gradients, and
``make_train_step`` builds the eager step that does forward, backward,
the sync and the optimizer update. Stochastic rounding
(``CGX_STOCHASTIC_ROUNDING``) takes a key: ``gradient_sync(key=)``, and
in ``make_train_step(stochastic_seed=)`` step ``i`` rounds with
``fold_in(key(stochastic_seed), i)``, as the JAX package's step does.
Error feedback, the nonfinite guard and the alternative compressors
(PowerSGD, top-k) wait (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from .. import config as cfg_mod
from ..ops import fused_producer
from ..utils import prng
from ..utils.device import DeviceLike, resolve_device
from .allreduce import GroupLike, allreduce_tree, flat_world
from .group import all_reduce_sum
from .mesh import TwoLevelGroup


def gradient_sync(
    grads: Mapping[str, torch.Tensor],
    *,
    group: GroupLike = None,
    average: bool = True,
    compress_small: bool = False,
    key: Optional[prng.Key] = None,
) -> Dict[str, torch.Tensor]:
    """Quantized allreduce of named gradients over a group, or over two
    levels with a ``TwoLevelGroup``. Averaging divides before quantization,
    the reference hook's order. Rounding is stochastic where a layer's
    config says so and ``key`` is given. ``CGX_NONFINITE_GUARD`` other than
    "off" is refused (not ported)."""
    cfg_mod.refuse_nonfinite_guard()
    return allreduce_tree(
        grads, group=group, average=average, compress_small=compress_small, key=key
    )


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
    group: GroupLike = None,
    device: DeviceLike = None,
    average: bool = True,
    stochastic_seed: Optional[int] = None,
) -> Callable[[Any], torch.Tensor]:
    """Build ``step(batch) -> loss``: forward and backward of
    ``loss_fn(model, batch)``, :func:`gradient_sync` over the named
    gradients, ``optimizer.step()``. The batch moves to ``device`` (the GPU
    unless the caller passes another device), where the model must already
    live. ``group`` may be a ``TwoLevelGroup``. The returned loss is averaged
    over the whole world.

    Under producer fusion the step owns the backward and the sync, so a
    wrapped layer whose payload the sync will consume returns no weight
    gradient (``fused_producer.consume_reason``); ``p.grad`` of such a
    layer is written from the decoded allreduce output, as every synced
    gradient is. With ``stochastic_seed`` the step's ``i``-th call (from 0)
    syncs with the key ``fold_in(key(stochastic_seed), i)``, which rounds
    stochastically under ``CGX_STOCHASTIC_ROUNDING``. ``CGX_NONFINITE_GUARD``
    other than "off" is refused (not ported)."""
    cfg_mod.refuse_nonfinite_guard()
    dev = resolve_device(device)
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    wrong = [n for n, p in params if p.device.type != dev.type]
    if wrong:
        raise ValueError(
            f"make_train_step: parameters {wrong[:3]} are not on {dev}; move the model first"
        )
    world, ws = flat_world(group)
    fused_producer.deconfigure()  # a rebuilt step drops the previous context
    base = None if stochastic_seed is None else prng.key(stochastic_seed)
    step_idx = [0]

    def step(batch: Any) -> torch.Tensor:
        # Producer fusion: the backward of a wrapped dense layer stages its
        # payload for this group. Only a plain group of more than one rank
        # consumes payloads (the two-level scheme never does); a layer
        # whose payload it will consume skips its dw. Error feedback and the
        # nonfinite guard, once ported, rewrite gradients before the sync
        # and must deactivate the plane here, as the JAX package's
        # active=(guard == "off" and not error_feedback ...) does; until
        # then both raise (error feedback is not in the port, the guard is
        # refused above and in gradient_sync).
        fused_producer.configure(
            group, divisor=ws if average else 1,
            active=not isinstance(group, TwoLevelGroup) and ws > 1, skip_dw=True,
        )
        fused_producer.begin_step()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, _to_device(batch, dev))
        loss.backward()
        grads = {n: p.grad for n, p in params if p.grad is not None}
        key = None if base is None else prng.fold_in(base, step_idx[0])
        step_idx[0] += 1
        synced = gradient_sync(grads, group=group, average=average, key=key)
        for n, p in params:
            if n in synced:
                p.grad = synced[n]
        optimizer.step()
        loss = loss.detach()
        if ws > 1:
            loss = all_reduce_sum(loss, world) / ws
        return loss

    return step
