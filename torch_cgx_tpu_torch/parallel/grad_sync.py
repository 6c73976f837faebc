"""Compressed data-parallel training front end.

Counterpart of ``torch_cgx_tpu/parallel/grad_sync.py``: ``gradient_sync``
runs the quantized allreduce over a model's named gradients, and
``make_train_step`` builds the eager step that does forward, backward,
the sync and the optimizer update. Stochastic rounding
(``CGX_STOCHASTIC_ROUNDING``) takes a key: ``gradient_sync(key=)``, and
in ``make_train_step(stochastic_seed=)`` step ``i`` rounds with
``fold_in(key(stochastic_seed), i)``, as the JAX package's step does.

Error feedback (``make_train_step(error_feedback=True)``): each rank keeps
a float32 residual a parameter (:class:`ErrorFeedbackState`), adds it to
its divided gradient before the sync and keeps, as the next residual, what
the wire lost of that sum: the sum less its round trip
(``allreduce_tree(..., return_roundtrip=True)``). Exact on the flat SRA
and all-to-all; the Ring's covers its hop 0 and the two-level scheme's its
first quantized stage, the JAX package's approximations.

The nonfinite guard (``CGX_NONFINITE_GUARD`` or ``nonfinite_guard=``):
whether any rank's floating gradients hold NaN or Inf, a 0/1 flag summed
over the whole world, so that every rank takes the same branch. The JAX
step is jitted and selects with ``where``; this eager one branches on the
host (one ``.item()`` a step, only with the guard on; ROADMAP C19): a
fault-free step runs the unguarded path, "skip" runs neither the sync nor
the optimizer, "exact" sums the sanitized gradients uncompressed
(:func:`~.reducers.psum_tree`). The values are the JAX package's.
``COUNTS["nonfinite_steps"]`` counts the bad steps on the world's rank 0.

The other compressors (PowerSGD, top-k) wait (ROADMAP Queue A); the optax
wrapper ``compressed_allreduce_transform`` is not queued.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch
from torch import nn

from .. import config as cfg_mod
from ..ops import fused_producer
from ..utils import prng
from ..utils.device import DeviceLike, resolve_device
from . import group as group_mod
from .allreduce import GroupLike, allreduce_tree, any_compressed, flat_world, refuse_unported
from .mesh import TwoLevelGroup
from .reducers import psum_tree

# The guard's execution counter (the JAX package's ``cgx.nonfinite_steps``).
COUNTS: Dict[str, int] = {"nonfinite_steps": 0}


def reset_counts() -> None:
    COUNTS["nonfinite_steps"] = 0


@dataclasses.dataclass
class ErrorFeedbackState:
    """One rank's residuals of the quantized transport: float32, shaped like
    the parameters, keyed by name. They differ from rank to rank (each is
    what that rank's own contribution lost on the wire), so they are never
    synced; a checkpoint keeps each rank's."""

    e: Dict[str, torch.Tensor]


def init_error_feedback(
    params: Union[nn.Module, Mapping[str, torch.Tensor]],
) -> ErrorFeedbackState:
    """Zero residuals for ``params``: a module's trainable named parameters,
    or a mapping of names to tensors, each on its tensor's device."""
    if isinstance(params, nn.Module):
        items = [(n, p) for n, p in params.named_parameters() if p.requires_grad]
    else:
        items = list(params.items())
    return ErrorFeedbackState(
        e={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in items}
    )


def _ef_sync(grads, e, *, group, key, divisor):
    """The error-feedback sync: ``g_eff = g / divisor + e`` in float32,
    quantized-summed, and the new residual ``g_eff - rt`` against the sync's
    own round trip. Returns ``(reduced_f32, e_new)``."""
    g_eff = {n: g.to(torch.float32) / divisor + e[n] for n, g in grads.items()}
    reduced, rt = allreduce_tree(
        g_eff, group=group, key=key, average=False, return_roundtrip=True
    )
    return reduced, {n: g_eff[n] - rt[n].to(torch.float32) for n in g_eff}


def _guard_policy(explicit: Optional[str]) -> str:
    p = explicit if explicit is not None else cfg_mod.nonfinite_guard()
    if p not in cfg_mod.NONFINITE_POLICIES:
        raise ValueError(f"nonfinite_guard must be one of {cfg_mod.NONFINITE_POLICIES}, got {p!r}")
    return p


def _global_nonfinite(grads: Mapping[str, torch.Tensor], group: GroupLike) -> bool:
    """Whether any rank's floating gradients hold a NaN or Inf: a per-rank
    0/1 float32 flag summed over the whole world (exact, so every rank
    reads the same answer), read on the host."""
    if not grads:
        return False
    world, ws = flat_world(group)
    floats = [g for g in grads.values() if g.is_floating_point()]
    if floats:
        flag = torch.stack([~torch.isfinite(g).all() for g in floats]).any()
    else:
        flag = torch.zeros((), dtype=torch.bool, device=next(iter(grads.values())).device)
    f = flag.to(torch.float32).reshape(1)
    if ws > 1:
        f = group_mod.all_reduce_sum(f, world)
    return bool(f.item() > 0)


def _nonfinite_step(grads, group) -> bool:
    """:func:`_global_nonfinite`, counted once a bad step on the world's
    rank 0."""
    bad = _global_nonfinite(grads, group)
    if bad and group_mod.rank(flat_world(group)[0]) == 0:
        COUNTS["nonfinite_steps"] += 1
    return bad


def _sanitize(t: torch.Tensor) -> torch.Tensor:
    """NaN and Inf zeroed, every finite value's bits kept."""
    if not t.is_floating_point():
        return t
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def _guarded(grads, group, policy: str, divisor: int) -> Dict[str, torch.Tensor]:
    """A bad step's reduced gradients: under "skip" zeros (what the JAX
    package's sync of the zeroed tree gives), under "exact" the exact sum of
    the sanitized gradients divided by ``divisor``, in each gradient's
    dtype."""
    if policy == "skip":
        return {n: torch.zeros_like(g) for n, g in grads.items()}
    exact = psum_tree({n: _sanitize(g) for n, g in grads.items()}, flat_world(group)[0])
    return {n: (v / divisor if divisor > 1 else v).to(grads[n].dtype) for n, v in exact.items()}


def gradient_sync(
    grads: Mapping[str, torch.Tensor],
    *,
    group: GroupLike = None,
    average: bool = True,
    compress_small: bool = False,
    key: Optional[prng.Key] = None,
    nonfinite_guard: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Quantized allreduce of named gradients over a group, or over two
    levels with a ``TwoLevelGroup``. Averaging divides before quantization,
    the reference hook's order. Rounding is stochastic where a layer's
    config says so and ``key`` is given.

    ``nonfinite_guard`` (None: ``CGX_NONFINITE_GUARD``, read on each call):
    on a step where any rank's gradients hold NaN or Inf, "skip" returns
    zeros (for a rollback of the parameters and the optimizer, use
    ``make_train_step``) and "exact" the uncompressed sum of the sanitized
    gradients (averaged if ``average``); each counts the step in
    ``COUNTS["nonfinite_steps"]``. Under ``CGX_SCHEDULE=on`` a flat group's
    SRA runs pipelined (``parallel/schedule.py``), bit-identical to the
    monolithic SRA where it rounds to nearest. Under ``CGX_PLANNER=on`` the
    step planner plans a flat group's SRA slices (``allreduce_tree``);
    ``CGX_MEMLEDGER`` then raises ``NotImplementedError`` before any
    collective (``allreduce.refuse_unported``)."""
    policy = _guard_policy(nonfinite_guard)
    refuse_unported(group, any_compressed(grads, compress_small=compress_small))
    if policy != "off" and _nonfinite_step(grads, group):
        return _guarded(grads, group, policy, flat_world(group)[1] if average else 1)
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
    error_feedback: bool = False,
    ef_state: Optional[ErrorFeedbackState] = None,
    nonfinite_guard: Optional[str] = None,
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
    stochastically under ``CGX_STOCHASTIC_ROUNDING``.

    ``error_feedback=True`` carries this rank's residuals from step to step
    (``ef_state``, else zeros from :func:`init_error_feedback`), as an
    optimizer keeps its state; ``step.ef_state`` holds them. The synced
    float32 gradients are cast back to each parameter's dtype.

    ``nonfinite_guard`` (None: ``CGX_NONFINITE_GUARD``), resolved here, when
    the step is built: on a step where any rank's gradients hold NaN or Inf,
    "skip" keeps the parameters, the optimizer state and the residuals as
    they were, and "exact" applies the update from the uncompressed sum of
    the sanitized gradients (divided by the world size if ``average``) and
    keeps the residuals. A fault-free step is the unguarded one, bit for
    bit.

    ``CGX_SCHEDULE`` and ``CGX_SCHED_CHUNKS`` are read on each call, as
    every knob of the sync is: the step keeps no state built for one
    schedule (the JAX step keys its trace by them). Under
    ``CGX_SCHEDULE=on`` the sync pipelines a flat group's SRA, the error
    feedback round trip included (``with_wire``), and producer fusion
    stages per-block payloads from a ``dw`` it keeps. ``CGX_PLANNER``,
    ``CGX_PLANNER_AVG_BITS`` and ``CGX_PLANNER_MODEL`` are read on each call
    too, and the plan comes from the planner's LRU, which keys the model and
    the plan version (the JAX step keys its trace by
    ``planner.cache_key_component()``; this step keeps no per-build state
    that a plan feeds). Under ``CGX_PLANNER=on`` with ``CGX_MEMLEDGER`` set a
    step whose flat-group sync would plan raises ``NotImplementedError``
    before its forward (``allreduce.refuse_unported``), so no rank enters a
    collective."""
    guard = _guard_policy(nonfinite_guard)
    if ef_state is not None and not error_feedback:
        raise ValueError("make_train_step: ef_state is given but error_feedback is off")
    dev = resolve_device(device)
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    wrong = [n for n, p in params if p.device.type != dev.type]
    if wrong:
        raise ValueError(
            f"make_train_step: parameters {wrong[:3]} are not on {dev}; move the model first"
        )
    world, ws = flat_world(group)
    divisor = ws if average else 1
    if error_feedback and ef_state is None:
        ef_state = init_error_feedback(dict(params))
    fused_producer.deconfigure()  # a rebuilt step drops the previous context
    base = None if stochastic_seed is None else prng.key(stochastic_seed)
    step_idx = [0]

    def step(batch: Any) -> torch.Tensor:
        refuse_unported(group, any_compressed(dict(params)))
        # Producer fusion: the backward of a wrapped dense layer stages its
        # payload for this group. Only a plain group of more than one rank
        # consumes payloads (the two-level scheme never does); a layer
        # whose payload it will consume skips its dw. Error feedback and the
        # nonfinite guard rewrite the gradients before the sync, so the
        # plane is inactive under either, as the JAX package's
        # active=(guard == "off" and not error_feedback ...) is.
        fused_producer.configure(
            group, divisor=divisor,
            active=(not isinstance(group, TwoLevelGroup) and ws > 1
                    and guard == "off" and not error_feedback),
            skip_dw=True,
        )
        fused_producer.begin_step()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, _to_device(batch, dev))
        loss.backward()
        grads = {n: p.grad for n, p in params if p.grad is not None}
        key = None if base is None else prng.fold_in(base, step_idx[0])
        step_idx[0] += 1
        bad = guard != "off" and _nonfinite_step(grads, group)
        if not (bad and guard == "skip"):
            if bad:  # "exact"; the residuals stay as they were
                synced = _guarded(grads, group, guard, divisor)
            elif error_feedback:
                reduced, e_new = _ef_sync(
                    grads, ef_state.e, group=group, key=key, divisor=divisor
                )
                ef_state.e.update(e_new)
                synced = {n: reduced[n].to(g.dtype) for n, g in grads.items()}
            else:
                synced = gradient_sync(
                    grads, group=group, average=average, key=key, nonfinite_guard="off"
                )
            for n, p in params:
                if n in synced:
                    p.grad = synced[n]
            optimizer.step()
        loss = loss.detach()
        if ws > 1:
            loss = group_mod.all_reduce_sum(loss, world) / ws
        return loss

    step.ef_state = ef_state
    return step
