"""The two-level (cross x intra) process-group layout.

Counterpart of ``torch_cgx_tpu/parallel/mesh.py``'s ``hierarchical_mesh``:
the JAX package reshapes its devices into a ``(cross, intra)`` mesh; here
every rank forms the intra and cross subgroups of that layout. Rank ``r``
sits at cross index ``r // intra`` and intra index ``r % intra``: the intra
groups are consecutive ranks (the node-local level, NVLink), the cross
groups the ranks at one intra index (the cross-node level).
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Optional

import torch.distributed as dist

from ..utils import env as _env
from .group import ProcessGroup

LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"  # set by torchrun: ranks on this node


@dataclasses.dataclass(frozen=True)
class TwoLevelGroup:
    """The intra and cross subgroups of one rank, with their sizes, and the
    world group they tile (``None``: the default group)."""

    intra: ProcessGroup
    intra_size: int
    cross: ProcessGroup
    cross_size: int
    world: ProcessGroup = None

    @property
    def size(self) -> int:
        return self.intra_size * self.cross_size


def _pow2_div(n: int) -> int:
    p = 1
    while p * 2 <= min(n, 8) and n % (p * 2) == 0:
        p *= 2
    return p


def hierarchical_groups(
    intra_size: Optional[int] = None, *, timeout: Optional[timedelta] = None
) -> TwoLevelGroup:
    """Form the ``(cross, intra)`` subgroups of the default group.
    ``intra_size`` defaults to ``LOCAL_WORLD_SIZE`` when it divides the
    world, else to the largest power-of-two divisor of the world up to 8.
    Collective: every rank calls it, and every rank creates every subgroup
    in the same order."""
    if not dist.is_available() or not dist.is_initialized():
        return TwoLevelGroup(intra=None, intra_size=1, cross=None, cross_size=1)
    ws, me = dist.get_world_size(), dist.get_rank()
    if intra_size is None:
        local = _env.get_int_env_or_default(LOCAL_WORLD_SIZE, 0)
        intra_size = local if 0 < local <= ws and ws % local == 0 else _pow2_div(ws)
    if intra_size < 1 or ws % intra_size:
        raise ValueError(f"world size {ws} is not divisible by intra_size={intra_size}")
    n_cross = ws // intra_size
    intra = cross = None
    for c in range(n_cross):
        ranks = list(range(c * intra_size, (c + 1) * intra_size))
        g = dist.new_group(ranks, timeout=timeout)
        if me in ranks:
            intra = g
    for i in range(intra_size):
        ranks = [c * intra_size + i for c in range(n_cross)]
        g = dist.new_group(ranks, timeout=timeout)
        if me in ranks:
            cross = g
    return TwoLevelGroup(
        intra=intra, intra_size=intra_size, cross=cross, cross_size=n_cross,
        world=dist.group.WORLD,
    )
