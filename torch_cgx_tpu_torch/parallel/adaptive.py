"""Per-layer bit allocation under an average-bits budget.

Counterpart of ``torch_cgx_tpu/parallel/adaptive.py`` over a mapping of
named gradient tensors:

* :func:`measure_layer_stats`: each eligible layer's element count and the
  mean squared range of its buckets, in one host pass;
* :func:`solve_bit_allocation`: the bits that minimize the summed max-min
  quantization error ``E_l(b) = numel_l * mean_range_l^2 / (12 (2^b-1)^2)``
  under ``sum(numel * bits) <= avg_bits * sum(numel)``, by greedy
  marginal-gain ascent (the error is convex and decreasing in the bits);
  the step planner's ``CGX_PLANNER_AVG_BITS`` solve calls it with unit
  ranges;
* :func:`apply_bit_allocation`: the result written into the name-pattern
  registry that ``allreduce.resolve_leaf_config`` reads, which bumps the
  registry's version, so the layout and plan caches miss on the next call.

Layers the eligibility rules exclude (rank <= 1, fewer than
``CGX_COMPRESSION_MINIMAL_SIZE`` values, not floating point) are skipped:
their wire is exact.
"""

from __future__ import annotations

import dataclasses
import heapq
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import config as cfg_mod
from ..utils.tree import sorted_items
from .allreduce import is_compressible, resolve_leaf_config


@dataclasses.dataclass(frozen=True)
class LayerStat:
    """One layer's quantization-error ingredients: its element count, the
    mean squared range of its buckets, and the resolved config the
    measurement used (the solver replaces only the bits)."""

    numel: int
    mean_sq_range: float
    cc: Optional[cfg_mod.CompressionConfig] = None


def measure_layer_stats(
    grads: Mapping[str, torch.Tensor],
    *,
    bucket_size: Optional[int] = None,
    compress_small: bool = False,
) -> Dict[str, LayerStat]:
    """One host pass over named gradients -> a ``LayerStat`` per eligible
    layer. Eligibility is structural, not gated on compression being on
    already: turning it on is what an allocation does. ``bucket_size``
    defaults to each layer's resolved config. The ranges are taken in
    float64, the last bucket edge-padded, as the JAX package does."""
    out: Dict[str, LayerStat] = {}
    for path, leaf in sorted_items(grads):
        if not is_compressible(leaf, compress_small=compress_small):
            continue
        cc = resolve_leaf_config(path, leaf, compress_small=compress_small)
        b = bucket_size or cc.bucket_size
        x = leaf.detach().to("cpu", torch.float64).reshape(-1).numpy()
        n = x.size
        nb = -(-n // b)
        pad = nb * b - n
        if pad:
            x = np.concatenate([x, np.repeat(x[-1], pad)])
        rows = x.reshape(nb, b)
        rng = rows.max(axis=1) - rows.min(axis=1)
        out[path] = LayerStat(
            numel=n,
            mean_sq_range=float(np.mean(rng**2)),
            cc=dataclasses.replace(cc, bucket_size=b),
        )
    return out


def _err(stat: LayerStat, bits: int) -> float:
    """Expected max-min quantization error at ``bits`` (a uniform error of
    unit^2 / 12 a value, unit = range / (2^bits - 1))."""
    return stat.numel * stat.mean_sq_range / (12.0 * (2**bits - 1) ** 2)


def solve_bit_allocation(
    stats: Mapping[str, LayerStat],
    avg_bits: float,
    *,
    bits_range: Tuple[int, int] = (2, 8),
) -> Dict[str, int]:
    """Per-layer bits minimizing the summed expected error under
    ``sum(numel * bits) <= avg_bits * sum(numel)``: from the floor, one more
    bit at a time to the layer with the best error reduction per payload
    bit (ties to the smaller path), skipping a layer that no longer fits.
    Exact for layers of equal size; the knapsack-greedy approximation
    otherwise."""
    lo, hi = bits_range
    if not 1 <= lo <= hi <= 8:
        raise ValueError(f"bits_range must satisfy 1 <= lo <= hi <= 8, got {bits_range}")
    if avg_bits < lo:
        raise ValueError(
            f"avg_bits={avg_bits} is below the bits_range floor {lo}: even "
            "the minimum allocation would exceed the budget"
        )
    total = sum(s.numel for s in stats.values())
    if not total:
        return {}
    budget = avg_bits * total
    alloc = {path: lo for path in stats}
    spent = lo * total
    heap = []  # a max-heap on the marginal gain a bit-element
    for path, s in stats.items():
        if lo < hi:
            gain = (_err(s, lo) - _err(s, lo + 1)) / s.numel
            heapq.heappush(heap, (-gain, path))
    while heap:
        _, path = heapq.heappop(heap)
        s = stats[path]
        if spent + s.numel > budget:
            continue  # this layer no longer fits; a smaller one may
        alloc[path] += 1
        spent += s.numel
        b = alloc[path]
        if b < hi:
            gain = (_err(s, b) - _err(s, b + 1)) / s.numel
            heapq.heappush(heap, (-gain, path))
    return alloc


def apply_bit_allocation(
    alloc: Mapping[str, int],
    stats: Mapping[str, LayerStat],
    *,
    bucket_size: Optional[int] = None,
) -> None:
    """Write an allocation into the name-pattern registry, one exact-path
    pattern a layer. Each layer keeps the config it was measured with
    (bucket size, stochastic rounding, the skip mode) and only its bits
    change; each write bumps the registry's version."""
    for path, bits in alloc.items():
        base = stats[path].cc or cfg_mod.default_compression_config()
        cfg_mod.set_layer_pattern_config(
            "^" + re.escape(path) + "$",
            dataclasses.replace(
                base,
                bits=int(bits),
                bucket_size=int(bucket_size or base.bucket_size),
            ),
        )


def adapt_bits(
    grads: Mapping[str, torch.Tensor],
    avg_bits: float,
    *,
    bits_range: Tuple[int, int] = (2, 8),
    bucket_size: Optional[int] = None,
    compress_small: bool = False,
) -> Dict[str, int]:
    """Measure, solve and apply in one call; returns the allocation. Call
    it between steps every few hundred steps on a recent gradient snapshot
    (the bucket ranges drift slowly): the next step's sync reads the new
    bits."""
    stats = measure_layer_stats(grads, bucket_size=bucket_size, compress_small=compress_small)
    alloc = solve_bit_allocation(stats, avg_bits, bits_range=bits_range)
    apply_bit_allocation(alloc, stats, bucket_size=bucket_size)
    return alloc
