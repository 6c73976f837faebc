"""Gradient allreduce over a mapping of named tensors: per-layer config,
fusion grouping and slicing, dispatch to the reducers.

Counterpart of ``torch_cgx_tpu/parallel/allreduce.py`` for one
data-parallel group: leaves resolve to a per-layer config (name-pattern
registry, else the ``CGX_*`` env default, re-read on every call), large
leaves form standalone groups, the rest group by (config, dtype) and are
concatenated, each group's flat buffer is cut into fusion slices (64 MB by
default) and every slice is reduced. The schedule compiler, the step
planner, producer fusion and the staged-program routes of the JAX package
stay out: off the TPU they are inert at their default settings.

Leaves are taken in the order JAX flattens a nested dict (keys sorted level
by level: ``h_10`` before ``h_2``), so fused groups concatenate in the same
order and carry the same wire bytes as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import torch

from .. import config as cfg_mod
from ..config import CompressionConfig
from ..utils.tree import sorted_items
from . import group as group_mod
from .group import ProcessGroup
from .reducers import quantized_allreduce

_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype in _FLOAT_DTYPES


def is_compressible(t: torch.Tensor, *, compress_small: bool = False) -> bool:
    """Float, at least ``CGX_COMPRESSION_MINIMAL_SIZE`` values, and (unless
    ``compress_small``) of rank > 1."""
    if not _is_float(t):
        return False
    if t.numel() < cfg_mod.minimal_size():
        return False
    if not compress_small and t.dim() <= 1:
        return False
    return True


def resolve_leaf_config(
    path: str, t: torch.Tensor, *, compress_small: bool = False
) -> CompressionConfig:
    """Pattern registry, else the env default; ineligible leaves get
    ``bits=32`` (uncompressed)."""
    cc = cfg_mod.resolve_pattern_config(path) or cfg_mod.default_compression_config()
    if not is_compressible(t, compress_small=compress_small):
        return dataclasses.replace(cc, bits=32)
    return cc


@dataclasses.dataclass(frozen=True)
class _Group:
    cc: CompressionConfig
    dtype: torch.dtype
    indices: Tuple[int, ...]  # positions in the ordered leaf list


def _group_leaves(paths_leaves, compress_small: bool) -> List[_Group]:
    """Standalone groups for leaves of at least
    ``CGX_STANDALONE_LAYER_ELEMS`` values (their flat view needs no
    concatenation), in leaf order; then one group per (config, dtype) in
    order of first appearance."""
    standalone = cfg_mod.standalone_layer_elems()
    groups: Dict[Tuple, List[int]] = {}
    out: List[_Group] = []
    for i, (path, leaf) in enumerate(paths_leaves):
        cc = resolve_leaf_config(path, leaf, compress_small=compress_small)
        if not cc.enabled:
            cc = CompressionConfig(bits=32)
        if leaf.numel() >= standalone:
            out.append(_Group(cc=cc, dtype=leaf.dtype, indices=(i,)))
            continue
        groups.setdefault((cc, leaf.dtype), []).append(i)
    out.extend(_Group(cc=k[0], dtype=k[1], indices=tuple(v)) for k, v in groups.items())
    return out


def _fusion_slices(n: int, elem_size: int) -> List[Tuple[int, int]]:
    """(offset, length) slices of at most ``CGX_FUSION_BUFFER_SIZE_MB``;
    every slice is emitted."""
    cap = cfg_mod.fusion_threshold_elems(elem_size)
    out = []
    off = 0
    while off < n:
        ln = min(cap, n - off)
        out.append((off, ln))
        off += ln
    return out


def allreduce_flat(
    flat: torch.Tensor,
    cc: CompressionConfig,
    *,
    group: ProcessGroup = None,
) -> torch.Tensor:
    """Allreduce one flat buffer, fusion slice by fusion slice."""
    ws = group_mod.world_size(group)
    red = cfg_mod.intra_reduction()
    pieces = [
        quantized_allreduce(flat[off : off + ln], group, ws, cc, red)
        for off, ln in _fusion_slices(flat.shape[0], flat.element_size())
    ]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def allreduce_tree(
    tree: Mapping[str, torch.Tensor],
    *,
    group: ProcessGroup = None,
    average: bool = False,
    compress_small: bool = False,
) -> Dict[str, torch.Tensor]:
    """Quantized allreduce of named gradients -> a dict with the same keys.

    ``average=True`` divides by the world size before quantization, the
    reference hook's order."""
    ws = group_mod.world_size(group)
    paths_leaves = sorted_items(tree)
    leaves = [t for _, t in paths_leaves]
    if average and ws > 1:
        leaves = [t / ws if _is_float(t) else t for t in leaves]
    out: Dict[str, torch.Tensor] = {}
    for g in _group_leaves(paths_leaves, compress_small):
        members = [leaves[i] for i in g.indices]
        fused = (
            torch.cat([t.reshape(-1) for t in members])
            if len(members) > 1
            else members[0].reshape(-1)
        )
        if g.cc.enabled:
            reduced = allreduce_flat(fused, g.cc, group=group)
        elif ws > 1:
            reduced = group_mod.all_reduce_sum(fused, group)
        else:
            reduced = fused
        off = 0
        for i, t in zip(g.indices, members):
            n = t.numel()
            out[paths_leaves[i][0]] = reduced[off : off + n].view(t.shape)
            off += n
    return out
