"""Gradient allreduce over a mapping of named tensors: per-layer config,
fusion grouping and slicing, dispatch to the reducers.

Counterpart of ``torch_cgx_tpu/parallel/allreduce.py`` over one
data-parallel group or a :class:`~.mesh.TwoLevelGroup` (the JAX package's
two mesh axes): leaves resolve to a per-layer config (name-pattern
registry, else the ``CGX_*`` env default, re-read on every call), large
leaves form standalone groups, the rest group by (config, dtype) and are
concatenated, each group's flat buffer is cut into fusion slices (64 MB by
default) and every slice is reduced, over two levels by
``hierarchical_allreduce``. A standalone group whose gradient the
backward already quantized (``ops/fused_producer.py``, producer fusion)
hands that payload to the multi-rank SRA in place of its own quantize.
Under ``CGX_SCHEDULE=on`` a flat group's SRA runs each fusion slice as the
column-block pipeline of ``parallel/schedule.py`` and the groups are
reduced in reverse order, each keeping its own key. Under
``CGX_PLANNER=on`` the step planner (``parallel/planner.py``) plans a flat
group's SRA slices: each its own depth and, under ``CGX_PLANNER_AVG_BITS``,
its own bits, and the groups in the plan's order. The staged-program routes
of the JAX package stay out: off the TPU they are inert at their default
settings. ``CGX_XLA_ALLREDUCE`` is not read: under "on" the JAX router changes the
result only for a group whose processes each hold several devices, and a
rank of the port holds one.

The grouping of a tree (its groups, their members' offsets and their fusion
slices) is a function of the leaves' names, shapes and dtypes and of the
knobs and registry it reads; it is kept in a bounded LRU
(:func:`layout_cache_stats`, :func:`invalidate_layout_cache`).

Leaves are taken in the order JAX flattens a nested dict (keys sorted level
by level: ``h_10`` before ``h_2``), so fused groups concatenate in the same
order and carry the same wire bytes as the reference.

``return_roundtrip=True`` (error feedback) also returns what the peers
decode from this rank's contribution, through the same layout: the flat
reducers' ``*_with_wire`` variants, the two-level scheme's stage-1 mirror
(:func:`_stage1_roundtrip_piece`), and the input itself where the wire is
exact (uncompressed groups, the fake ratio's tail).
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from .. import config as cfg_mod
from ..config import CompressionConfig
from ..ops import fused_producer
from ..utils import prng
from ..utils.tree import sorted_items
from . import group as group_mod
from . import planner as planner_mod
from . import schedule as sched_mod
from .group import ProcessGroup
from .mesh import TwoLevelGroup
from .reducers import (
    _ring_hop0_wire,
    alltoall_stage1_wire,
    hierarchical_allreduce,
    quantized_allreduce,
    quantized_allreduce_with_wire,
    sra_stage1_wire,
)

GroupLike = Union[ProcessGroup, TwoLevelGroup]

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


def flat_world(group: GroupLike) -> Tuple[ProcessGroup, int]:
    """The flat group ``group`` spans and its size."""
    if isinstance(group, TwoLevelGroup):
        return group.world, group.size
    return group, group_mod.world_size(group)


def refuse_unported(group: GroupLike, compressed: bool) -> None:
    """Raise ``NotImplementedError`` (``config.refuse_memledger``) where the
    step planner would plan a flat group of more than one rank reducing
    ``compressed`` values by an SRA under ``CGX_MEMLEDGER``. Every rank
    reaches the same verdict from the same knobs and layout, before any
    collective. A ``TwoLevelGroup`` runs as it would unset: the JAX package
    consults the planner only on one-axis calls."""
    if not compressed or isinstance(group, TwoLevelGroup) or cfg_mod.dummy_compression():
        return
    if group_mod.world_size(group) > 1 and cfg_mod.intra_reduction() == cfg_mod.REDUCTION_SRA:
        cfg_mod.refuse_memledger()


# ---------------------------------------------------------------------------
# The layout cache: a tree's grouping, kept per (leaves, knobs, registry).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _GroupLayout:
    """One fused group's plan: its members (positions in the ordered leaf
    list), their offsets in the fused buffer, and its fusion slices."""

    cc: CompressionConfig
    dtype: torch.dtype
    indices: Tuple[int, ...]
    offsets: Tuple[int, ...]
    fused_n: int
    slices: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class _TreeLayout:
    groups: Tuple[_GroupLayout, ...]


_LAYOUT_CACHE: "OrderedDict" = OrderedDict()
_LAYOUT_CACHE_MAX = 64
_LAYOUT_STATS = {"hits": 0, "misses": 0, "invalidations": 0}


def layout_cache_stats() -> Dict[str, int]:
    """A copy of the cache's hits, misses and invalidations."""
    return dict(_LAYOUT_STATS)


def layout_cache_clear() -> None:
    _LAYOUT_CACHE.clear()
    _LAYOUT_STATS.update(hits=0, misses=0)


def invalidate_layout_cache() -> None:
    """Drop every cached layout and, with them, every compiled schedule
    (``schedule.invalidate_schedule_cache``) and every step plan
    (``planner.invalidate_plan_cache``): all were derived for one world,
    and a schedule of another would frame its blocks differently from its
    peers'. Counted in :func:`layout_cache_stats`."""
    layout_cache_clear()
    _LAYOUT_STATS["invalidations"] += 1
    sched_mod.invalidate_schedule_cache()
    planner_mod.invalidate_plan_cache()


def _layout_key(paths_leaves, compress_small: bool) -> Tuple:
    """Everything the grouping reads: the leaves' names, shapes and dtypes
    in order, ``compress_small``, the registry's version (the pattern
    configs), the env default config and the size thresholds."""
    return (
        tuple((p, tuple(t.shape), t.dtype) for p, t in paths_leaves),
        bool(compress_small),
        cfg_mod.registry_version(),
        cfg_mod.default_compression_config(),
        cfg_mod.minimal_size(),
        cfg_mod.standalone_layer_elems(),
        cfg_mod.fusion_threshold_elems(1),
    )


def _tree_layout(paths_leaves, compress_small: bool) -> _TreeLayout:
    key = _layout_key(paths_leaves, compress_small)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        _LAYOUT_CACHE.move_to_end(key)
        _LAYOUT_STATS["hits"] += 1
        return hit
    _LAYOUT_STATS["misses"] += 1
    groups = []
    for g in _group_leaves(paths_leaves, compress_small):
        offsets, off = [], 0
        for i in g.indices:
            offsets.append(off)
            off += paths_leaves[i][1].numel()
        elem = torch.empty((), dtype=g.dtype).element_size()
        groups.append(_GroupLayout(
            cc=g.cc, dtype=g.dtype, indices=g.indices, offsets=tuple(offsets), fused_n=off,
            slices=tuple(_fusion_slices(off, elem)),
        ))
    layout = _TreeLayout(groups=tuple(groups))
    _LAYOUT_CACHE[key] = layout
    if len(_LAYOUT_CACHE) > _LAYOUT_CACHE_MAX:
        _LAYOUT_CACHE.popitem(last=False)
    return layout


def any_compressed(tree: Mapping[str, torch.Tensor], *, compress_small: bool = False) -> bool:
    """Whether ``allreduce_tree`` would reduce any leaf of ``tree``
    compressed."""
    return any(resolve_leaf_config(p, t, compress_small=compress_small).enabled
               for p, t in tree.items())


def allreduce_flat(
    flat: torch.Tensor,
    cc: CompressionConfig,
    *,
    group: GroupLike = None,
    pre=None,
    key: Optional[prng.Key] = None,
    return_roundtrip: bool = False,
    slices: Optional[Sequence[Tuple[int, int]]] = None,
    plan: Optional[Sequence[planner_mod.SliceDecision]] = None,
):
    """Allreduce one flat buffer, fusion slice by fusion slice: over a
    :class:`TwoLevelGroup` with the env's two-level scheme
    (``topology_from_env``), over a plain group with its reduction type
    (``intra_reduction``). ``pre``: the producer-staged stage-1 payload of
    ``flat`` (``fused_producer.Produced``), consumed and marked ``consumed``
    where ``fused_producer.consume_reason`` (the predicate ``allreduce_tree``
    applies) holds for this buffer, else ignored and the fallback counted.
    Under ``CGX_COMPRESSION_FAKE_RATIO`` a compressed buffer reduces only its
    leading ``ceil(ratio * n)`` values; the tail comes back un-reduced, as
    in the JAX package. ``key``: stochastic rounding where ``cc.stochastic``,
    the slice at offset ``off`` with ``fold_in(key, off)``.

    ``return_roundtrip=True`` returns ``(reduced, rt)``, ``rt`` this rank's
    wire round trip slice by slice: the flat reducers' own payload
    (``quantized_allreduce_with_wire``), the two-level stage-1 mirror
    (:func:`_stage1_roundtrip_piece`), the fake ratio's tail as it is.

    Under ``CGX_SCHEDULE=on`` each slice of a flat group's SRA whose rows
    sustain two column blocks runs the pipelined SRA
    (``schedule.pipelined_quantized_allreduce``); a producer-staged payload
    is consumed there only if it was quantized per block against the same
    table (``consume_reason``: else "plan"). ``slices``: the buffer's
    fusion slices where the caller has them (the layout cache); the fake
    ratio's shaped prefix recomputes them.

    ``plan``: the step planner's decisions for ``slices`` on a flat group
    (``allreduce_tree`` hands a group's in): each slice runs at its
    decision's depth (``schedule.compiled_schedule(chunks=)``) and bits. A
    producer-staged payload of a slice whose bits the plan moved falls back
    (``plan``). None: the knobs decide, as unplanned."""
    if isinstance(group, TwoLevelGroup):
        plan = None  # the JAX package plans one-axis calls only
    if pre is not None:
        reason = fused_producer.consume_reason(
            pre.key, cc=cc, ws=flat_world(group)[1], divisor=pre.divisor, n=flat.shape[0],
            elem_size=flat.element_size(), group=group, table=pre.table,
            plan=plan[0] if plan else None,
        )
        if reason:
            fused_producer.fallback(reason)
            pre = None
        else:
            pre.consumed = True
            fused_producer.count("producer_consumed_slices")
    ratio = cfg_mod.fake_ratio()
    tail = None
    if ratio is not None and cc.enabled and flat.shape[0] > 1:
        m = max(1, math.ceil(ratio * flat.shape[0]))
        flat, tail = flat[:m], flat[m:]
        slices = plan = None  # the plan was solved for the unshaped slices
    if slices is None:
        slices = _fusion_slices(flat.shape[0], flat.element_size())

    def slice_key(off: int) -> Optional[prng.Key]:
        return None if key is None else prng.fold_in(key, off)

    pieces, rt_pieces = [], []
    if isinstance(group, TwoLevelGroup):
        topo = cfg_mod.topology_from_env()
        for off, ln in slices:
            piece, k = flat[off : off + ln], slice_key(off)
            pieces.append(hierarchical_allreduce(piece, group, cc, topo, key=k))
            if return_roundtrip:
                rt_pieces.append(_stage1_roundtrip_piece(piece, cc, group, topo, k))
    else:
        ws, red = group_mod.world_size(group), cfg_mod.intra_reduction()
        for si, (off, ln) in enumerate(slices):
            piece, k = flat[off : off + ln], slice_key(off)
            dec = plan[si] if plan is not None and si < len(plan) else None
            cc_s = planned_config(cc, dec)
            sched = sched_mod.compiled_schedule(
                ln, ws, cc_s, reduction=red, chunks=dec.chunks if dec is not None else None
            )
            if sched is not None:
                out = sched_mod.pipelined_quantized_allreduce(
                    piece, group, ws, cc_s, red, k, sched, with_wire=return_roundtrip, pre=pre
                )
            elif return_roundtrip:
                out = quantized_allreduce_with_wire(piece, group, ws, cc_s, red, pre, key=k)
            else:
                out = quantized_allreduce(piece, group, ws, cc_s, red, pre, key=k)
            if return_roundtrip:
                out, rt = out
                rt_pieces.append(rt)
            pieces.append(out)
    if tail is not None:
        pieces.append(tail)
        rt_pieces.append(tail)  # never travels: exact
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    if not return_roundtrip:
        return out
    return out, rt_pieces[0] if len(rt_pieces) == 1 else torch.cat(rt_pieces)


def planned_config(cc: CompressionConfig, dec) -> CompressionConfig:
    """A slice's config under the step planner's decision ``dec`` (None:
    ``cc``): the decision's bits where it moved a compressed slice's width
    (``CGX_PLANNER_AVG_BITS``), else ``cc`` itself."""
    if dec is not None and cc.enabled and 1 <= dec.bits <= cfg_mod.MAX_BITS and dec.bits != cc.bits:
        return dataclasses.replace(cc, bits=dec.bits)
    return cc


def _roundtrip_wire_1axis(
    piece: torch.Tensor,
    cc: CompressionConfig,
    group: ProcessGroup,
    ws: int,
    red: str,
    key: Optional[prng.Key],
    leader_rs: bool = False,
) -> torch.Tensor:
    """What this rank's contribution to one level's reduction (of ``ws`` >
    1 ranks) decodes to on the wire: a mirror of ``quantized_allreduce``'s
    stage-1 layout and keys (with ``leader_rs``, of
    ``reduce_scatter_quantized``'s, an SRA stage 1 whatever the level's
    reduction type)."""
    if not cc.enabled:
        return piece
    if leader_rs:
        red = cfg_mod.REDUCTION_SRA
    if red == cfg_mod.REDUCTION_PSUM:
        return piece
    if red == cfg_mod.REDUCTION_ALLTOALL:
        return alltoall_stage1_wire(piece, group, cc, key)
    if red == cfg_mod.REDUCTION_RING:
        return _ring_hop0_wire(piece, group, ws, cc, key)
    return sra_stage1_wire(piece, group, ws, cc, key)


def _stage1_roundtrip_piece(
    piece: torch.Tensor,
    cc: CompressionConfig,
    groups: TwoLevelGroup,
    topo: cfg_mod.TopologyConfig,
    key: Optional[prng.Key],
) -> torch.Tensor:
    """One two-level fusion slice's round trip, following
    ``hierarchical_allreduce``'s decision tree with its per-level configs
    and keys (``fold_in(key, 3)`` intra, ``fold_in(key, 5)`` cross). Only
    the first quantized stage is attributed to this rank: under the leader
    scheme the intra reduce-scatter, and nothing (``rt = piece``) when the
    intra level is uncompressed, since the cross stage then quantizes a
    chunk the node shares (the JAX package's approximation)."""
    if cfg_mod.dummy_compression():
        return piece
    wi, wc = groups.intra_size, groups.cross_size
    ki = prng.fold_in(key, 3) if key is not None else None
    kc = prng.fold_in(key, 5) if key is not None else None
    intra_cc = cc if topo.intra_compress else CompressionConfig(bits=32)
    cross_cc = cc if topo.cross_compress else CompressionConfig(bits=32)
    if wi == 1 and wc == 1:
        return piece
    if wi == 1:
        return _roundtrip_wire_1axis(piece, cross_cc, groups.cross, wc, topo.cross_reduction, kc)
    if wc == 1 or not topo.intra_broadcast:
        return _roundtrip_wire_1axis(piece, intra_cc, groups.intra, wi, topo.intra_reduction, ki)
    if not intra_cc.enabled:
        return piece
    return _roundtrip_wire_1axis(
        piece, intra_cc, groups.intra, wi, topo.intra_reduction, ki, leader_rs=True
    )


def allreduce_tree(
    tree: Mapping[str, torch.Tensor],
    *,
    group: GroupLike = None,
    average: bool = False,
    compress_small: bool = False,
    key: Optional[prng.Key] = None,
    return_roundtrip: bool = False,
):
    """Quantized allreduce of named gradients -> a dict with the same keys.
    ``key``: stochastic rounding where a group's config says so, group
    ``gi`` (in :func:`_group_leaves` order) with ``fold_in(key, gi)``.
    ``return_roundtrip=True`` returns ``(reduced, rt)``, ``rt`` a dict of
    this rank's contributions as the wire decodes them (``allreduce_flat``'s
    round trip over the same layout; an uncompressed group's is its input):
    the error-feedback residual's base.

    ``average=True`` divides by the world size before quantization, the
    reference hook's order. Uncompressed groups sum exactly over the whole
    world. A standalone compressed gradient that the backward already
    quantized (producer fusion) is matched in the stash by its original
    tensor, before the division, and handed to :func:`allreduce_flat` as
    ``pre`` where ``fused_producer.consume_reason`` allows. A layer whose
    backward skipped its weight gradient (``make_train_step``) has no
    tensor: it is taken from the stash by name, its payload (already
    divided) must be consumed, and its averaged gradient is returned under
    its name; that it cannot be is a ``RuntimeError``. The stash is drained
    after the sweep. The grouping comes from the layout cache. Under
    ``CGX_SCHEDULE=on`` the groups are reduced last first
    (``schedule.dispatch_order``), each keyed with its own index ``gi``, so
    the order changes no byte. Under ``CGX_PLANNER=on`` a flat group's
    layout is planned (``planner.plan_for_layout``, from its LRU): the
    groups go in the plan's order and each group's fusion slices take their
    decisions (:func:`allreduce_flat`'s ``plan``). ``CGX_MEMLEDGER`` under
    the planner raises ``NotImplementedError`` before any collective
    (:func:`refuse_unported`)."""
    world, ws = flat_world(group)
    skipped = fused_producer.skipped_entries()
    if skipped:
        given = sorted(set(skipped) & set(tree))
        if given:
            raise RuntimeError(
                f"producer fusion skipped the weight gradients of {given}, "
                f"but the tree holds gradients under those names"
            )
        tree = {**tree, **{n: fused_producer.placeholder(e) for n, e in skipped.items()}}
    paths_leaves = sorted_items(tree)
    leaves = [t for _, t in paths_leaves]
    div = ws if average and ws > 1 else 1
    if div > 1:
        leaves = [
            t / ws if _is_float(t) and path not in skipped else t
            for (path, _), t in zip(paths_leaves, leaves)
        ]
    fp = None
    if (
        not isinstance(group, TwoLevelGroup)
        and fused_producer.engaged()
        and fused_producer.stash_size()
    ):
        fp = fused_producer
    groups = _tree_layout(paths_leaves, compress_small).groups
    refuse_unported(group, any(g.cc.enabled for g in groups))
    plan = None
    if not isinstance(group, TwoLevelGroup) and planner_mod.engaged():
        plan = planner_mod.plan_for_layout(groups, ws, reduction=cfg_mod.intra_reduction())
    out: Dict[str, torch.Tensor] = {}
    rt_out: Dict[str, torch.Tensor] = {}
    if plan is not None:
        order = plan.order
    elif sched_mod.engaged():
        order = sched_mod.dispatch_order(len(groups))
    else:
        order = range(len(groups))
    for gi in order:
        g = groups[gi]
        g_plan = plan.decisions[gi] if plan is not None else None
        pre = None
        path, leaf = paths_leaves[g.indices[0]]
        if len(g.indices) == 1 and (path in skipped or (fp is not None and g.cc.enabled)):
            ent = skipped[path] if path in skipped else fp.lookup(path, leaf)
            if ent is not None:
                reason = fused_producer.consume_reason(
                    ent.key, cc=g.cc, ws=ws, divisor=div, n=leaf.numel(),
                    elem_size=leaf.element_size(), group=group, table=ent.table,
                    plan=g_plan[0] if g_plan else None,
                )
                if not reason:
                    pre = ent
                elif ent.skipped:
                    raise RuntimeError(
                        f"producer fusion skipped the weight gradient of {path!r}, but the "
                        f"allreduce cannot consume its payload ({reason})"
                    )
                else:
                    fused_producer.fallback(reason)
        elif any(paths_leaves[i][0] in skipped for i in g.indices):
            raise RuntimeError(
                f"producer fusion skipped the weight gradient of "
                f"{[paths_leaves[i][0] for i in g.indices if paths_leaves[i][0] in skipped]}, "
                f"but it landed in a fused group"
            )
        members = [leaves[i] for i in g.indices]
        fused = (
            torch.cat([t.reshape(-1) for t in members])
            if len(members) > 1
            else members[0].reshape(-1)
        )
        rt_flat = fused  # an uncompressed group's wire is exact
        if g.cc.enabled:
            reduced = allreduce_flat(
                fused, g.cc, group=group, pre=pre,
                key=None if key is None else prng.fold_in(key, gi),
                return_roundtrip=return_roundtrip, slices=g.slices, plan=g_plan,
            )
            if return_roundtrip:
                reduced, rt_flat = reduced
            if pre is not None and pre.consumed:
                fused_producer.claim(pre.name)
        elif ws > 1:
            reduced = group_mod.all_reduce_sum(fused, world)
        else:
            reduced = fused
        for i, t, off in zip(g.indices, members, g.offsets):
            n = t.numel()
            out[paths_leaves[i][0]] = reduced[off : off + n].view(t.shape)
            if return_roundtrip:
                rt_out[paths_leaves[i][0]] = rt_flat[off : off + n].view(t.shape)
    if fp is not None or skipped:
        fused_producer.drain()
    # The keys in group order, whatever order the groups ran in.
    names = [paths_leaves[i][0] for g in groups for i in g.indices]
    out = {p: out[p] for p in names}
    if not return_roundtrip:
        return out
    return out, {p: rt_out[p] for p in names}
