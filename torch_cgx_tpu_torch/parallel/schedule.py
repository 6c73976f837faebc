"""The column-block pipelined SRA (``CGX_SCHEDULE=on``).

Counterpart of ``torch_cgx_tpu/parallel/schedule.py`` on the eager plane.
A fusion slice's SRA wire layout is the ``(ws, chunk)`` matrix whose row r
is rank r's owned span. The schedule splits it into column blocks and runs
each block's quantize -> all-to-all -> epilogue -> all-gather -> decode in
software-pipeline order: block c+1 is quantized and its all-to-all posted
(``async_op=True``) before block c's epilogue, all-gather and decode run,
so block c+1 is on the wire while block c's epilogue runs.

The bit-equality contract is the JAX package's: blocks are column blocks,
not contiguous spans of the buffer, so row r stays owned by rank r in every
block (the own-row-raw rule keys off the row index), and block widths are
multiples of ``lcm(bucket_size, 32)``, so every bucket boundary within a
row stays on the monolithic layout's grid. The fold is the dispatcher's
ascending ``ordered_rowsum`` in both forms, so a deterministic pipelined
SRA equals the monolithic SRA bit for bit on any payload. Stochastic
rounding keys block c with ``fold_in(key, c)``, then the phase keys as in
the monolithic SRA, so its bytes differ from the monolithic ones, as they
differ between any two fusion layouts.

Each block's rows are copied into a contiguous ``(ws, w)`` buffer before
its quantize (:data:`COUNTS` ``block_copies``); the kernels read them
there. The decoded blocks are copied back side by side into the slice's
``(ws, chunk)`` rows once a slice (``join_copies``; twice under
``with_wire``). Plans come from a bounded LRU keyed by what the table
reads: the slice's length, the world size, the config and the depth
(:func:`compiled_schedule`), cleared together with the layout cache
(``allreduce.invalidate_layout_cache``).

The step planner (``parallel/planner.py``) hands each slice its own depth
(``compiled_schedule(chunks=)``), which replaces ``CGX_SCHED_CHUNKS`` and
the mode gate.

Where this differs from the JAX package: "auto" never engages (the JAX
package engages it only on the staged in-XLA plane of a real TPU, which the
port does not have), and the JAX trace-time metrics are the counters of
:data:`COUNTS`.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from .. import config as cfg_mod
from ..config import CompressionConfig
from ..ops import codec
from ..utils import prng
from . import group as group_mod
from . import reducers
from .group import ProcessGroup

Table = Tuple[Tuple[int, int], ...]  # (column offset, column width) per block

# Pipelined slices, blocks run, block copies made and slices joined back
# (the JAX package's ``cgx.sched.*`` metrics).
COUNTS: Dict[str, int] = {}


def reset_counts() -> None:
    COUNTS.update(pipelined_slices=0, blocks=0, block_copies=0, join_copies=0)


reset_counts()


def chunk_alignment(bucket_size: int) -> int:
    """Column-width alignment of the block boundaries:
    ``lcm(bucket_size, 32)``, so that every block starts a bucket."""
    return math.lcm(max(1, bucket_size), codec.LANE_GROUP)


def chunk_table(width: int, chunks: int, bucket_size: int) -> Table:
    """The (column offset, column width) plan over one row of ``width``
    values at a target depth of ``chunks``: every boundary a multiple of
    :func:`chunk_alignment`, the last block taking the remainder. A row too
    narrow for the depth gets fewer blocks, down to ``((0, width),)``."""
    if width <= 0:
        return ((0, max(width, 0)),) if width else ()
    align = chunk_alignment(bucket_size)
    chunks = max(1, int(chunks))
    units = width // align
    depth = min(chunks, units) if units else 1
    if depth <= 1:
        return ((0, width),)
    per = (units // depth) * align
    out = []
    off = 0
    for _ in range(depth - 1):
        out.append((off, per))
        off += per
    out.append((off, width - off))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CompiledSchedule:
    """One fusion slice's pipeline plan: ``table`` over the per-rank row of
    ``chunk`` values (``reducers.chunk_layout(n, ws)[0]``)."""

    table: Table
    n: int
    ws: int
    chunk: int
    cc: CompressionConfig

    @property
    def depth(self) -> int:
        return len(self.table)


_SCHED_CACHE: "OrderedDict" = OrderedDict()
_SCHED_CACHE_MAX = 128
_SCHED_STATS = {"hits": 0, "misses": 0}
# The cached "no pipeline for this key": a stored None would read as a miss.
_NO_SCHEDULE = object()


def schedule_cache_stats() -> Dict[str, int]:
    return dict(_SCHED_STATS)


def invalidate_schedule_cache() -> None:
    """Drop every plan (``allreduce.invalidate_layout_cache`` calls it): a
    plan of another world would frame the blocks differently from its
    peers' fresh plans."""
    _SCHED_CACHE.clear()
    _SCHED_STATS.update(hits=0, misses=0)


def _schedule_key(n, ws, cc, chunks) -> Tuple:
    """What the table reads: neither the dtype nor the card changes it, so
    the producer's lookup and the sync's share one entry."""
    return (int(n), int(ws), cc, int(chunks))


def engaged() -> bool:
    """Whether the schedule may pipeline at all: ``CGX_SCHEDULE=on``."""
    return cfg_mod.schedule_mode() == "on"


def compiled_schedule(
    n: int,
    ws: int,
    cc: CompressionConfig,
    *,
    reduction: str = cfg_mod.REDUCTION_SRA,
    chunks: Optional[int] = None,
) -> Optional[CompiledSchedule]:
    """The pipeline plan of one fusion slice of ``n`` values over ``ws``
    ranks, or None where the SRA stays monolithic: the schedule not
    engaged, ``ws`` 1, compression off, the dummy codec, a reduction other
    than SRA (the Ring pipelines hop by hop already, the all-to-all is the
    debug path), or a row too narrow for two blocks. Plans (and the
    negative results) come from the bounded LRU.

    ``chunks``: the step planner's depth for this slice. Given, it replaces
    both ``CGX_SCHED_CHUNKS`` and the mode gate (the planner's own gate
    decided); every other gate holds, and a depth of 1 is None."""
    if ws <= 1 or not cc.enabled or cfg_mod.dummy_compression():
        return None
    if reduction != cfg_mod.REDUCTION_SRA:
        return None
    if chunks is None:
        if not engaged():
            return None
        chunks = cfg_mod.sched_chunks()
    key = _schedule_key(n, ws, cc, chunks)
    hit = _SCHED_CACHE.get(key)
    if hit is not None:
        _SCHED_CACHE.move_to_end(key)
        _SCHED_STATS["hits"] += 1
        return None if hit is _NO_SCHEDULE else hit
    _SCHED_STATS["misses"] += 1
    chunk = reducers.chunk_layout(n, ws)[0]
    table = chunk_table(chunk, chunks, cc.bucket_size)
    sched = None
    if len(table) >= 2:
        sched = CompiledSchedule(table=table, n=n, ws=ws, chunk=chunk, cc=cc)
    _SCHED_CACHE[key] = sched if sched is not None else _NO_SCHEDULE
    if len(_SCHED_CACHE) > _SCHED_CACHE_MAX:
        _SCHED_CACHE.popitem(last=False)
    return sched


def block_rows(xs: torch.Tensor, off: int, w: int) -> torch.Tensor:
    """Block ``(off, w)`` of the ``(ws, chunk)`` rows, copied contiguous
    for the kernels (counted)."""
    COUNTS["block_copies"] += 1
    return xs[:, off : off + w].contiguous()


def join_blocks(blocks) -> torch.Tensor:
    """The decoded ``(ws, w)`` blocks side by side: the slice's ``(ws,
    chunk)`` rows, one copy of the slice (counted)."""
    COUNTS["join_copies"] += 1
    return torch.cat(blocks, dim=1)


def pipelined_quantized_allreduce(
    x: torch.Tensor,
    group: ProcessGroup,
    ws: int,
    cc: CompressionConfig,
    reduction: str,
    key: Optional[prng.Key],
    sched: CompiledSchedule,
    *,
    with_wire: bool = False,
    pre=None,
):
    """The pipelined SRA allreduce (sum) of one fusion slice: each column
    block of the ``(ws, chunk)`` layout runs the monolithic SRA's quantize
    (phase-1 key), all-to-all, fused or staged epilogue (phase-2 key),
    all-gather and decode, block c+1's quantize and all-to-all posted
    before block c's epilogue.

    ``with_wire=True`` returns ``(reduced, rt)``, ``rt`` this rank's wire
    round trip: the decode of the block payloads it sent, its own row raw.

    ``pre``: a producer-staged payload (``ops.fused_producer.Produced``)
    whose ``q_blocks`` were quantized against this ``sched.table``: each
    block's quantize is skipped, the raw own row comes from
    ``pre.raw_row``, and ``x`` gives only its length and dtype."""
    if reduction != cfg_mod.REDUCTION_SRA:
        raise ValueError(
            f"pipelined schedules cover the SRA transport only, got {reduction!r} "
            f"(compiled_schedule should have returned None)"
        )
    if pre is not None and (pre.q_blocks is None or pre.table != sched.table):
        raise ValueError("the producer-staged payload's block plan does not match the schedule")
    depth = sched.depth
    COUNTS["pipelined_slices"] += 1
    COUNTS["blocks"] += depth
    n = x.shape[0]
    xs = None if pre is not None else reducers._pad_rows(x, ws, sched.chunk)
    own_idx = group_mod.rank(group)
    pending: list = [None] * depth
    outs: list = [None] * depth
    rts: list = [None] * depth

    def raw_of(c: int) -> torch.Tensor:
        off, w = sched.table[c]
        return pre.raw_row[off : off + w]

    def start(c: int) -> None:
        """Block c's quantize and its all-to-all, posted."""
        off, w = sched.table[c]
        kc = None if key is None else prng.fold_in(key, c)
        if pre is not None:
            q, xs_c = pre.q_blocks[c], None
        else:
            xs_c = block_rows(xs, off, w)
            q = reducers._quantize_rows(xs_c, cc, reducers._phase_key(kc, 1, own_idx))
        q_recv, works = reducers._exchange_async(q, group)
        pending[c] = (kc, q, q_recv, works, xs_c)

    def finish(c: int) -> None:
        """Block c's epilogue, all-gather and decode."""
        kc, q, q_recv, works, xs_c = pending[c]
        pending[c] = None
        reducers._wait_all(works)
        raw = raw_of(c) if pre is not None else None
        q_own = reducers._sra_epilogue_q(q_recv, xs_c, own_idx, cc, x.dtype, raw_row=raw, key=kc)
        gathered, works = reducers._gather_async(q_own, group, ws)
        reducers._wait_all(works)
        outs[c] = reducers._dequantize_rows(gathered)
        if with_wire:
            rt_rows = reducers._dequantize_rows(q)
            own = (torch.arange(ws, device=rt_rows.device) == own_idx)[:, None]
            raw_b = xs_c if pre is None else raw[None]
            rts[c] = torch.where(own, raw_b.to(rt_rows.dtype), rt_rows)

    start(0)
    for c in range(depth):
        if c + 1 < depth:
            start(c + 1)
        finish(c)
    out = join_blocks(outs).reshape(-1)[:n].to(x.dtype)
    if not with_wire:
        return out
    return out, join_blocks(rts).reshape(-1)[:n].to(x.dtype)


def dispatch_order(n_groups: int) -> Tuple[int, ...]:
    """The order ``allreduce_tree`` reduces its fused groups in under the
    schedule: reversed (the backward produces the last layers' gradients
    first). Each group keeps its original index for its key, so the order
    changes no byte."""
    return tuple(reversed(range(n_groups)))
