"""The bucket side of the DDP comm hook: a per-layer framed quantized
allreduce of one DDP bucket.

Counterpart of the bucket-side functions of the JAX package's c10d backend
(``torch_cgx_tpu/torch_backend/backend.py``) with the same per-layer
semantics and the same wire frames. The port registers no c10d backend and
keeps no store: the frames move with ``all_to_all_single`` over the
caller's ``torch.distributed`` group (gloo or NCCL), on the bucket's device.

* :func:`allreduce` gates like the JAX backend's ``allreduce``: a float
  bucket under SUM at world size > 1 takes :func:`_allreduce_quantized`,
  anything else a plain ``dist.all_reduce``; at world size 1 the bucket is
  returned untouched. :func:`allreduce_async` runs it on the group's FIFO
  worker thread and returns a future (the hook's path).
* The bucket's layers come from the registry by the hook's bucket tag
  (:func:`_extract_layers`). Enabled layers of at least
  ``CGX_COMPRESSION_MINIMAL_SIZE`` values are concatenated into an f32
  buffer (its leading ``ceil(ratio * n)`` values under
  ``CGX_COMPRESSION_FAKE_RATIO``) and reduced by SRA, Ring or all-to-all
  (``CGX_INNER_REDUCTION_TYPE``, ``CGX_DEBUG_ALL_TO_ALL_REDUCTION``), or by
  the two-level scheme (:func:`_qreduce_hier`) where the group's host map
  spans hosts with several ranks on one (:func:`_use_hierarchy`); the rest
  are summed uncompressed over the whole group (:func:`_sum_alltoall`).
* Each rank chunk of the buffer is cut at layer boundaries into segments;
  each segment is quantized from its own start with its layer's bits and
  bucket into a frame ``meta | packed`` (``ops/codec.py::wire_layout``),
  bf16 buckets with bf16 meta, f16 and f32 buckets with f32 meta.

The codec work runs through ``ops/dispatch.py``: the quantize (B1), the
decode with or without the fused add (B2), and the fused epilogue (B3) or
reduce (B4) where the dispatcher routes a segment to them. The sum of an
SRA chunk and of the all-to-all is ``v0 + v1 + ...`` ascending by rank, the
raw own chunk in its place for SRA. The JAX backend folds its own row
first in the all-to-all and the uncompressed sum, which at world size 3
and more gives ranks 2 and up other bits than ranks 0 and 1 (ROADMAP C12);
the port folds ascending everywhere, so its replicas stay identical and
equal the JAX result on ranks 0 and 1.

Under ``CGX_STOCHASTIC_ROUNDING`` each frame rounds stochastically with a
key of its own, ``prng.key(seed)`` for one ``int(rng.integers(2**31 -
1))`` of the rank's generator ``np.random.default_rng((CGX_SEED << 16) ^
(rank + 1))``, as the JAX backend draws its frame seeds; the two-level
scheme's stage 3, which every leader requantizes from the same values,
draws from a generator common to the leaders, seeded from the collective's
name (:func:`_qreduce_hier`), so the hosts stay bit-identical.

Under ``CGX_SCHEDULE=on`` an SRA (the flat one and the leaders' cross one
of the two-level scheme) whose rank chunks sustain two sub-chunks runs
pipelined (:func:`_qreduce_sra`): each rank's chunk is cut into
the sub-chunks of a group-global table (:func:`_sched_tables`), and the
frames of sub-chunk c+1 are compressed and their all-to-all posted
(``async_op=True``) before sub-chunk c is folded, requantized, gathered and
decoded: the JAX backend's in-flight window of two, with asynchronous
collectives in place of its encoder thread. Frames restart their buckets at
each sub-chunk, so where a sub-chunk boundary cuts a layer whose segment
does not start on the boundaries' grid the bytes differ from the
monolithic SRA's, as in the JAX backend. Stochastic frame keys come from a
generator per (collective, sub-chunk, stage), so they never depend on
timing.

Under ``CGX_PLANNER=on`` the SRA pipelines as under ``CGX_SCHEDULE=on``,
at the step planner's depth for the bucket (``planner.bridge_chunks``, from
the default model or the ``CGX_PLANNER_MODEL`` file) in place of
``CGX_SCHED_CHUNKS``; a depth of 1 keeps it monolithic.

Not ported, refused with ``NotImplementedError``: the two-level scheme's
asynchronous cross stage (``CGX_ASYNC=on``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import queue
import socket
import threading
import zlib
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import config as cfg
from ..config import CompressionConfig
from ..ops import codec, codec_cuda, dispatch
from ..ops.codec import QTensor
from ..parallel import group as group_mod
from ..parallel import planner as planner_mod
from ..parallel import schedule as sched_mod
from ..parallel.group import ProcessGroup
from ..utils import prng

_ALIGN = 8  # element alignment of the equal chunk split
_TORCH_FLOATS = (torch.float32, torch.float16, torch.bfloat16)

Layer = Tuple[int, int, CompressionConfig]  # (offset, numel, resolved config)


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """Meta dtype of a bucket's frames: bf16 for bf16 buckets (half the
    meta bytes), f32 otherwise. f16 stays f32-framed: the f32 partial sums
    of a reduction can leave the f16 range, bf16 shares f32's exponent."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


# ---------------------------------------------------------------------------
# Layout: chunk split and segments.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Segment:
    """A ``[start, start + numel)`` slice of the fused buffer with its
    layer's quantization parameters."""

    start: int
    numel: int
    bits: int
    bucket_size: int


def _segments_in(layers: Sequence[Layer], lo: int, hi: int) -> List[_Segment]:
    """Intersect fused-coordinate layers with the chunk ``[lo, hi)``."""
    out = []
    for start, numel, c in layers:
        s, e = max(start, lo), min(start + numel, hi)
        if s < e:
            out.append(_Segment(s, e - s, c.bits, c.bucket_size))
    return out


def _chunk_split(
    n: int, ws: int, layers: Optional[Sequence[Layer]] = None
) -> Tuple[List[int], List[int]]:
    """``(sizes, offsets)`` of the ws rank chunks of ``n`` fused values: an
    equal split rounded up to 8 values (trailing chunks may be short or
    empty), or with ``CGX_LAYER_ALIGNED_SPLIT`` and ``layers`` the greedy
    layer-aligned split."""
    if layers is not None and cfg.layer_aligned_split():
        return _chunk_split_layer_aligned(n, ws, [numel for (_o, numel, _c) in layers])
    per = -(-n // ws)
    per = -(-per // _ALIGN) * _ALIGN
    sizes, offs, used = [], [], 0
    for _ in range(ws):
        offs.append(used)
        take = min(per, n - used)
        sizes.append(take)
        used += take
    return sizes, offs


def _chunk_split_layer_aligned(
    n: int, ws: int, layer_sizes: List[int], align: int = 32
) -> Tuple[List[int], List[int]]:
    """The reference's greedy split (Quantizer::GetSizesAndOffsets): rank
    r's chunk targets ``remaining // (ws - r)`` values and takes whole
    layers while they fit; a layer larger than what is left of the target
    is cut at an offset rounded up to ``align`` (the 32-value packing
    group)."""
    sizes_out: List[int] = []
    offs_out: List[int] = []
    li = 0
    remaining = n
    n_elem = min(layer_sizes[0], remaining) if layer_sizes else 0
    offset = 0
    for rank in range(ws):
        per_node = remaining // (ws - rank)
        cur = 0
        while cur < per_node:
            if n_elem <= per_node - cur:
                cur += n_elem
                li += 1
                if li == len(layer_sizes):
                    break
                n_elem = min(layer_sizes[li], remaining)
            else:
                aligned = min(-(-(per_node - cur) // align) * align, n_elem)
                cur += aligned
                n_elem -= aligned
        remaining -= cur
        sizes_out.append(cur)
        offs_out.append(offset)
        offset += cur
    return sizes_out, offs_out


# ---------------------------------------------------------------------------
# The frame codec.
# ---------------------------------------------------------------------------


Rng = Optional[np.random.Generator]  # a frame-seed generator; None: round to nearest


def _cc(s: _Segment) -> CompressionConfig:
    # Frames never carry a residual.
    return CompressionConfig(
        bits=s.bits, bucket_size=s.bucket_size, stochastic=cfg.stochastic_rounding()
    )


def _frame_key(rng: Rng) -> Optional[prng.Key]:
    """The key of the next frame: one draw of ``rng`` (the JAX backend's
    ``int(rng.integers(2**31 - 1))`` frame seed), or None."""
    return None if rng is None else prng.key(int(rng.integers(2**31 - 1)))


def frame_bytes(s: _Segment, wdt: torch.dtype, dummy: bool) -> int:
    """Bytes of a segment's frame (the raw f32 values under the dummy codec)."""
    if dummy:
        return 4 * s.numel
    return codec.wire_layout(s.numel, s.bits, s.bucket_size, wdt)[3]


def frames_bytes(segs: Sequence[_Segment], wdt: torch.dtype, dummy: bool) -> int:
    return sum(frame_bytes(s, wdt, dummy) for s in segs)


def _encode(x: torch.Tensor, s: _Segment, wdt: torch.dtype, rng: Rng = None) -> torch.Tensor:
    """The frame of one segment's f32 values (with ``rng``: rounded with the
    next frame key)."""
    q = dispatch.quantize_batch(x[None], _cc(s), _frame_key(rng))
    return codec.to_bytes(dispatch._row(q, 0), wdt)


def _parse(buf: torch.Tensor, s: _Segment, wdt: torch.dtype) -> QTensor:
    """A frame as a rows=1 QTensor with f32 meta (the decode reads the meta
    as it travelled, upcast)."""
    q = codec.from_bytes(buf, s.numel, s.bits, s.bucket_size, wdt)
    return QTensor(
        packed=q.packed[None],
        meta=q.meta.to(torch.float32)[None],
        residual=q.residual.to(torch.float32)[None],
        numel=s.numel, bits=s.bits, bucket_size=s.bucket_size, dtype=torch.float32,
    )


def _decode(buf: torch.Tensor, s: _Segment, wdt: torch.dtype, dummy: bool,
            add_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 values of one segment's frame, ``add_to + decoded`` with an
    accumulator (the decode's fused add)."""
    if dummy:
        vals = buf.view(torch.float32)
        return vals if add_to is None else add_to + vals
    return dispatch.dequantize_batch(
        _parse(buf, s, wdt), add_to=None if add_to is None else add_to[None],
        out_dtype=torch.float32,
    )[0]


def _compress_frames(fused: torch.Tensor, segs: Sequence[_Segment], dummy: bool,
                     wdt: torch.dtype = torch.float32, rng: Rng = None) -> torch.Tensor:
    """Concatenated frames of ``segs`` (uint8, on the buffer's device), each
    quantized frame with a key of ``rng`` where one is given."""
    parts = []
    for s in segs:
        x = fused[s.start : s.start + s.numel]
        parts.append(x.contiguous().view(torch.uint8) if dummy else _encode(x, s, wdt, rng))
    return torch.cat(parts) if parts else fused.new_empty((0,), dtype=torch.uint8)


def _decompress_frames(buf: torch.Tensor, segs: Sequence[_Segment], fused: torch.Tensor,
                       dummy: bool, add: bool, wdt: torch.dtype = torch.float32) -> None:
    """Decode frames into the fused buffer at their segments, accumulating
    (``add``) or assigning."""
    off = 0
    for s in segs:
        nb = frame_bytes(s, wdt, dummy)
        sl = fused[s.start : s.start + s.numel]
        sl.copy_(_decode(buf[off : off + nb], s, wdt, dummy, sl if add else None))
        off += nb


def _requantize_frames(fused: torch.Tensor, segs: Sequence[_Segment], dummy: bool,
                       wdt: torch.dtype = torch.float32, rng: Rng = None) -> torch.Tensor:
    """Quantize the reduced segments and decode each frame back into the
    buffer, so every replica holds the decode of the same bytes (the
    error-symmetry rule). The decode reads the meta in the wire dtype."""
    parts = []
    for s in segs:
        sl = fused[s.start : s.start + s.numel]
        frame = _compress_frames(fused, [s], dummy, wdt, rng)
        sl.copy_(_decode(frame, s, wdt, dummy))
        parts.append(frame)
    return torch.cat(parts) if parts else fused.new_empty((0,), dtype=torch.uint8)


def _stack_frames(bufs: Sequence[Optional[torch.Tensor]], s: _Segment, wdt: torch.dtype) -> QTensor:
    """Rows of one segment's frames (``None``: a zero row in that place,
    for the raw own row the fold substitutes) as one QTensor, f32 meta."""
    qs = [None if b is None else _parse(b, s, wdt) for b in bufs]
    like = next(q for q in qs if q is not None)
    qs = [q if q is not None else QTensor(
        packed=torch.zeros_like(like.packed), meta=torch.zeros_like(like.meta),
        residual=like.residual, numel=like.numel, bits=like.bits,
        bucket_size=like.bucket_size, dtype=like.dtype) for q in qs]
    return QTensor(
        packed=torch.cat([q.packed for q in qs]),
        meta=torch.cat([q.meta for q in qs]),
        residual=torch.cat([q.residual for q in qs]),
        numel=like.numel, bits=like.bits, bucket_size=like.bucket_size, dtype=like.dtype,
    )


def _sra_fold_chunk(fused: torch.Tensor, segs_me: Sequence[_Segment],
                    frames: Sequence[Optional[torch.Tensor]], me: int, ws: int,
                    dummy: bool, wdt: torch.dtype = torch.float32, rng: Rng = None) -> torch.Tensor:
    """The SRA epilogue of this rank's chunk, segment by segment: fold the
    peers' stage-1 frames ``v0 + v1 + ...`` ascending by rank with the raw
    own values at position ``me``, requantize, decode the frame back into
    the buffer. Returns the chunk's stage-2 frames. ``frames[j]``: peer
    ``j``'s frames of this chunk (``frames[me]`` unused). The fold and the
    requantize are ``dispatch.reduce_rows_requantize``: one fused kernel
    where the dispatcher routes the segment to it."""
    parts = []
    off = 0
    for s in segs_me:
        nb = frame_bytes(s, wdt, dummy)
        sl = fused[s.start : s.start + s.numel]
        peer = [None if j == me else frames[j][off : off + nb] for j in range(ws)]
        off += nb
        if dummy:
            rows = torch.stack([sl if j == me else peer[j].view(torch.float32) for j in range(ws)])
            sl.copy_(dispatch.ordered_rowsum(rows))
            parts.append(sl.contiguous().view(torch.uint8).clone())
            continue
        q = _stack_frames(peer, s, wdt)
        # An aligned raw row keeps the reduce kernel at its full width. The
        # fold stays exact whatever CGX_SRA_ACCUM says: the JAX hook folds
        # in numpy (torch_cgx_tpu/torch_backend/backend.py _sra_fold_chunk).
        qo = dispatch.reduce_rows_requantize(
            q, _cc(s), raw_row=codec_cuda._aligned(sl), own_idx=me, key=_frame_key(rng),
            accum="exact")
        frame = codec.to_bytes(dispatch._row(qo, 0), wdt)
        sl.copy_(_decode(frame, s, wdt, dummy))
        parts.append(frame)
    return torch.cat(parts) if parts else fused.new_empty((0,), dtype=torch.uint8)


# ---------------------------------------------------------------------------
# Byte exchange over the group.
# ---------------------------------------------------------------------------


def _alltoallv(send: Sequence[Optional[torch.Tensor]], recv_sizes: Sequence[int],
               moves: bool, group: ProcessGroup, device: torch.device) -> List[torch.Tensor]:
    """``send[j]`` (uint8, or None) to rank ``j``; ``recv_sizes[j]`` bytes
    from rank ``j`` -> the received parts. ``moves``: whether any rank of
    the group sends anything in this exchange, which every rank knows from
    the layout; without it no collective runs, on every rank alike."""
    parts, work = _alltoallv_async(send, recv_sizes, moves, group, device)
    group_mod.wait(work)
    return parts


def _alltoallv_async(send: Sequence[Optional[torch.Tensor]], recv_sizes: Sequence[int],
                     moves: bool, group: ProcessGroup,
                     device: torch.device) -> Tuple[List[torch.Tensor], group_mod.Pending]:
    """:func:`_alltoallv` posted without waiting: ``(parts, work)``; read
    the parts after ``group_mod.wait(work)``."""
    empty = torch.empty((0,), dtype=torch.uint8, device=device)
    send = [empty if t is None else t for t in send]
    if not moves:
        return [empty] * len(recv_sizes), None
    inp = torch.cat(send)
    out = torch.empty((sum(recv_sizes),), dtype=torch.uint8, device=device)
    work = dist.all_to_all_single(out, inp, list(recv_sizes), [t.numel() for t in send],
                                  group=group, async_op=True)
    return list(out.split(list(recv_sizes))), work


def _shift(frame: torch.Tensor, recv_n: int, me: int, ws: int, moves: bool,
           group: ProcessGroup) -> torch.Tensor:
    """Send ``frame`` to rank ``me + 1`` and receive ``recv_n`` bytes from
    rank ``me - 1``: one Ring hop."""
    send: List[Optional[torch.Tensor]] = [None] * ws
    recv = [0] * ws
    send[(me + 1) % ws] = frame
    recv[(me - 1) % ws] = recv_n
    return _alltoallv(send, recv, moves, group, frame.device)[(me - 1) % ws]


# ---------------------------------------------------------------------------
# Reducers over frames.
# ---------------------------------------------------------------------------


def _layout(n: int, ws: int, layers: Sequence[Layer], wdt: torch.dtype, dummy: bool):
    sizes, offs = _chunk_split(n, ws, layers)
    segs = [_segments_in(layers, offs[r], offs[r] + sizes[r]) for r in range(ws)]
    return segs, [frames_bytes(sg, wdt, dummy) for sg in segs]


def _qreduce_sra(fused: torch.Tensor, layers: Sequence[Layer], wdt: torch.dtype,
                 group: ProcessGroup, force_raw: bool = False, rng: Rng = None,
                 pfx: str = "") -> None:
    """Scatter-Reduce-AllGather: each rank posts each peer's chunk as
    frames, folds the arrivals into its raw own chunk and requantizes it
    (:func:`_sra_fold_chunk`), then every rank gathers and decodes every
    other rank's reduced chunk, sub-chunk by sub-chunk. Without the
    schedule every chunk is one sub-chunk. Under ``CGX_SCHEDULE=on``, where
    the chunks sustain two, rank r's chunk is cut into the sub-chunks
    ``tables[r]`` (:func:`_sched_tables`), and sub-chunk c+1's frames are
    compressed and their all-to-all posted before sub-chunk c is folded,
    requantized, gathered and decoded: at most two sub-chunks in flight,
    the JAX backend's window of two (its ``_SCHED_WINDOW``). Its stochastic
    frame keys then come from :func:`_sched_rng` (``pfx`` names the
    collective), else from the rank's ``rng``. Under ``CGX_PLANNER=on`` it
    pipelines too, at the planner's depth (:func:`_sched_tables`)."""
    ws, me = group_mod.world_size(group), group_mod.rank(group)
    dummy = cfg.dummy_compression() or force_raw
    sizes, offs = _chunk_split(fused.shape[0], ws, layers)
    tables = _sched_tables(sizes, layers) if ws > 1 and _pipelines() else None
    pipelined = tables is not None
    if not pipelined:
        tables = [[(0, sz)] for sz in sizes]

    def rng_of(c: int, stage: str) -> Rng:
        return _sched_rng(pfx, c, stage) if pipelined else rng

    depth = len(tables[0])
    segs = [[_segments_in(layers, offs[r] + o, offs[r] + o + w) for o, w in tables[r]]
            for r in range(ws)]
    fsize = [[frames_bytes(segs[r][c], wdt, dummy) for c in range(depth)] for r in range(ws)]
    pending: List = [None] * depth

    def start(c: int) -> None:
        sent = [None if j == me else _compress_frames(fused, segs[j][c], dummy, wdt,
                                                      rng_of(c, "enc"))
                for j in range(ws)]
        recv = [0 if j == me else fsize[me][c] for j in range(ws)]
        moves = any(fsize[r][c] for r in range(ws))
        pending[c] = _alltoallv_async(sent, recv, moves, group, fused.device) + (moves,)

    def finish(c: int) -> None:
        frames, work, moves = pending[c]
        pending[c] = None
        group_mod.wait(work)
        wire = _sra_fold_chunk(fused, segs[me][c], frames, me, ws, dummy, wdt, rng_of(c, "req"))
        recv = [0 if j == me else fsize[j][c] for j in range(ws)]
        bufs = _alltoallv([None if j == me else wire for j in range(ws)], recv, moves, group,
                          fused.device)
        for j in range(ws):
            if j != me:
                _decompress_frames(bufs[j], segs[j][c], fused, dummy, add=False, wdt=wdt)

    start(0)
    for c in range(depth):
        if c + 1 < depth:
            start(c + 1)
        finish(c)


def _pipelines() -> bool:
    """Whether the bucket SRA may pipeline: ``CGX_SCHEDULE=on`` or
    ``CGX_PLANNER=on``, read from the environment alone, so every rank
    answers alike."""
    return cfg.schedule_mode() == "on" or cfg.planner_mode() == "on"


def _sched_tables(sizes: Sequence[int], layers: Sequence[Layer]) -> Optional[List[List[Tuple[int, int]]]]:
    """Every rank's sub-chunk plan (``schedule.chunk_table``,
    ``CGX_SCHED_CHUNKS`` deep, aligned to the lcm of the layers' buckets
    and 32), or None where no chunk sustains two (the JAX backend's copy of
    the table, ``_sched_chunk_table``, is the same function). Under
    ``CGX_PLANNER=on`` the depth is ``planner.bridge_chunks``' for the
    largest chunk at the first compressed layer's bits (the JAX backend's
    rule). Group-global: every rank derives every rank's table from the
    chunk sizes, the layers and the knobs, and the tables are padded to one
    depth with empty sub-chunks, whose empty frames travel like empty
    chunks."""
    align = 1
    for b in [c.bucket_size for (_o, _n, c) in layers] or [1]:
        align = math.lcm(align, max(1, b))
    chunks = cfg.sched_chunks()
    if cfg.planner_mode() == "on" and sizes:
        bits = next((c.bits for (_o, _n, c) in layers if c.enabled), 32)
        chunks = planner_mod.bridge_chunks(max(sizes), align, len(sizes), bits, chunks)
    tables = [list(sched_mod.chunk_table(s, chunks, align)) for s in sizes]
    depth = max((len(t) for t in tables), default=1)
    if depth < 2:
        return None
    for t in tables:
        while len(t) < depth:
            end = t[-1][0] + t[-1][1] if t else 0
            t.append((end, 0))
    return tables


def _sched_rng(pfx: str, c: int, salt: str) -> Rng:
    """The frame-seed generator of sub-chunk ``c``'s stage ``salt`` ("enc":
    the stage-1 frames, "req": the requantize) of the collective ``pfx``
    under stochastic rounding (else None): the JAX backend's
    ``default_rng((CGX_SEED << 16) ^ (rank + 1) ^ crc32(f"{pfx}/c{c}/{salt}"))``,
    ``rank`` the process's rank in the default group."""
    if not cfg.stochastic_rounding():
        return None
    mix = zlib.crc32(f"{pfx}/c{c}/{salt}".encode())
    return np.random.default_rng((cfg.global_seed() << 16) ^ (group_mod.rank() + 1) ^ mix)


def _qreduce_ring(fused: torch.Tensor, layers: Sequence[Layer], wdt: torch.dtype,
                  group: ProcessGroup, force_raw: bool = False, rng: Rng = None) -> None:
    """Ring: ws-1 scatter-reduce hops, each quantizing the outgoing chunk
    and decode-adding the arriving one, then the reduced chunk
    ``(me + 1) % ws`` is requantized once (and decoded back) and ws-1
    all-gather hops pass each owner's frames on unchanged."""
    ws, me = group_mod.world_size(group), group_mod.rank(group)
    dummy = cfg.dummy_compression() or force_raw
    segs, fsize = _layout(fused.shape[0], ws, layers, wdt, dummy)
    moves = sum(fsize) > 0
    for step in range(ws - 1):
        s_idx = (me - step) % ws  # chunk sent to the right
        r_idx = (me - step - 1) % ws  # chunk received and reduced
        frame = _compress_frames(fused, segs[s_idx], dummy, wdt, rng)
        buf = _shift(frame, fsize[r_idx], me, ws, moves, group)
        _decompress_frames(buf, segs[r_idx], fused, dummy, add=True, wdt=wdt)
    hold = _requantize_frames(fused, segs[(me + 1) % ws], dummy, wdt, rng)
    for step in range(ws - 1):
        r_idx = (me - step) % ws  # chunk arriving at this hop
        hold = _shift(hold, fsize[r_idx], me, ws, moves, group)
        _decompress_frames(hold, segs[r_idx], fused, dummy, add=False, wdt=wdt)


def _qreduce_alltoall(fused: torch.Tensor, layers: Sequence[Layer], wdt: torch.dtype,
                      group: ProcessGroup, force_raw: bool = False, rng: Rng = None) -> None:
    """All-to-all: every rank quantizes its whole buffer once, sends it to
    every peer, and decodes and folds all ws frames, its own included, in
    ascending rank order (``dispatch.reduce_rows``)."""
    ws, me = group_mod.world_size(group), group_mod.rank(group)
    dummy = cfg.dummy_compression() or force_raw
    segs = _segments_in(layers, 0, fused.shape[0])
    wire = _compress_frames(fused, segs, dummy, wdt, rng)
    size = wire.numel()
    bufs = _alltoallv([None if j == me else wire for j in range(ws)],
                      [0 if j == me else size for j in range(ws)], size > 0, group, fused.device)
    bufs[me] = wire
    off = 0
    for s in segs:
        nb = frame_bytes(s, wdt, dummy)
        rows = [b[off : off + nb] for b in bufs]
        off += nb
        sl = fused[s.start : s.start + s.numel]
        if dummy:
            sl.copy_(dispatch.ordered_rowsum(torch.stack([r.view(torch.float32) for r in rows])))
        else:
            # Exact whatever CGX_SRA_ACCUM says, as the JAX hook's numpy
            # fold (torch_cgx_tpu/torch_backend/backend.py _qreduce_alltoall).
            sl.copy_(dispatch.reduce_rows(_stack_frames(rows, s, wdt), accum="exact"))


def _qreduce_flat(fused: torch.Tensor, layers: Sequence[Layer], wdt: torch.dtype, algo: str,
                  group: ProcessGroup, force_raw: bool = False, rng: Rng = None,
                  pfx: str = "") -> None:
    """One level's reduction over ``group``. ``force_raw``: pass-through
    frames whatever the layers' configs (the two-level scheme's
    uncompressed cross stage). ``rng``: the rank's frame-seed generator
    under stochastic rounding. ``pfx``: the collective's name, for the
    pipelined SRA's streams."""
    if algo == cfg.REDUCTION_ALLTOALL:
        _qreduce_alltoall(fused, layers, wdt, group, force_raw, rng)
    elif algo == cfg.REDUCTION_RING:
        _qreduce_ring(fused, layers, wdt, group, force_raw, rng)
    else:
        _qreduce_sra(fused, layers, wdt, group, force_raw, rng, pfx)


def _sum_alltoall(part: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Uncompressed sum of the raw layers: gather every rank's values and
    fold them ascending by rank."""
    ws = group_mod.world_size(group)
    return dispatch.ordered_rowsum(group_mod.all_gather_rows(part[None], ws, group))


# ---------------------------------------------------------------------------
# Layers of a bucket.
# ---------------------------------------------------------------------------


def _resolve_layers(bucket_key: Hashable, sizes: Sequence[int]) -> List[Layer]:
    out, off = [], 0
    for li, n in enumerate(sizes):
        out.append((off, n, cfg.get_layer_config((bucket_key, li))))
        off += n
    return out


def _extract_layers(numel: int, bucket_key: Optional[Hashable] = None) -> List[Layer]:
    """``(offset, numel, config)`` of each layer of a bucket. A tagged
    bucket takes its registered sizes, which must sum to ``numel`` (a
    ``RuntimeError`` names a stale registry); an unregistered one is one
    layer of the env default. An untagged call resolves by element count:
    one registered bucket of that total gives its layers, none gives one
    default layer, several raise."""
    if bucket_key is not None:
        sizes = cfg.registered_layer_sizes(bucket_key)
        if sizes is not None:
            if sum(sizes) != numel:
                raise RuntimeError(
                    f"bucket {bucket_key!r}: registered layer sizes sum to {sum(sizes)} but "
                    f"the buffer has {numel} elements (stale registry? call clear_registry() "
                    f"after changing the model)"
                )
            return _resolve_layers(bucket_key, sizes)
        return [(0, numel, cfg.default_compression_config())]
    matches = [
        (key, sizes)
        for key in cfg.registered_buckets()
        if (sizes := cfg.registered_layer_sizes(key)) and sum(sizes) == numel
    ]
    if not matches:
        return [(0, numel, cfg.default_compression_config())]
    if len(matches) > 1:
        raise RuntimeError(
            f"untagged allreduce of {numel} elements matches {len(matches)} registered "
            f"buckets ({[m[0] for m in matches]!r}): cannot resolve per-layer configs; use "
            f"the cgx_hook (which tags buckets) or clear_registry()"
        )
    return _resolve_layers(*matches[0])


def split_layers(layers: Sequence[Layer]) -> Tuple[List[Layer], List[Layer]]:
    """(compressed, raw) layers: enabled and at least
    ``CGX_COMPRESSION_MINIMAL_SIZE`` values, or not."""
    minimal = cfg.minimal_size()
    comp = [(o, n, c) for (o, n, c) in layers if c.enabled and n >= minimal]
    rest = [(o, n, c) for (o, n, c) in layers if not (c.enabled and n >= minimal)]
    return comp, rest


# ---------------------------------------------------------------------------
# The host map and the two-level scheme.
# ---------------------------------------------------------------------------

# The classes of a host map, named as in the JAX backend.
TOPO_SINGLE = "single"
TOPO_INTRA = "intra_slice"
TOPO_CROSS = "cross_slice"
TOPO_MIXED = "mixed"


def host_fingerprint() -> str:
    """This process's host key: ``CGX_SHM_HOST_ID`` where it is set, else
    ``"hostname:boot_id"`` (``"noboot"`` where the boot id cannot be read),
    so that containers on two machines that share a hostname stay apart.
    The JAX package's ``shm.host_fingerprint``, copied."""
    override = os.environ.get(cfg.SHM_HOST_ID)
    if override:
        return override
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = "noboot"
    return f"{socket.gethostname()}:{boot}"


def _host_topology(hosts: Sequence[str]) -> str:
    """The class of a group from its ranks' host keys: one rank, one host,
    a host each, or MIXED (spanning hosts with several ranks on some host:
    the two-level scheme's groups)."""
    n_hosts = len(set(hosts))
    if len(hosts) <= 1:
        return TOPO_SINGLE
    if n_hosts == 1:
        return TOPO_INTRA
    if n_hosts == len(hosts):
        return TOPO_CROSS
    return TOPO_MIXED


def _slice_leaders(hosts: Sequence[str]) -> List[int]:
    """The group ranks that lead their hosts: each host's first rank, hosts
    in first-seen order (so ascending)."""
    seen: Dict[str, int] = {}
    for i, h in enumerate(hosts):
        seen.setdefault(h, i)
    return list(seen.values())


@dataclasses.dataclass(frozen=True)
class HostMap:
    """A group's host map as this rank sees it. ``leaders`` and ``local``
    are group ranks: each host's leader, and the ranks on this rank's host
    (ascending, its leader first). A MIXED map also holds the two-level
    scheme's subgroups: ``intra`` this host's ranks, ``cross`` the ranks of
    this rank's local index across hosts (on a leader: the leaders)."""

    hosts: Tuple[str, ...]
    topology: str
    leaders: Tuple[int, ...]
    local: Tuple[int, ...]
    intra: ProcessGroup = None
    cross: ProcessGroup = None


_HOSTS: Dict[object, HostMap] = {}
# The two-level subgroups of released MIXED maps, by (backend, the group's
# global ranks, its hosts): a later map of the same group over the same
# hosts takes them again (see :func:`release`).
_RETIRED: Dict[tuple, List[Tuple[ProcessGroup, ProcessGroup]]] = {}


def _group_key(group: ProcessGroup):
    return group if group is not None else dist.group.WORLD


def _new_subgroup(group: ProcessGroup, members: Sequence[int]) -> "dist.ProcessGroup":
    """The subgroup of ``group``'s ranks ``members``. ``dist.new_group``
    takes global ranks, hence the mapping. Under
    ``use_local_synchronization`` only the members call it, so a hook group
    other than the default one needs nothing from the ranks outside it."""
    base = _group_key(group)
    ranks = [dist.get_global_rank(base, r) for r in members]
    sub = dist.new_group(ranks, backend=dist.get_backend(group), use_local_synchronization=True)
    if sub is None or sub == dist.GroupMember.NON_GROUP_MEMBER:
        raise RuntimeError(f"forming the subgroup of global ranks {ranks} failed")
    return sub


def _host_map(group: ProcessGroup, hosts: Tuple[str, ...]) -> HostMap:
    """Classify ``hosts``; for a MIXED map form this rank's two subgroups:
    its host's ranks, then the ranks of its local index across hosts (the
    reference's cross communicator; local index 0 is the leaders). A
    subgroup formed under ``use_local_synchronization`` is named by its
    members and the count of groups the process holds, so its members must
    hold equally many: every rank forms exactly two, a leader or not, alone
    on its host or not, or, where the group released a map over the same
    hosts, every rank takes that map's two again."""
    me = group_mod.rank(group)
    topology = _host_topology(hosts)
    leaders = tuple(_slice_leaders(hosts))
    local = tuple(r for r, h in enumerate(hosts) if h == hosts[me])
    if topology != TOPO_MIXED:
        return HostMap(hosts, topology, leaders, local)
    li = local.index(me)
    kept = _RETIRED.get(_retired_key(group, hosts))
    if kept:
        intra, cross = kept.pop()
    else:
        peers = [[r for r, h in enumerate(hosts) if h == hosts[lead]] for lead in leaders]
        intra = _new_subgroup(group, local)
        cross = _new_subgroup(group, sorted(p[li] for p in peers if len(p) > li))
    # The exchanges address the subgroups' ranks by local and leader index.
    if dist.get_rank(intra) != li or (li == 0 and dist.get_rank(cross) != leaders.index(me)):
        raise RuntimeError(f"the two-level subgroups of rank {me} do not follow the group's rank order")
    return HostMap(hosts, topology, leaders, local, intra, cross)


def _retired_key(group: ProcessGroup, hosts: Tuple[str, ...]):
    """The key of ``group``'s two-level subgroups over ``hosts`` in
    :data:`_RETIRED`: the same on every rank of the group."""
    base = _group_key(group)
    ranks = tuple(dist.get_global_rank(base, r) for r in range(group_mod.world_size(group)))
    return dist.get_backend(group), ranks, hosts


def _hosts(group: ProcessGroup) -> HostMap:
    """The group's host map: every rank's :func:`host_fingerprint`,
    gathered once per group at its first quantized allreduce (every rank
    calls it there), with the two-level subgroups of a MIXED map."""
    key = _group_key(group)
    if key not in _HOSTS:
        out: List[Optional[str]] = [None] * group_mod.world_size(group)
        dist.all_gather_object(out, host_fingerprint(), group=group)
        _HOSTS[key] = _host_map(group, tuple(str(h) for h in out))
    return _HOSTS[key]


def _use_hierarchy(group: ProcessGroup, topo: cfg.TopologyConfig) -> bool:
    """The JAX backend's predicate: the two-level scheme runs where the
    group's host map is MIXED and ``CGX_INTRA_BROADCAST`` is on. It is
    group-global, so every rank takes the same branch; a rank alone on its
    host takes part as its own leader."""
    return topo.intra_broadcast and _hosts(group).topology == TOPO_MIXED


def _qreduce_hier(fused: torch.Tensor, layers: Sequence[Layer], wdt: torch.dtype,
                  topo: cfg.TopologyConfig, hm: HostMap, rng: Rng = None,
                  rng3: Rng = None, pfx: str = "") -> None:
    """The two-level leader reduction:

    1. each non-leader frames its whole buffer once (pass-through frames
       under ``CGX_INTRA_COMPRESS=0``) and sends it to its host's leader,
       which decode-adds the frames into its raw buffer in ascending local
       index (B2 with the fused add);
    2. the leaders run the flat cross reduction
       (``CGX_CROSS_REDUCTION_TYPE``) over their own group;
    3. every leader, alone on its host too, requantizes its buffer and
       decodes the frame back (so every rank holds the decode of the same
       bytes) and sends the frame to its locals, who decode it.

    The leaders hold bit-identical values after stage 2, so all ranks agree
    bit for bit. Under stochastic rounding stages 1 and 2 draw their frame
    keys from this rank's ``rng``, stage 3 from ``rng3``, a generator that
    every leader seeds alike, so that the leaders' stage-3 frames stay
    identical. ``pfx``: the collective's name; the leaders' cross stage is
    ``{pfx}/hx``."""
    me = dist.get_rank(hm.intra)  # this rank's local index
    nl = len(hm.local)
    raw = cfg.dummy_compression() or not topo.intra_compress
    segs = _segments_in(layers, 0, fused.shape[0])
    size = frames_bytes(segs, wdt, raw)
    dev = fused.device
    if me != 0:
        frame = _compress_frames(fused, segs, raw, wdt, rng)
        _alltoallv([frame] + [None] * (nl - 1), [0] * nl, size > 0, hm.intra, dev)
        buf = _alltoallv([None] * nl, [size] + [0] * (nl - 1), size > 0, hm.intra, dev)[0]
        _decompress_frames(buf, segs, fused, raw, add=False, wdt=wdt)
        return
    if nl > 1:
        bufs = _alltoallv([None] * nl, [0] + [size] * (nl - 1), size > 0, hm.intra, dev)
        for idx in range(1, nl):
            _decompress_frames(bufs[idx], segs, fused, raw, add=True, wdt=wdt)
    _qreduce_flat(fused, layers, wdt, topo.cross_reduction, hm.cross,
                  force_raw=not topo.cross_compress, rng=rng, pfx=f"{pfx}/hx")
    wire = _requantize_frames(fused, segs, raw, wdt, rng3)
    if nl > 1:
        _alltoallv([None] + [wire] * (nl - 1), [0] * nl, size > 0, hm.intra, dev)


# ---------------------------------------------------------------------------
# Stochastic rounding's frame seeds.
# ---------------------------------------------------------------------------

_RNGS: Dict[object, np.random.Generator] = {}
_SEQ: Dict[object, int] = {}  # two-level allreduces a group has run
_QSEQ: Dict[object, int] = {}  # quantized allreduces a group has run


def _stochastic_rng(group: ProcessGroup) -> Rng:
    """This rank's frame-seed generator for ``group`` under
    ``CGX_STOCHASTIC_ROUNDING`` (else None), made at first use and kept
    until :func:`release`: ``np.random.default_rng((CGX_SEED << 16) ^
    (rank + 1))``, the JAX backend's."""
    if not cfg.stochastic_rounding():
        return None
    key = _group_key(group)
    if key not in _RNGS:
        _RNGS[key] = np.random.default_rng((cfg.global_seed() << 16) ^ (group_mod.rank(group) + 1))
    return _RNGS[key]


def _collective_name(group: ProcessGroup) -> str:
    """The name of this quantized allreduce of ``group``, ``cgx{n}q`` for
    the group's n-th one (every rank runs them in one order): the pipelined
    SRA's streams are keyed by it."""
    key = _group_key(group)
    _QSEQ[key] = _QSEQ.get(key, 0) + 1
    return f"cgx{_QSEQ[key]}q"


def _stage3_rng(group: ProcessGroup) -> Rng:
    """The two-level stage-3 generator of this quantized allreduce of
    ``group``, alike on every leader: seeded from ``CGX_SEED`` and the
    collective's name ``cgx{seq}p`` (``seq`` counts the group's two-level
    allreduces, which every rank runs in one order), as the JAX backend
    seeds it from its collective key. None without stochastic rounding."""
    key = _group_key(group)
    _SEQ[key] = _SEQ.get(key, 0) + 1
    if not cfg.stochastic_rounding():
        return None
    name = f"cgx{_SEQ[key]}p"
    return np.random.default_rng((cfg.global_seed() << 16) ^ (zlib.crc32(name.encode()) & 0x7FFF))


# ---------------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------------


def _refuse_unported(topo: cfg.TopologyConfig, hier: bool) -> None:
    """Raise, on every rank alike and before any collective of the bucket,
    for what the JAX backend would run and the port does not have."""
    if hier and cfg.async_mode() == "on":
        raise NotImplementedError(
            f"{cfg.ASYNC}=on (the two-level scheme without its cross stage, for the "
            f"asynchronous plane) is not ported; unset it or set it to off"
        )


# ---------------------------------------------------------------------------
# The bucket allreduce.
# ---------------------------------------------------------------------------


def allreduce(t: torch.Tensor, group: ProcessGroup = None, op=dist.ReduceOp.SUM,
              bucket_key: Optional[Hashable] = None) -> torch.Tensor:
    """Allreduce ``t`` in place over ``group`` and return it. The bucket's
    layers resolve by ``bucket_key`` (registered layer sizes), else by
    the element count alone. A float tensor under SUM is reduced per layer with compression; anything else
    by a plain ``dist.all_reduce``. At world size 1 ``t`` is returned
    untouched."""
    if group_mod.world_size(group) == 1:
        return t
    if t.dtype in _TORCH_FLOATS and op == dist.ReduceOp.SUM:
        _allreduce_quantized(t, group, bucket_key)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _shaped_spans(comp: Sequence[Layer]) -> List[Tuple[int, int]]:
    """``(offset, numel)`` of the compressed layers' values that travel:
    all of them, or under ``CGX_COMPRESSION_FAKE_RATIO`` the leading
    ``ceil(ratio * total)``, cut at the layer where the budget ends."""
    spans = [(o, n) for (o, n, _) in comp]
    total = sum(n for _, n in spans)
    ratio = cfg.fake_ratio()
    if ratio is None or total <= 1:
        return spans
    budget = max(1, math.ceil(ratio * total))
    cut, acc = [], 0
    for o, n in spans:
        take = min(n, budget - acc)
        if take <= 0:
            break
        cut.append((o, take))
        acc += take
    return cut


def _allreduce_quantized(t: torch.Tensor, group: ProcessGroup,
                         bucket_key: Optional[Hashable] = None) -> None:
    """The bucket's layers split into compressed and raw ones; the raw
    ones summed exactly over the whole group, the compressed ones (their
    shaped prefix under the fake ratio) concatenated into an f32 buffer and
    reduced by the two-level scheme or the inner reduction type; both
    written back in the bucket's dtype."""
    topo = cfg.topology_from_env()
    layers = _extract_layers(t.numel(), bucket_key)
    comp, rest = split_layers(layers)
    hier = bool(comp) and _use_hierarchy(group, topo)
    if comp:
        _refuse_unported(topo, hier)
    arr = t.detach().reshape(-1).to(torch.float32, copy=True)
    if rest:
        part = torch.cat([arr[o : o + n] for (o, n, _) in rest])
        part = _sum_alltoall(part, group)
        off = 0
        for (o, n, _) in rest:
            arr[o : o + n] = part[off : off + n]
            off += n
    if comp:
        spans = _shaped_spans(comp)
        fused = torch.cat([arr[o : o + n] for (o, n) in spans])
        # Layer offsets in fused coordinates, clipped to the shaped length.
        fl, off = [], 0
        for (_, n, c) in comp:
            if off >= fused.shape[0]:
                break
            fl.append((off, min(n, fused.shape[0] - off), c))
            off += n
        wdt = _wire_dtype(t.dtype)
        rng = _stochastic_rng(group)
        pfx = _collective_name(group)
        if hier:
            _qreduce_hier(fused, fl, wdt, topo, _hosts(group), rng, _stage3_rng(group), pfx)
        else:
            _qreduce_flat(fused, fl, wdt, topo.intra_reduction, group, rng=rng, pfx=pfx)
        off = 0
        for (o, n) in spans:
            arr[o : o + n] = fused[off : off + n]
            off += n
    with torch.no_grad():
        t.copy_(arr.view(t.shape))


# ---------------------------------------------------------------------------
# The group's worker thread.
# ---------------------------------------------------------------------------


class _Worker:
    """A process group's FIFO thread: it runs the group's bucket
    allreduces in the order they were submitted, so every rank issues the
    same sequence of collectives, off the autograd thread. On the card a
    job runs on the worker's own stream of the bucket's device."""

    def __init__(self, name: str):
        self._jobs: "queue.SimpleQueue[Optional[Callable[[], None]]]" = queue.SimpleQueue()
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self.thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while (job := self._jobs.get()) is not None:
            job()

    def submit(self, job: Callable[[], None]) -> None:
        self._jobs.put(job)

    @contextlib.contextmanager
    def side_stream(self, dev: torch.device, ready: "torch.cuda.Event"):
        """Make the worker's stream of ``dev`` current, ordered after
        ``ready``."""
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            stream.wait_event(ready)
            yield

    def close(self, timeout: float) -> bool:
        """Stop after the jobs already queued; whether the thread ended
        within ``timeout`` seconds."""
        self._jobs.put(None)
        self.thread.join(timeout)
        return not self.thread.is_alive()


_WORKERS: Dict[object, _Worker] = {}
_WORKERS_LOCK = threading.Lock()


def _worker(group: ProcessGroup) -> _Worker:
    key = _group_key(group)
    with _WORKERS_LOCK:
        if key not in _WORKERS:
            _WORKERS[key] = _Worker(f"cgx-bucket-worker-{len(_WORKERS)}")
        return _WORKERS[key]


def allreduce_async(t: torch.Tensor, group: ProcessGroup = None,
                    bucket_key: Optional[Hashable] = None) -> torch.futures.Future:
    """:func:`allreduce` of ``t`` (SUM) with the tag ``bucket_key`` on the
    group's worker thread. Returns a future that holds ``t`` once it is
    reduced, or the exception the reduction raised. On the card the worker's
    stream waits for an event recorded here on the current stream, after
    whatever wrote ``t``, and the future is CUDA-aware: a wait on it orders
    the waiter's current stream after the reduction."""
    worker = _worker(group)
    if t.is_cuda:
        fut = torch.futures.Future(devices=[t.device])
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        where = lambda: worker.side_stream(t.device, ready)  # noqa: E731
    else:
        fut, where = torch.futures.Future(), contextlib.nullcontext

    def job() -> None:
        try:
            with where():
                allreduce(t, group, bucket_key=bucket_key)
                fut.set_result(t)
        except Exception as e:  # carried by the future to the waiter (DDP raises it)
            fut.set_exception(e)

    worker.submit(job)
    return fut


def release(group: ProcessGroup = None, timeout: float = 60.0) -> None:
    """Drop the state kept for ``group``: stop its worker once the buckets
    already queued have run (a bounded join; ``RuntimeError`` if the thread
    is still running after ``timeout`` seconds), forget its frame-seed
    generator and collective count, and forget its host map, setting its
    two-level subgroups aside. The next quantized allreduce over the
    group gathers the map anew; over the same hosts it takes the subgroups
    set aside. They live until the default group is destroyed
    (:func:`destroy_process_group`): a subgroup destroyed and formed again
    over the same ranks would take the destroyed one's name (its members
    and the count of groups the process holds) and read its stale keys in
    the store."""
    key = _group_key(group)
    with _WORKERS_LOCK:
        worker = _WORKERS.pop(key, None)
    if worker is not None and not worker.close(timeout):
        raise RuntimeError(f"the bucket worker {worker.thread.name} did not stop within {timeout} s")
    _RNGS.pop(key, None)
    _SEQ.pop(key, None)
    _QSEQ.pop(key, None)
    hm = _HOSTS.pop(key, None)
    if hm is not None and hm.intra is not None:
        _RETIRED.setdefault(_retired_key(group, hm.hosts), []).append((hm.intra, hm.cross))


def destroy_process_group(group: ProcessGroup = None, timeout: float = 60.0) -> None:
    """:func:`release` ``group`` (the default group: every group and the
    two-level subgroups set aside), then
    ``dist.destroy_process_group(group)``."""
    keys = list(set(_WORKERS) | set(_HOSTS)) if group is None else [group]
    for key in keys:
        release(key, timeout)
    if group is None:
        _RETIRED.clear()
    dist.destroy_process_group(group)
