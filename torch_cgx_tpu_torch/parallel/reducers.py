"""Quantized allreduce over a data-parallel group.

Counterpart of ``torch_cgx_tpu/parallel/reducers.py`` over
``torch.distributed`` instead of ``shard_map``; each ``lax.scan`` there is
a Python loop here, and each ``lax.axis_index`` the rank within the group
the collective runs over.

* SRA (Scatter-Reduce-AllGather). Stage 1: edge-pad the buffer to ``(ws,
  chunk)`` rows, quantize every row and exchange them with
  ``all_to_all_single`` (int32 words, meta). The epilogue: decode the ws
  arriving rows of this rank's chunk, keep the raw own row in place of its
  decode, fold in ascending order and requantize
  (``dispatch.reduce_rows_requantize``, fused or staged). Stage 2:
  ``all_gather_into_tensor`` of the requantized chunks and decode every
  row, one's own included, so every rank holds the same bytes.
* Ring: ws-1 scatter-reduce hops, each requantizing the outgoing segment
  and decode-adding the arriving one, then ws-1 all-gather hops that pass
  each owner's once-quantized segment on, so every rank decodes the same
  bytes.
* All-to-all: quantize once, all-gather every rank's payload, decode and
  fold them in rank order (``dispatch.reduce_rows``).
* Two-level (cross x intra, :func:`hierarchical_allreduce`): the leader
  scheme reduce-scatters inside the node, cross-reduces each rank's chunk
  and all-gathers inside the node again.

Stochastic rounding (``cc.stochastic`` and a ``key``) decorrelates its
streams per rank and per phase where the JAX package folds its key: SRA
``fold_in(fold_in(key, 1 or 2), rank)`` for stages 1 and 2
(:func:`_phase_key`), the Ring ``fold_in(fold_in(key, hop), rank)`` at
each scatter hop and ``fold_in(fold_in(key, ws), rank)`` for the
all-gather quantize, the all-to-all ``fold_in(key, rank)``, the two levels
``fold_in(key, 3)`` intra and ``fold_in(key, 5)`` cross. Every rank
decodes the same bytes, so the replicas stay identical.

Error feedback needs what the peers decode from this rank's contribution
(its wire round trip ``rt``): the ``*_with_wire`` reducers return
``(reduced, rt)``. SRA and the all-to-all decode the very payload they send
(quantize once); the Ring mirrors its hop 0 (:func:`_ring_hop0_wire`) and
the two levels their stage 1 (:func:`sra_stage1_wire`), as the JAX package
does; exact wires give ``rt = x``. :func:`psum_tree` is the exact sum of a
tree, the nonfinite guard's fallback.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from .. import config as cfg_mod
from ..config import CompressionConfig
from ..ops import codec, dispatch
from ..ops.codec import QTensor
from ..utils import prng
from ..utils.tree import round_up
from . import group as group_mod
from .group import ProcessGroup
from .mesh import TwoLevelGroup


def _chunk_size(n: int, ws: int) -> int:
    return round_up(-(-n // ws), codec.LANE_GROUP) if n else codec.LANE_GROUP


def chunk_layout(n: int, ws: int) -> Tuple[int, int]:
    """(chunk elements per rank, padded total) of the SRA wire layout."""
    chunk = _chunk_size(n, ws)
    return chunk, chunk * ws


def _pad_rows(x: torch.Tensor, ws: int, chunk: int) -> torch.Tensor:
    """Edge-pad flat ``x`` to ``(ws, chunk)``."""
    pad = ws * chunk - x.shape[0]
    if pad:
        x = torch.cat([x, x[-1:].expand(pad)])
    return x.reshape(ws, chunk)


def _quantize_1d(x: torch.Tensor, cc: CompressionConfig, key=None) -> QTensor:
    return dispatch.quantize_batch(x[None], cc, key)


def _phase_key(key: Optional[prng.Key], salt: int, rank: int) -> Optional[prng.Key]:
    """The stream of one phase on one rank: ``fold_in(fold_in(key, salt),
    rank)`` (salts 1 and 2: SRA stages 1 and 2)."""
    if key is None:
        return None
    return prng.fold_in(prng.fold_in(key, salt), rank)


def _dequantize_rows(q: QTensor) -> torch.Tensor:
    return dispatch.dequantize_batch(q, out_dtype=torch.float32)


def _dequantize_1d(q: QTensor, add_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    return dispatch.dequantize_batch(
        q, add_to=None if add_to is None else add_to[None], out_dtype=torch.float32
    )[0]


def _map_q(q: QTensor, fn) -> QTensor:
    return QTensor(
        packed=fn(q.packed), meta=fn(q.meta), residual=fn(q.residual),
        numel=q.numel, bits=q.bits, bucket_size=q.bucket_size, dtype=q.dtype,
    )


def _quantize_rows(xs: torch.Tensor, cc: CompressionConfig, key=None) -> QTensor:
    """Stage 1's quantize of ``(ws, m)`` rows (``key``: the phase-1 key)."""
    return dispatch.quantize_batch(xs, cc, key)


def _exchange_async(q: QTensor, group: ProcessGroup) -> Tuple[QTensor, list]:
    """Stage 1's all-to-all of the rows of ``q``, posted without waiting:
    ``(q_recv, works)``; read ``q_recv`` after :func:`_wait_all`."""
    works = []

    def post(t):
        out, work = group_mod.all_to_all_rows_async(t, group)
        works.append(work)
        return out

    return _map_q(q, post), works


def _gather_async(q_own: QTensor, group: ProcessGroup, ws: int) -> Tuple[QTensor, list]:
    """Stage 2's all-gather of the requantized chunk, posted without
    waiting: ``(gathered (ws, ...), works)``."""
    works = []

    def post(t):
        out, work = group_mod.all_gather_rows_async(t, ws, group)
        works.append(work)
        return out

    return _map_q(q_own, post), works


def _wait_all(works) -> None:
    for work in works:
        group_mod.wait(work)


def _sra_exchange(x, group: ProcessGroup, ws: int, cc: CompressionConfig, pre=None, key=None):
    """Stage 1: ``(q, q_recv, xs, own_idx)`` — the sent ``(ws, chunk)``
    payload (quantized with the phase-1 key), the received one (row j =
    this rank's chunk as peer j quantized it), the raw padded rows and this
    rank's position.

    ``pre``: a producer-staged stage-1 payload
    (``ops.fused_producer.Produced``: ``pre.q`` the quantized ``(ws,
    chunk)`` rows, ``pre.raw_row`` the raw own chunk). The quantize is
    skipped, ``x`` is never read and ``xs`` is None; callers take
    ``pre.raw_row`` for the own row."""
    if pre is not None:
        q = pre.q
        xs = None
    else:
        xs = _pad_rows(x, ws, _chunk_size(x.shape[0], ws))
        q = _quantize_rows(xs, cc, _phase_key(key, 1, group_mod.rank(group)))
    q_recv = _map_q(q, lambda t: group_mod.all_to_all_rows(t, group))
    return q, q_recv, xs, group_mod.rank(group)


def _sra_epilogue_q(q_recv, xs, own_idx, cc, out_dtype, raw_row=None, key=None) -> QTensor:
    return dispatch.reduce_rows_requantize(
        q_recv, cc, raw_rows=xs, raw_row=raw_row, own_idx=own_idx, out_dtype=out_dtype,
        key=_phase_key(key, 2, own_idx) if cc.stochastic else None,
    )


def _sra_gather_decode(q_own: QTensor, group: ProcessGroup, ws: int, n: int, dtype):
    gathered = _map_q(q_own, lambda t: group_mod.all_gather_rows(t, ws, group))
    return _dequantize_rows(gathered).reshape(-1)[:n].to(dtype)


def reduce_scatter_quantized(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, key=None
) -> torch.Tensor:
    """SRA round 1: quantize the peers' chunks, exchange them and
    decode-accumulate into the RAW own chunk (``dispatch.reduce_rows``), so
    only the ws-1 peer contributions carry quantization error. Returns this
    rank's reduced chunk, f32 ``(chunk_layout(n, ws)[0],)``."""
    _, q_recv, xs, own_idx = _sra_exchange(x, group, ws, cc, key=key)
    return dispatch.reduce_rows(q_recv, raw_rows=xs, own_idx=own_idx)


def allgather_quantized(
    chunk_f32: torch.Tensor,
    group: ProcessGroup,
    ws: int,
    cc: CompressionConfig,
    n: int,
    out_dtype: torch.dtype,
    key=None,
) -> torch.Tensor:
    """SRA round 2: requantize the owned chunk (phase-2 key), all-gather
    and decode every row, one's own included (error symmetry)."""
    key = _phase_key(key, 2, group_mod.rank(group)) if cc.stochastic else None
    q_own = _quantize_1d(chunk_f32.to(out_dtype), cc, key)
    return _sra_gather_decode(q_own, group, ws, n, out_dtype)


def sra_allreduce(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, pre=None, key=None
) -> torch.Tensor:
    """Quantized Scatter-Reduce-AllGather allreduce of a flat buffer.
    ``pre``: a producer-staged stage-1 payload (see :func:`_sra_exchange`);
    ``x`` then gives only its length and dtype."""
    return sra_wire_frames(x, group, ws, cc, pre, key)[0]


def sra_wire_frames(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, pre=None, key=None
) -> Tuple[torch.Tensor, QTensor, QTensor]:
    """:func:`sra_allreduce` with both wire payloads: ``(out, q_sent,
    q_own)`` — the reduced buffer, the stage-1 ``(ws, chunk)`` QTensor this
    rank sent and the stage-2 requantized chunk it all-gathered."""
    out, q, q_own, _ = _sra(x, group, ws, cc, pre, key)
    return out, q, q_own


def sra_allreduce_with_wire(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, pre=None, key=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sra_allreduce` and this rank's wire round trip: ``(reduced,
    rt)``, ``rt`` what the peers decode from the stage-1 payload this rank
    sent (one decode of those very rows), the own chunk raw, since the
    epilogue folds the raw own row in place of its decode."""
    out, _, _, rt = _sra(x, group, ws, cc, pre, key, roundtrip=True)
    return out, rt


def _sra(x, group, ws, cc, pre, key, roundtrip: bool = False):
    """The one SRA wire: ``(out, q_sent, q_own, rt)``, ``rt`` None unless
    ``roundtrip``."""
    n = x.shape[0]
    q, q_recv, xs, own_idx = _sra_exchange(x, group, ws, cc, pre, key)
    rt = None
    if roundtrip:
        rt_rows = _dequantize_rows(q)
        own = (torch.arange(ws, device=rt_rows.device) == own_idx)[:, None]
        raw_b = xs if pre is None else pre.raw_row[None]
        rt = torch.where(own, raw_b.to(rt_rows.dtype), rt_rows).reshape(-1)[:n].to(x.dtype)
    q_own = _sra_epilogue_q(
        q_recv, xs, own_idx, cc, x.dtype, raw_row=None if pre is None else pre.raw_row, key=key
    )
    return _sra_gather_decode(q_own, group, ws, n, x.dtype), q, q_own, rt


def sra_stage1_wire(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, key=None
) -> torch.Tensor:
    """A mirror of SRA's stage-1 round trip that runs no collective: the
    ``(ws, chunk)`` rows quantized with the phase-1 key and decoded, the own
    row raw. For the two-level scheme, whose wire runs inside
    :func:`hierarchical_allreduce`; a flat group shares the payload
    (:func:`sra_allreduce_with_wire`)."""
    n = x.shape[0]
    rows = _pad_rows(x, ws, _chunk_size(n, ws))
    me = group_mod.rank(group)
    vals = _dequantize_rows(dispatch.quantize_batch(rows, cc, _phase_key(key, 1, me)))
    own = (torch.arange(ws, device=vals.device) == me)[:, None]
    return torch.where(own, rows.to(vals.dtype), vals).reshape(-1)[:n].to(x.dtype)


def _shift_right(q: QTensor, group: ProcessGroup) -> QTensor:
    return _map_q(q, lambda t: group_mod.shift_right(t, group))


def ring_allreduce(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, key=None
) -> torch.Tensor:
    """Quantized ring allreduce: 2*(ws-1) hops to the right neighbour.
    Scatter-reduce: rank r sends segment (r - step) % ws, requantized every
    hop, and decode-adds the arriving segment (r - step - 1) % ws. All-gather:
    rank r owns segment (r + 1) % ws, quantizes it once and passes each
    owner's payload on, so every rank decodes the same bytes."""
    n = x.shape[0]
    dtype = x.dtype
    if ws == 1:
        return x
    seg = _chunk_size(n, ws)
    me = group_mod.rank(group)
    acc = _pad_rows(x.to(torch.float32), ws, seg).clone()
    use_key = key is not None and cc.stochastic
    for step in range(ws - 1):
        k = prng.fold_in(prng.fold_in(key, step), me) if use_key else None
        q = _quantize_1d(acc[(me - step) % ws].to(dtype), cc, k)
        q_in = _shift_right(q, group)
        recv_idx = (me - step - 1) % ws
        acc[recv_idx] = dispatch.reduce_rows(q_in, add_to=acc[recv_idx])
    own_idx = (me + 1) % ws
    k = prng.fold_in(prng.fold_in(key, ws), me) if use_key else None
    cur = _quantize_1d(acc[own_idx].to(dtype), cc, k)
    out = torch.empty((ws, seg), dtype=torch.float32, device=x.device)
    out[own_idx] = _dequantize_1d(cur)
    for step in range(ws - 1):
        cur = _shift_right(cur, group)
        out[(me - step) % ws] = _dequantize_1d(cur)
    return out.reshape(-1)[:n].to(dtype)


def _ring_hop0_wire(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, key=None
) -> torch.Tensor:
    """The Ring's round trip for error feedback: ``x`` with its own segment
    (row ``rank`` of the padded rows, what hop 0 sends) quantized with hop
    0's key ``fold_in(fold_in(key, 0), rank)`` and decoded. The later hops
    requantize partial sums and count as exact (the JAX package's
    approximation). A mirror: it quantizes 1/ws of the buffer again."""
    n = x.shape[0]
    me = group_mod.rank(group)
    rows = _pad_rows(x, ws, _chunk_size(n, ws)).clone()
    k = prng.fold_in(prng.fold_in(key, 0), me) if key is not None and cc.stochastic else None
    q = dispatch.quantize_batch(rows[me : me + 1], cc, k)
    rows[me] = dispatch.dequantize_batch(q, out_dtype=x.dtype)[0]
    return rows.reshape(-1)[:n]


def _alltoall_q(x: torch.Tensor, group: ProcessGroup, cc: CompressionConfig, key=None) -> QTensor:
    k = None
    if key is not None and cc.stochastic:
        k = prng.fold_in(key, group_mod.rank(group))
    return _quantize_1d(x, cc, k)


def _alltoall_fold(q: QTensor, group: ProcessGroup, ws: int, dtype) -> torch.Tensor:
    gathered = _map_q(q, lambda t: group_mod.all_gather_rows(t, ws, group))
    return dispatch.reduce_rows(gathered).to(dtype)


def alltoall_allreduce(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, key=None
) -> torch.Tensor:
    """Quantize once, all-gather every rank's payload, decode and fold the
    rows in rank order. O(ws * n) traffic: the debug path."""
    return _alltoall_fold(_alltoall_q(x, group, cc, key), group, ws, x.dtype)


def alltoall_allreduce_with_wire(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig, key=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`alltoall_allreduce` and this rank's round trip, the decode of
    the one row every peer decodes."""
    q = _alltoall_q(x, group, cc, key)
    return _alltoall_fold(q, group, ws, x.dtype), _dequantize_1d(q).to(x.dtype)


def alltoall_stage1_wire(
    x: torch.Tensor, group: ProcessGroup, cc: CompressionConfig, key=None
) -> torch.Tensor:
    """The all-to-all's round trip without the collective (the two-level
    scheme's mirror): the row quantized with ``fold_in(key, rank)`` and
    decoded."""
    return _dequantize_1d(_alltoall_q(x, group, cc, key)).to(x.dtype)


def _force_codec_proxy(x: torch.Tensor, cc: CompressionConfig, key=None) -> torch.Tensor:
    """CGX_DEBUG_FORCE_CODEC at world size 1: the per-rank kernel sequence
    of a real SRA step, so one card measures codec cost in a train step.
    Fused era: quantize -> fused epilogue (rows=1, the phase-2 key) ->
    decode; the value is decode(requant(decode)). Staged era: one quantize
    and two decodes, one through the accumulate path, averaged so both stay
    live."""
    q = _quantize_1d(x, cc, key)
    if dispatch.fused_epilogue_would_run(q):
        k2 = _phase_key(key, 2, 0) if cc.stochastic else None
        q2 = dispatch.reduce_rows_requantize(q, cc, out_dtype=x.dtype, key=k2)
        return _dequantize_1d(q2).to(x.dtype)
    dec_assign = _dequantize_1d(q)
    dec_acc = _dequantize_1d(q, add_to=x) - x.to(torch.float32)
    return ((dec_assign + dec_acc) * 0.5).to(x.dtype)


def _check_pre(pre, reduction: str, ws: int, cc: CompressionConfig) -> None:
    if pre is not None and (
        reduction != cfg_mod.REDUCTION_SRA
        or ws == 1
        or not cc.enabled
        or cfg_mod.dummy_compression()
    ):
        raise ValueError(
            "producer-staged payloads route only to the multi-rank SRA "
            f"transport (got reduction={reduction!r}, ws={ws})"
        )


def quantized_allreduce(
    x: torch.Tensor,
    group: ProcessGroup,
    ws: int,
    cc: CompressionConfig,
    reduction: str = cfg_mod.REDUCTION_SRA,
    pre=None,
    key: Optional[prng.Key] = None,
) -> torch.Tensor:
    """Allreduce (sum) of a flat buffer, dispatched on the reduction type.
    ``pre`` (a producer-staged stage-1 payload) is for the multi-rank SRA
    only; ``key`` rounds stochastically where ``cc.stochastic``."""
    _check_pre(pre, reduction, ws, cc)
    if ws == 1:
        if cc.enabled and cfg_mod.force_codec():
            return _force_codec_proxy(x, cc, key)
        return x
    if cfg_mod.dummy_compression():
        # Pass-through codec: the raw f32 bits travel, to test the transport.
        q = codec.quantize_dummy(x)
        gathered = group_mod.all_gather_rows(q.packed[None], ws, group)
        return dispatch.ordered_rowsum(gathered.view(torch.float32)).to(x.dtype)
    if not cc.enabled or reduction == cfg_mod.REDUCTION_PSUM:
        return group_mod.all_reduce_sum(x, group)
    if reduction == cfg_mod.REDUCTION_SRA:
        return sra_allreduce(x, group, ws, cc, pre, key)
    if reduction == cfg_mod.REDUCTION_RING:
        return ring_allreduce(x, group, ws, cc, key)
    if reduction == cfg_mod.REDUCTION_ALLTOALL:
        return alltoall_allreduce(x, group, ws, cc, key)
    raise ValueError(f"unknown reduction {reduction!r}")


def quantized_allreduce_with_wire(
    x: torch.Tensor,
    group: ProcessGroup,
    ws: int,
    cc: CompressionConfig,
    reduction: str = cfg_mod.REDUCTION_SRA,
    pre=None,
    key: Optional[prng.Key] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantized_allreduce` and this rank's wire round trip ``rt``
    (``(reduced, rt)``), for error feedback. The exact wires (PSUM,
    compression off, the dummy codec, one rank without the force-codec
    knob) give ``rt = x``; the world-size-1 force-codec proxy gives ``rt =
    reduced``. SRA and the all-to-all decode the payload they send, the
    Ring mirrors its hop 0. ``pre`` is for the multi-rank SRA only."""
    _check_pre(pre, reduction, ws, cc)
    if ws == 1:
        out = quantized_allreduce(x, group, ws, cc, reduction, key=key)
        return out, out
    if cfg_mod.dummy_compression() or not cc.enabled or reduction == cfg_mod.REDUCTION_PSUM:
        return quantized_allreduce(x, group, ws, cc, reduction, key=key), x
    if reduction == cfg_mod.REDUCTION_SRA:
        return sra_allreduce_with_wire(x, group, ws, cc, pre, key)
    if reduction == cfg_mod.REDUCTION_ALLTOALL:
        return alltoall_allreduce_with_wire(x, group, ws, cc, key)
    if reduction == cfg_mod.REDUCTION_RING:
        return ring_allreduce(x, group, ws, cc, key), _ring_hop0_wire(x, group, ws, cc, key)
    raise ValueError(f"unknown reduction {reduction!r}")


def psum_tree(tree: Mapping[str, torch.Tensor], group: ProcessGroup = None) -> Dict[str, torch.Tensor]:
    """The exact (uncompressed) sum of named tensors over ``group``, the
    nonfinite guard's fallback: the leaves of each dtype concatenated,
    all-gathered once, and folded in ascending rank order in that dtype
    (``dispatch.ordered_rowsum``), so every rank holds the same bits."""
    ws = group_mod.world_size(group)
    if ws == 1:
        return dict(tree)
    by_dtype: Dict[torch.dtype, list] = {}
    for name, t in tree.items():
        by_dtype.setdefault(t.dtype, []).append(name)
    out: Dict[str, torch.Tensor] = {}
    for names in by_dtype.values():
        flat = torch.cat([tree[n].reshape(-1) for n in names])
        total = dispatch.ordered_rowsum(group_mod.all_gather_rows(flat[None], ws, group))
        off = 0
        for n in names:
            k = tree[n].numel()
            out[n] = total[off : off + k].view(tree[n].shape)
            off += k
    return {n: out[n] for n in tree}


def hierarchical_allreduce(
    x: torch.Tensor,
    groups: TwoLevelGroup,
    cc: CompressionConfig,
    topology: Optional[cfg_mod.TopologyConfig] = None,
    key: Optional[prng.Key] = None,
) -> torch.Tensor:
    """Two-level allreduce over the ``(cross, intra)`` subgroups.

    With ``intra_broadcast`` (the leader scheme): quantized reduce-scatter
    inside the node, each rank cross-reduces only its own chunk, quantized
    all-gather inside the node. Without it: a full intra allreduce, then a
    full cross allreduce. An uncompressed intra level runs a plain
    reduce-scatter and all-gather. A level of size 1 is skipped. The two
    levels round with ``fold_in(key, 3)`` and ``fold_in(key, 5)``: a rank's
    intra and cross ranks can coincide, so the phase salts alone would not
    decorrelate them."""
    topo = topology or cfg_mod.topology_from_env()
    n = x.shape[0]
    wi, wc = groups.intra_size, groups.cross_size
    intra_cc = cc if topo.intra_compress else CompressionConfig(bits=32)
    cross_cc = cc if topo.cross_compress else CompressionConfig(bits=32)
    ki = prng.fold_in(key, 3) if key is not None else None
    kc = prng.fold_in(key, 5) if key is not None else None
    if wi == 1 and wc == 1:
        return x
    if wi == 1:
        return quantized_allreduce(x, groups.cross, wc, cross_cc, topo.cross_reduction, key=kc)
    if wc == 1:
        return quantized_allreduce(x, groups.intra, wi, intra_cc, topo.intra_reduction, key=ki)
    if not topo.intra_broadcast:
        y = quantized_allreduce(x, groups.intra, wi, intra_cc, topo.intra_reduction, key=ki)
        return quantized_allreduce(y, groups.cross, wc, cross_cc, topo.cross_reduction, key=kc)

    compressed = intra_cc.enabled and not cfg_mod.dummy_compression()
    if compressed:
        chunk = reduce_scatter_quantized(x, groups.intra, wi, intra_cc, ki)
    else:
        xp = _pad_rows(x.to(torch.float32), wi, _chunk_size(n, wi)).reshape(-1)
        chunk = group_mod.reduce_scatter_sum(xp, wi, groups.intra)
    chunk = quantized_allreduce(
        chunk.to(x.dtype), groups.cross, wc, cross_cc, topo.cross_reduction, key=kc
    ).to(torch.float32)
    if compressed:
        return allgather_quantized(chunk, groups.intra, wi, intra_cc, n, x.dtype, ki)
    full = group_mod.all_gather_rows(chunk[None], wi, groups.intra).reshape(-1)
    return full[:n].to(x.dtype)
