"""Quantized allreduce over a data-parallel group.

Counterpart of ``torch_cgx_tpu/parallel/reducers.py``, cut to the SRA
(Scatter-Reduce-AllGather) path the gradient sync runs, over
``torch.distributed`` instead of ``shard_map``:

* stage 1: edge-pad the buffer to ``(ws, chunk)`` rows, quantize every row
  and exchange them with ``all_to_all_single`` (int32 words, meta);
* the epilogue: decode the ws arriving rows of this rank's chunk, keep the
  raw own row in place of its decode, fold in ascending order and
  requantize (``dispatch.reduce_rows_requantize``, fused or staged);
* stage 2: ``all_gather_into_tensor`` of the requantized chunks and decode
  every row, one's own included, so every rank holds the same bytes.

Ring, all-to-all and the two-level (hierarchical) reductions wait
(ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import config as cfg_mod
from ..config import CompressionConfig
from ..ops import codec, dispatch
from ..ops.codec import QTensor
from ..utils.tree import round_up
from . import group as group_mod
from .group import ProcessGroup


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


def _quantize_1d(x: torch.Tensor, cc: CompressionConfig) -> QTensor:
    return dispatch.quantize_batch(x[None], cc)


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


def _sra_exchange(x, group: ProcessGroup, ws: int, cc: CompressionConfig):
    """Stage 1: ``(q, q_recv, xs, own_idx)`` — the sent ``(ws, chunk)``
    payload, the received one (row j = this rank's chunk as peer j
    quantized it), the raw padded rows and this rank's position."""
    xs = _pad_rows(x, ws, _chunk_size(x.shape[0], ws))
    q = dispatch.quantize_batch(xs, cc)
    q_recv = _map_q(q, lambda t: group_mod.all_to_all_rows(t, group))
    return q, q_recv, xs, group_mod.rank(group)


def _sra_epilogue_q(q_recv, xs, own_idx, cc, out_dtype) -> QTensor:
    return dispatch.reduce_rows_requantize(
        q_recv, cc, raw_rows=xs, own_idx=own_idx, out_dtype=out_dtype
    )


def _sra_gather_decode(q_own: QTensor, group: ProcessGroup, ws: int, n: int, dtype):
    gathered = _map_q(q_own, lambda t: group_mod.all_gather_rows(t, ws, group))
    return _dequantize_rows(gathered).reshape(-1)[:n].to(dtype)


def sra_allreduce(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig
) -> torch.Tensor:
    """Quantized Scatter-Reduce-AllGather allreduce of a flat buffer."""
    return sra_wire_frames(x, group, ws, cc)[0]


def sra_wire_frames(
    x: torch.Tensor, group: ProcessGroup, ws: int, cc: CompressionConfig
) -> Tuple[torch.Tensor, QTensor, QTensor]:
    """:func:`sra_allreduce` with both wire payloads: ``(out, q_sent,
    q_own)`` — the reduced buffer, the stage-1 ``(ws, chunk)`` QTensor this
    rank sent and the stage-2 requantized chunk it all-gathered."""
    n = x.shape[0]
    q, q_recv, xs, own_idx = _sra_exchange(x, group, ws, cc)
    q_own = _sra_epilogue_q(q_recv, xs, own_idx, cc, x.dtype)
    return _sra_gather_decode(q_own, group, ws, n, x.dtype), q, q_own


def _force_codec_proxy(x: torch.Tensor, cc: CompressionConfig) -> torch.Tensor:
    """CGX_DEBUG_FORCE_CODEC at world size 1: the per-rank kernel sequence
    of a real SRA step, so one card measures codec cost in a train step.
    Fused era: quantize -> fused epilogue (rows=1) -> decode; the value is
    decode(requant(decode)). Staged era: one quantize and two decodes, one
    through the accumulate path, averaged so both stay live."""
    q = _quantize_1d(x, cc)
    if dispatch.fused_epilogue_would_run(q):
        q2 = dispatch.reduce_rows_requantize(q, cc, out_dtype=x.dtype)
        return _dequantize_1d(q2).to(x.dtype)
    dec_assign = _dequantize_1d(q)
    dec_acc = _dequantize_1d(q, add_to=x) - x.to(torch.float32)
    return ((dec_assign + dec_acc) * 0.5).to(x.dtype)


def quantized_allreduce(
    x: torch.Tensor,
    group: ProcessGroup,
    ws: int,
    cc: CompressionConfig,
    reduction: str = cfg_mod.REDUCTION_SRA,
) -> torch.Tensor:
    """Allreduce (sum) of a flat buffer, dispatched on the reduction type."""
    if ws == 1:
        if cc.enabled and cfg_mod.force_codec():
            return _force_codec_proxy(x, cc)
        return x
    if cfg_mod.dummy_compression():
        # Pass-through codec: the raw f32 bits travel, to test the transport.
        q = codec.quantize_dummy(x)
        gathered = group_mod.all_gather_rows(q.packed[None], ws, group)
        return dispatch.ordered_rowsum(gathered.view(torch.float32)).to(x.dtype)
    if not cc.enabled or reduction == cfg_mod.REDUCTION_PSUM:
        return group_mod.all_reduce_sum(x, group)
    if reduction == cfg_mod.REDUCTION_SRA:
        return sra_allreduce(x, group, ws, cc)
    raise NotImplementedError(
        f"reduction {reduction!r} is not ported yet (SRA and PSUM are)"
    )
