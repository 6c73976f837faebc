"""Codec dispatch and the SRA epilogue's two lowerings.

Counterpart of ``torch_cgx_tpu/ops/dispatch.py``. Buffers the chunk kernels
cover go through ``codec_cuda`` (the kernel on a CUDA tensor, its plain
version on a CPU tensor); the rest (buffers shorter than a bucket, buckets
that are not a multiple of 32) through ``ops/codec.py``, as the JAX package
leaves them to XLA. Both give the same wire bytes.

``CGX_SRA_EPILOGUE`` picks the epilogue lowering: "auto" takes the fused
kernel for CUDA payloads at or above ``CGX_SRA_EPILOGUE_MIN_ELEMS`` and the
staged decode/sum/quantize otherwise, "fused" and "staged" force one. Both
lowerings give the same bytes.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import config as cfg_mod
from ..config import CompressionConfig
from . import codec, codec_cuda
from .codec import QTensor


def _stack_rows(qs: List[QTensor]) -> QTensor:
    q0 = qs[0]
    return QTensor(
        packed=torch.stack([q.packed for q in qs]),
        meta=torch.stack([q.meta for q in qs]),
        residual=torch.stack([q.residual for q in qs]),
        numel=q0.numel,
        bits=q0.bits,
        bucket_size=q0.bucket_size,
        dtype=q0.dtype,
    )


def _row(q: QTensor, r: int) -> QTensor:
    return QTensor(
        packed=q.packed[r], meta=q.meta[r], residual=q.residual[r],
        numel=q.numel, bits=q.bits, bucket_size=q.bucket_size, dtype=q.dtype,
    )


def quantize_batch(xs: torch.Tensor, cc: CompressionConfig) -> QTensor:
    """Quantize each row of ``xs (rows, m)`` (deterministic rounding)."""
    if cc.stochastic:
        raise NotImplementedError(
            "stochastic rounding is not ported (it needs a Philox stream in "
            "the kernels); unset CGX_STOCHASTIC_ROUNDING"
        )
    if codec_cuda.supports(xs.shape[1], cc.bits, cc.bucket_size, cc.skip_incomplete_buckets):
        return codec_cuda.quantize_batch(
            xs, cc.bits, cc.bucket_size,
            skip_incomplete_buckets=cc.skip_incomplete_buckets,
        )
    return _stack_rows([
        codec.quantize(
            r, cc.bits, cc.bucket_size,
            skip_incomplete_buckets=cc.skip_incomplete_buckets,
        )
        for r in xs
    ])


def dequantize_batch(
    q: QTensor,
    *,
    add_to: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Decode a row-batched QTensor -> ``(rows, numel)``."""
    skip = bool(q.residual.shape[-1])
    if q.bits and codec_cuda.supports(q.numel, q.bits, q.bucket_size, skip):
        return codec_cuda.dequantize_batch(q, add_to=add_to, out_dtype=out_dtype)
    rows = q.packed.shape[0]
    return torch.stack([
        codec.dequantize(
            _row(q, r),
            add_to=None if add_to is None else add_to[r],
            out_dtype=out_dtype,
        )
        for r in range(rows)
    ])


def _use_fused_reduce(q: QTensor) -> bool:
    mode = cfg_mod.sra_epilogue()
    if mode == "staged" or not codec_cuda.supports_reduce(q):
        return False
    if mode == "fused":
        return True
    if q.batch_rows * q.numel < cfg_mod.sra_epilogue_min_elems():
        return False
    return q.packed.is_cuda


def fused_epilogue_would_run(q: QTensor) -> bool:
    """True when :func:`reduce_rows_requantize` takes the fused kernel for
    this QTensor: the world-size-1 proxy keys its kernel sequence off it."""
    return _use_fused_reduce(q)


def ordered_rowsum(vals: torch.Tensor) -> torch.Tensor:
    """``v0 + v1 + ...`` ascending: the fold order both lowerings pin, since
    a last-ulp change in the sum is a different requantized wire byte."""
    red = vals[0]
    for r in range(1, vals.shape[0]):
        red = red + vals[r]
    return red


def reduce_rows(
    q: QTensor,
    *,
    raw_rows: Optional[torch.Tensor] = None,
    own_idx: Optional[int] = None,
) -> torch.Tensor:
    """Staged dequantize-accumulate of a row-batched QTensor -> flat f32
    ``(numel,)``: decode every row, substitute the raw own chunk
    ``raw_rows[own_idx]`` for its decode, sum in ascending order."""
    vals = dequantize_batch(q, out_dtype=torch.float32)
    if raw_rows is not None:
        own = (torch.arange(q.batch_rows, device=vals.device) == own_idx)[:, None]
        vals = torch.where(own, raw_rows.to(torch.float32), vals)
    return ordered_rowsum(vals)


def reduce_rows_requantize(
    q: QTensor,
    cc: CompressionConfig,
    *,
    raw_rows: Optional[torch.Tensor] = None,
    own_idx: Optional[int] = None,
    out_dtype: torch.dtype = torch.float32,
) -> QTensor:
    """The SRA epilogue: :func:`reduce_rows` + requantize of the reduced
    chunk into a rows=1 QTensor (the stage-2 payload). One fused kernel
    where :func:`fused_epilogue_would_run`, the staged ops otherwise."""
    if _use_fused_reduce(q):
        return codec_cuda.sra_epilogue_batch(
            q, raw_row=None if raw_rows is None else raw_rows[own_idx],
            own_idx=own_idx, out_dtype=out_dtype,
        )
    reduced = reduce_rows(q, raw_rows=raw_rows, own_idx=own_idx)
    return quantize_batch(reduced.to(out_dtype)[None], cc)
