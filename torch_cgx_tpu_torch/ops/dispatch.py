"""Codec dispatch and the SRA epilogue's two lowerings.

Counterpart of ``torch_cgx_tpu/ops/dispatch.py``. Buffers the chunk kernels
cover go through ``codec_cuda`` (the kernel on a CUDA tensor, its plain
version on a CPU tensor); the rest (buffers shorter than a bucket, buckets
that are not a multiple of 32) through ``ops/codec.py``, as the JAX package
leaves them to XLA. Both give the same wire bytes.

``CGX_SRA_EPILOGUE`` picks the epilogue lowering: "auto" takes the fused
kernel for CUDA payloads at or above ``CGX_SRA_EPILOGUE_MIN_ELEMS`` and the
staged decode/sum/quantize otherwise, "fused" and "staged" force one. Both
lowerings give the same bytes under the default ``CGX_SRA_ACCUM=exact``.
``reduce_rows`` (the reduce without the requantize: the all-to-all
reduction and the reduce-scatter half of SRA) takes the fused reduce kernel
under the same rule; both gates are the JAX package's eligibility.

``CGX_SRA_ACCUM=int8`` (or an explicit ``accum``) folds in the level domain
where the fused kernels run; the staged lowering folds exactly whatever it
says, as the JAX package's does.

Inside the batch functions ``CGX_PALLAS_DB`` and the autotune cache pick
the single-stage or the pipelined kernel (same bytes);
:func:`db_would_run` tells which without running it.

Rounding is stochastic where the config says so (``cc.stochastic``) and a
key (``utils/prng.Key``) is given, as in the JAX package; otherwise to
nearest. The fused and the staged epilogue give the same stochastic bytes.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import config as cfg_mod
from ..config import CompressionConfig
from ..utils import prng
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


def _seed(cc: CompressionConfig, key: Optional[prng.Key]) -> Optional[int]:
    """The kernels' seed: stochastic iff ``cc.stochastic`` and a key."""
    return prng.seed_from_key(key) if cc.stochastic and key is not None else None


def quantize_batch(
    xs: torch.Tensor, cc: CompressionConfig, key: Optional[prng.Key] = None
) -> QTensor:
    """Quantize each row of ``xs (rows, m)``; stochastic iff
    ``cc.stochastic`` and a key is given. Rows the chunk kernels do not
    cover round with ``fold_in(key, row)``, as the JAX package's XLA path
    does."""
    seed = _seed(cc, key)
    if codec_cuda.supports(xs.shape[1], cc.bits, cc.bucket_size, cc.skip_incomplete_buckets):
        return codec_cuda.quantize_batch(
            xs, cc.bits, cc.bucket_size,
            skip_incomplete_buckets=cc.skip_incomplete_buckets, seed=seed,
        )
    return _stack_rows([
        codec.quantize(
            r, cc.bits, cc.bucket_size,
            skip_incomplete_buckets=cc.skip_incomplete_buckets,
            key=None if seed is None else prng.fold_in(key, i),
        )
        for i, r in enumerate(xs)
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


def db_would_run(q: QTensor, kernel: str, *, with_add: bool = False,
                 stochastic: bool = False) -> bool:
    """True when the dispatcher sends a payload of ``q``'s layout to the
    pipelined kernel of ``kernel``: "quantize" (:func:`quantize_batch` of
    rows of that length), "dequantize" (:func:`dequantize_batch`;
    ``with_add``: with an accumulator that fuses) or "epilogue"
    (:func:`reduce_rows_requantize`; ``stochastic``: with a key, which
    makes no autotune lookup). On the card that is a launch of
    ``codec_<kernel>_db`` in place of the single-stage kernel; the launch
    model of ``chip_smoke.py`` and the CPU tests read the routing here."""
    if kernel == "epilogue":
        if not _use_fused_reduce(q):
            return False
    elif not (q.bits and codec_cuda.supports(
            q.numel, q.bits, q.bucket_size, bool(q.residual.shape[-1]))):
        return False
    return codec_cuda.db_would_run(kernel, q, with_add=with_add, stochastic=stochastic)


def fused_reduce_would_run(q: QTensor) -> bool:
    """True when :func:`reduce_rows` takes the fused reduce kernel for this
    QTensor (rows > 1, no accumulator)."""
    return q.batch_rows > 1 and _use_fused_reduce(q)


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
    raw_row: Optional[torch.Tensor] = None,
    own_idx: Optional[int] = None,
    add_to: Optional[torch.Tensor] = None,
    accum: Optional[str] = None,
) -> torch.Tensor:
    """Dequantize-accumulate a row-batched QTensor -> flat f32 ``(numel,)``:
    decode every row, substitute the raw own chunk (``raw_rows[own_idx]``,
    or the pre-sliced ``raw_row``) for its decode, sum in ascending order.
    ``add_to`` (flat) is a pre-accumulator: the Ring hop's decode-add. The
    fused reduce kernel where :func:`fused_reduce_would_run` and there is
    no accumulator, folding by ``accum`` (None: ``CGX_SRA_ACCUM``); the
    staged decode/select/sum otherwise, always exact: the same values
    under the exact fold."""
    if raw_rows is not None and raw_row is not None:
        raise ValueError("pass raw_rows or raw_row, not both")
    rows = q.batch_rows
    have_raw = raw_rows is not None or raw_row is not None
    if add_to is None and fused_reduce_would_run(q):
        rr = raw_rows[own_idx] if raw_rows is not None else raw_row
        return codec_cuda.reduce_rows_batch(q, raw_row=rr, own_idx=own_idx, accum=accum)
    if rows == 1 and not have_raw:
        return dequantize_batch(
            q, add_to=None if add_to is None else add_to[None], out_dtype=torch.float32
        )[0]
    vals = dequantize_batch(q, out_dtype=torch.float32)
    if have_raw:
        own = (torch.arange(rows, device=vals.device) == own_idx)[:, None]
        raw_b = raw_rows if raw_rows is not None else raw_row[None]
        vals = torch.where(own, raw_b.to(torch.float32), vals)
    red = ordered_rowsum(vals)
    if add_to is not None:
        red = add_to.to(torch.float32) + red
    return red


def reduce_rows_requantize(
    q: QTensor,
    cc: CompressionConfig,
    *,
    raw_rows: Optional[torch.Tensor] = None,
    raw_row: Optional[torch.Tensor] = None,
    own_idx: Optional[int] = None,
    out_dtype: torch.dtype = torch.float32,
    key: Optional[prng.Key] = None,
    accum: Optional[str] = None,
) -> QTensor:
    """The SRA epilogue: :func:`reduce_rows` + requantize of the reduced
    chunk into a rows=1 QTensor (the stage-2 payload), stochastic iff
    ``cc.stochastic`` and a key is given. One fused kernel where
    :func:`fused_epilogue_would_run`, folding by ``accum`` (None:
    ``CGX_SRA_ACCUM``), the staged ops otherwise; the same bytes either way
    under the exact fold. ``raw_row`` is the pre-sliced own chunk of a
    producer-staged caller, in place of ``raw_rows[own_idx]``."""
    if raw_rows is not None and raw_row is not None:
        raise ValueError("pass raw_rows or raw_row, not both")
    if _use_fused_reduce(q):
        return codec_cuda.sra_epilogue_batch(
            q, raw_row=raw_rows[own_idx] if raw_rows is not None else raw_row,
            own_idx=own_idx, out_dtype=out_dtype, seed=_seed(cc, key), accum=accum,
        )
    reduced = reduce_rows(q, raw_rows=raw_rows, raw_row=raw_row, own_idx=own_idx, accum=accum)
    return quantize_batch(reduced.to(out_dtype)[None], cc, key)
