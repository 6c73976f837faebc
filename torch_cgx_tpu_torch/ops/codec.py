"""Bucketwise max-min quantization: the wire format and its plain oracle.

Counterpart of ``torch_cgx_tpu/ops/codec.py`` in plain PyTorch, with the
same bytes on the wire:

* per bucket of ``bucket_size`` values, ``unit = (max - min) *
  f32(1/(2^bits - 1))`` (a multiply by a constant rounded once to f32, never
  a divide) and ``level = clip(floor((x - min) / safe + 0.5), 0, 2^bits-1)``
  with ``safe = unit if unit > 0 else 1`` (an IEEE divide);
* meta is the ``(unit, min)`` pair of each bucket, in the tensor's dtype;
* full chunks of 32 buckets are packed as bit planes: word ``(c, w, l)``
  (flat index ``c*bits*B + w*B + l``) holds bit ``w`` of the level at
  position ``l`` of each of the chunk's 32 buckets, bucket ``s`` in bit
  ``s``; the final ``nb % 32`` buckets use the dense layout (32 consecutive
  values per group, ``bits`` words per group);
* the final partial bucket is edge-padded, so constant buckets decode to
  exactly their value;
* decode is ``min + unit * level`` with the product rounded before the add.

Words are stored as ``torch.int32``: PyTorch has no uint32 arithmetic, and
every operation here (shift, and, or, disjoint sums) is exact in int32 with
wrap-around. Compare words as uint32 views.

The functions here are the plain versions the CUDA kernels in
``codec_cuda.py`` are held against; a CPU tensor runs them directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

LANE_GROUP = 32  # values per packing group
CHUNK_BUCKETS = 32  # buckets per bit-plane chunk


def num_buckets(n: int, bucket_size: int) -> int:
    return -(-n // bucket_size)


def unit_scale(bits: int) -> float:
    """``f32(1 / (2^bits - 1))`` as a Python float (exact in double), the
    constant every implementation multiplies the bucket range by."""
    return float(np.float32(1.0 / ((1 << bits) - 1)))


@dataclasses.dataclass
class QTensor:
    """Quantized wire tensor.

    ``packed``: int32 words; ``(W,)`` flat or ``(rows, W)`` row-batched.
    ``meta``: ``(nb, 2)`` or ``(rows, nb, 2)`` per-bucket ``(unit, min)`` in
    the tensor dtype. ``residual``: the raw final partial bucket in
    skip-incomplete mode (length 0 otherwise)."""

    packed: torch.Tensor
    meta: torch.Tensor
    residual: torch.Tensor
    numel: int
    bits: int
    bucket_size: int
    dtype: torch.dtype

    @property
    def numel_main(self) -> int:
        return self.numel - self.residual.shape[-1]

    @property
    def batch_rows(self) -> int:
        return self.packed.shape[0] if self.packed.dim() == 2 else 1


# ---------------------------------------------------------------------------
# Bit-plane packing.
# ---------------------------------------------------------------------------


def _u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bit pattern."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def pack_levels_bucketed(lvl: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack levels ``(nb, B)`` (any integer dtype, values < 2^bits) into the
    chunked wire layout -> flat int32 words."""
    nb, b = lvl.shape
    c, r = divmod(nb, CHUNK_BUCKETS)
    parts = []
    if c:
        head = lvl[: c * CHUNK_BUCKETS].reshape(c, CHUNK_BUCKETS, b).to(torch.int64)
        sub = torch.arange(CHUNK_BUCKETS, device=lvl.device, dtype=torch.int64)
        sub = sub.view(1, CHUNK_BUCKETS, 1)
        planes = [
            ((head >> w) & 1).bitwise_left_shift(sub).sum(dim=1)
            for w in range(bits)
        ]
        parts.append(_u32_to_i32(torch.stack(planes, dim=1)).reshape(-1))
    if r:
        parts.append(pack_levels(lvl[c * CHUNK_BUCKETS :].reshape(-1), bits))
    if not parts:
        return torch.zeros((0,), dtype=torch.int32, device=lvl.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unpack_levels_bucketed(
    words: torch.Tensor, bits: int, nb: int, bucket_size: int
) -> torch.Tensor:
    """Inverse of :func:`pack_levels_bucketed` -> int32 levels ``(nb, B)``."""
    b = bucket_size
    c, r = divmod(nb, CHUNK_BUCKETS)
    parts = []
    head_words = c * bits * b
    if c:
        w3 = words[:head_words].reshape(c, bits, b)
        sub = torch.arange(CHUNK_BUCKETS, device=words.device, dtype=torch.int32)
        sub = sub.view(1, CHUNK_BUCKETS, 1)
        lvl = torch.zeros((c, CHUNK_BUCKETS, b), dtype=torch.int32, device=words.device)
        for w in range(bits):
            lvl |= ((w3[:, w : w + 1, :] >> sub) & 1) << w
        parts.append(lvl.reshape(c * CHUNK_BUCKETS, b))
    if r:
        parts.append(unpack_levels(words[head_words:], bits, r * b).reshape(r, b))
    if not parts:
        return torch.zeros((0, b), dtype=torch.int32, device=words.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def pack_levels(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Dense (tail) packing: flat levels ``(m,)`` -> int32 words
    ``(ceil(m/32) * bits,)``, 32 consecutive values per group."""
    m = levels.shape[0]
    if m == 0:
        return torch.zeros((0,), dtype=torch.int32, device=levels.device)
    groups = -(-m // LANE_GROUP)
    padded = torch.zeros(groups * LANE_GROUP, dtype=torch.int64, device=levels.device)
    padded[:m] = levels
    g = padded.reshape(groups, LANE_GROUP)
    lane = torch.arange(LANE_GROUP, device=levels.device, dtype=torch.int64).view(1, -1)
    planes = [((g >> w) & 1).bitwise_left_shift(lane).sum(dim=1) for w in range(bits)]
    return _u32_to_i32(torch.stack(planes, dim=1)).reshape(-1)


def unpack_levels(words: torch.Tensor, bits: int, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_levels` -> int32 levels ``(m,)``."""
    if m == 0:
        return torch.zeros((0,), dtype=torch.int32, device=words.device)
    groups = -(-m // LANE_GROUP)
    w2 = words.reshape(groups, bits)
    lane = torch.arange(LANE_GROUP, device=words.device, dtype=torch.int32).view(1, -1)
    lvl = torch.zeros((groups, LANE_GROUP), dtype=torch.int32, device=words.device)
    for w in range(bits):
        lvl |= ((w2[:, w : w + 1] >> lane) & 1) << w
    return lvl.reshape(-1)[:m]


# ---------------------------------------------------------------------------
# Quantize / dequantize.
# ---------------------------------------------------------------------------


def _split_residual(n: int, bucket_size: int, skip_incomplete: bool) -> Tuple[int, int]:
    rem = n % bucket_size
    if skip_incomplete and rem:
        return n - rem, rem
    return n, 0


def compute_meta(xb: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket ``(unit, min)`` in float32. ``xb``: f32 ``(nb, B)``."""
    bmax = xb.amax(dim=1)
    bmin = xb.amin(dim=1)
    return (bmax - bmin) * unit_scale(bits), bmin


def encode_levels(
    xb: torch.Tensor, unit: torch.Tensor, bmin: torch.Tensor, bits: int
) -> torch.Tensor:
    """int32 levels ``(nb, B)``: round to nearest (deterministic mode)."""
    safe = torch.where(unit > 0, unit, torch.ones_like(unit))
    lvl = torch.floor((xb - bmin[:, None]) / safe[:, None] + 0.5)
    return torch.clamp(lvl, 0, (1 << bits) - 1).to(torch.int32)


def decode_levels(
    lvl: torch.Tensor, unit: torch.Tensor, bmin: torch.Tensor
) -> torch.Tensor:
    """f32 ``(nb, B)`` decoded values: the product rounds before the add."""
    prod = unit[:, None] * lvl.to(torch.float32)
    return bmin[:, None] + prod


def bucket_view(flat: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """Edge-pad a flat tensor to whole buckets -> f32 ``(nb, B)``."""
    n = flat.shape[0]
    nb = num_buckets(n, bucket_size)
    pad = nb * bucket_size - n
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    return flat.reshape(nb, bucket_size).to(torch.float32)


def quantize(
    x: torch.Tensor,
    bits: int,
    bucket_size: int,
    *,
    skip_incomplete_buckets: bool = False,
) -> QTensor:
    """Quantize a tensor into a flat :class:`QTensor`."""
    if not (1 <= bits <= 8):
        raise ValueError(f"bits must be in 1..8, got {bits}")
    dtype = x.dtype
    flat = x.reshape(-1)
    n = flat.shape[0]
    main_n, _ = _split_residual(n, bucket_size, skip_incomplete_buckets)
    residual = flat[main_n:]
    nb = num_buckets(main_n, bucket_size)
    if nb == 0:
        return QTensor(
            packed=torch.zeros((0,), dtype=torch.int32, device=x.device),
            meta=torch.zeros((0, 2), dtype=dtype, device=x.device),
            residual=residual,
            numel=n,
            bits=bits,
            bucket_size=bucket_size,
            dtype=dtype,
        )
    xb = bucket_view(flat[:main_n], bucket_size)
    unit, bmin = compute_meta(xb, bits)
    lvl = encode_levels(xb, unit, bmin, bits)
    return QTensor(
        packed=pack_levels_bucketed(lvl, bits),
        meta=torch.stack([unit, bmin], dim=1).to(dtype),
        residual=residual,
        numel=n,
        bits=bits,
        bucket_size=bucket_size,
        dtype=dtype,
    )


def dequantize(
    q: QTensor,
    *,
    add_to: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Decode a flat :class:`QTensor`. ``add_to`` is a flat accumulator
    (decompress-with-add); the add runs in float32. Result dtype:
    ``out_dtype``, else the accumulator's, else the wire dtype."""
    if out_dtype is None:
        out_dtype = add_to.dtype if add_to is not None else q.dtype
    main_n = q.numel_main
    nb = num_buckets(main_n, q.bucket_size)
    if nb:
        lvl = unpack_levels_bucketed(q.packed, q.bits, nb, q.bucket_size)
        unit = q.meta[:, 0].to(torch.float32)
        bmin = q.meta[:, 1].to(torch.float32)
        vals = decode_levels(lvl, unit, bmin).reshape(-1)[:main_n]
    else:
        vals = torch.zeros((0,), dtype=torch.float32, device=q.packed.device)
    full = torch.cat([vals, q.residual.to(torch.float32)])
    if add_to is not None:
        return (add_to.to(torch.float32) + full).to(out_dtype)
    return full.to(out_dtype)


# ---------------------------------------------------------------------------
# Dummy (pass-through) codec — CGX_DEBUG_DUMMY_COMPRESSION.
# ---------------------------------------------------------------------------


def quantize_dummy(x: torch.Tensor) -> QTensor:
    """Identity "compression": the payload is the raw f32 bit pattern."""
    flat = x.reshape(-1).to(torch.float32)
    return QTensor(
        packed=flat.view(torch.int32),
        meta=torch.zeros((0, 2), dtype=x.dtype, device=x.device),
        residual=torch.zeros((0,), dtype=x.dtype, device=x.device),
        numel=flat.shape[0],
        bits=0,
        bucket_size=0,
        dtype=x.dtype,
    )


# ---------------------------------------------------------------------------
# Error envelope and measurement.
# ---------------------------------------------------------------------------


def allreduce_error_bound(
    n: int, bits: int, bucket_size: int, world_size: int, value_range: float = 1.0
) -> float:
    """Sup-norm bound of a ws-way quantized allreduce of values whose
    per-bucket range is at most ``value_range * min(bucket, n)``:
    ``2 * min(bucket, n) / (2^bits - 1) * ws * (ws + 1) * value_range``."""
    return (
        2.0
        * min(bucket_size, n)
        / float((1 << bits) - 1)
        * world_size
        * (world_size + 1)
        * value_range
    )


def relative_l2_error(x: torch.Tensor, decoded: torch.Tensor) -> torch.Tensor:
    """``|x - decoded|_2 / |x|_2``; a zero input reports zero error."""
    x = x.to(torch.float32)
    num = torch.sqrt(torch.sum((x - decoded.to(torch.float32)) ** 2))
    den = torch.sqrt(torch.sum(x**2))
    return num / torch.clamp(den, min=1e-30)
