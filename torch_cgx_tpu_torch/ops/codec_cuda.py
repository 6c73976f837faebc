"""The codec's CUDA kernels, their wrappers and their plain versions.

Counterpart of ``torch_cgx_tpu/ops/codec_pallas.py``. Three hand-written
kernels in ``csrc/codec.cu`` (built for ``sm_90a`` with ``nvcc`` into a
plain C shared library at first use, loaded with ``ctypes``) replace the
five Pallas kernels on the gradient-sync path:

=====================  =================================================
wrapper                TPU kernels replaced (``codec_pallas.py``)
=====================  =================================================
``quantize_chunks``    ``_quantize_flat_impl``, ``_quantize_chunks_impl``
``dequantize_chunks``  ``_dequantize_flat_impl``, ``_dequantize_chunks_impl``
``sra_epilogue_chunks`` ``_sra_epilogue_impl``
=====================  =================================================

Each wrapper works on whole 32-bucket chunks. On a CUDA tensor it launches
its kernel (and counts the launch in :data:`LAUNCHES`) or raises; on a CPU
tensor it runs its plain version, written from ``ops/codec.py``'s
arithmetic. Nothing else picks between the two. The batch functions below
(``quantize_batch``, ``dequantize_batch``, ``sra_epilogue_batch``) add the
glue both packages keep outside their kernels: edge padding, the dense tail
of the last ``nb % 32`` buckets and the raw residual, all plain PyTorch.

Not in the kernels yet (ROADMAP Queue B), and refused on every device:
stochastic rounding, the ``CGX_CODEC_ENCODE=mul`` encode and the
``CGX_SRA_ACCUM=int8`` fold. A CUDA tensor must be float32: bf16/f16 wire
dtypes inside the kernels wait too.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import config as cfg_mod
from . import codec
from .codec import CHUNK_BUCKETS, LANE_GROUP, QTensor

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "codec.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libcgx_codec.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The epilogue stages the reduced (32, B) f32 tile in dynamic shared
# memory: a block may use 232,448 bytes on Hopper, less the 256 bytes of
# static meta. Larger buckets take the staged path (supports_reduce).
MAX_EPILOGUE_TILE_BYTES = 232448 - 256

# Kernel launches per wrapper, counted where the kernel is launched and
# nowhere else.
LAUNCHES: Dict[str, int] = {
    "codec_quantize": 0,
    "codec_dequantize": 0,
    "codec_sra_epilogue": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()
BUILD_LOG: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA codec kernels are built at first use")


def build(force: bool = False) -> Path:
    """Compile ``csrc/codec.cu`` into ``_build/libcgx_codec.so`` unless an
    up-to-date build exists. Returns the library path; the compiler's
    output (registers, shared memory, spills) lands in ``BUILD_LOG``."""
    if (
        not force
        and LIBRARY.exists()
        and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime
    ):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, ptxas=proc.stderr)
    return LIBRARY


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
            lib.cgx_quantize.argtypes = [vp, vp, vp, ll, i, i, f, vp]
            lib.cgx_dequantize.argtypes = [vp, vp, vp, vp, ll, i, i, vp]
            lib.cgx_sra_epilogue.argtypes = [vp, vp, vp, i, i, ll, i, i, f, vp, vp, vp]
            for fn in (lib.cgx_quantize, lib.cgx_dequantize, lib.cgx_sra_epilogue):
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# Argument checks shared by the kernel wrappers.
# ---------------------------------------------------------------------------


def _refuse_unported() -> None:
    if cfg_mod.codec_encode() != "div":
        raise NotImplementedError(
            "CGX_CODEC_ENCODE=mul is not ported: the codec kernels implement "
            "the div encode only"
        )


def _device_kind(*ts: Optional[torch.Tensor]) -> str:
    kinds = {t.device.type for t in ts if t is not None}
    if len(kinds) != 1:
        raise ValueError(f"codec operands on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"codec kernels run on cuda (or the plain version on cpu), got {kind}")
    return kind


def _require_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int) -> None:
    if t.dtype != dtype:
        raise TypeError(
            f"{name}: expected {dtype}, got {t.dtype} (bf16/f16 wire dtypes are "
            "not ported into the kernels yet)"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")
    if t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} elements, got {t.numel()}")


def _chunk_geometry(n: int, bits: int, bucket_size: int) -> int:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in 1..8, got {bits}")
    if bucket_size < LANE_GROUP or bucket_size % LANE_GROUP:
        raise ValueError(f"bucket_size must be a positive multiple of 32, got {bucket_size}")
    chunk = CHUNK_BUCKETS * bucket_size
    if n < chunk or n % chunk:
        raise ValueError(f"{n} values are not whole 32-bucket chunks of {bucket_size}")
    return n // chunk


# ---------------------------------------------------------------------------
# Quantize (B1 + B5).
# ---------------------------------------------------------------------------


def quantize_chunks_plain(
    x: torch.Tensor, bits: int, bucket_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`quantize_chunks`."""
    xb = x.reshape(-1, bucket_size).to(torch.float32)
    unit, bmin = codec.compute_meta(xb, bits)
    lvl = codec.encode_levels(xb, unit, bmin, bits)
    return codec.pack_levels_bucketed(lvl, bits), torch.stack([unit, bmin], dim=1)


def quantize_chunks(
    x: torch.Tensor, bits: int, bucket_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a flat buffer of whole chunks: ``x`` f32 ``(C*32*B,)`` ->
    ``(words int32 (C*bits*B,), meta f32 (C*32, 2))``."""
    _refuse_unported()
    chunks = _chunk_geometry(x.numel(), bits, bucket_size)
    if _device_kind(x) == "cpu":
        return quantize_chunks_plain(x, bits, bucket_size)
    _require_cuda_operand("quantize x", x, torch.float32, x.numel())
    words = torch.empty(chunks * bits * bucket_size, dtype=torch.int32, device=x.device)
    meta = torch.empty((chunks * CHUNK_BUCKETS, 2), dtype=torch.float32, device=x.device)
    err = _lib().cgx_quantize(
        x.data_ptr(), words.data_ptr(), meta.data_ptr(), chunks, bucket_size,
        bits, codec.unit_scale(bits), _stream(x),
    )
    LAUNCHES["codec_quantize"] += 1
    _check_launch("codec_quantize", err)
    return words, meta


# ---------------------------------------------------------------------------
# Dequantize (B2 + B6).
# ---------------------------------------------------------------------------


def dequantize_chunks_plain(
    words: torch.Tensor,
    meta: torch.Tensor,
    bits: int,
    bucket_size: int,
    add_to: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`dequantize_chunks`."""
    nb = meta.shape[0]
    lvl = codec.unpack_levels_bucketed(words, bits, nb, bucket_size)
    m = meta.to(torch.float32)
    vals = codec.decode_levels(lvl, m[:, 0], m[:, 1]).reshape(-1)
    if add_to is not None:
        return add_to.to(torch.float32).reshape(-1) + vals
    return vals


def dequantize_chunks(
    words: torch.Tensor,
    meta: torch.Tensor,
    bits: int,
    bucket_size: int,
    add_to: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode whole chunks: ``words`` int32 ``(C*bits*B,)`` + ``meta`` f32
    ``(C*32, 2)`` -> f32 ``(C*32*B,)``; with ``add_to`` (f32, same length)
    the result is ``add_to + decoded``."""
    n = meta.shape[0] * bucket_size
    chunks = _chunk_geometry(n, bits, bucket_size)
    if _device_kind(words, meta, add_to) == "cpu":
        return dequantize_chunks_plain(words, meta, bits, bucket_size, add_to)
    _require_cuda_operand("dequantize words", words, torch.int32, chunks * bits * bucket_size)
    _require_cuda_operand("dequantize meta", meta, torch.float32, 2 * n // bucket_size)
    if add_to is not None:
        _require_cuda_operand("dequantize add_to", add_to, torch.float32, n)
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    err = _lib().cgx_dequantize(
        words.data_ptr(), meta.data_ptr(),
        None if add_to is None else add_to.data_ptr(),
        out.data_ptr(), chunks, bucket_size, bits, _stream(words),
    )
    LAUNCHES["codec_dequantize"] += 1
    _check_launch("codec_dequantize", err)
    return out


# ---------------------------------------------------------------------------
# Fused SRA epilogue (B3).
# ---------------------------------------------------------------------------


def sra_epilogue_chunks_plain(
    words: torch.Tensor,
    meta: torch.Tensor,
    raw: Optional[torch.Tensor],
    own: int,
    bits: int,
    bucket_size: int,
    cast_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`sra_epilogue_chunks`. ``cast_dtype`` rounds
    the reduced chunk through the wire dtype before the requantize, as the
    staged path quantizes ``reduced.to(dtype)``."""
    acc = None
    for r in range(words.shape[0]):
        if r == own:
            vals = raw.to(torch.float32).reshape(-1)
        else:
            vals = dequantize_chunks_plain(words[r], meta[r], bits, bucket_size)
        acc = vals if acc is None else acc + vals
    if cast_dtype != torch.float32:
        acc = acc.to(cast_dtype).to(torch.float32)
    return quantize_chunks_plain(acc, bits, bucket_size)


def sra_epilogue_chunks(
    words: torch.Tensor,
    meta: torch.Tensor,
    raw: Optional[torch.Tensor],
    own: int,
    bits: int,
    bucket_size: int,
    cast_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dequantize-accumulate-requantize: ``words`` int32 ``(ws,
    C*bits*B)`` and ``meta`` f32 ``(ws, C*32, 2)`` of the ws peer rows, the
    raw own chunk ``raw`` f32 ``(C*32*B,)`` replacing row ``own`` (-1 and
    None: no substitution) -> the stage-2 payload ``(words (C*bits*B,),
    meta (C*32, 2))`` of the reduced chunk. Rows fold in ascending order.
    ``cast_dtype``: the wire dtype the reduced chunk rounds through before
    the requantize (float32 only in the kernel)."""
    _refuse_unported()
    if cfg_mod.sra_accum() != "exact":
        raise NotImplementedError(
            "CGX_SRA_ACCUM=int8 is not ported: the epilogue kernel folds in f32"
        )
    ws = words.shape[0]
    n = meta.shape[1] * bucket_size
    chunks = _chunk_geometry(n, bits, bucket_size)
    if (raw is None) != (own < 0) or own >= ws:
        raise ValueError(f"own={own} must name a row exactly when a raw row is given")
    if _device_kind(words, meta, raw) == "cpu":
        return sra_epilogue_chunks_plain(
            words, meta, raw, own, bits, bucket_size, cast_dtype
        )
    if cast_dtype != torch.float32:
        raise NotImplementedError(
            f"{cast_dtype} wire dtypes are not ported into the epilogue kernel yet"
        )
    if CHUNK_BUCKETS * bucket_size * 4 > MAX_EPILOGUE_TILE_BYTES:
        raise ValueError(f"bucket_size {bucket_size} exceeds the epilogue's shared-memory tile")
    _require_cuda_operand("epilogue words", words, torch.int32, ws * chunks * bits * bucket_size)
    _require_cuda_operand("epilogue meta", meta, torch.float32, ws * 2 * n // bucket_size)
    if raw is not None:
        _require_cuda_operand("epilogue raw", raw, torch.float32, n)
    out_words = torch.empty(chunks * bits * bucket_size, dtype=torch.int32, device=words.device)
    out_meta = torch.empty((chunks * CHUNK_BUCKETS, 2), dtype=torch.float32, device=words.device)
    err = _lib().cgx_sra_epilogue(
        words.data_ptr(), meta.data_ptr(), None if raw is None else raw.data_ptr(),
        own, ws, chunks, bucket_size, bits, codec.unit_scale(bits),
        out_words.data_ptr(), out_meta.data_ptr(), _stream(words),
    )
    LAUNCHES["codec_sra_epilogue"] += 1
    _check_launch("codec_sra_epilogue", err)
    return out_words, out_meta


# ---------------------------------------------------------------------------
# Batch API (rows = independent flat buffers of equal length).
# ---------------------------------------------------------------------------


def supports(n: int, bits: int, bucket_size: int, skip_incomplete: bool) -> bool:
    """Whether the chunk kernels cover a buffer of ``n`` values at all
    (otherwise the dispatcher quantizes it with ``ops/codec.py``)."""
    main_n = n - (n % bucket_size) if skip_incomplete else n
    return (
        1 <= bits <= 8
        and bucket_size % LANE_GROUP == 0
        and main_n >= bucket_size
    )


def supports_reduce(q: QTensor, ws: Optional[int] = None) -> bool:
    """Fused-epilogue eligibility. The geometry is the JAX package's
    (``codec_pallas.supports_reduce``: every row whole 32-bucket chunks of
    128-aligned buckets, no residual, ws x chunk tile within its budget) so
    the world-size-1 proxy picks the same lowering as the reference; on top
    of that, the reduced (32, B) f32 tile must fit the kernel's shared
    memory."""
    rows = q.packed.shape[0] if q.packed.dim() == 2 else 0
    ws = rows if ws is None else ws
    b = q.bucket_size
    if not q.bits or not (1 <= q.bits <= 8) or rows < 1:
        return False
    if not b or b % 128 or CHUNK_BUCKETS * b * 4 > MAX_EPILOGUE_TILE_BYTES:
        return False
    if q.residual.shape[-1]:
        return False
    nb_r = codec.num_buckets(q.numel_main, b)
    if nb_r == 0 or nb_r % CHUNK_BUCKETS or q.numel_main != nb_r * b:
        return False
    return ws * CHUNK_BUCKETS * b <= (1 << 20)


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t
    if t.is_cuda:
        raise NotImplementedError(
            f"{t.dtype} buffers are not ported into the codec kernels yet"
        )
    return t.to(torch.float32)


def quantize_batch(
    xs: torch.Tensor,
    bits: int,
    bucket_size: int,
    *,
    skip_incomplete_buckets: bool = False,
) -> QTensor:
    """Quantize each row of ``xs (rows, m)``: the kernel covers each row's
    whole chunks, the dense tail of the last ``nb % 32`` buckets goes
    through ``ops/codec.py``. Same QTensor layout as the JAX package's
    ``codec_pallas.quantize_batch``."""
    rows, m = xs.shape
    dtype = xs.dtype
    b = bucket_size
    main_n, res_n = codec._split_residual(m, b, skip_incomplete_buckets)
    residual = xs[:, main_n:] if res_n else xs.new_zeros((rows, 0))
    x = _as_f32(xs[:, :main_n] if res_n else xs)
    nb_r = codec.num_buckets(main_n, b)
    pad = nb_r * b - main_n
    if pad:
        x = torch.cat([x, x[:, -1:].expand(rows, pad)], dim=1)
    c_r, t_r = divmod(nb_r, CHUNK_BUCKETS)
    word_parts, meta_parts = [], []
    if c_r:
        head = x[:, : c_r * CHUNK_BUCKETS * b].contiguous()
        words, meta = quantize_chunks(head.reshape(-1), bits, b)
        word_parts.append(words.view(rows, c_r * bits * b))
        meta_parts.append(meta.view(rows, c_r * CHUNK_BUCKETS, 2))
    if t_r:
        tail = x[:, c_r * CHUNK_BUCKETS * b :].reshape(rows * t_r, b)
        unit, bmin = codec.compute_meta(tail, bits)
        lvl = codec.encode_levels(tail, unit, bmin, bits).view(rows, t_r * b)
        word_parts.append(torch.stack([codec.pack_levels(r, bits) for r in lvl]))
        meta_parts.append(torch.stack([unit, bmin], dim=1).view(rows, t_r, 2))
    words = word_parts[0] if len(word_parts) == 1 else torch.cat(word_parts, dim=1)
    meta = meta_parts[0] if len(meta_parts) == 1 else torch.cat(meta_parts, dim=1)
    return QTensor(
        packed=words,
        meta=meta.to(dtype),
        residual=residual,
        numel=m,
        bits=bits,
        bucket_size=b,
        dtype=dtype,
    )


def dequantize_batch(
    q: QTensor,
    *,
    add_to: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Decode a row-batched QTensor -> ``(rows, numel)``. When every row is
    whole chunks the accumulate of ``add_to`` runs inside the kernel; other
    shapes add after the decode (same values: one f32 add either way)."""
    if out_dtype is None:
        out_dtype = add_to.dtype if add_to is not None else q.dtype
    rows = q.packed.shape[0]
    b = q.bucket_size
    nb_r = codec.num_buckets(q.numel_main, b)
    c_r, t_r = divmod(nb_r, CHUNK_BUCKETS)
    meta = _as_f32(q.meta)
    fuse_add = (
        add_to is not None
        and t_r == 0
        and q.residual.shape[-1] == 0
        and q.numel_main == nb_r * b
        and tuple(add_to.shape) == (rows, q.numel_main)
    )
    parts = []
    head_words = c_r * q.bits * b
    if c_r:
        vals = dequantize_chunks(
            q.packed[:, :head_words].contiguous().view(-1),
            meta[:, : c_r * CHUNK_BUCKETS].contiguous().view(-1, 2),
            q.bits,
            b,
            add_to=_as_f32(add_to).contiguous().view(-1) if fuse_add else None,
        ).view(rows, c_r * CHUNK_BUCKETS * b)
        if fuse_add:
            return vals.to(out_dtype)
        parts.append(vals)
    if t_r:
        tw = q.packed[:, head_words:]
        lvl = torch.stack(
            [codec.unpack_levels(w, q.bits, t_r * b) for w in tw]
        ).view(rows * t_r, b)
        unit = meta[:, c_r * CHUNK_BUCKETS :, 0].reshape(-1)
        bmin = meta[:, c_r * CHUNK_BUCKETS :, 1].reshape(-1)
        parts.append(codec.decode_levels(lvl, unit, bmin).view(rows, t_r * b))
    vals = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    vals = vals[:, : q.numel_main]
    if q.residual.shape[-1]:
        vals = torch.cat([vals, q.residual.to(torch.float32)], dim=1)
    if add_to is not None:
        return (add_to.to(torch.float32) + vals).to(out_dtype)
    return vals.to(out_dtype)


def sra_epilogue_batch(
    q: QTensor,
    *,
    raw_row: Optional[torch.Tensor] = None,
    own_idx: Optional[int] = None,
    out_dtype: torch.dtype = torch.float32,
) -> QTensor:
    """Fused dequantize-accumulate-requantize of a ws-row QTensor -> a
    rows=1 QTensor holding the stage-2 (all-gather) payload of the reduced
    chunk, the layout ``quantize_batch(reduced[None])`` would give. The
    caller checks :func:`supports_reduce`."""
    own = -1 if own_idx is None else int(own_idx)
    raw = None if raw_row is None else _as_f32(raw_row).reshape(-1).contiguous()
    words, meta = sra_epilogue_chunks(
        q.packed.contiguous(), _as_f32(q.meta).contiguous(), raw, own,
        q.bits, q.bucket_size, cast_dtype=out_dtype,
    )
    nb_r = codec.num_buckets(q.numel_main, q.bucket_size)
    return QTensor(
        packed=words.view(1, -1),
        meta=meta.view(1, nb_r, 2).to(out_dtype),
        residual=torch.zeros((1, 0), dtype=out_dtype, device=words.device),
        numel=q.numel,
        bits=q.bits,
        bucket_size=q.bucket_size,
        dtype=out_dtype,
    )
