"""The codec's CUDA kernels, their wrappers and their plain versions.

Counterpart of ``torch_cgx_tpu/ops/codec_pallas.py``, of the kernel of
``torch_cgx_tpu/ops/fused_producer.py`` and of the quantize diagnostics of
``tools/qbench.py``. Ten hand-written kernels in ``csrc/codec.cu`` (built
for ``sm_90a`` with ``nvcc`` into a plain C shared library at first use,
loaded with ``ctypes``) replace the eleven Pallas kernels, the
matmul-quantize with two (an FFMA one, and a tensor-core one for 16-bit
operands):

============================  =================================================
wrapper                       TPU kernels replaced
============================  =================================================
``quantize_chunks``           ``codec_pallas._quantize_flat_impl``, ``_quantize_chunks_impl``
``dequantize_chunks``         ``codec_pallas._dequantize_flat_impl``, ``_dequantize_chunks_impl``
``sra_epilogue_chunks``       ``codec_pallas._sra_epilogue_impl``
``reduce_rows_chunks``        ``codec_pallas._reduce_rows_impl``
``matmul_quantize_chunks``    ``fused_producer._matmul_quantize_impl``
``quantize_chunks_db``        ``codec_pallas._quantize_flat_db_impl``
``dequantize_chunks_db``      ``codec_pallas._dequantize_flat_db_impl``
``sra_epilogue_chunks_db``    ``codec_pallas._sra_epilogue_db_impl``
``quantize_variant_chunks``   ``tools/qbench.make_variant_kernel`` (nometa, metalane, read)
============================  =================================================

Each wrapper works on whole 32-bucket chunks. ``quantize_chunks``,
``quantize_variant_chunks`` and ``sra_epilogue_chunks`` launch on a
thread-block cluster a chunk, the chunk's values in registers
(:func:`cluster_geometry`; past the register budget a thread takes several
positions, re-read from the L2);
``quantize_chunks_db`` and ``sra_epilogue_chunks_db`` run the same body on a
persistent grid of such clusters fed by a bulk-copy ring (:func:`db_ring`);
``reduce_rows_chunks`` spreads its grid over the values, 8 buckets of 4
positions a thread, at scalar width where an operand is not 16-byte
aligned (:data:`REDUCE_SCALAR`). On a CUDA tensor a
wrapper launches its kernel (and counts the launch in :data:`LAUNCHES`) or
raises; on a CPU tensor it runs its plain version, written from
``ops/codec.py``'s arithmetic. Nothing else picks between the two. The batch functions below
(``quantize_batch``, ``dequantize_batch``, ``sra_epilogue_batch``,
``reduce_rows_batch``) add the glue both packages keep outside their
kernels: edge padding, the dense tail of the last ``nb % 32`` buckets and
the raw residual, all plain PyTorch. They also route: at the JAX package's
six call sites they look the shape up in the per-card autotune cache
(``ops/autotune.py``) and take the pipelined (``*_db``) kernel where
``CGX_PALLAS_DB`` says so and its geometry fits (:func:`db_would_run`).

Every quantizing wrapper takes the two lowerings the JAX package threads
through its quantizing kernels: the level encode (``CGX_CODEC_ENCODE``,
"div" or "mul", read on every call) and the bit-plane pack ("sum" or
"butterfly": ``CGX_PALLAS_PACK``, else the autotuned entry's, else "sum").
On the card they are template parameters of the kernel. The dense tail
outside the kernels keeps the "div" encode whatever the knob says, as the
JAX package's does.

Stochastic rounding: the quantizing wrappers (B1/B5, B3, B7a, B7c) take a
64-bit ``seed`` (``utils/prng.seed_from_key``; None: round to nearest) and
draw each value's offset from the Philox4x32-10 counter stream of
``utils/prng.py``, the kernels in CUDA and the plain versions in PyTorch, so
both give the same bytes whatever the cluster geometry, tile, ring or pack.
On the card the entry points take a flag and the seed's words
(:func:`_seed_args`) and pick the stochastic or the deterministic
instance; the deterministic ones are unchanged. The matmul-quantize
(B8) stays deterministic, as the JAX package's is, and refuses
``CGX_STOCHASTIC_ROUNDING``.

Wire dtypes: the JAX package syncs a bf16 or f16 leaf in its own dtype.
On the card the quantize (B1/B5, B7a) reads its input, and the epilogue
(B3, B7c) and the reduce (B4) their raw own row, as float32, bfloat16 or
float16 (:data:`WIRE_DTYPES`), each value upcast inside the kernel; the
epilogue rounds the folded chunk through its ``cast_dtype`` (the wire
dtype, which a raw row must share) before the requantize, as the staged
path quantizes ``reduced.to(dtype)``. The kernels' meta, the decode
(B2/B6, B7b) and every other operand stay float32: the batch functions
cast the meta to the tensor's dtype after a quantize and upcast sub-f32
meta and accumulators before a decode, as the JAX package's do outside
its kernels (``codec.batch_views``). Another dtype raises ``ValueError``.
The matmul-quantize (B8) reads its two operands in one dtype of the
three, as the JAX kernel reads them in the layer's compute dtype. 16-bit
operands whose shape TMA can describe and every float32 pair
(:func:`mm_tc_eligible`) go to the tensor cores (``wgmma`` fed by a TMA
ring, :data:`MM_TC_LAUNCHES`): float32 operands as split TF32, a
split-transpose pass (:func:`tf32_split_transpose`, its own launch count)
writing the K-major ``hi`` and ``lo`` planes (:func:`tf32_split_plain`)
and three tf32 products a step (``lo hi + hi lo + hi hi``), which keeps
float32 accuracy. Their float32 sums come in the tensor cores' order:
bit-identical to the plain version where every partial sum is exact
(small integers, whose ``lo`` is 0), within ``chip_smoke.py``'s payload
tolerance otherwise. The other 16-bit shapes take the FFMA kernel, whose
sums (and so words and meta) are those of the float32 FFMA instance on the
upcast operands, bit for bit, since the product of two bf16 (or two f16)
values is exact in float32. Either way the own raw row is the product
rounded to the operand dtype, then divided.

The int8 fold (``CGX_SRA_ACCUM=int8``): the reduce kernels (B3, B7c, B4)
and their plain versions take ``accum`` ("exact", the f32 fold, or "int8";
None: the knob, read on every call). Under "int8" the peer rows fold in the
level domain, as the JAX package's ``_decode_accumulate`` does: per bucket
the rows' units snap to 12-bit fixed-point multiples ``s_r`` of their
largest ``U`` (the own row's included), ``sum_r level_r * s_r`` accumulates
in int32, and ``bsum + (usafe * 2^-12) * float(acc)`` (the product rounded
first) plus the raw own row gives the value. The int8 instances build into
a library of their own (:func:`build_int8`) at the first call that asks for
one; their launches are counted again in :data:`INT8_LAUNCHES`.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import config as cfg_mod
from ..utils import prng
from . import autotune, codec
from .codec import CHUNK_BUCKETS, LANE_GROUP, QTensor

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "codec.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libcgx_codec.so"
# The int8 fold's instances of B3, B7c and B4 (csrc/codec.cu, CGX_INT8).
LIBRARY_INT8 = BUILD_DIR / "libcgx_codec_int8.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The source's entry points fall into this many parts (CGX_PART in
# csrc/codec.cu), compiled by one nvcc each, all at once, then linked:
# parts 7-10 hold the stochastic f32 instances of B1, B3, B7a and B7c,
# parts 11-18 their 16-bit instances (round to nearest and stochastic),
# part 19 B4's with a 16-bit raw row, part 20 B8's with 16-bit operands on
# the FFMA kernel, part 21 B8's tensor-core kernel (bf16 and f16), part 22
# B8's float32 operands on the tensor cores (split pass, split TF32).
BUILD_PARTS = 23
# The int8 library's parts: its entry points and B4 (0), B3 (1-4), B7c
# (5-8), B4 with a 16-bit raw row (9).
INT8_BUILD_PARTS = 10

# The wire dtypes of the quantize's input, the epilogue's and the reduce's
# raw own row and the epilogue's cast: the entry points' ``wire`` argument,
# by index (csrc/codec.cu kWireF32, kWireBf16, kWireF16).
WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# A chunk's (32, B) f32 values within a block's 232,448 bytes of shared
# memory, less 256 of static meta: the matmul-quantize's (B8) tile, and
# the producer's gate (ops/fused_producer.py, ROADMAP C3).
MAX_EPILOGUE_TILE_BYTES = 232448 - 256
# The JAX package's fused-reduce gate (codec_pallas.MAX_BUCKET_ELEMS,
# MAX_REDUCE_BLOCK_ELEMS), kept so both packages route the same batches.
MAX_BUCKET_ELEMS = 16384
MAX_REDUCE_BLOCK_ELEMS = 1 << 20

# Kernel launches per wrapper, counted where the kernel is launched and
# nowhere else.
LAUNCHES: Dict[str, int] = {
    "codec_quantize": 0,
    "codec_dequantize": 0,
    "codec_sra_epilogue": 0,
    "codec_reduce_rows": 0,
    "codec_matmul_quantize": 0,
    "codec_quantize_db": 0,
    "codec_dequantize_db": 0,
    "codec_sra_epilogue_db": 0,
    "codec_quantize_variant": 0,
    "codec_tf32_split": 0,
}
# Calls that CGX_PALLAS_DB sent to a pipelined kernel whose ring (or tile)
# does not fit a block's shared memory at this geometry, so the
# single-stage kernel ran instead (ROADMAP C7), counted by kernel.
DB_GATED: Dict[str, int] = {"quantize": 0, "dequantize": 0, "epilogue": 0}
# Launches of the multi-row reduce (B4) at scalar width, for operands that
# are not 16-byte aligned (a raw row view at an odd offset) or a bucket that
# is not a multiple of 128; a share of LAUNCHES["codec_reduce_rows"].
REDUCE_SCALAR: Dict[str, int] = {"launches": 0}
# Launches whose wire operand (B1/B7a's input; B3/B7c's wire dtype, a raw
# row's included; B4's raw row; B8's two operands) was bf16 or f16, read
# by the kernel itself: a share of LAUNCHES, by kernel.
WIRE16_LAUNCHES: Dict[str, int] = {
    "codec_quantize": 0, "codec_quantize_db": 0, "codec_sra_epilogue": 0,
    "codec_sra_epilogue_db": 0, "codec_reduce_rows": 0, "codec_matmul_quantize": 0,
}
# Launches of the int8 fold's instances (CGX_SRA_ACCUM=int8): a share of
# LAUNCHES, by kernel.
INT8_LAUNCHES: Dict[str, int] = {
    "codec_sra_epilogue": 0, "codec_sra_epilogue_db": 0, "codec_reduce_rows": 0,
}
# Launches of the matmul-quantize's tensor-core kernels (bf16 or f16
# operands that TMA can describe, and float32 operands as split TF32:
# :func:`mm_tc_eligible`): a share of LAUNCHES["codec_matmul_quantize"].
MM_TC_LAUNCHES: Dict[str, int] = {"launches": 0}


def _count_launch(name: str, wire: int, accum: str = "exact") -> None:
    LAUNCHES[name] += 1
    if wire:
        WIRE16_LAUNCHES[name] += 1
    if accum == "int8":
        INT8_LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, DB_GATED, REDUCE_SCALAR, WIRE16_LAUNCHES, INT8_LAUNCHES,
                   MM_TC_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()
BUILD_LOG: Dict[str, object] = {}
_LIB_INT8 = None
_INT8_LOCK = threading.RLock()
INT8_BUILD_LOG: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA codec kernels are built at first use")


def _run_nvcc(procs, seconds: Optional[list] = None) -> str:
    """Wait for each started nvcc, a thread each; raise on the first failure
    (after stopping the rest). Returns their diagnostics, concatenated in
    the order of ``procs``; ``seconds``, if given, gets each one's seconds
    from this call to its end, in that order."""
    t0 = time.perf_counter()

    def wait(proc):
        stdout, stderr = proc.communicate(timeout=600)
        return proc.returncode, stdout, stderr, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        futures = [pool.submit(wait, proc) for proc in procs]
        try:
            for f in concurrent.futures.as_completed(futures):
                rc, stdout, stderr, _ = f.result()
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{stdout}{stderr}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    done = [f.result() for f in futures]
    if seconds is not None:
        seconds.extend(d[3] for d in done)
    return "".join(d[2] for d in done)


def _build(library: Path, parts: int, defines: Tuple[str, ...], log: Dict[str, object],
           force: bool, nice: int = 0) -> Path:
    """Compile ``csrc/codec.cu`` into ``library`` unless an up-to-date build
    exists: one nvcc for each of ``parts`` parts, all started together
    (at niceness ``nice``), then one link. The compiler's output
    (registers, shared memory, spills) lands in ``log``, with the build's
    seconds and each part's (``part_seconds``, by part: its nvcc's)."""
    if not force and library.exists() and library.stat().st_mtime >= SOURCE.stat().st_mtime:
        return library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"part{k}.o") for k in range(parts)]
        part_seconds: list = []
        ptxas = _run_nvcc([
            subprocess.Popen([*(("nice", "-n", str(nice)) if nice else ()), _nvcc(), *NVCC_FLAGS,
                              *defines, f"-DCGX_PART={k}", "-c", "-o", obj, str(SOURCE)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k, obj in enumerate(objs)
        ], part_seconds)
        tmp = os.path.join(work, library.name)
        _run_nvcc([subprocess.Popen([_nvcc(), "-shared", "-o", tmp, *objs],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
        os.replace(tmp, library)
    log.update(seconds=time.perf_counter() - t0, ptxas=ptxas, part_seconds=part_seconds)
    return library


def build(force: bool = False) -> Path:
    """Compile ``csrc/codec.cu`` into ``_build/libcgx_codec.so`` (its
    ``BUILD_PARTS`` parts) unless an up-to-date build exists. Returns the
    library path; the compiler's output lands in ``BUILD_LOG``."""
    return _build(LIBRARY, BUILD_PARTS, (), BUILD_LOG, force)


def build_int8(force: bool = False, nice: int = 0) -> Path:
    """Compile the int8 fold's instances (``-DCGX_INT8``, its
    ``INT8_BUILD_PARTS`` parts) into ``_build/libcgx_codec_int8.so`` unless
    an up-to-date build exists; the compiler's output lands in
    ``INT8_BUILD_LOG``. ``nice``: the compilers' niceness, so that a build
    started beside other work takes the cores that work leaves idle. Holds
    the int8 library's lock, so a caller of the int8 kernels waits for a
    build started on another thread."""
    with _INT8_LOCK:
        return _build(LIBRARY_INT8, INT8_BUILD_PARTS, ("-DCGX_INT8",), INT8_BUILD_LOG, force, nice)


def ptxas_instances(ptxas: str) -> Dict[str, Dict[str, int]]:
    """Each kernel of a build's ptxas report (``BUILD_LOG["ptxas"]``, from
    ``-Xptxas -v``): ``name<its template's int and bool arguments>``, with
    ``:int8`` appended for an instance of the int8 fold (the ``ACCUM``
    argument after the element type: 1; the f32 fold's 0 adds nothing) and
    then ``:16`` for an instance whose element type is the 16-bit one
    (``uint16_t``; a ``float`` instance keeps the plain key, so a build from
    before the 16-bit instances or the ``ACCUM`` argument existed gives the
    same keys) -> its ``registers``, ``spill_stores`` and ``spill_loads``
    (bytes) and ``smem`` (static shared memory, bytes)."""
    out: Dict[str, Dict[str, int]] = {}
    for block in ptxas.split("Compiling entry function")[1:]:
        mangled = block.split("'")[1]
        found = re.search(r"(cgx_\w+?_kernel)I((?:L[ib]\d+E)+)([ft]?)((?:Li\d+E)?)EE", mangled)
        if found:
            args = ",".join(re.findall(r"L[ib](\d+)E", found.group(2)))
            key = (f"{found.group(1)}<{args}>" + (":int8" if found.group(4) == "Li1E" else "")
                   + (":16" if found.group(3) == "t" else ""))
        else:
            plain = re.search(r"(cgx_\w+?_kernel)", mangled)
            key = plain.group(1) if plain else mangled
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out[key] = {
            "registers": int(regs.group(1)) if regs else 0,
            "spill_stores": int(spill.group(1)) if spill else 0,
            "spill_loads": int(spill.group(2)) if spill else 0,
            "smem": int(smem.group(1)) if smem else 0,
        }
    return out


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
            u = ctypes.c_uint
            lib.cgx_quantize.argtypes = [vp, vp, vp, ll, i, i, f, i, i, i, i, i, u, u, i, vp]
            lib.cgx_dequantize.argtypes = [vp, vp, vp, vp, ll, i, i, vp]
            lib.cgx_sra_epilogue.argtypes = [
                vp, vp, vp, i, i, ll, i, i, f, i, i, i, i, i, u, u, vp, vp, i, vp]
            lib.cgx_reduce_rows.argtypes = [vp, vp, vp, i, i, ll, i, i, i, vp, i, vp]
            lib.cgx_matmul_quantize.argtypes = [
                vp, vp, ll, i, i, f, vp, vp, vp, ll, ll, vp, vp, i, i, f, i, i, i, vp]
            lib.cgx_matmul_quantize_tc.argtypes = lib.cgx_matmul_quantize.argtypes
            lib.cgx_matmul_quantize_tf32.argtypes = lib.cgx_matmul_quantize.argtypes
            lib.cgx_tf32_split.argtypes = [vp, vp, ll, i, i, ll, vp, vp, vp]
            lib.cgx_quantize_db.argtypes = [vp, vp, vp, ll, i, i, i, f, i, i, i, i, i, i, u, u, i, vp]
            lib.cgx_dequantize_db.argtypes = [vp, vp, vp, vp, ll, i, i, i, vp]
            lib.cgx_sra_epilogue_db.argtypes = [
                vp, vp, vp, i, i, ll, i, i, i, f, i, i, i, i, i, i, u, u, vp, vp, i, vp]
            lib.cgx_quantize_variant.argtypes = [vp, vp, vp, ll, i, i, i, f, i, i, vp]
            lib.cgx_div_sweep.argtypes = [i, i, i, i, i, vp, vp, vp]
            lib.cgx_div_pairs.argtypes = [vp, vp, i, vp, vp, vp]
            lib.cgx_error_name.argtypes = [i]
            lib.cgx_error_name.restype = ctypes.c_char_p
            fns = (lib.cgx_quantize, lib.cgx_dequantize, lib.cgx_sra_epilogue,
                   lib.cgx_reduce_rows, lib.cgx_matmul_quantize, lib.cgx_matmul_quantize_tc,
                   lib.cgx_matmul_quantize_tf32, lib.cgx_tf32_split,
                   lib.cgx_quantize_db, lib.cgx_dequantize_db, lib.cgx_sra_epilogue_db,
                   lib.cgx_quantize_variant, lib.cgx_div_sweep, lib.cgx_div_pairs)
            for fn in fns:
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _lib_int8():
    """The int8 fold's library (:func:`build_int8` at first use): its
    entry points take the arguments of the f32 fold's."""
    global _LIB_INT8
    with _INT8_LOCK:
        if _LIB_INT8 is None:
            lib = ctypes.CDLL(str(build_int8()))
            vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
            u = ctypes.c_uint
            lib.cgx_sra_epilogue_int8.argtypes = [
                vp, vp, vp, i, i, ll, i, i, f, i, i, i, i, i, u, u, vp, vp, i, vp]
            lib.cgx_reduce_rows_int8.argtypes = [vp, vp, vp, i, i, ll, i, i, i, vp, i, vp]
            lib.cgx_sra_epilogue_db_int8.argtypes = [
                vp, vp, vp, i, i, ll, i, i, i, f, i, i, i, i, i, i, u, u, vp, vp, i, vp]
            for fn in (lib.cgx_sra_epilogue_int8, lib.cgx_reduce_rows_int8,
                       lib.cgx_sra_epilogue_db_int8):
                fn.restype = ctypes.c_int
            _LIB_INT8 = lib
    return _LIB_INT8


def _entry(name: str, accum: str):
    """The entry point ``name`` of the fold ``accum``: the default
    library's, or the int8 library's ``name_int8``."""
    return getattr(_lib(), name) if accum == "exact" else getattr(_lib_int8(), name + "_int8")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _seed_args(seed: Optional[int]) -> Tuple[int, int, int]:
    """A quantizing entry point's ``(stochastic, k0, k1)``: 0 (round to
    nearest) with no seed, else 1 and the seed's Philox key words."""
    return (0, 0, 0) if seed is None else (1, *prng.seed_words(seed))


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        what = _lib().cgx_error_name(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({what}) at launch")


# ---------------------------------------------------------------------------
# Argument checks shared by the kernel wrappers.
# ---------------------------------------------------------------------------


ENCODES = ("div", "mul")  # the kernels' ENCODE template argument, by index
PACKS = ("sum", "butterfly")  # the kernels' PACK template argument, by index


def _lowering(encode: Optional[str], pack: Optional[str]) -> Tuple[str, str]:
    """The (encode, pack) pair a quantizing wrapper or plain version runs:
    an explicit argument, else ``CGX_CODEC_ENCODE`` (read on every call) and
    ``CGX_PALLAS_PACK`` (else "sum"). The batch functions pass the pack they
    resolved with the autotune entry."""
    encode = cfg_mod.codec_encode() if encode is None else encode
    pack = (cfg_mod.pallas_pack() or "sum") if pack is None else pack
    if encode not in ENCODES:
        raise ValueError(f"encode must be one of {ENCODES}, got {encode!r}")
    if pack not in PACKS:
        raise ValueError(f"pack must be one of {PACKS}, got {pack!r}")
    return encode, pack


def _check_seed(seed: Optional[int]) -> None:
    if seed is not None and not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be a 64-bit unsigned integer or None, got {seed!r}")


ACCUMS = ("exact", "int8")  # the reduce kernels' ACCUM template argument, by index


def _accum(accum: Optional[str]) -> str:
    """The fold a reduce wrapper or plain version runs: an explicit
    argument, else ``CGX_SRA_ACCUM`` (read on every call)."""
    accum = cfg_mod.sra_accum() if accum is None else accum
    if accum not in ACCUMS:
        raise ValueError(f"accum must be one of {ACCUMS}, got {accum!r}")
    return accum


def _check_own(raw: Optional[torch.Tensor], own: int, ws: int) -> None:
    if (raw is None) != (own < 0) or own >= ws:
        raise ValueError(f"own={own} must name a row exactly when a raw row is given")


def _device_kind(*ts: Optional[torch.Tensor]) -> str:
    kinds = {t.device.type for t in ts if t is not None}
    if len(kinds) != 1:
        raise ValueError(f"codec operands on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"codec kernels run on cuda (or the plain version on cpu), got {kind}")
    return kind


def wire_code(name: str, dtype: torch.dtype) -> int:
    """The entry points' ``wire`` argument for ``dtype``: its index in
    :data:`WIRE_DTYPES`; another dtype raises ``ValueError`` naming it."""
    if dtype not in WIRE_DTYPES:
        raise ValueError(
            f"{name}: the codec kernels read float32, bfloat16 or float16, got {dtype}"
        )
    return WIRE_DTYPES.index(dtype)


def _require_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
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
# The cluster geometry of B1/B5 and B3 (csrc/codec.cu, "The cluster
# kernels"): a cluster of k CTAs takes one 32-bucket chunk, CTA ``rank``
# the positions [rank*B/k, (rank+1)*B/k), its thread t the position
# rank*B/k + t of all 32 buckets, whose values it holds in registers; past
# the register budget also rank*B/k + t + T, + 2T, ... (T threads a CTA),
# each re-read from the L2 for the encode.
# ---------------------------------------------------------------------------

CLUSTER_SIZES = (1, 2, 4, 8)
CLUSTER_MAX_THREADS = 512
# The register budget: the 32 values of one position a thread, so a chunk
# fits the largest cluster up to B = 8 * 512.
CLUSTER_VALUES_PER_THREAD = CHUNK_BUCKETS
# The SMs the rule that picks k counts in where no card is named: an H100
# SXM's.
CLUSTER_SMS = 132


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    k: int  # CTAs a chunk (the cluster size)
    threads: int  # a CTA's threads
    positions: int = 1  # positions a thread: 1 in registers, more re-read


def cluster_geometries(bucket_size: int) -> list:
    """Every geometry within the register budget for bucket ``bucket_size``,
    by k: B/k threads a CTA, one position each, in whole warps, at most
    :data:`CLUSTER_MAX_THREADS`."""
    return [ClusterGeometry(k, bucket_size // k) for k in CLUSTER_SIZES
            if bucket_size % (LANE_GROUP * k) == 0 and bucket_size // k <= CLUSTER_MAX_THREADS]


def cluster_k(chunks: int, sms: int = CLUSTER_SMS) -> int:
    """The cluster size the rule wants for ``chunks`` chunks on ``sms`` SMs,
    before the bucket's own limits (measured on an H100's 132:
    ``tools/shapebench.py --geometries``): up to one SM's worth of chunks,
    the largest k that keeps one CTA an SM (a chunk's k CTAs run side by
    side on otherwise idle SMs); up to 1.6 SMs' worth, where one CTA a chunk
    would give a few SMs two and the rest one, the smallest k that puts at
    least four CTAs on each SM; above it, k = 1: the chunks fill the card
    evenly alone."""
    if chunks <= sms:
        return max([k for k in CLUSTER_SIZES if chunks * k <= sms] or [1])
    if 5 * chunks < 8 * sms:
        return next((k for k in CLUSTER_SIZES if chunks * k >= 4 * sms), CLUSTER_SIZES[-1])
    return 1


def cluster_geometry(chunks: int, bucket_size: int, bits: int,
                     sms: int = CLUSTER_SMS) -> ClusterGeometry:
    """The launch geometry of the cluster kernels for ``chunks`` chunks of
    bucket ``bucket_size`` at ``bits`` bits on a card of ``sms`` SMs: of
    :func:`cluster_geometries`, the smallest k at or above
    :func:`cluster_k`'s, else the largest. Where none fits (B > 4096, or
    B/32 warps of positions that no k splits into at most 512 threads), the
    largest k that splits the warps, each CTA's B/k positions in the fewest
    rounds of at most 512 threads, evenly: ``positions`` rounds, re-read.
    ``bits`` adds only its ``bits`` words a thread, within the budget at
    every width."""
    if chunks < 1 or not 1 <= bits <= 8:
        raise ValueError(f"chunks={chunks}, bits={bits}: need chunks >= 1 and bits in 1..8")
    if bucket_size < LANE_GROUP or bucket_size % LANE_GROUP:
        raise ValueError(f"bucket_size must be a positive multiple of 32, got {bucket_size}")
    fits = cluster_geometries(bucket_size)
    if fits:
        want = cluster_k(chunks, sms)
        return next((g for g in fits if g.k >= want), fits[-1])
    warps = bucket_size // LANE_GROUP
    k = max(k for k in CLUSTER_SIZES if warps % k == 0)
    rounds = -(-(warps // k) // (CLUSTER_MAX_THREADS // LANE_GROUP))
    return ClusterGeometry(k, LANE_GROUP * -(-(warps // k) // rounds), rounds)


def cluster_positions(g: ClusterGeometry, bucket_size: int) -> torch.Tensor:
    """The positions each thread of a chunk's cluster owns, as the kernels
    compute them: int64 ``(k, positions, threads)``, entry ``[rank, p, t] =
    rank*B/k + p*T + t`` where ``p*T + t < B/k``, else -1."""
    span = bucket_size // g.k
    off = (torch.arange(g.positions).view(1, -1, 1) * g.threads
           + torch.arange(g.threads).view(1, 1, -1))
    pos = torch.arange(g.k).view(-1, 1, 1) * span + off
    return torch.where(off < span, pos, torch.full_like(pos, -1))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(t: torch.Tensor) -> int:
    """The SMs of the card that holds ``t`` (:data:`CLUSTER_SMS` for a CPU
    tensor, whose plain version has no grid)."""
    return _sm_count(t.device.index) if t.is_cuda else CLUSTER_SMS


def _geometry(t: torch.Tensor, chunks: int, bucket_size: int, bits: int) -> ClusterGeometry:
    """:func:`cluster_geometry` on the card that holds ``t``."""
    return cluster_geometry(chunks, bucket_size, bits, _sm_count(t.device.index))


# ---------------------------------------------------------------------------
# Quantize (B1 + B5).
# ---------------------------------------------------------------------------


def quantize_chunks_plain(
    x: torch.Tensor, bits: int, bucket_size: int,
    encode: Optional[str] = None, pack: Optional[str] = None, seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`quantize_chunks`."""
    encode, pack = _lowering(encode, pack)
    xb = x.reshape(-1, bucket_size).to(torch.float32)
    unit, bmin = codec.compute_meta(xb, bits)
    rand = None if seed is None else prng.chunk_offsets(
        seed, xb.shape[0] // CHUNK_BUCKETS, bucket_size, device=x.device)
    lvl = codec.encode_levels(xb, unit, bmin, bits, encode, rand)
    return codec.pack_levels_bucketed(lvl, bits, pack), torch.stack([unit, bmin], dim=1)


def quantize_chunks(
    x: torch.Tensor, bits: int, bucket_size: int,
    encode: Optional[str] = None, pack: Optional[str] = None, seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a flat buffer of whole chunks: ``x`` f32, bf16 or f16
    ``(C*32*B,)`` -> ``(words int32 (C*bits*B,), meta f32 (C*32, 2))``, in
    the ``encode`` and ``pack`` lowerings (:func:`_lowering`); with
    ``seed``, rounding stochastically (chunk indices 0 .. C-1 of
    ``utils/prng.py``'s layout). The kernel reads ``x`` in its dtype."""
    encode, pack = _lowering(encode, pack)
    _check_seed(seed)
    wire_code("quantize x", x.dtype)
    chunks = _chunk_geometry(x.numel(), bits, bucket_size)
    if _device_kind(x) == "cpu":
        return quantize_chunks_plain(x, bits, bucket_size, encode, pack, seed)
    _require_cuda_operand("quantize x", x, x.dtype, x.numel())
    return _launch_quantize(x, bits, bucket_size, encode, pack, seed=seed)


def _launch_quantize(
    x: torch.Tensor, bits: int, bucket_size: int, encode: str, pack: str,
    g: Optional[ClusterGeometry] = None, seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of B1 on a checked CUDA operand at geometry ``g`` (None:
    :func:`cluster_geometry`'s on the operand's card), stochastic with
    ``seed``."""
    lib = _lib()
    chunks = x.numel() // (CHUNK_BUCKETS * bucket_size)
    g = g or _geometry(x, chunks, bucket_size, bits)
    words = torch.empty(chunks * bits * bucket_size, dtype=torch.int32, device=x.device)
    meta = torch.empty((chunks * CHUNK_BUCKETS, 2), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), words.data_ptr(), meta.data_ptr(), chunks, bucket_size,
            bits, codec.unit_scale(bits), ENCODES.index(encode), PACKS.index(pack),
            g.k, g.threads)
    wire = wire_code("quantize x", x.dtype)
    err = lib.cgx_quantize(*args, *_seed_args(seed), wire, _stream(x))
    _count_launch("codec_quantize", wire)
    _check_launch("codec_quantize", err)
    return words, meta


# ---------------------------------------------------------------------------
# The divide of the cluster kernels' div encode: where the bucket's divisor
# ``safe`` lies in [2^-64, 2^64) and a = x - min is 0 or at least
# :data:`RCP_MIN_NUMERATOR`, a is divided as q = a*r with r the correctly
# rounded reciprocal of safe, then q + (a - safe*q)*r with both steps one
# FMA (csrc/codec.cu div_quotient); elsewhere by the IEEE divide. The bytes
# rest on that quotient being the IEEE one: the card checks it
# (:func:`reciprocal_sweep`), the CPU tests an exact model of it.
# ---------------------------------------------------------------------------

RCP_EXP_RANGE = (-64, 64)  # safe's binary exponent e, 2^e <= safe < 2^(e+1)
RCP_MIN_NUMERATOR = 2.0**-62  # the least nonzero a the reciprocal divides


def rcp_in_range(safe: float) -> bool:
    """Whether the cluster kernels divide by ``safe`` (a float32 value,
    positive or +inf) through its reciprocal: exponent field within
    :data:`RCP_EXP_RANGE`, so subnormal, infinite and NaN divisors (and
    those whose reciprocal could leave the normal range) take the IEEE
    divide."""
    bits = int(np.array(safe, dtype=np.float32).view(np.uint32))
    e = ((bits >> 23) & 0xFF) - 127
    return RCP_EXP_RANGE[0] <= e < RCP_EXP_RANGE[1]


def reciprocal_sweep(dev, e2: int = 0, m0: int = 0, m_step: int = 1, ulps: int = 1,
                     extra: int = 64) -> Dict[str, object]:
    """On the card: the kernels' reciprocal quotient against ``__fdiv_rn``
    for every divisor significand ``m = m0, m0 + m_step, ... < 2^23`` at
    binary exponent ``e2`` (d = (1 + m/2^23) * 2^e2), each with the
    numerators RN(t/2 * d) (t = 0 .. 513, every level and level boundary
    of 8 bits), ``ulps`` neighbours on each side, ``extra`` pseudo-random
    ones in [0, 256 d), and :data:`RCP_MIN_NUMERATOR` with its neighbours.
    Returns the pairs tried; those whose quotient differs in any bit from
    the IEEE one (``quotients_differ``); those whose 8-bit level differs;
    and one pair (a, d) of either kind, or None. A verification kernel, not
    a codec one: no launch count."""
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    first = torch.zeros(2, dtype=torch.float32, device=dev)
    err = _lib().cgx_div_sweep(e2, m0, m_step, ulps, extra, counts.data_ptr(), first.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("cgx_div_sweep", err)
    c = counts.tolist()
    return {"pairs": c[0], "quotients_differ": c[1], "levels_differ": c[2],
            "first": tuple(first.tolist()) if c[3] else None}


def reciprocal_pairs(a: torch.Tensor, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """On the card: ``(div_quotient(a, d), __fdiv_rn(a, d))`` elementwise for
    f32 CUDA tensors of equal length (the guard included)."""
    a, d = a.contiguous(), d.contiguous()
    fast, ref = torch.empty_like(a), torch.empty_like(a)
    err = _lib().cgx_div_pairs(a.data_ptr(), d.data_ptr(), a.numel(), fast.data_ptr(),
                               ref.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    _check_launch("cgx_div_pairs", err)
    return fast, ref


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
    encode: Optional[str] = None,
    pack: Optional[str] = None,
    seed: Optional[int] = None,
    accum: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`sra_epilogue_chunks`. ``cast_dtype`` rounds
    the reduced chunk through the wire dtype before the requantize, as the
    staged path quantizes ``reduced.to(dtype)``. The raw row may be of any
    float dtype here."""
    acc = reduce_rows_chunks_plain(words, meta, raw, own, bits, bucket_size, accum)
    if cast_dtype != torch.float32:
        acc = acc.to(cast_dtype).to(torch.float32)
    return quantize_chunks_plain(acc, bits, bucket_size, encode, pack, seed)


def sra_epilogue_chunks(
    words: torch.Tensor,
    meta: torch.Tensor,
    raw: Optional[torch.Tensor],
    own: int,
    bits: int,
    bucket_size: int,
    cast_dtype: torch.dtype = torch.float32,
    encode: Optional[str] = None,
    pack: Optional[str] = None,
    seed: Optional[int] = None,
    accum: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dequantize-accumulate-requantize: ``words`` int32 ``(ws,
    C*bits*B)`` and ``meta`` f32 ``(ws, C*32, 2)`` of the ws peer rows, the
    raw own chunk ``raw`` ``(C*32*B,)`` replacing row ``own`` (-1 and None:
    no substitution) -> the stage-2 payload ``(words (C*bits*B,), meta
    (C*32, 2))`` of the reduced chunk. Rows fold in ascending order, in the
    fold ``accum`` (:func:`_accum`). ``cast_dtype``: the wire dtype (of
    :data:`WIRE_DTYPES`) the reduced chunk rounds through before the
    requantize; on the card the kernel reads a raw row in that same dtype
    (another raises ``ValueError``; the plain version takes any). ``encode``
    and ``pack``: the requantize's lowerings (:func:`_lowering`); ``seed``:
    a stochastic requantize, the output row's chunk indices 0 .. C-1."""
    accum = _accum(accum)
    encode, pack = _lowering(encode, pack)
    _check_seed(seed)
    wire_code("epilogue cast_dtype", cast_dtype)
    ws = words.shape[0]
    n = meta.shape[1] * bucket_size
    chunks = _chunk_geometry(n, bits, bucket_size)
    _check_own(raw, own, ws)
    if _device_kind(words, meta, raw) == "cpu":
        return sra_epilogue_chunks_plain(
            words, meta, raw, own, bits, bucket_size, cast_dtype, encode, pack, seed, accum
        )
    _require_epilogue_operands("epilogue", words, meta, raw, cast_dtype, ws, n, bits, bucket_size)
    return _launch_epilogue(words, meta, raw, own, bits, bucket_size, encode, pack, seed=seed,
                            cast_dtype=cast_dtype, accum=accum)


def _require_epilogue_operands(name: str, words, meta, raw, cast_dtype, ws: int, n: int,
                               bits: int, bucket_size: int) -> None:
    """B3's and B7c's CUDA operands: int32 words and f32 meta of ``ws``
    rows of ``n`` values, a raw row of ``n`` values in the wire dtype
    ``cast_dtype``."""
    _require_cuda_operand(f"{name} words", words, torch.int32, ws * n * bits // CHUNK_BUCKETS)
    _require_cuda_operand(f"{name} meta", meta, torch.float32, ws * 2 * n // bucket_size)
    if raw is not None:
        if raw.dtype != cast_dtype:
            raise ValueError(
                f"{name} raw: the kernel reads the raw own row in the wire dtype {cast_dtype}, "
                f"got {raw.dtype}"
            )
        _require_cuda_operand(f"{name} raw", raw, cast_dtype, n)


def _launch_epilogue(
    words: torch.Tensor, meta: torch.Tensor, raw: Optional[torch.Tensor], own: int, bits: int,
    bucket_size: int, encode: str, pack: str, g: Optional[ClusterGeometry] = None,
    seed: Optional[int] = None, cast_dtype: torch.dtype = torch.float32, accum: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of B3 on checked CUDA operands at geometry ``g`` (None:
    :func:`cluster_geometry`'s on the operands' card), stochastic with
    ``seed``, in the wire dtype ``cast_dtype``, folding by ``accum``."""
    ws = words.shape[0]
    chunks = meta.shape[1] // CHUNK_BUCKETS
    g = g or _geometry(words, chunks, bucket_size, bits)
    out_words = torch.empty(chunks * bits * bucket_size, dtype=torch.int32, device=words.device)
    out_meta = torch.empty((chunks * CHUNK_BUCKETS, 2), dtype=torch.float32, device=words.device)
    args = (words.data_ptr(), meta.data_ptr(), None if raw is None else raw.data_ptr(),
            own, ws, chunks, bucket_size, bits, codec.unit_scale(bits),
            ENCODES.index(encode), PACKS.index(pack), g.k, g.threads)
    wire = wire_code("epilogue cast_dtype", cast_dtype)
    outs = (out_words.data_ptr(), out_meta.data_ptr(), wire, _stream(words))
    err = _entry("cgx_sra_epilogue", accum)(*args, *_seed_args(seed), *outs)
    _count_launch("codec_sra_epilogue", wire, accum)
    _check_launch("codec_sra_epilogue", err)
    return out_words, out_meta


# ---------------------------------------------------------------------------
# Fused multi-row reduce (B4).
# ---------------------------------------------------------------------------


INT8_ONE = 4096.0  # 2^12: the int8 fold's fixed-point one (codec_pallas._INT8_FRAC_BITS)


def round_i32(v: torch.Tensor) -> torch.Tensor:
    """float -> int32 to nearest, ties to even, saturating, NaN -> 0: XLA's
    f32 -> s32 convert of ``jnp.round`` (on the card ``__float2int_rn``)."""
    d = torch.nan_to_num(torch.round(v).to(torch.float64), nan=0.0)
    return d.clamp(-(2.0**31), 2.0**31 - 1).to(torch.int32)


def _fold_int8(words, meta, raw, own: int, bits: int, bucket_size: int) -> torch.Tensor:
    """The int8 fold of the rows (``codec_pallas._decode_accumulate``,
    ``accum="int8"``): per bucket, ``U`` the rows' largest unit (NaN
    propagating, the own row's included), ``usafe`` U or 1, each kept row's
    scale ``s_r = round_i32(unit_r * (4096 / usafe))``, ``bsum`` the kept
    rows' mins summed ascending from +0 (+0 in the own row's place); per
    value ``acc = sum_r level_r * s_r`` wrapping in int32, then ``bsum +
    (usafe * 2^-12) * float(acc)`` and the raw own row last."""
    ws = words.shape[0]
    m = meta.to(torch.float32).reshape(ws, -1, 2)
    units, mins = m[..., 0], m[..., 1]
    umax = units[0]
    for r in range(1, ws):
        umax = torch.maximum(umax, units[r])
    usafe = torch.where(umax > 0, umax, torch.ones_like(umax))
    # Tensor by tensor: an IEEE divide (a scalar over a tensor multiplies by
    # the tensor's reciprocal).
    inv = torch.full_like(usafe, INT8_ONE) / usafe
    nb = units.shape[1]
    bsum = torch.zeros_like(umax)
    acc = torch.zeros((nb, bucket_size), dtype=torch.int64, device=words.device)
    for r in range(ws):
        bsum = bsum + (torch.zeros_like(umax) if r == own else mins[r])
        if r != own:
            lvl = codec.unpack_levels_bucketed(words[r], bits, nb, bucket_size).to(torch.int64)
            acc += lvl * round_i32(units[r] * inv).to(torch.int64)[:, None]
    acc = (torch.remainder(acc + 2**31, 2**32) - 2**31).to(torch.int32)
    vals = bsum[:, None] + (usafe * (1.0 / INT8_ONE))[:, None] * acc.to(torch.float32)
    if raw is not None:
        vals = vals + raw.to(torch.float32).reshape(nb, bucket_size)
    return vals.reshape(-1)


def reduce_rows_chunks_plain(
    words: torch.Tensor,
    meta: torch.Tensor,
    raw: Optional[torch.Tensor],
    own: int,
    bits: int,
    bucket_size: int,
    accum: Optional[str] = None,
) -> torch.Tensor:
    """Plain version of :func:`reduce_rows_chunks`: decode each row (the
    raw row, upcast, in place of row ``own``) and fold ``v0 + v1 + ...``;
    under ``accum="int8"`` :func:`_fold_int8`."""
    if _accum(accum) == "int8":
        return _fold_int8(words, meta, raw, own, bits, bucket_size)
    acc = None
    for r in range(words.shape[0]):
        if r == own:
            vals = raw.to(torch.float32).reshape(-1)
        else:
            vals = dequantize_chunks_plain(words[r], meta[r], bits, bucket_size)
        acc = vals if acc is None else acc + vals
    return acc


def reduce_rows_chunks(
    words: torch.Tensor,
    meta: torch.Tensor,
    raw: Optional[torch.Tensor],
    own: int,
    bits: int,
    bucket_size: int,
    accum: Optional[str] = None,
) -> torch.Tensor:
    """Fused dequantize-accumulate: ``words`` int32 ``(ws, C*bits*B)`` and
    ``meta`` f32 ``(ws, C*32, 2)`` of ws rows of whole chunks, the raw own
    chunk ``raw`` f32, bf16 or f16 ``(C*32*B,)`` (read in its dtype)
    replacing row ``own`` (-1 and None: no substitution) -> the reduced
    chunk f32 ``(C*32*B,)``, rows folded in ascending order, in the fold
    ``accum`` (:func:`_accum`)."""
    accum = _accum(accum)
    ws = words.shape[0]
    n = meta.shape[1] * bucket_size
    chunks = _chunk_geometry(n, bits, bucket_size)
    _check_own(raw, own, ws)
    if raw is not None:
        wire_code("reduce raw", raw.dtype)
    if _device_kind(words, meta, raw) == "cpu":
        return reduce_rows_chunks_plain(words, meta, raw, own, bits, bucket_size, accum)
    _require_cuda_operand("reduce words", words, torch.int32, ws * chunks * bits * bucket_size)
    _require_cuda_operand("reduce meta", meta, torch.float32, ws * 2 * n // bucket_size)
    if raw is not None:
        _require_cuda_operand("reduce raw", raw, raw.dtype, n)
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    # Full width: copies of 4 positions (16 bytes, the raw row's 4 values),
    # 32 such vectors a block.
    wide = bucket_size % 128 == 0 and all(
        t is None or t.data_ptr() % (4 * t.element_size()) == 0 for t in (words, meta, raw, out))
    return _launch_reduce(words, meta, raw, own, bits, bucket_size, out, 4 if wide else 1, accum)


def _launch_reduce(
    words: torch.Tensor, meta: torch.Tensor, raw: Optional[torch.Tensor], own: int, bits: int,
    bucket_size: int, out: torch.Tensor, vec: int, accum: str = "exact",
) -> torch.Tensor:
    """One launch of B4 on checked CUDA operands at width ``vec`` (4: every
    operand aligned to four of its values, the bucket a multiple of 128; 1:
    scalar width, counted in :data:`REDUCE_SCALAR`), folding by ``accum``."""
    chunks = meta.shape[1] // CHUNK_BUCKETS
    wire = 0 if raw is None else wire_code("reduce raw", raw.dtype)
    err = _entry("cgx_reduce_rows", accum)(
        words.data_ptr(), meta.data_ptr(), None if raw is None else raw.data_ptr(),
        own, words.shape[0], chunks, bucket_size, bits, vec, out.data_ptr(), wire, _stream(words),
    )
    _count_launch("codec_reduce_rows", wire, accum)
    if vec == 1:
        REDUCE_SCALAR["launches"] += 1
    _check_launch("codec_reduce_rows", err)
    return out


# ---------------------------------------------------------------------------
# Matmul with a quantize epilogue (B8).
# ---------------------------------------------------------------------------


def _own_span(n: int, own_row: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """``(start, length)`` in the flat dw of row ``own`` of ``ws`` equal
    rows, or ``(0, 0)`` without ``own_row``."""
    if own_row is None:
        return 0, 0
    own, ws = own_row
    if ws < 1 or n % ws or not 0 <= own < ws:
        raise ValueError(f"own_row={own_row}: own must index one of ws equal rows of {n} values")
    return own * (n // ws), n // ws


# The tensor-core kernel's output tile (rows of dw, columns of dw): two
# warpgroups of 64 rows, one m64n192 wgmma wide (csrc/codec.cu kTcBM, kTcBN).
MM_TC_TILE = (128, 192)
# The split-TF32 kernel's ring stage, in contraction steps: the split pass
# pads K to a multiple of it (csrc/codec.cu kTf32BK).
MM_TF32_BK = 32


def mm_tc_eligible(x2: torch.Tensor, g2: torch.Tensor) -> bool:
    """Whether the matmul-quantize's tensor cores take these operands: both
    2-D and of one dtype; float32 always (the split pass reads any width
    and alignment and writes TMA-describable planes, so every float32 pair
    the FFMA kernel takes, ``o % 4 == 0``, runs as split TF32); bfloat16
    or float16 where ``din = x2.shape[1]`` and ``o = g2.shape[1]`` are
    multiples of 8 (TMA's row strides are multiples of 16 bytes) and both
    base pointers 16-byte aligned. Pure: the wrapper decides the route with
    it before the launch."""
    if x2.dtype != g2.dtype or x2.dim() != 2 or g2.dim() != 2:
        return False
    if x2.dtype == torch.float32:
        return True
    return (x2.dtype in (torch.bfloat16, torch.float16) and x2.shape[1] % 8 == 0
            and g2.shape[1] % 8 == 0 and x2.data_ptr() % 16 == 0 and g2.data_ptr() % 16 == 0)


def mm_tc_tiles(din: int, o: int) -> Tuple[int, int]:
    """The tensor-core kernels' tiles of a ``(din, o)`` dw: ``(rows of
    tiles, columns of tiles)``, :data:`MM_TC_TILE` each; the persistent
    grid walks their product (at most one block an SM)."""
    bm, bn = MM_TC_TILE
    return -(-din // bm), -(-o // bn)


def _mm_route(x2: torch.Tensor, g2: torch.Tensor, route: Optional[str]) -> str:
    """The kernel a matmul-quantize launch takes: "tc" (the tensor cores;
    split TF32 for float32) where :func:`mm_tc_eligible` admits the
    operands, else "ffma"; ``route="ffma"`` forces the FFMA kernel for any
    operands."""
    if route not in (None, "ffma"):
        raise ValueError(f"_route must be None or 'ffma', got {route!r}")
    return route or ("tc" if mm_tc_eligible(x2, g2) else "ffma")


def tf32_round_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, the 13 low bits zero (PTX ``cvt.rna.tf32.f32``, as the
    split kernel clears them): half a unit of the 13 bits added to the
    magnitude, then cut. A value past TF32's largest rounds to inf;
    infinities and NaNs stay as they are."""
    b = x.contiguous().view(torch.int32)
    finite = (b & 0x7FFFFFFF) < 0x7F800000
    r = torch.where(finite, (b + 0x1000) & -0x2000, b)
    return r.view(torch.float32).reshape(x.shape)


def tf32_split_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split of float32 ``x`` into ``hi = tf32(x)`` and ``lo = tf32(x -
    hi)`` (``x - hi`` is exact): ``hi + lo`` is ``x`` within ``2^-22 |x|``,
    and an integer below ``2^11`` in magnitude has ``lo = 0``. A nonfinite
    ``x`` gives ``lo`` NaN."""
    hi = tf32_round_plain(x)
    return hi, tf32_round_plain(x - hi)


def _k_pad(k_total: int) -> int:
    return -(-k_total // MM_TF32_BK) * MM_TF32_BK


def tf32_split_transpose_plain(x2: torch.Tensor, g2: torch.Tensor):
    """Plain version of :func:`tf32_split_transpose`: ``(xs, gs)``, the
    ``(2, din, kp)`` and ``(2, o, kp)`` float32 planes ``[hi, lo]`` of
    ``x2^T`` and ``g2^T``, K padded with zeros to ``kp``, a multiple of
    :data:`MM_TF32_BK`."""
    kp = _k_pad(x2.shape[0])

    def planes(t):
        hi, lo = tf32_split_plain(t.t())
        out = torch.zeros((2, t.shape[1], kp), dtype=torch.float32, device=t.device)
        out[0, :, : t.shape[0]] = hi
        out[1, :, : t.shape[0]] = lo
        return out

    return planes(x2), planes(g2)


def tf32_split_transpose(x2: torch.Tensor, g2: torch.Tensor):
    """The split-TF32 matmul-quantize's pass over its float32 operands
    ``x2`` ``(K, din)`` and ``g2`` ``(K, o)``: the K-major planes of
    :func:`tf32_split_transpose_plain`, written by one launch of
    ``cgx_tf32_split_kernel`` on the card (counted in
    ``LAUNCHES["codec_tf32_split"]``), the plain version for CPU tensors."""
    if x2.dim() != 2 or g2.dim() != 2 or x2.shape[0] != g2.shape[0]:
        raise ValueError(f"expected x2 (K, din) and g2 (K, o), got {tuple(x2.shape)}, {tuple(g2.shape)}")
    if _device_kind(x2, g2) == "cpu":
        return tf32_split_transpose_plain(x2.float(), g2.float())
    _require_cuda_operand("split x2", x2, torch.float32, x2.numel())
    _require_cuda_operand("split g2", g2, torch.float32, g2.numel())
    k_total, din = x2.shape
    o = g2.shape[1]
    kp = _k_pad(k_total)
    xs = torch.empty((2, din, kp), dtype=torch.float32, device=x2.device)
    gs = torch.empty((2, o, kp), dtype=torch.float32, device=x2.device)
    err = _lib().cgx_tf32_split(x2.data_ptr(), g2.data_ptr(), k_total, din, o, kp, xs.data_ptr(),
                                gs.data_ptr(), _stream(x2))
    _count_launch("codec_tf32_split", 0)
    _check_launch("codec_tf32_split", err)
    return xs, gs


def matmul_quantize_chunks_plain(
    x2: torch.Tensor, g2: torch.Tensor, div: int, bits: int, bucket_size: int,
    encode: Optional[str] = None, pack: Optional[str] = None,
    own_row: Optional[Tuple[int, int]] = None,
):
    """Plain version of :func:`matmul_quantize_chunks`: the float32 product
    of the (upcast) operands, the divide, then :func:`quantize_chunks_plain`
    of the flat result; the own row's values are the product rounded to the
    operands' dtype (the layer's compute dtype; float32: itself), then
    divided."""
    dw = torch.matmul(x2.float().t(), g2.float()).reshape(-1)
    return _quantize_dw(dw, x2.dtype, div, bits, bucket_size, encode, pack, own_row)


def _quantize_dw(dw, dtype, div, bits, bucket_size, encode, pack, own_row):
    words, meta = quantize_chunks_plain(dw / div, bits, bucket_size, encode, pack)
    if own_row is None:
        return words, meta
    lo, ln = _own_span(dw.numel(), own_row)
    return words, meta, dw[lo : lo + ln].to(dtype).float() / div


def matmul_quantize_chunks_tf32_plain(
    x2: torch.Tensor, g2: torch.Tensor, div: int, bits: int, bucket_size: int,
    encode: Optional[str] = None, pack: Optional[str] = None,
    own_row: Optional[Tuple[int, int]] = None,
):
    """The split-TF32 scheme's function, in plain PyTorch, for float32
    operands: ``dw = lo(x)^T hi(g) + hi(x)^T lo(g) + hi(x)^T hi(g)``
    (:func:`tf32_split_plain`; ``lo lo`` dropped), each product exact,
    summed in float64 and rounded once to float32 (an order-free value the
    tensor cores' float32 sums approach), then divided and quantized as
    :func:`matmul_quantize_chunks_plain` does. Equal to it bit for bit
    where every ``lo`` is 0 and every partial sum exact (small integers)."""
    (xh, xl), (gh, gl) = tf32_split_plain(x2.float()), tf32_split_plain(g2.float())
    xh, xl, gh, gl = (t.double() for t in (xh, xl, gh, gl))
    dw = (xl.t() @ gh + xh.t() @ gl + xh.t() @ gh).float().reshape(-1)
    return _quantize_dw(dw, torch.float32, div, bits, bucket_size, encode, pack, own_row)


def matmul_quantize_chunks(
    x2: torch.Tensor, g2: torch.Tensor, div: int, bits: int, bucket_size: int,
    encode: Optional[str] = None, pack: Optional[str] = None,
    own_row: Optional[Tuple[int, int]] = None, *, _route: Optional[str] = None,
):
    """The weight gradient of a dense layer, divided and quantized:
    ``x2`` ``(K, din)`` and ``g2`` ``(K, o)``, both float32, bfloat16 or
    float16 (one dtype, else ``TypeError``) -> ``(words int32 (C*bits*B,),
    meta f32 (C*32, 2))`` of the flat float32 ``x2^T g2 / div`` (``din*o``
    values, row-major, ``C = din*o / (32*B)`` chunks) in the wire layout, in
    the ``encode`` and ``pack`` lowerings (:func:`_lowering`). With
    ``own_row=(own, ws)`` also the f32 values of row ``own`` of the ``(ws,
    din*o/ws)`` view of the product in the operands' dtype, divided, from
    the same sums. On the card the kernel reads 16-bit operands itself
    (counted in :data:`WIRE16_LAUNCHES`); the quotient goes only to an
    L2-sized workspace the kernel quantizes from; one launch (float32 on
    the tensor cores: two, the split pass first). Operands
    that :func:`mm_tc_eligible` admits (every float32 pair; 16-bit ones
    TMA can describe) go to the tensor cores (counted in
    :data:`MM_TC_LAUNCHES`; float32 as split TF32, after one launch of the
    split pass, :func:`tf32_split_transpose`; the sums are the tensor
    cores', so on data whose partial sums are not exact the bytes agree
    with the plain version within a tolerance, not bit for bit), the other
    16-bit ones to the FFMA kernel, whose sums are the float32 ones of the
    upcast operands. ``_route="ffma"`` forces the FFMA kernel, for tests and
    timings; it leaves the CPU's plain version alone."""
    encode, pack = _lowering(encode, pack)
    if cfg_mod.stochastic_rounding():
        raise NotImplementedError(
            "stochastic rounding is not ported into the matmul-quantize kernel; "
            "unset CGX_STOCHASTIC_ROUNDING"
        )
    if x2.dim() != 2 or g2.dim() != 2 or x2.shape[0] != g2.shape[0]:
        raise ValueError(f"expected x2 (K, din) and g2 (K, o), got {tuple(x2.shape)}, {tuple(g2.shape)}")
    if x2.dtype != g2.dtype:
        raise TypeError(f"matmul-quantize operands must share one dtype, got {x2.dtype} and {g2.dtype}")
    wire = wire_code("matmul-quantize operands", x2.dtype)
    k_total, din = x2.shape
    o = g2.shape[1]
    chunks = _chunk_geometry(din * o, bits, bucket_size)
    raw_lo, raw_n = _own_span(din * o, own_row)
    route = _mm_route(x2, g2, _route)
    if _device_kind(x2, g2) == "cpu":
        return matmul_quantize_chunks_plain(x2, g2, div, bits, bucket_size, encode, pack, own_row)
    if o % 4:
        raise ValueError(f"the matmul-quantize kernel needs o % 4 == 0, got o={o}")
    if CHUNK_BUCKETS * bucket_size * 4 > MAX_EPILOGUE_TILE_BYTES:
        raise ValueError(f"bucket_size {bucket_size} exceeds the kernel's shared-memory tile")
    _require_cuda_operand("matmul x2", x2, x2.dtype, x2.numel())
    _require_cuda_operand("matmul g2", g2, x2.dtype, g2.numel())
    tf32 = route == "tc" and not wire
    if not wire and route == "ffma" and g2.data_ptr() % 16:  # it reads g2 four floats at a time
        g2 = g2.clone()
    dev = x2.device
    words = torch.empty(chunks * bits * bucket_size, dtype=torch.int32, device=dev)
    meta = torch.empty((chunks * CHUNK_BUCKETS, 2), dtype=torch.float32, device=dev)
    work = torch.empty(din * o, dtype=torch.float32, device=dev)
    arrivals = torch.zeros(chunks, dtype=torch.int32, device=dev)  # the launch's own
    raw = torch.empty(raw_n, dtype=torch.float32, device=dev) if own_row is not None else None
    if tf32:  # the split pass's planes in place of the operands, kp of K
        x2, g2 = tf32_split_transpose(x2, g2)
        k_total = x2.shape[2]
        entry = _lib().cgx_matmul_quantize_tf32
    else:
        entry = _lib().cgx_matmul_quantize_tc if route == "tc" else _lib().cgx_matmul_quantize
    err = entry(
        x2.data_ptr(), g2.data_ptr(), k_total, din, o, float(div),
        work.data_ptr(), arrivals.data_ptr(),
        None if raw is None or raw_n == 0 else raw.data_ptr(), raw_lo, raw_n,
        words.data_ptr(), meta.data_ptr(), bucket_size, bits,
        codec.unit_scale(bits), ENCODES.index(encode), PACKS.index(pack), wire, _stream(x2),
    )
    _count_launch("codec_matmul_quantize", wire)
    if route == "tc":
        MM_TC_LAUNCHES["launches"] += 1
    _check_launch("codec_matmul_quantize", err)
    return (words, meta) if raw is None else (words, meta, raw)


# ---------------------------------------------------------------------------
# Quantize diagnostics (B9): the bodies of tools/qbench.py's variant kernel
# that change what is stored, on B1's cluster body and geometry. Its "mul"
# and "butterfly" variants are quantize_chunks' lowerings (encode="mul",
# pack="butterfly").
# ---------------------------------------------------------------------------

VARIANTS = ("nometa", "metalane", "read")  # the kernel's VARIANT argument, by index


def _trunc_i32(v: torch.Tensor) -> torch.Tensor:
    """float -> int32 toward zero, saturating, NaN -> 0 (``__float2int_rz``)."""
    d = torch.nan_to_num(v.to(torch.float64), nan=0.0)
    return d.clamp(-(2.0**31), 2.0**31 - 1).trunc().to(torch.int32)


def quantize_variant_chunks_plain(
    x: torch.Tensor, variant: str, bits: int, bucket_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`quantize_variant_chunks`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    xb = x.reshape(-1, bucket_size).to(torch.float32)
    chunks = xb.shape[0] // CHUNK_BUCKETS
    unit, bmin = codec.compute_meta(xb, bits)
    if variant == "read":
        top = unit.view(chunks, CHUNK_BUCKETS).amax(dim=1)
        words = _trunc_i32(top)[:, None].expand(chunks, bits * bucket_size).reshape(-1)
        return words.contiguous(), torch.stack([unit, bmin], dim=1)
    lvl = codec.encode_levels(xb, unit, bmin, bits, "div")
    words = codec.pack_levels_bucketed(lvl, bits, "sum")
    if variant == "nometa":
        return words, torch.zeros((chunks * CHUNK_BUCKETS, 2), dtype=torch.float32, device=x.device)
    pad = torch.zeros((chunks, 128 - 2 * CHUNK_BUCKETS), dtype=torch.float32, device=x.device)
    return words, torch.cat([unit.view(chunks, -1), bmin.view(chunks, -1), pad], dim=1)


def quantize_variant_chunks(
    x: torch.Tensor, variant: str, bits: int, bucket_size: int,
    g: Optional[ClusterGeometry] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9's diagnostic bodies on a flat buffer of whole chunks: ``x`` f32
    ``(C*32*B,)`` -> words int32 ``(C*bits*B,)`` and meta f32:

    * "nometa": the quantize words, the meta ``(C*32, 2)`` zero-filled;
    * "metalane": the quantize words, the meta as ``(C, 128)`` rows
      ``[32 units | 32 mins | 64 zeros]``;
    * "read": every word of chunk c the int32 (toward zero) of the largest
      unit of its 32 buckets, the meta the usual ``(C*32, 2)`` pairs.

    The div encode and the sum pack, whatever the knobs say, as the JAX
    variant kernels. On the card the kernel runs B1's cluster body at B1's
    geometry ``g`` (None: :func:`cluster_geometry`'s on the operand's card,
    as :func:`quantize_chunks` launches B1)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    chunks = _chunk_geometry(x.numel(), bits, bucket_size)
    if _device_kind(x) == "cpu":
        return quantize_variant_chunks_plain(x, variant, bits, bucket_size)
    _require_cuda_operand("quantize_variant x", x, torch.float32, x.numel())
    g = g or _geometry(x, chunks, bucket_size, bits)
    words = torch.empty(chunks * bits * bucket_size, dtype=torch.int32, device=x.device)
    shape = (chunks, 128) if variant == "metalane" else (chunks * CHUNK_BUCKETS, 2)
    meta = torch.empty(shape, dtype=torch.float32, device=x.device)
    err = _lib().cgx_quantize_variant(
        x.data_ptr(), words.data_ptr(), meta.data_ptr(), chunks, bucket_size, bits,
        VARIANTS.index(variant), codec.unit_scale(bits), g.k, g.threads, _stream(x),
    )
    LAUNCHES["codec_quantize_variant"] += 1
    _check_launch("codec_quantize_variant", err)
    return words, meta


# ---------------------------------------------------------------------------
# Pipelined kernels (B7a-c). Same bytes as the single-stage kernels, so
# their plain versions are the single-stage plain versions. B7b: a
# persistent block per SM slot streams its tiles of ``tc`` chunks through
# two shared-memory slots. B7a and B7c: B1's and B3's cluster body on a
# persistent grid of clusters (:func:`cluster_geometry`), each CTA
# streaming its share of a chunk through a ring of share slots
# (:func:`db_ring`), so their shared memory does not grow with ``tc``; a
# tile of ``tc`` chunks is what the clusters share out.
# ---------------------------------------------------------------------------

SMEM_BLOCK_BYTES = 232448  # shared memory a Hopper block may use
SMEM_SM_BYTES = 233472  # shared memory an SM holds for its blocks
SMEM_BLOCK_RESERVED = 1024  # the runtime's part of it a resident block
SM_THREADS, SM_REGISTERS, SM_BLOCKS = 2048, 65536, 32  # an SM's other limits
DB_STATIC_BYTES = 256  # B7b's bound for static shared memory
DB_BAR_BYTES = 128  # the ring's barriers, ahead of the slots (kBarBytes)
# The cluster body's static shared memory: each warp's extremes (16 warps
# x 32 buckets x max, min), the CTA's partials and the buckets' encode
# parameters (float4 each); B7a's and B7c's add the walk's cursor (five
# ints), padded to the ring's 128-byte alignment.
CLUSTER_STATIC_BYTES = (2 * 16 * 32 + 2 * 32 + 4 * 32) * 4
DB_CLUSTER_STATIC_BYTES = -(-(CLUSTER_STATIC_BYTES + 5 * 4) // 128) * 128
# Registers a thread of the cluster body at most: __launch_bounds__(512, 2)
# within the register budget, (512, 1) with positions in rounds.
CLUSTER_THREAD_REGISTERS = (64, 128)
DB_MAX_SLOTS = 8  # the deepest ring kBarBytes has barriers for (kMaxSlots)
# The depth of B7a's and B7c's rings (a power of two, at most kMaxSlots), by whether the
# geometry takes positions in rounds: B7a one slot (the registers are the
# second buffer) or, re-reading, two; B7c four of its small row items.
DB_SLOTS = {"quantize": (1, 2), "epilogue": (4, 4)}


@dataclasses.dataclass(frozen=True)
class DbRing:
    geometry: ClusterGeometry  # the cluster geometry the kernel runs at
    slots: int  # the ring's depth
    slot_bytes: int  # one slot: a CTA's share of one round (B7c: of one peer row)


def db_geometry(chunks: int, bucket_size: int, bits: int,
                sms: int = CLUSTER_SMS) -> ClusterGeometry:
    """B7a's and B7c's launch geometry: :func:`cluster_geometry`'s, except
    that past the register budget a CTA's positions go in rounds of equal
    width (whole warps: the fewest rounds, at least ``positions``, that
    divide its warps), so that every warp of the CTA reads every item of
    the ring."""
    g = cluster_geometry(chunks, bucket_size, bits, sms)
    if g.positions == 1:
        return g
    warps = bucket_size // (LANE_GROUP * g.k)
    rounds = next(r for r in range(g.positions, warps + 1) if warps % r == 0)
    return ClusterGeometry(g.k, LANE_GROUP * (warps // rounds), rounds)


def db_ring(kernel: str, chunks: int, bits: int, bucket_size: int,
            sms: int = CLUSTER_SMS, elem_size: int = 4) -> DbRing:
    """The ring of the pipelined ``kernel`` ("quantize": B7a, "epilogue":
    B7c) for ``chunks`` chunks on a card of ``sms`` SMs: at
    :func:`db_geometry`, :data:`DB_SLOTS` slots, each holding a CTA's
    ``threads`` positions of one round: B7a 32 buckets of the input's
    ``elem_size``-byte values (4, or 2 in a 16-bit wire dtype), B7c one
    peer row's ``bits`` words and its 256 bytes of chunk meta."""
    g = db_geometry(chunks, bucket_size, bits, sms)
    per = (CHUNK_BUCKETS * g.threads * elem_size if kernel == "quantize"
           else bits * g.threads * 4 + 2 * CHUNK_BUCKETS * 4)
    return DbRing(g, DB_SLOTS[kernel][g.positions > 1], per)


def _db_bytes_per_tc(bits: int, bucket_size: int, with_add: bool) -> int:
    """B7b's two slots' bytes a chunk of the tile."""
    return 2 * (bits * bucket_size * 4 + 2 * CHUNK_BUCKETS * 4
                + (CHUNK_BUCKETS * bucket_size * 4 if with_add else 0))


def db_smem_bytes(
    kernel: str, tc: int, bits: int, bucket_size: int, *, with_add: bool = False,
    chunks: int = 1, pack: str = "sum", sms: int = CLUSTER_SMS, elem_size: int = 4,
) -> int:
    """Dynamic shared memory the pipelined ``kernel`` launches with
    (``csrc/codec.cu``): the barriers, then for dequantize two slots of
    ``tc`` chunks of words and meta (and of the accumulator ``with_add``);
    for quantize and the epilogue the :func:`db_ring` of ``chunks`` chunks
    (B7a's of ``elem_size``-byte values), whatever ``tc`` is, and the
    butterfly ``pack``'s stage."""
    if kernel == "dequantize":
        return DB_BAR_BYTES + tc * _db_bytes_per_tc(bits, bucket_size, with_add)
    ring = db_ring(kernel, chunks, bits, bucket_size, sms, elem_size)
    stage = ring.geometry.threads // 32 * 32 * 32 * 4 if pack == "butterfly" else 0
    return DB_BAR_BYTES + ring.slots * ring.slot_bytes + stage


def db_clusters(kernel: str, chunks: int, bits: int, bucket_size: int,
                sms: int = CLUSTER_SMS, elem_size: int = 4) -> int:
    """The clusters of B7a or B7c that ``sms`` SMs hold at once under the
    sum pack, from the per-SM limits of threads, registers (the launch
    bounds' most), blocks and shared memory (B7a's ring of
    ``elem_size``-byte values); the kernel's own grid comes from the card's
    occupancy query."""
    ring = db_ring(kernel, chunks, bits, bucket_size, sms, elem_size)
    g = ring.geometry
    smem = (db_smem_bytes(kernel, 1, bits, bucket_size, chunks=chunks, sms=sms,
                          elem_size=elem_size)
            + DB_CLUSTER_STATIC_BYTES + SMEM_BLOCK_RESERVED)
    per_sm = min(SM_THREADS // g.threads,
                 SM_REGISTERS // (CLUSTER_THREAD_REGISTERS[g.positions > 1] * g.threads),
                 SM_BLOCKS, SMEM_SM_BYTES // smem)
    return max(1, sms * per_sm // g.k)


def db_tc_cap(kernel: str, bits: int, bucket_size: int, *, with_add: bool = False,
              chunks: int = 1, sms: int = CLUSTER_SMS, elem_size: int = 4) -> int:
    """The most chunks a tile of the pipelined ``kernel`` takes; 0 where
    its ring does not fit a block's shared memory (the single-stage kernel
    runs then: ROADMAP C7). B7b: the chunks its two slots hold. B7a and
    B7c, whose ring does not grow with the tile: ``chunks`` over the
    clusters the card holds at once (:func:`db_clusters`; B7a's ring of
    ``elem_size``-byte values), so that every cluster has a tile; their
    ring fits at every geometry."""
    if kernel == "dequantize":
        room = SMEM_BLOCK_BYTES - DB_STATIC_BYTES - DB_BAR_BYTES
        return room // _db_bytes_per_tc(bits, bucket_size, with_add)
    most = db_smem_bytes(kernel, 1, bits, bucket_size, chunks=chunks, pack="butterfly", sms=sms,
                         elem_size=elem_size)
    if most + DB_CLUSTER_STATIC_BYTES > SMEM_BLOCK_BYTES:
        return 0
    return max(1, chunks // db_clusters(kernel, chunks, bits, bucket_size, sms, elem_size))


def _require_aligned(name: str, t: Optional[torch.Tensor]) -> None:
    if t is not None and t.data_ptr() % 16:
        raise ValueError(f"{name}: the pipelined kernel's bulk copies need a 16-byte aligned operand")


def _db_tile(kernel: str, chunks: int, tc: int, bits: int, bucket_size: int,
             with_add: bool = False, elem_size: int = 4) -> None:
    """``tc`` divides the chunks, and the pipelined ``kernel``'s ring holds
    it: B7b's at most :func:`db_tc_cap` chunks a slot; B7a's and B7c's any
    tile, where their ring fits at all."""
    if tc < 1 or chunks % tc:
        raise ValueError(f"tc={tc} must divide the {chunks} chunks")
    cap = db_tc_cap(kernel, bits, bucket_size, with_add=with_add, chunks=chunks,
                    elem_size=elem_size)
    if (tc > cap) if kernel == "dequantize" else cap < 1:
        raise ValueError(
            f"{kernel}: tc={tc} chunks of bucket {bucket_size} at {bits} bits exceed the "
            f"pipelined kernel's shared memory (at most {cap})"
        )


# The plain versions: the single-stage ones (the kernels give the same bytes).
quantize_chunks_db_plain = quantize_chunks_plain
dequantize_chunks_db_plain = dequantize_chunks_plain
sra_epilogue_chunks_db_plain = sra_epilogue_chunks_plain


def quantize_chunks_db(
    x: torch.Tensor, bits: int, bucket_size: int, tc: int,
    encode: Optional[str] = None, pack: Optional[str] = None, seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_chunks` through the pipelined kernel (B7a), the
    clusters sharing out tiles of ``tc`` chunks; ``x`` f32, bf16 or f16,
    streamed into the ring in its dtype."""
    encode, pack = _lowering(encode, pack)
    _check_seed(seed)
    wire_code("quantize_db x", x.dtype)
    chunks = _chunk_geometry(x.numel(), bits, bucket_size)
    if _device_kind(x) == "cpu":
        return quantize_chunks_db_plain(x, bits, bucket_size, encode, pack, seed)
    _require_cuda_operand("quantize_db x", x, x.dtype, x.numel())
    _require_aligned("quantize_db x", x)
    _db_tile("quantize", chunks, tc, bits, bucket_size, elem_size=x.element_size())
    return _launch_quantize_db(x, bits, bucket_size, tc, encode, pack, seed=seed)


def _launch_quantize_db(
    x: torch.Tensor, bits: int, bucket_size: int, tc: int, encode: str, pack: str,
    g: Optional[ClusterGeometry] = None, slots: Optional[int] = None,
    seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of B7a on a checked CUDA operand at geometry ``g`` with a
    ring of ``slots`` (None: :func:`db_ring`'s on the operand's card),
    stochastic with ``seed``."""
    chunks = x.numel() // (CHUNK_BUCKETS * bucket_size)
    ring = db_ring("quantize", chunks, bits, bucket_size, _sm_count(x.device.index),
                   x.element_size())
    g = g or ring.geometry
    words = torch.empty(chunks * bits * bucket_size, dtype=torch.int32, device=x.device)
    meta = torch.empty((chunks * CHUNK_BUCKETS, 2), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), words.data_ptr(), meta.data_ptr(), chunks, tc, bucket_size,
            bits, codec.unit_scale(bits), ENCODES.index(encode), PACKS.index(pack),
            g.k, g.threads, slots or DB_SLOTS["quantize"][g.positions > 1])
    wire = wire_code("quantize_db x", x.dtype)
    err = _lib().cgx_quantize_db(*args, *_seed_args(seed), wire, _stream(x))
    _count_launch("codec_quantize_db", wire)
    _check_launch("codec_quantize_db", err)
    return words, meta


def dequantize_chunks_db(
    words: torch.Tensor,
    meta: torch.Tensor,
    bits: int,
    bucket_size: int,
    tc: int,
    add_to: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`dequantize_chunks` through the pipelined kernel (B7b), ``tc``
    chunks a ring slot, the accumulate of ``add_to`` fused."""
    n = meta.shape[0] * bucket_size
    chunks = _chunk_geometry(n, bits, bucket_size)
    if _device_kind(words, meta, add_to) == "cpu":
        return dequantize_chunks_db_plain(words, meta, bits, bucket_size, add_to)
    _require_cuda_operand("dequantize_db words", words, torch.int32, chunks * bits * bucket_size)
    _require_cuda_operand("dequantize_db meta", meta, torch.float32, 2 * n // bucket_size)
    if add_to is not None:
        _require_cuda_operand("dequantize_db add_to", add_to, torch.float32, n)
    for name, t in (("words", words), ("meta", meta), ("add_to", add_to)):
        _require_aligned(f"dequantize_db {name}", t)
    _db_tile("dequantize", chunks, tc, bits, bucket_size, with_add=add_to is not None)
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    err = _lib().cgx_dequantize_db(
        words.data_ptr(), meta.data_ptr(),
        None if add_to is None else add_to.data_ptr(),
        out.data_ptr(), chunks, tc, bucket_size, bits, _stream(words),
    )
    LAUNCHES["codec_dequantize_db"] += 1
    _check_launch("codec_dequantize_db", err)
    return out


def sra_epilogue_chunks_db(
    words: torch.Tensor,
    meta: torch.Tensor,
    raw: Optional[torch.Tensor],
    own: int,
    bits: int,
    bucket_size: int,
    tc: int,
    cast_dtype: torch.dtype = torch.float32,
    encode: Optional[str] = None,
    pack: Optional[str] = None,
    seed: Optional[int] = None,
    accum: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sra_epilogue_chunks` through the pipelined kernel (B7c): each
    CTA's ring streams its share of one peer row at a time, rows ascending,
    the clusters sharing out tiles of ``tc`` chunks; the raw row, read in
    the wire dtype ``cast_dtype``, from device memory. Under the int8 fold
    each chunk's scales come from every row's meta in device memory."""
    accum = _accum(accum)
    encode, pack = _lowering(encode, pack)
    _check_seed(seed)
    wire_code("epilogue_db cast_dtype", cast_dtype)
    ws = words.shape[0]
    n = meta.shape[1] * bucket_size
    chunks = _chunk_geometry(n, bits, bucket_size)
    _check_own(raw, own, ws)
    if _device_kind(words, meta, raw) == "cpu":
        return sra_epilogue_chunks_db_plain(
            words, meta, raw, own, bits, bucket_size, cast_dtype, encode, pack, seed, accum
        )
    _require_epilogue_operands("epilogue_db", words, meta, raw, cast_dtype, ws, n, bits,
                               bucket_size)
    for name, t in (("words", words), ("meta", meta), ("raw", raw)):
        _require_aligned(f"epilogue_db {name}", t)
    _db_tile("epilogue", chunks, tc, bits, bucket_size)
    return _launch_epilogue_db(words, meta, raw, own, bits, bucket_size, tc, encode, pack,
                               seed=seed, cast_dtype=cast_dtype, accum=accum)


def _launch_epilogue_db(
    words: torch.Tensor, meta: torch.Tensor, raw: Optional[torch.Tensor], own: int, bits: int,
    bucket_size: int, tc: int, encode: str, pack: str,
    g: Optional[ClusterGeometry] = None, slots: Optional[int] = None,
    seed: Optional[int] = None, cast_dtype: torch.dtype = torch.float32, accum: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of B7c on checked CUDA operands at geometry ``g`` with a
    ring of ``slots`` (None: :func:`db_ring`'s on the operands' card),
    stochastic with ``seed``, in the wire dtype ``cast_dtype``, folding by
    ``accum``."""
    ws = words.shape[0]
    chunks = meta.shape[1] // CHUNK_BUCKETS
    ring = db_ring("epilogue", chunks, bits, bucket_size, _sm_count(words.device.index))
    g = g or ring.geometry
    out_words = torch.empty(chunks * bits * bucket_size, dtype=torch.int32, device=words.device)
    out_meta = torch.empty((chunks * CHUNK_BUCKETS, 2), dtype=torch.float32, device=words.device)
    args = (words.data_ptr(), meta.data_ptr(), None if raw is None else raw.data_ptr(),
            own, ws, chunks, tc, bucket_size, bits, codec.unit_scale(bits),
            ENCODES.index(encode), PACKS.index(pack), g.k, g.threads,
            slots or DB_SLOTS["epilogue"][g.positions > 1])
    wire = wire_code("epilogue_db cast_dtype", cast_dtype)
    outs = (out_words.data_ptr(), out_meta.data_ptr(), wire, _stream(words))
    err = _entry("cgx_sra_epilogue_db", accum)(*args, *_seed_args(seed), *outs)
    _count_launch("codec_sra_epilogue_db", wire, accum)
    _check_launch("codec_sra_epilogue_db", err)
    return out_words, out_meta


# ---------------------------------------------------------------------------
# Routing: the autotune lookups, CGX_PALLAS_DB and the tile
# (codec_pallas.py:86-152, :288-302).
# ---------------------------------------------------------------------------


def _use_db(tuned: Optional[autotune.TunedConfig]) -> bool:
    """Whether a pipelined kernel runs: ``CGX_PALLAS_DB=on`` forces it,
    "auto" only where a persisted autotune entry measured it faster, "off"
    never."""
    mode = cfg_mod.pallas_db()
    if mode == "off":
        return False
    if mode == "on":
        return True
    return bool(tuned is not None and tuned.db)


def _tile_chunks(
    n_chunks: int, cap: int, tuned: Optional[autotune.TunedConfig] = None
) -> int:
    """Chunks a pipelined kernel's tile holds (``tc``): the
    ``CGX_PALLAS_TILE_CHUNKS`` override, else the tuned entry, else 1,
    always within ``cap`` (:func:`db_tc_cap`: B7b's slots, B7a's and B7c's
    busy clusters; the TPU's cap is VMEM) and the chunk count. The default
    differs from the JAX package's 16: there a tile is one step of a
    sequential grid, here tiles are what the blocks or clusters share out,
    so a slice of C chunks at tile tc keeps at most C / tc of them busy.
    The single-stage kernels ignore ``tc``: it is the CUDA counterpart of
    the TPU's grid-only tile. Read on every call, so a bad override always
    raises."""
    forced = cfg_mod.pallas_tile_chunks()
    tc = forced if forced is not None else (tuned.tc if tuned is not None else 1)
    return int(max(1, min(tc, cap, n_chunks)))


def _pipe_tc(
    n_chunks: int, cap: int, tuned: Optional[autotune.TunedConfig] = None
) -> int:
    """:func:`_tile_chunks` snapped to a divisor of the chunk count (a tile
    never straddles the end)."""
    return autotune.snap_to_divisor(_tile_chunks(n_chunks, cap, tuned), n_chunks, max(cap, 1))


def _pack_strategy(tuned: Optional[autotune.TunedConfig] = None) -> str:
    """The bit-plane pack lowering (``codec_pallas._pack_strategy``): an
    explicit ``CGX_PALLAS_PACK`` wins, then the tuned entry's, then
    "sum"."""
    forced = cfg_mod.pallas_pack()
    if forced:
        return forced
    if tuned is not None and tuned.pack in PACKS:
        return tuned.pack
    return "sum"


def _db_route(
    kernel: str, n_chunks: int, bits: int, bucket_size: int,
    tuned: Optional[autotune.TunedConfig], *, with_add: bool = False, count: bool = False,
    sms: int = CLUSTER_SMS, elem_size: int = 4,
) -> Optional[int]:
    """``tc`` for the pipelined ``kernel``, or None where the single-stage
    kernel runs. ``count``: count a call that CGX_PALLAS_DB sends to a
    pipelined kernel whose geometry does not fit (:data:`DB_GATED`).
    ``elem_size``: bytes of a quantize input's value."""
    cap = db_tc_cap(kernel, bits, bucket_size, with_add=with_add, chunks=n_chunks, sms=sms,
                    elem_size=elem_size)
    tc = _pipe_tc(n_chunks, cap, tuned)
    if not _use_db(tuned):
        return None
    if cap < 1:
        if count:
            DB_GATED[kernel] += 1
        return None
    return tc


def _flat(c_r: int, t_r: int, bucket_size: int) -> bool:
    """The flat geometry (the JAX package's flat fast path): every row whole
    chunks of 128-aligned buckets."""
    return c_r > 0 and t_r == 0 and bucket_size % 128 == 0


def db_would_run(kernel: str, q: QTensor, *, with_add: bool = False,
                 stochastic: bool = False) -> bool:
    """Whether the batch function of ``kernel`` ("quantize", "dequantize"
    or "epilogue") takes the pipelined kernel for a payload of ``q``'s
    layout (rows, length, bits, bucket, dtype; ``with_add``: a dequantize
    whose accumulator fuses; ``stochastic``: an epilogue with a seed, which
    makes no lookup). Consults the autotune cache as the batch function
    does; the caller checks the dispatcher's own gates."""
    b = q.bucket_size
    c_r, t_r = divmod(codec.num_buckets(q.numel_main, b), CHUNK_BUCKETS)
    if kernel == "epilogue":
        kind, n_chunks, ws = autotune.KIND_EPILOGUE, c_r, q.batch_rows
    elif _flat(c_r, t_r, b):
        kind, n_chunks, ws = autotune.KIND_FLAT, q.batch_rows * c_r, 0
    else:
        return False
    # The accumulator fuses only into rows of whole buckets (dequantize_batch).
    with_add = with_add and not q.residual.shape[-1] and q.numel_main == c_r * CHUNK_BUCKETS * b
    tuned = None if stochastic and kernel == "epilogue" else autotune.lookup(
        kind, n_chunks=n_chunks, bucket_size=b, bits=q.bits, ws=ws)
    elem = torch.empty((), dtype=q.dtype).element_size() if kernel == "quantize" else 4
    return _db_route(kernel, n_chunks, q.bits, b, tuned, with_add=with_add,
                     elem_size=elem) is not None


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where a bulk copy could not read it."""
    return t.clone() if t.data_ptr() % 16 else t


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
    """Fused-reduce eligibility, of the epilogue and the reduce alike: the
    JAX package's (``codec_pallas.supports_reduce``: every row whole
    32-bucket chunks of 128-aligned buckets up to 16,384, no residual, ws x
    chunk within its budget), so both packages route the same batches to
    the fused kernels, whose fold (``CGX_SRA_ACCUM``) is where the two
    lowerings can differ. The kernels take any such bucket: B3 past the
    register budget in rounds (REREAD), B7c's ring at every geometry."""
    rows = q.packed.shape[0] if q.packed.dim() == 2 else 0
    ws = rows if ws is None else ws
    b = q.bucket_size
    if not q.bits or not (1 <= q.bits <= 8) or rows < 1:
        return False
    if not b or b % 128 or b > MAX_BUCKET_ELEMS:
        return False
    if q.residual.shape[-1]:
        return False
    nb_r = codec.num_buckets(q.numel_main, b)
    if nb_r == 0 or nb_r % CHUNK_BUCKETS or q.numel_main != nb_r * b:
        return False
    return ws * CHUNK_BUCKETS * b <= MAX_REDUCE_BLOCK_ELEMS


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    """A decode's meta or accumulator in float32: the wire carries the meta
    in the tensor's dtype, the decode kernels read f32 (the JAX package
    upcasts the same operands outside its kernels, ``codec.batch_views``)."""
    return t.to(torch.float32)


def quantize_batch(
    xs: torch.Tensor,
    bits: int,
    bucket_size: int,
    *,
    skip_incomplete_buckets: bool = False,
    seed: Optional[int] = None,
) -> QTensor:
    """Quantize each row of ``xs (rows, m)``: the kernel covers each row's
    whole chunks, the dense tail of the last ``nb % 32`` buckets goes
    through ``ops/codec.py``. Same QTensor layout as the JAX package's
    ``codec_pallas.quantize_batch``. The flat geometry (every row whole
    chunks, buckets a multiple of 128) consults the autotune cache as kind
    "flat" and may take the pipelined kernel; the rest as kind "chunks".
    ``seed``: stochastic rounding, the offsets of
    ``codec.rounding_offsets`` (the kernel's chunk indices row-major over
    the rows, the tail's from its own stream). A bf16 or f16 ``xs`` goes to
    the kernel in its dtype; the meta comes back in it."""
    _check_seed(seed)
    rows, m = xs.shape
    dtype = xs.dtype
    b = bucket_size
    main_n, res_n = codec._split_residual(m, b, skip_incomplete_buckets)
    residual = xs[:, main_n:] if res_n else xs.new_zeros((rows, 0))
    x = xs[:, :main_n] if res_n else xs
    nb_r = codec.num_buckets(main_n, b)
    c_r, t_r = divmod(nb_r, CHUNK_BUCKETS)
    pad = nb_r * b - main_n
    # The edge padding of a partial last bucket: on the dense tail where
    # there is one, so the kernel reads the whole chunks where they lie.
    if pad and not t_r:
        x = torch.cat([x, x[:, -1:].expand(rows, pad)], dim=1)
    word_parts, meta_parts = [], []
    if c_r:
        head = x[:, : c_r * CHUNK_BUCKETS * b].contiguous().reshape(-1)
        tc = None
        if _flat(c_r, t_r, b):
            tuned = autotune.lookup(autotune.KIND_FLAT, n_chunks=rows * c_r, bucket_size=b, bits=bits)
            tc = _db_route("quantize", rows * c_r, bits, b, tuned, count=True, sms=_sms(x),
                           elem_size=x.element_size())
        else:
            tuned = autotune.lookup(autotune.KIND_CHUNKS, n_chunks=rows * c_r, bucket_size=b, bits=bits)
            cfg_mod.pallas_tile_chunks()  # validated on every call, as the JAX tile is
        pack = _pack_strategy(tuned)
        if tc is None:
            words, meta = quantize_chunks(head, bits, b, pack=pack, seed=seed)
        else:
            words, meta = quantize_chunks_db(_aligned(head), bits, b, tc, pack=pack, seed=seed)
        word_parts.append(words.view(rows, c_r * bits * b))
        meta_parts.append(meta.view(rows, c_r * CHUNK_BUCKETS, 2))
    if t_r:
        # The dense tail keeps the div encode (codec_pallas.py:955-972).
        tail = x[:, c_r * CHUNK_BUCKETS * b :]
        if pad:
            tail = torch.cat([tail, tail[:, -1:].expand(rows, pad)], dim=1)
        tail = tail.reshape(rows * t_r, b).to(torch.float32)
        unit, bmin = codec.compute_meta(tail, bits)
        rand = None
        if seed is not None:
            rand = codec.rounding_offsets(seed, rows, t_r, b, x.device).reshape(rows * t_r, b)
        lvl = codec.encode_levels(tail, unit, bmin, bits, rand=rand).view(rows, t_r * b)
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
        tc = None
        if _flat(c_r, t_r, b):
            tuned = autotune.lookup(autotune.KIND_FLAT, n_chunks=rows * c_r, bucket_size=b, bits=q.bits)
            tc = _db_route("dequantize", rows * c_r, q.bits, b, tuned, with_add=fuse_add, count=True,
                           sms=_sms(q.packed))
        else:
            autotune.lookup(autotune.KIND_CHUNKS, n_chunks=rows * c_r, bucket_size=b, bits=q.bits)
            cfg_mod.pallas_tile_chunks()  # validated on every call, as the JAX tile is
        w = q.packed[:, :head_words].contiguous().view(-1)
        m = meta[:, : c_r * CHUNK_BUCKETS].contiguous().view(-1, 2)
        acc = _as_f32(add_to).contiguous().view(-1) if fuse_add else None
        if tc is None:
            vals = dequantize_chunks(w, m, q.bits, b, add_to=acc)
        else:
            vals = dequantize_chunks_db(
                _aligned(w), _aligned(m), q.bits, b, tc,
                add_to=None if acc is None else _aligned(acc),
            )
        vals = vals.view(rows, c_r * CHUNK_BUCKETS * b)
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
    seed: Optional[int] = None,
    accum: Optional[str] = None,
) -> QTensor:
    """Fused dequantize-accumulate-requantize of a ws-row QTensor -> a
    rows=1 QTensor holding the stage-2 (all-gather) payload of the reduced
    chunk, the layout ``quantize_batch(reduced[None], seed=seed)`` would
    give. The caller checks :func:`supports_reduce`. Consults the autotune
    cache as kind "epilogue" and may take the pipelined kernel. A
    stochastic requantize (``seed``) keeps the heuristic tile and pack and
    makes no lookup, as the JAX package does. The reduced chunk rounds
    through ``out_dtype`` before the requantize; the raw row goes to the
    kernel in its dtype (on the card, ``out_dtype``). ``accum``: the fold
    (:func:`_accum`)."""
    _check_seed(seed)
    own = -1 if own_idx is None else int(own_idx)
    raw = None if raw_row is None else raw_row.reshape(-1).contiguous()
    nb_r = codec.num_buckets(q.numel_main, q.bucket_size)
    c_r = nb_r // CHUNK_BUCKETS
    tuned = None if seed is not None else autotune.lookup(
        autotune.KIND_EPILOGUE, n_chunks=c_r, bucket_size=q.bucket_size, bits=q.bits,
        ws=q.batch_rows,
    )
    pack = _pack_strategy(tuned)
    tc = _db_route("epilogue", c_r, q.bits, q.bucket_size, tuned, count=True, sms=_sms(q.packed))
    words, meta = q.packed.contiguous(), _as_f32(q.meta).contiguous()
    if tc is None:
        words, meta = sra_epilogue_chunks(
            words, meta, raw, own, q.bits, q.bucket_size, cast_dtype=out_dtype, pack=pack,
            seed=seed, accum=accum,
        )
    else:
        words, meta = sra_epilogue_chunks_db(
            _aligned(words), _aligned(meta), None if raw is None else _aligned(raw), own,
            q.bits, q.bucket_size, tc, cast_dtype=out_dtype, pack=pack, seed=seed, accum=accum,
        )
    return QTensor(
        packed=words.view(1, -1),
        meta=meta.view(1, nb_r, 2).to(out_dtype),
        residual=torch.zeros((1, 0), dtype=out_dtype, device=words.device),
        numel=q.numel,
        bits=q.bits,
        bucket_size=q.bucket_size,
        dtype=out_dtype,
    )


def reduce_rows_batch(
    q: QTensor,
    *,
    raw_row: Optional[torch.Tensor] = None,
    own_idx: Optional[int] = None,
    accum: Optional[str] = None,
) -> torch.Tensor:
    """Fused dequantize-accumulate of a row-batched QTensor -> flat f32
    ``(numel,)``: ``raw_row`` (the flat raw own chunk) replaces row
    ``own_idx``'s decode before the fold (``accum``: :func:`_accum`). The
    caller checks :func:`supports_reduce`. Looks the shape up as kind
    "epilogue", as the JAX package does; the reduce has no pipelined
    kernel, so the entry goes unused. The raw row goes to the kernel in its
    dtype."""
    nb_r = codec.num_buckets(q.numel_main, q.bucket_size)
    autotune.lookup(
        autotune.KIND_EPILOGUE, n_chunks=nb_r // CHUNK_BUCKETS, bucket_size=q.bucket_size,
        bits=q.bits, ws=q.batch_rows,
    )
    cfg_mod.pallas_tile_chunks()  # validated on every call, as the JAX tile is
    own = -1 if own_idx is None else int(own_idx)
    raw = None if raw_row is None else raw_row.reshape(-1).contiguous()
    out = reduce_rows_chunks(
        q.packed.contiguous(), _as_f32(q.meta).contiguous(), raw, own,
        q.bits, q.bucket_size, accum,
    )
    return out[: q.numel]
