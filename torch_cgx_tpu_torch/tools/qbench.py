"""Quantize-kernel benchmark of the port: B9's diagnostic variants beside the
public codec paths, one variant an invocation, on one card.

    python -m torch_cgx_tpu_torch.tools.qbench current      # quantize_batch
    python -m torch_cgx_tpu_torch.tools.qbench butterfly    # the ballot pack lowering
    python -m torch_cgx_tpu_torch.tools.qbench mul          # reciprocal-multiply encode
    python -m torch_cgx_tpu_torch.tools.qbench nometa       # words only, meta zero-filled
    python -m torch_cgx_tpu_torch.tools.qbench metalane     # meta as 128-float rows
    python -m torch_cgx_tpu_torch.tools.qbench read         # no encode, no pack
    python -m torch_cgx_tpu_torch.tools.qbench dequant      # dequantize_batch
    python -m torch_cgx_tpu_torch.tools.qbench sra_epilogue --ws 8

Counterpart of the repository's ``tools/qbench.py`` (same arguments, same
record fields). The five kernel variants (``butterfly``, ``mul``,
``nometa``, ``metalane``, ``read``) keep the JAX wire contract of
``make_variant_kernel``: words ``(C*bits*B/128, 128)`` int32 and meta
``(C*32, 2)`` f32 (``metalane``: ``(C, 128)``) for ``C*32*B`` values.
``mul`` and ``butterfly`` are the quantize kernel with one lowering
swapped; ``nometa``, ``metalane`` and ``read`` are the variant kernel
(``codec_cuda.quantize_variant_chunks``): B1's cluster body at B1's
geometry with one store changed, so that ``current`` less ``nometa`` is
B1's meta store and ``nometa`` less ``read`` its encode and pack. At the
default 128 MB B1 launches on 2,048 chunks (one CTA a chunk); ``--mb 9``
gives 144 chunks, the ``mlp_in`` launch of a GPT-2 124M step, where a
chunk takes a cluster of 4 CTAs.

The operands (k sets of ``--mb`` MB of normal floats) are drawn on the card
from a seeded generator. Before timing, each variant's bytes are checked on
a small slice: the kernel variants against their plain versions on the CPU
and, as the JAX tool does, ``metalane`` and ``butterfly`` against
``quantize_batch`` (``mul`` reports how many words differ from it);
``sra_epilogue`` against the staged decode, own-row select, ordered row sum
and quantize. The time is the slope between k calls over k operand sets and
one call (CUDA events around back-to-back launches), so the fixed overhead
of a timed run cancels. One JSON record is printed, with the bytes bound at
the card's published memory rate; nothing is written to a file.

The tool runs on the card; ``--device cpu`` runs the plain versions on the
CPU instead (host clock, no bound), and nothing falls back on its own.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as cfg_mod
from ..ops import codec_cuda, dispatch
from ..ops.codec import CHUNK_BUCKETS
from ..utils.device import DeviceLike, card_line, mem_rate, resolve_device

CB = CHUNK_BUCKETS
VARIANTS = (
    "current", "butterfly", "mul", "nometa", "metalane", "read", "dequant", "sra_epilogue",
)
KERNEL_VARIANTS = ("butterfly", "mul", "nometa", "metalane", "read")
UNRESOLVED_S = 1e-8  # a slope at or below this is noise (the JAX tool's threshold)


def _chunk_count(n: int, bits: int, bucket: int, tc: int) -> int:
    """The chunks of ``n`` values; the JAX tool's words are 128-lane rows
    and its grid steps ``tc`` chunks at a time."""
    if bucket % 128:
        raise ValueError(f"bucket must be a positive multiple of 128, got {bucket}")
    chunks = codec_cuda._chunk_geometry(n, bits, bucket)
    if tc < 1 or chunks % tc:
        raise ValueError(f"tc={tc} must divide the {chunks} chunks")
    return chunks


def _kernel_variant(name: str, x: torch.Tensor, bits: int, bucket: int,
                    plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel variant on flat ``x``: the kernel's wrapper, or with
    ``plain`` its plain version."""
    if name == "mul":
        fn = codec_cuda.quantize_chunks_plain if plain else codec_cuda.quantize_chunks
        return fn(x, bits, bucket, encode="mul", pack="sum")
    if name == "butterfly":
        fn = codec_cuda.quantize_chunks_plain if plain else codec_cuda.quantize_chunks
        return fn(x, bits, bucket, encode="div", pack="butterfly")
    if name not in codec_cuda.VARIANTS:
        raise ValueError(f"variant must be one of {KERNEL_VARIANTS}, got {name!r}")
    fn = codec_cuda.quantize_variant_chunks_plain if plain else codec_cuda.quantize_variant_chunks
    return fn(x, name, bits, bucket)


def run_variant(name: str, x: torch.Tensor, bits: int, bucket: int, tc: int, *,
                device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9's variant ``name`` over ``x`` (any shape, ``C*32*B`` f32 values)
    on ``device`` (the card unless given; with no card and no device it
    raises) -> ``(words int32 (C*bits*B/128, 128), meta f32 (C*32, 2)``, or
    ``(C, 128)`` for "metalane"``)``. ``tc`` must divide C: the kernel runs
    B1's cluster geometry (a cluster of CTAs a chunk,
    ``codec_cuda.cluster_geometry``), not tiles, so the tile is checked for
    shape parity with the JAX tool and recorded, not staged."""
    dev = resolve_device(device)
    flat = x.reshape(-1).to(dev, torch.float32).contiguous()
    _chunk_count(flat.numel(), bits, bucket, tc)
    words, meta = _kernel_variant(name, flat, bits, bucket)
    return words.view(-1, 128), meta


def quantize_variant_plain(name: str, x: torch.Tensor, bits: int, bucket: int,
                           tc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`run_variant`, on ``x``'s device."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    _chunk_count(flat.numel(), bits, bucket, tc)
    words, meta = _kernel_variant(name, flat, bits, bucket, plain=True)
    return words.view(-1, 128), meta


def tie_operand(n: int, bucket: int, bits: int, seed: int = 0,
                fused_agree: bool = False) -> np.ndarray:
    """f32 ``(n,)`` on which the two level encodes (``CGX_CODEC_ENCODE``
    div and mul) disagree: each bucket holds 0, a seeded top value in
    [1, 10) and, in its other positions, values 3 ulps below to 3 ulps above
    the level boundaries ``(k + 1/2) * unit``, where a quotient and a
    product by the rounded reciprocal may fall on either side. Random data
    meets such a tie about once in 3e6 levels at 4 bits.

    The mul encode rounds the product before the add. ``fused_agree``
    moves each value whose level a fused multiply-add would change to
    ``k * unit``, far from any boundary: XLA on the CPU contracts the JAX
    kernels' ``(x - min) * inv + 0.5`` into one, so only such an operand
    compares bit for bit with their interpret mode."""
    if n % bucket or bucket < 3:
        raise ValueError(f"{n} values are not whole buckets of {bucket}")
    maxlvl = (1 << bits) - 1
    rng = np.random.default_rng(seed)
    nb = n // bucket
    top = rng.uniform(1.0, 10.0, nb).astype(np.float32)
    unit = top * np.float32(1.0 / maxlvl)
    j = np.arange(bucket - 2)
    level = (j // 7) % maxlvl
    k = np.float32(0.5) + level.astype(np.float32)
    ulps = j % 7 - 3
    base = k[None, :] * unit[:, None]
    x = np.empty((nb, bucket), np.float32)
    x[:, 0] = 0.0
    x[:, 1] = top
    x[:, 2:] = (base.view(np.int32) + ulps[None, :].astype(np.int32)).view(np.float32)
    x = np.minimum(x, top[:, None])
    if fused_agree:  # the bucket minimum is 0, so x - min is x
        inv = np.float32(1.0) / unit
        product = np.floor((x * inv[:, None]).astype(np.float32) + np.float32(0.5))
        fused = np.floor((x.astype(np.float64) * inv[:, None] + 0.5).astype(np.float32))
        grid = level.astype(np.float32)[None, :] * unit[:, None]
        x[:, 2:] = np.where(product[:, 2:] == fused[:, 2:], x[:, 2:], grid)
    return x.reshape(-1)


ADVERSARIAL_RECIPES = (
    "normal", "constant", "range_overflows", "subnormal_unit", "nan_entry", "inf_entry",
    "neg_inf_entry", "level_midpoints", "unit_below_rcp_range", "unit_above_rcp_range",
    "unit_at_rcp_low_edge", "unit_at_rcp_high_edge", "ties",
)


def adversarial_operand(n: int, bucket: int, bits: int, seed: int = 0) -> np.ndarray:
    """f32 ``(n,)`` whose buckets cycle through :data:`ADVERSARIAL_RECIPES`:
    normal data; a constant bucket (unit 0); a range that overflows to inf
    (unit inf); a subnormal range (subnormal unit); a NaN, a +inf and a
    -inf entry among normal values; values on level midpoints ``k + 1/2``
    of a unit-1 bucket; units below, above and at both edges of the range
    in which the cluster kernels divide through a reciprocal (2^-64 <=
    unit < 2^64); and :func:`tie_operand`'s last-ulp level boundaries."""
    if n % bucket or bucket < 3:
        raise ValueError(f"{n} values are not whole buckets of {bucket}")
    rng = np.random.default_rng(seed)
    nb = n // bucket
    maxlvl = (1 << bits) - 1
    x = rng.standard_normal((nb, bucket)).astype(np.float32)
    ties = tie_operand(n, bucket, bits, seed=seed + 1).reshape(nb, bucket)
    for b in range(nb):
        kind = ADVERSARIAL_RECIPES[b % len(ADVERSARIAL_RECIPES)]
        row = x[b]
        if kind == "constant":
            row[:] = np.float32(-7.25)
        elif kind == "range_overflows":
            row[:] = np.where(row > 0, np.float32(3e38), np.float32(-3e38))
        elif kind == "subnormal_unit":
            row[:] = (np.abs(row) * np.float32(1e-39)).astype(np.float32)
        elif kind in ("nan_entry", "inf_entry", "neg_inf_entry"):
            row[rng.integers(bucket)] = {"nan_entry": np.nan, "inf_entry": np.inf,
                                         "neg_inf_entry": -np.inf}[kind]
        elif kind == "level_midpoints":
            row[:] = rng.integers(0, maxlvl, bucket).astype(np.float32) + np.float32(0.5)
            row[0], row[1] = 0.0, maxlvl
        elif kind == "unit_below_rcp_range":
            row *= np.float32(2.0**-70)
        elif kind == "unit_above_rcp_range":
            row *= np.float32(2.0**70)
        elif kind in ("unit_at_rcp_low_edge", "unit_at_rcp_high_edge"):
            # A range from 0 to just above maxlvl * 2^-64 (unit just above
            # 2^-64), or to just below maxlvl * 2^64 (unit just below 2^64).
            top = maxlvl * (2.0**-64 * (1 + 2.0**-20) if kind.endswith("low_edge")
                            else 2.0**64 * (1 - 2.0**-20))
            row[:] = (np.abs(row) / np.abs(row).max() * top).astype(np.float32)
            row[0] = 0.0
        elif kind == "ties":
            row[:] = ties[b]
    return x.reshape(-1)


def variant_bytes(name: str, n: int, bits: int, bucket: int, ws: int) -> int:
    """Bytes a variant must move over ``n`` f32 values, each input read once
    and each output written once: the quantizers read 4n and write the
    words (n*bits/8) and the meta (8n/B; metalane 512 bytes a chunk);
    dequant the reverse; sra_epilogue reads ws - 1 packed rows of n/ws
    values and the raw own row and writes one packed row."""
    def wire(m: int) -> int:
        return m * bits // 8 + 8 * m // bucket

    if name == "metalane":
        return 4 * n + n * bits // 8 + 512 * (n // (CB * bucket))
    if name == "sra_epilogue":
        chunk = n // ws
        return (ws - 1) * wire(chunk) + 4 * chunk + wire(chunk)
    return 4 * n + wire(n)


def slope_time(fn: Callable[[int], object], k: int, *, cuda: bool, reps: int = 6) -> float:
    """Seconds a call of ``fn(i)`` adds: the median time of k back-to-back
    calls over operand sets 0..k-1 less the median of one call over set 0,
    over k - 1 (``bench.py``'s slope, in turns). On the card CUDA events
    bracket the calls; ``cuda=False`` reads the host clock."""
    def run(m: int) -> float:
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for i in range(m):
                fn(i)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        for i in range(m):
            fn(i)
        return time.perf_counter() - t0

    for i in range(k):  # warm-up: the build, the allocator's pools
        fn(i)
    if cuda:
        torch.cuda.synchronize()
    t_k, t_1 = [], []
    for _ in range(reps):
        t_k.append(run(k))
        t_1.append(run(1))
    return max((statistics.median(t_k) - statistics.median(t_1)) / (k - 1), 1e-9)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _byte_check(name: str, stack: torch.Tensor, bits: int, b: int, tc: int, ws: int) -> str:
    """The check of a variant's bytes on a small slice before it is timed;
    raises on a difference, returns the line to print."""
    if name == "sra_epilogue":
        own = ws // 2
        xs = stack[0].view(ws, -1)[:, : CB * b * 2]
        q = codec_cuda.quantize_batch(xs, bits, b)
        vals = codec_cuda.dequantize_batch(q, out_dtype=torch.float32)
        mask = (torch.arange(ws, device=xs.device) == own)[:, None]
        red = dispatch.ordered_rowsum(torch.where(mask, xs, vals))
        ref = codec_cuda.quantize_batch(red[None], bits, b)
        got = codec_cuda.sra_epilogue_batch(q, raw_row=xs[own], own_idx=own)
        if not (_same(got.packed, ref.packed) and _same(got.meta, ref.meta)):
            raise AssertionError("sra_epilogue wire mismatch vs the staged decode/sum/quantize")
        return "byte_check: ok (staged decode, own-row select, ordered sum, quantize)"
    if name not in KERNEL_VARIANTS:
        return "byte_check: none (a public batch function)"
    xs = stack[0].reshape(-1)[: CB * b * 2 * tc]
    words, meta = run_variant(name, xs, bits, b, tc, device=xs.device)
    pw, pm = quantize_variant_plain(name, xs.cpu(), bits, b, tc)
    if not (_same(words, pw) and _same(meta, pm)):
        raise AssertionError(f"{name}: kernel bytes differ from the plain version")
    line = "byte_check: ok (plain version)"
    ref = codec_cuda.quantize_batch(xs[None], bits, b)
    ref_words = ref.packed.reshape(-1, 128)
    if name == "metalane":
        ok = (_same(words, ref_words) and _same(meta[:, :CB].reshape(-1), ref.meta[0, :, 0])
              and _same(meta[:, CB:2 * CB].reshape(-1), ref.meta[0, :, 1]))
        if not ok:
            raise AssertionError("metalane: wire mismatch vs quantize_batch")
        line += " (quantize_batch: meta lane-major by design)"
    elif name == "butterfly":
        if not (_same(words, ref_words) and _same(meta, ref.meta[0])):
            raise AssertionError("butterfly: wire mismatch vs quantize_batch")
        line += " (quantize_batch: equal)"
    elif name == "mul":
        mism = float((words != ref_words).float().mean())
        line += f" (quantize_batch: words_equal={mism == 0.0} mismatch_frac={mism:.2e})"
    return line


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m torch_cgx_tpu_torch.tools.qbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", choices=VARIANTS)
    ap.add_argument("--ws", type=int, default=8,
                    help="peer rows for the sra_epilogue variant (the SRA world size)")
    ap.add_argument("--tc", type=int, default=0, help="tile chunks override")
    ap.add_argument("--mb", type=int, default=128, help="payload MB (fp32)")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--bucket", type=int, default=512)
    ap.add_argument("--k", type=int, default=8, help="operand sets (>= 2)")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given ('cpu': the plain versions)")
    args = ap.parse_args(argv)
    if args.k < 2:
        ap.error("--k must be >= 2 (slope timing needs two run lengths)")
    return args


def measure(args: argparse.Namespace) -> dict:
    """Check and time one variant; returns the record."""
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    n = args.mb * 1024 * 1024 // 4
    bits, b, k, ws = args.bits, args.bucket, args.k, args.ws
    chunks = _chunk_count(n, bits, b, 1)
    tc = args.tc or codec_cuda._pipe_tc(chunks, max(codec_cuda.db_tc_cap("quantize", bits, b), 1))
    _chunk_count(n, bits, b, tc)
    if args.variant == "sra_epilogue":
        _chunk_count(n // ws if n % ws == 0 else 0, bits, b, 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    stack = torch.randn((k, 1, n), generator=gen, device=dev)
    print(_byte_check(args.variant, stack, bits, b, tc, ws), flush=True)

    name = args.variant
    if name == "current":
        def fn(i):
            return codec_cuda.quantize_batch(stack[i], bits, b)
    elif name == "dequant":
        qs = [codec_cuda.quantize_batch(stack[i], bits, b) for i in range(k)]

        def fn(i):
            return codec_cuda.dequantize_batch(qs[i], out_dtype=torch.float32)
    elif name == "sra_epilogue":
        own = ws // 2
        rows = stack.view(k, ws, n // ws)
        qs = [codec_cuda.quantize_batch(rows[i], bits, b) for i in range(k)]
        if not codec_cuda.supports_reduce(qs[0]):
            raise ValueError(f"ws={ws} x {n // ws} values is outside the fused epilogue's geometry")

        def fn(i):
            return codec_cuda.sra_epilogue_batch(qs[i], raw_row=rows[i][own], own_idx=own)
    else:
        def fn(i):
            return _kernel_variant(name, stack[i].view(-1), bits, b)
    t = slope_time(fn, k, cuda=cuda)

    rec = {
        "tool": "qbench", "variant": name, "tc": tc, "mb": args.mb, "bits": bits, "bucket": b,
        "pack": "butterfly" if name == "butterfly" else codec_cuda._pack_strategy(),
        "encode": ("mul" if name == "mul" else
                   "div" if name in KERNEL_VARIANTS else cfg_mod.codec_encode()),
    }
    if name == "sra_epilogue":
        rec["ws"] = ws
    unresolved = t <= UNRESOLVED_S
    nbytes = variant_bytes(name, n, bits, b, ws)
    if cuda:
        rec["device"], rec["card"] = torch.cuda.get_device_name(0), card_line()
        bound = nbytes / mem_rate(rec["device"])
    else:
        rec["device"], rec["card"], bound = "cpu", None, None
    rec["bytes"] = nbytes
    rec["bound_ms"] = None if bound is None else bound * 1e3
    if unresolved:
        rec["t_ms"] = rec["gbps_in"] = rec["pct_of_bound"] = None
        rec["unresolved"] = "slope <= noise; re-run with a larger --k"
    else:
        rec["t_ms"] = t * 1e3
        rec["gbps_in"] = n * 4 / 1e9 / t
        rec["pct_of_bound"] = None if bound is None else 100 * bound / t
        rec["unresolved"] = None
    return rec


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, check and time the variant, print its record (and a
    summary line) and return it. ``--tc`` holds ``CGX_PALLAS_TILE_CHUNKS``
    for the run, as the JAX tool sets it, and restores it after."""
    args = parse_args(argv)
    before = os.environ.get("CGX_PALLAS_TILE_CHUNKS")
    if args.tc:
        os.environ["CGX_PALLAS_TILE_CHUNKS"] = str(args.tc)
    try:
        rec = measure(args)
    finally:
        if before is None:
            os.environ.pop("CGX_PALLAS_TILE_CHUNKS", None)
        else:
            os.environ["CGX_PALLAS_TILE_CHUNKS"] = before
    print(json.dumps(rec), flush=True)
    prefix = f"variant={rec['variant']} tc={rec['tc']} mb={rec['mb']} bits={rec['bits']} bucket={rec['bucket']}"
    if rec["t_ms"] is None:
        print(f"{prefix} UNRESOLVED (k-spread slope <= noise; re-run with --k {max(args.k * 2, 8)})")
    else:
        bound = "" if rec["bound_ms"] is None else (
            f"  bound {rec['bound_ms']:.4f} ms = {rec['pct_of_bound']:.1f}% of bound")
        print(f"{prefix} t={rec['t_ms']:.4f} ms  {rec['gbps_in']:.1f} GB/s(in){bound}  "
              f"[{rec['device']}]", flush=True)
    return rec


if __name__ == "__main__":
    main()
