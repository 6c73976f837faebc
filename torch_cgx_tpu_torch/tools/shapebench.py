"""Time the quantize (B1, B5), the SRA epilogue (B3), their pipelined
versions (B7a, B7c) and the multi-row reduce (B4) alone at the launch
shapes of a GPT-2 124M step, and profile that step's codec kernels.

    python3 torch_cgx_tpu_torch/tools/shapebench.py [--root DIR] [--groups 5] [--no-step]
        [--only reduce]

It times ``SHAPES``, ``PAST_BUDGET`` (buckets past the cluster kernels'
register budget) and ``REDUCE_SHAPES`` (B4 in the four-rank steps);
``--only KERNEL`` keeps the shapes of one kernel (``reduce``: B4's alone).

``--root`` names the checkout whose ``torch_cgx_tpu_torch`` is timed (by
default the one this file belongs to). The wrappers it calls
(``codec_cuda.quantize_chunks``, ``sra_epilogue_chunks``, their pipelined
versions at one chunk a tile, ``reduce_rows_chunks``, the plain versions,
``make_train_step``) take the same arguments in every version of the port
since its quantize lowerings, so two checkouts can be timed in turns on
one card, one process each. The script imports the package only from
``--root``; it prints one JSON record and writes no file.

A kernel's time is a burst: the stream is held by a sleep kernel while the
host enqueues an L2 flush and ``launches`` calls, each on its own input
buffers (rotating through at least 400 MB of them, so every launch finds
its inputs cold, as the step's sync does), between two CUDA events; the
time is their difference over ``launches``. Groups alternate kernel and
plain version (kernel, plain, plain, kernel, ...); the record keeps each
group's time, the median and the spread (max - min over the median). The
bound is the bytes the call must move at the card's published memory
rate. The step (``--no-step`` skips it): GPT-2 124M (random weights from
seed 0), 8 x 512 tokens, 4 bits, bucket 512, the world-size-1 codec
(``CGX_DEBUG_FORCE_CODEC=1``), under ``CGX_PALLAS_DB=off`` and then
``on``: the host-clock step (median of 5 synchronised steps) and one
profiled step's device time, the codec kernels' by kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BITS = 4
BUCKET = 512
SEED = 0
FLUSH_BYTES = 128 << 20  # twice the H100's 50 MB L2
ROTATE_BYTES = 400 << 20  # inputs a burst rotates through

# (kernel, label, chunks, rows, own): the launch shapes of the GPT-2 124M
# step at bucket 512 (parallel/allreduce.py's grouping: attn_qkv 108
# chunks, mlp_in / mlp_out 144, attn_proj + wpe 480, a 64 MB wte slice
# 1,024, the wte tail's whole chunks 307 through B5), the epilogue at the
# same shapes with one row and no raw row, at the four-rank flat SRA's 4 x
# 256 chunks with the raw own row, and at one mlp layer's share of an
# eight-rank SRA (18 chunks, 8 rows).
# B7a and B7c at the shapes the step gives them under CGX_PALLAS_DB=on (the
# slices of whole chunks; the tail slice keeps B5 and the staged decode),
# one chunk a tile as the batch functions give them without a tuned entry,
# and B7c at the four-rank flat SRA's shape.
SHAPES = (
    [("quantize", f"B1 c={c}", c, 1, -1) for c in (108, 144, 480, 1024)]
    + [("quantize", "B5 c=307", 307, 1, -1)]
    + [("epilogue", f"B3 c={c} rows=1", c, 1, -1) for c in (108, 144, 307, 480, 1024)]
    + [("epilogue", "B3 c=256 ws=4 own=1", 256, 4, 1), ("epilogue", "B3 c=18 ws=8 own=3", 18, 8, 3)]
    + [("quantize_db", f"B7a c={c}", c, 1, -1) for c in (108, 144, 480, 1024)]
    + [("epilogue_db", f"B7c c={c} rows=1", c, 1, -1) for c in (108, 144, 480, 1024)]
    + [("epilogue_db", "B7c c=256 ws=4 own=1", 256, 4, 1)]
)
# Buckets past the cluster kernels' register budget, where a thread takes
# several positions (a sixth field: the bucket): B1 at 64 MB of bucket 8192,
# B1 and B3 at 144 chunks of bucket 1760 (55 warps of positions, which no
# cluster size splits into CTAs of at most 512 threads).
PAST_BUDGET = [
    ("quantize", "B1 c=64 B=8192", 64, 1, -1, 8192),
    ("quantize", "B1 c=144 B=1760", 144, 1, -1, 1760),
    ("epilogue", "B3 c=144 B=1760 rows=1", 144, 1, -1, 1760),
]


# B4 in phase 7's four-rank steps (``chip_smoke.py``, bucket 512): the
# two-level scheme's intra reduce (2 rows of half a slice, the raw own row
# in row 0) and the all-to-all's (4 rows of a slice, no raw row); the
# chunk counts and launches a rank-step are :func:`reduce_step_shapes`'.
REDUCE_SHAPES = (
    [("reduce", f"B4 two-level c={c} rows=2 own=0", c, 2, 0) for c in (54, 72, 240, 512)]
    + [("reduce", f"B4 all-to-all c={c} rows=4", c, 4, -1) for c in (108, 144, 480, 1024)]
)


# The 16-bit instances (bf16 and f16 wire dtypes; a seventh field: the
# dtype's torch name): B1 and B7a at a 64 MB f32 slice's 16,777,216 values
# and at a 64 MB bf16 slice's 33,554,432 (2,048 chunks: the bf16-parameter
# step's wte slice), B3 and B7c there with one row (the wire dtype's round
# trip, no raw row) and at the four-rank flat SRA's 4 x 256 chunks with a
# 16-bit raw own row, B4 at the bf16-parameter four-rank steps' shapes with
# a 16-bit raw own row (two-level: half of each bf16 slice) and without
# (all-to-all).
WIRE16_SHAPES = (
    [(k, f"{lab} {d} c={c}", c, 1, -1, BUCKET, d)
     for d in ("bfloat16", "float16") for k, lab in (("quantize", "B1"), ("quantize_db", "B7a"))
     for c in (1024, 2048)]
    + [(k, f"{lab} {d} c={c} rows=1", c, 1, -1, BUCKET, d)
       for d in ("bfloat16", "float16") for k, lab in (("epilogue", "B3"), ("epilogue_db", "B7c"))
       for c in (1024, 2048)]
    + [(k, f"{lab} {d} c=256 ws=4 own=1", 256, 4, 1, BUCKET, d)
       for d in ("bfloat16", "float16") for k, lab in (("epilogue", "B3"), ("epilogue_db", "B7c"))]
    + [("reduce", f"B4 bfloat16 two-level c={c} rows=2 own=0", c, 2, 0, BUCKET, "bfloat16")
       for c in (54, 72, 240, 1024)]
    + [("reduce", "B4 float16 two-level c=1024 rows=2 own=0", 1024, 2, 0, BUCKET, "float16")]
)


def wire_bytes(n: int, bits: int = BITS, bucket: int = BUCKET) -> int:
    """Bytes of the quantized payload of n values: words and meta."""
    return n * bits // 8 + 8 * n // bucket


def shape_bytes(kernel: str, chunks: int, rows: int, own: int, bucket: int = BUCKET,
                elem_size: int = 4) -> int:
    """Bytes a call must move, each input read once and each output written
    once: the quantize (B1, B7a) reads its input (``elem_size`` bytes a
    value: 4, or 2 in a 16-bit wire dtype) and writes the payload; the
    epilogue (B3, B7c) reads the payload of every row but the own one, the
    raw own row (``elem_size`` a value), and writes one payload; the reduce
    (B4) reads as the epilogue does and writes 4n (f32)."""
    n = chunks * 32 * bucket
    wire = wire_bytes(n, BITS, bucket)
    if kernel.startswith("quantize"):
        return elem_size * n + wire
    peers = rows - (1 if own >= 0 else 0)
    return (peers * wire + (elem_size * n if own >= 0 else 0)
            + (4 * n if kernel == "reduce" else wire))


def slice_lengths(dtype_name: str = "float32") -> list:
    """``(length, compression config)`` of each compressed fusion slice of
    the GPT-2 124M step's gradients, from the port's own grouping
    (``parallel/allreduce.py``) of a model on the meta device, its
    parameters in ``dtype_name`` (the 64 MB slices hold 2-byte values
    twice as many)."""
    import torch

    from torch_cgx_tpu_torch.models import GPT2, GPT2Config
    from torch_cgx_tpu_torch.parallel import allreduce

    model = GPT2(GPT2Config.small(), device="meta").to(getattr(torch, dtype_name))
    pl = allreduce.sorted_items(dict(model.named_parameters()))
    out = []
    for g in allreduce._group_leaves(pl, compress_small=False):
        if g.cc.enabled:
            n = sum(pl[i][1].numel() for i in g.indices)
            elem = torch.empty(0, dtype=g.dtype).element_size()
            out += [(ln, g.cc) for _, ln in allreduce._fusion_slices(n, elem)]
    return out


def step_slices(dtype_name: str = "float32") -> list:
    """``(whole chunks, tail buckets)`` of each compressed fusion slice of
    the GPT-2 124M step's gradients at bucket 512, the parameters in
    ``dtype_name``."""
    from torch_cgx_tpu_torch.ops import codec

    return [divmod(codec.num_buckets(ln, BUCKET), 32) for ln, _ in slice_lengths(dtype_name)]


def reduce_step_shapes(dev="cpu", dtype_name: str = "float32") -> dict:
    """B4's launches a rank-step of phase 7's two-level scheme (cross 2 x
    intra 2: each slice's intra reduce over ``chunk_layout(slice, 2)``, 2
    rows, the raw own row) and all-to-all (4 ranks: each slice, 4 rows):
    ``{scheme: {(chunks, rows, own): launches}}`` where the dispatcher's
    own gate (``dispatch.fused_reduce_would_run``, on layout stand-ins on
    ``dev``) takes the fused reduce; the parameters in ``dtype_name``."""
    import torch

    from torch_cgx_tpu_torch.ops import codec, dispatch
    from torch_cgx_tpu_torch.parallel import chunk_layout

    def stand_in(rows, n, cc):
        nb = codec.num_buckets(n, cc.bucket_size)
        return codec.QTensor(
            packed=torch.empty((rows, 0), dtype=torch.int32, device=dev),
            meta=torch.empty((rows, nb, 2), device=dev), residual=torch.empty((rows, 0), device=dev),
            numel=n, bits=cc.bits, bucket_size=cc.bucket_size, dtype=torch.float32)

    out = {"two_level": {}, "alltoall": {}}
    for ln, cc in slice_lengths(dtype_name):
        for scheme, rows, n, own in (("two_level", 2, chunk_layout(ln, 2)[0], 0),
                                     ("alltoall", 4, ln, -1)):
            if dispatch.fused_reduce_would_run(stand_in(rows, n, cc)):
                key = (n // (32 * cc.bucket_size), rows, own)
                out[scheme][key] = out[scheme].get(key, 0) + 1
    return out


def reduce_step_bounds(rate: float, dev="cpu", dtype_name: str = "float32") -> dict:
    """B4's launches a rank-step of each four-rank scheme and the least
    device time they could take (bytes at ``rate``, :func:`shape_bytes`:
    the raw own row in ``dtype_name``)."""
    import torch

    elem = torch.empty(0, dtype=getattr(torch, dtype_name)).element_size()
    out = {}
    for scheme, shapes in reduce_step_shapes(dev, dtype_name).items():
        nbytes = sum(k * shape_bytes("reduce", c, rows, own, elem_size=elem)
                     for (c, rows, own), k in shapes.items())
        out[scheme] = {"launches": sum(shapes.values()), "bytes": nbytes,
                       "bound_ms": nbytes / rate * 1e3}
    return out


def reduce_step_ms(shapes: list, counts: dict) -> dict:
    """B4's burst time a rank-step of each scheme: each launch shape's
    burst (a ``time_shapes`` record) times its launches
    (:func:`reduce_step_shapes`); None where a shape was not timed."""
    ms = {(r["chunks"], r["rows"], r["own"]): r["ms"] for r in shapes if r["kernel"] == "reduce"}
    return {scheme: (sum(k * ms[key] for key, k in c.items()) if all(key in ms for key in c) else None)
            for scheme, c in counts.items()}


def step_bounds(rate: float, dtype_name: str = "float32") -> dict:
    """Launches and the least device time a step of the world-size-1 codec
    proxy (``CGX_PALLAS_DB=off``) could take in each kernel, summed over
    its launch shapes (bytes at ``rate``): a quantize (B1; B5 on the tail
    slice's whole chunks) of every slice; the fused epilogue (B3, one row)
    of every slice of whole chunks, then a decode (B2); the tail slice
    decoded twice, the second time with the add (B6). ``dtype_name``: the
    parameters' dtype, the quantize's input's (the decode writes f32)."""
    import torch

    elem = torch.empty(0, dtype=getattr(torch, dtype_name)).element_size()
    out = {"quantize": [0, 0], "epilogue": [0, 0], "dequantize": [0, 0]}

    def add(kernel, nbytes):
        out[kernel][0] += 1
        out[kernel][1] += nbytes

    for c, tail in step_slices(dtype_name):
        n = c * 32 * BUCKET
        add("quantize", shape_bytes("quantize", c, 1, -1, elem_size=elem))
        if tail:
            add("dequantize", wire_bytes(n) + 4 * n)
            add("dequantize", wire_bytes(n) + 8 * n)
        else:
            add("epilogue", shape_bytes("epilogue", c, 1, -1))
            add("dequantize", wire_bytes(n) + 4 * n)
    return {k: {"launches": v[0], "bytes": v[1], "bound_ms": v[1] / rate * 1e3} for k, v in out.items()}


def import_port(root: str):
    """The ``torch_cgx_tpu_torch`` of the checkout at ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch_cgx_tpu_torch  # noqa: F401
    from torch_cgx_tpu_torch.ops import codec_cuda

    found = Path(codec_cuda.__file__).resolve()
    if Path(root).resolve() not in found.parents:
        raise RuntimeError(f"imported {found}, not the checkout at {root}")
    return codec_cuda


def burst_ms(fn, launches: int, flush=None) -> float:
    """Milliseconds a call of ``fn(i)`` (i = 0 .. launches-1) takes on the
    card when the calls run back to back (after an L2 flush: ``flush``, a
    tensor to zero)."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # tens of ms: the host enqueues everything behind it
    if flush is not None:
        flush.zero_()
    a.record()
    for i in range(launches):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def plain_ms(fn, iters: int = 3) -> float:
    """Median milliseconds of a synchronised call of ``fn``."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def shape_calls(codec_cuda, dev, kernel: str, chunks: int, rows: int, own: int, launches: int,
                geometry=None, bucket: int = BUCKET, dtype_name: str = "float32"):
    """``(kernel call of buffer i, plain call)`` of one shape on seeded normal
    data, the inputs copied into enough buffers to rotate through. With a
    ``geometry`` (``codec_cuda.ClusterGeometry``) the kernel launches at it
    rather than at the wrappers' choice (div encode, sum pack).
    ``dtype_name``: the wire dtype of the quantize's input and of the
    epilogue's and reduce's raw row (the epilogue's cast too); the payloads'
    meta goes to the kernels in f32, as the batch functions give it."""
    import torch

    dtype = getattr(torch, dtype_name)
    elem = torch.empty(0, dtype=dtype).element_size()
    n = chunks * 32 * bucket
    gen = torch.Generator(device=dev).manual_seed(SEED + chunks + rows)
    per = shape_bytes(kernel, chunks, rows, own, bucket, elem)
    copies = max(1, min(launches, -(-ROTATE_BYTES // per)))
    if kernel.startswith("quantize"):
        xs = [torch.randn(n, generator=gen, device=dev).to(dtype) for _ in range(copies)]
        plain = lambda: codec_cuda.quantize_chunks_plain(xs[0], BITS, bucket)  # noqa: E731
        if kernel == "quantize_db":
            if geometry is not None:
                return (lambda i: codec_cuda._launch_quantize_db(
                    xs[i % copies], BITS, bucket, 1, "div", "sum", geometry), None)
            return lambda i: codec_cuda.quantize_chunks_db(xs[i % copies], BITS, bucket, 1), plain
        if geometry is not None:
            return (lambda i: codec_cuda._launch_quantize(xs[i % copies], BITS, bucket, "div", "sum",
                                                          geometry), None)
        return lambda i: codec_cuda.quantize_chunks(xs[i % copies], BITS, bucket), plain
    data = (torch.randn(rows, n, generator=gen, device=dev) * torch.arange(
        1, rows + 1, device=dev, dtype=torch.float32)[:, None]).to(dtype)
    q = codec_cuda.quantize_batch(data, BITS, bucket)
    w = [q.packed.contiguous().clone() for _ in range(copies)]
    m = [q.meta.to(torch.float32).contiguous().clone() for _ in range(copies)]
    raw = [data[own].clone() if own >= 0 else None for _ in range(copies)]
    if kernel == "reduce":
        return (lambda i: codec_cuda.reduce_rows_chunks(w[i % copies], m[i % copies], raw[i % copies],
                                                        own, BITS, bucket),
                lambda: codec_cuda.reduce_rows_chunks_plain(w[0], m[0], raw[0], own, BITS, bucket))
    # The cast is passed only for a 16-bit wire dtype: a checkout from
    # before the 16-bit instances takes the float32 calls as they were.
    cast = {} if dtype == torch.float32 else {"cast_dtype": dtype}
    plain = lambda: codec_cuda.sra_epilogue_chunks_plain(  # noqa: E731
        w[0], m[0], raw[0], own, BITS, bucket, **cast)
    if kernel == "epilogue_db":
        if geometry is not None:
            return (lambda i: codec_cuda._launch_epilogue_db(
                w[i % copies], m[i % copies], raw[i % copies], own, BITS, bucket, 1, "div", "sum",
                geometry, **cast), None)
        return (lambda i: codec_cuda.sra_epilogue_chunks_db(
            w[i % copies], m[i % copies], raw[i % copies], own, BITS, bucket, 1, **cast), plain)
    if geometry is not None:
        return (lambda i: codec_cuda._launch_epilogue(w[i % copies], m[i % copies], raw[i % copies],
                                                      own, BITS, bucket, "div", "sum", geometry,
                                                      **cast), None)
    return (lambda i: codec_cuda.sra_epilogue_chunks(w[i % copies], m[i % copies], raw[i % copies],
                                                     own, BITS, bucket, **cast), plain)


def time_shapes(codec_cuda, dev, rate: float, groups: int = 5, launches: int = 32,
                shapes=SHAPES) -> list:
    """Each shape's kernel bursts and plain calls in alternating groups (a
    shape's sixth field, if any, its bucket; its seventh its wire dtype)."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out = []
    for kernel, label, chunks, rows, own, *rest in shapes:
        bucket = rest[0] if rest else BUCKET
        dtype_name = rest[1] if len(rest) > 1 else "float32"
        elem = torch.empty(0, dtype=getattr(torch, dtype_name)).element_size()
        kern, plain = shape_calls(codec_cuda, dev, kernel, chunks, rows, own, launches,
                                  bucket=bucket, dtype_name=dtype_name)
        burst_ms(kern, launches, flush)  # warm-up
        ks, ps = [], []
        for g in range(groups):
            if g % 2 == 0:
                ks.append(burst_ms(kern, launches, flush))
                ps.append(plain_ms(plain))
            else:
                ps.append(plain_ms(plain))
                ks.append(burst_ms(kern, launches, flush))
        ms = statistics.median(ks)
        nbytes = shape_bytes(kernel, chunks, rows, own, bucket, elem)
        bound = nbytes / rate * 1e3
        out.append({"kernel": kernel, "shape": label, "chunks": chunks, "rows": rows, "own": own,
                    "bucket": bucket, "dtype": dtype_name,
                    "ms": ms, "groups_ms": ks, "spread": (max(ks) - min(ks)) / ms,
                    "plain_ms": statistics.median(ps), "bytes": nbytes, "bound_ms": bound,
                    "pct_of_bound": 100 * bound / ms})
        del kern, plain
        torch.cuda.empty_cache()
    return out


def geometry_sweep(codec_cuda, dev, rate: float, groups: int = 3, launches: int = 32,
                   shapes=SHAPES) -> list:
    """Each shape's kernel (div encode, sum pack) at every geometry the
    cluster kernels take for bucket 512 (``codec_cuda.cluster_geometries``),
    the wrappers' own choice marked: the median of ``groups`` bursts each,
    or the launch's error."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out = []
    for kernel, label, chunks, rows, own in shapes:
        if kernel == "reduce":
            continue
        chosen = codec_cuda.cluster_geometry(
            chunks, BUCKET, BITS, torch.cuda.get_device_properties(dev).multi_processor_count)
        bound = shape_bytes(kernel, chunks, rows, own) / rate * 1e3
        for g in codec_cuda.cluster_geometries(BUCKET):
            kern, _ = shape_calls(codec_cuda, dev, kernel, chunks, rows, own, launches, geometry=g)
            rec = {"shape": label, "k": g.k, "threads": g.threads, "chosen": g == chosen,
                   "bound_ms": bound}
            try:
                ks = [burst_ms(kern, launches, flush) for _ in range(groups + 1)][1:]
                rec.update(ms=statistics.median(ks), groups_ms=ks)
            except RuntimeError as e:  # a launch the card refuses, kept as the result
                rec["error"] = str(e)
            out.append(rec)
            del kern
        torch.cuda.empty_cache()
    return out


def profile_codec(fn) -> dict:
    """``torch.profiler`` over one warm call of ``fn``: wall ms, device busy
    ms, the codec kernels' device ms in all and by kernel (over their
    template instances), and the eight largest kernels; ``busy_ms`` 0 where
    the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        # Ranges such as "Optimizer.step#Adam.step" span kernels counted
        # on their own: keep kernels and copies only.
        if getattr(e, "is_user_annotation", False) or "#" in e.key:
            continue
        if us and e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    codec = {}
    for k, v in by_name.items():
        found = re.search(r"cgx_\w+_kernel", k)
        if found:
            codec[found.group(0)] = codec.get(found.group(0), 0.0) + v
    return {"wall_ms": wall_ms, "busy_ms": sum(by_name.values()),
            "codec_ms": sum(codec.values()), "codec_by_kernel": codec,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def step_record(dev, db: str = "off") -> dict:
    """The world-size-1 GPT-2 124M step under ``CGX_PALLAS_DB=db``: host
    clock and profile."""
    import torch

    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.parallel import make_train_step

    os.environ["CGX_PALLAS_DB"] = db
    cfg = GPT2Config.small()
    model = GPT2(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (8, 512))).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device=dev)
    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    prof = profile_codec(lambda: step(tokens))
    os.environ["CGX_PALLAS_DB"] = "off"
    return {"db": db, "step_ms": statistics.median(ts), "steps_ms": ts, **prof}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--groups", type=int, default=5)
    ap.add_argument("--launches", type=int, default=32)
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--only", choices=("quantize", "epilogue", "quantize_db", "epilogue_db", "reduce"),
                    help="time one kernel's shapes only")
    ap.add_argument("--geometries", action="store_true",
                    help="also time every cluster geometry at each shape (this tree's kernels only)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("shapebench: no CUDA device; it times the kernels on the card")
    cache = tempfile.TemporaryDirectory()
    os.environ.update({
        "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS), "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
        "CGX_DEBUG_FORCE_CODEC": "1", "CGX_PALLAS_DB": "off", "CGX_AUTOTUNE_DIR": cache.name,
    })
    torch.backends.cuda.matmul.allow_tf32 = False
    codec_cuda = import_port(args.root)
    from torch_cgx_tpu_torch.utils.device import card_line, mem_rate

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    codec_cuda.build()
    build_s = time.perf_counter() - t0
    shapes = time_shapes(codec_cuda, dev, mem_rate(name), args.groups, args.launches,
                         [s for s in SHAPES + PAST_BUDGET + REDUCE_SHAPES
                          if args.only in (None, s[0])])
    reduce_counts = reduce_step_shapes(dev)
    rec = {"root": str(Path(args.root).resolve()), "card": card_line(), "build_s": build_s,
           "step_bounds": step_bounds(mem_rate(name)),
           "reduce_step_bounds": reduce_step_bounds(mem_rate(name), dev),
           # B4's burst time a rank-step of each scheme: each launch shape's
           # burst times its launches.
           "reduce_step_ms": reduce_step_ms(shapes, reduce_counts),
           "shapes": shapes}
    if args.geometries:
        rec["geometries"] = geometry_sweep(codec_cuda, dev, mem_rate(name))
    if not args.no_step:
        rec["step"] = step_record(dev, "off")
        rec["step_on"] = step_record(dev, "on")
    cache.cleanup()
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
