#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torch_cgx_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, in
order, none of whose failures is caught:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build: ``nvcc`` compiles ``torch_cgx_tpu_torch/csrc/codec.cu`` into
   ``torch_cgx_tpu_torch/_build/``;
3. kernels against their plain PyTorch versions on the card, at the shapes
   the GPT-2 124M train step gives them: words, meta and decoded values must
   be bit-identical (tolerance 0);
4. the GPT-2 124M slice: three compressed train steps through
   ``make_train_step`` (4 bits, bucket 512, ``CGX_DEBUG_FORCE_CODEC=1``) with
   the launch counters reset just before and read just after, held against
   the counts derived from the gradient layout; one step's gradients synced
   through the kernels and, on the CPU, through the plain versions must agree
   bit for bit;
5. times: each kernel and its plain version (CUDA events, median after
   warm-up), a device-to-device copy as the yardstick, the train step with
   and without the codec, and a ``torch.profiler`` breakdown of one step of
   each.

The second-to-last line is the per-kernel JSON record, the last
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
BITS = 4
BUCKET = 512
BATCH, SEQ = 8, 512
STEPS = 3
FLAT_N = 16_777_216  # a full 64 MB fusion slice: whole 32-bucket chunks
TAIL_N = 5_042_944  # the last wte slice: 307 chunks, 26 tail buckets, a partial bucket
SRA_WS = 4  # the stage-1 row count of the multi-rank epilogue check

# Published device-memory rates (NVIDIA data sheets), bytes/s, by the name
# fragment nvidia-smi reports; the longest matching fragment wins.
MEM_RATE = {
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
    "H100": 3.35e12,
    "H200": 4.8e12,
}
# float32 outside the tensor cores, operations/s (H100 SXM data sheet).
F32_RATE = 67e12

TPU_KERNELS = {
    "codec_quantize": "torch_cgx_tpu/ops/codec_pallas.py:312,763",
    "codec_dequantize": "torch_cgx_tpu/ops/codec_pallas.py:389,815",
    "codec_sra_epilogue": "torch_cgx_tpu/ops/codec_pallas.py:1375",
}
SOURCE = "torch_cgx_tpu_torch/csrc/codec.cu"


def log(*args) -> None:
    print(*args, flush=True)


def fuzz_operand(rng, n, kind):
    """The cross-implementation codec fuzz recipes: normal data, extreme
    magnitudes with denormal-scale spikes, constant runs with outliers."""
    if kind == 0:
        return rng.standard_normal(n).astype(np.float32)
    if kind == 1:
        x = (rng.standard_normal(n) * 1e30).astype(np.float32)
        x[:: max(1, n // 7)] = 1e-38
        return x
    x = np.full(n, -7.25, np.float32)
    x[:: max(1, n // 5)] = 3.5
    return x


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mem_rate(name: str) -> float:
    best = max((k for k in MEM_RATE if k in name), key=len, default=None)
    if best is None:
        raise RuntimeError(f"no memory rate on record for {name!r}")
    return MEM_RATE[best]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------


def _same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _max_abs(a, b) -> float:
    import torch

    if a.dtype == torch.int32:
        return float((a != b).sum())
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_kernels(dev, flat_n: int, tail_n: int, ws: int) -> dict:
    """Each kernel wrapper against its plain version on the same inputs.
    Raises on the first difference: the tolerance is 0. Returns each
    kernel's largest absolute difference over its checks (differing words
    count for the integer outputs)."""
    import torch

    from torch_cgx_tpu_torch.ops import codec, codec_cuda

    rng = np.random.default_rng(SEED)
    max_err = {k: 0.0 for k in TPU_KERNELS}

    def record(kernel: str, label: str, got, want) -> None:
        err = _max_abs(got, want) if got.shape == want.shape else float("inf")
        max_err[kernel] = max(max_err[kernel], err)
        if not _same_bits(got, want):
            raise AssertionError(
                f"{kernel} {label}: kernel disagrees with its plain version (max error {err})"
            )
        log(f"  {kernel:20s} {label:44s} bit-identical")

    cases = [(flat_n, b, BUCKET, 0) for b in (1, 2, 4, 8)]
    cases += [(flat_n, BITS, BUCKET, 1), (flat_n, BITS, BUCKET, 2)]
    cases += [(tail_n, BITS, BUCKET, k) for k in (0, 1, 2)]
    cases += [(flat_n // 4, BITS, 1024, 0), (tail_n // 4, 3, 96, 0)]
    for n, bits, b, kind in cases:
        x = torch.from_numpy(fuzz_operand(rng, n, kind)).to(dev)
        label = f"n={n} bits={bits} B={b} recipe={kind}"
        q = codec_cuda.quantize_batch(x[None], bits, b)
        want = codec.quantize(x, bits, b)
        record("codec_quantize", label + " words", q.packed[0], want.packed)
        record("codec_quantize", label + " meta", q.meta[0], want.meta)
        acc = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
        record("codec_dequantize", label, codec_cuda.dequantize_batch(q)[0], codec.dequantize(want))
        record(
            "codec_dequantize", label + " add_to",
            codec_cuda.dequantize_batch(q, add_to=acc[None])[0],
            codec.dequantize(want, add_to=acc),
        )
        if not codec_cuda.supports_reduce(q):
            continue
        got = codec_cuda.sra_epilogue_batch(q)
        w, m = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, None, -1, bits, b)
        record("codec_sra_epilogue", label + " rows=1 words", got.packed[0], w)
        record("codec_sra_epilogue", label + " rows=1 meta", got.meta[0], m)

    # The multi-rank epilogue: ws stage-1 rows of one rank's chunk, the raw
    # own row swapped in for each position it can take.
    chunk = flat_n // ws
    rows = torch.from_numpy(
        np.stack([fuzz_operand(rng, chunk, 0) * (r + 1) for r in range(ws)])
    ).to(dev)
    qs = codec_cuda.quantize_batch(rows, BITS, BUCKET)
    for own in range(ws):
        got = codec_cuda.sra_epilogue_batch(qs, raw_row=rows[own], own_idx=own)
        w, m = codec_cuda.sra_epilogue_chunks_plain(
            qs.packed, qs.meta, rows[own], own, BITS, BUCKET
        )
        label = f"ws={ws} own={own} n={chunk}"
        record("codec_sra_epilogue", label + " words", got.packed[0], w)
        record("codec_sra_epilogue", label + " meta", got.meta[0], m)
    return max_err


# ---------------------------------------------------------------------------
# Phase 4: the GPT-2 slice.
# ---------------------------------------------------------------------------


def expected_launches(named_grads) -> dict:
    """Kernel launches one compressed gradient sync makes at world size 1
    with ``CGX_DEBUG_FORCE_CODEC``, derived from the layout: per compressed
    fusion slice one quantize when it has a whole 32-bucket chunk; then the
    fused epilogue and one decode where the fused epilogue runs, else two
    decodes (the staged proxy)."""
    import torch

    from torch_cgx_tpu_torch.ops import codec, dispatch
    from torch_cgx_tpu_torch.parallel import allreduce

    counts = {k: 0 for k in TPU_KERNELS}
    dev = next(iter(named_grads.values())).device
    paths_leaves = allreduce.sorted_items(named_grads)
    for g in allreduce._group_leaves(paths_leaves, compress_small=False):
        if not g.cc.enabled:
            continue
        n = sum(paths_leaves[i][1].numel() for i in g.indices)
        for _, ln in allreduce._fusion_slices(n, 4):
            nb = codec.num_buckets(ln, g.cc.bucket_size)
            if nb < codec.CHUNK_BUCKETS:
                continue
            counts["codec_quantize"] += 1
            # A layout-only stand-in for the slice's stage-1 payload: the
            # fused-epilogue decision reads shapes and the device only.
            q = codec.QTensor(
                packed=torch.empty((1, 0), dtype=torch.int32, device=dev),
                meta=torch.empty((1, nb, 2), device=dev),
                residual=torch.empty((1, 0), device=dev),
                numel=ln, bits=g.cc.bits, bucket_size=g.cc.bucket_size,
                dtype=torch.float32,
            )
            if dispatch.fused_epilogue_would_run(q):
                counts["codec_sra_epilogue"] += 1
                counts["codec_dequantize"] += 1
            else:
                counts["codec_dequantize"] += 2
    return counts


def gpt2_slice(dev, cfg, batch: int, seq: int, steps: int, cpu_check: bool = True) -> dict:
    """Build GPT-2 from the seed, check one gradient sync kernel-vs-plain,
    then take ``steps`` compressed train steps with the counters reset."""
    import torch

    from torch_cgx_tpu_torch.models import GPT2, lm_loss
    from torch_cgx_tpu_torch.ops import codec, codec_cuda
    from torch_cgx_tpu_torch.parallel import gradient_sync, make_train_step

    gen = torch.Generator().manual_seed(SEED)
    model = GPT2(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(batch, seq))).to(dev)
    log(f"  GPT-2: {cfg.n_layer} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{n_params} parameters; tokens {batch}x{seq}")

    # One step's gradients, synced through the kernels and through the plain
    # versions on the CPU. The CPU run forces the fused era the card takes
    # for every slice that supports it, so both run the same sequence.
    model.zero_grad(set_to_none=True)
    lm_loss(model(tokens), tokens).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    expected = expected_launches(grads)
    log(f"  launches per step derived from the layout: {expected}")
    synced = gradient_sync(grads)
    sync(dev)
    worst_rel = max(
        float(codec.relative_l2_error(grads[k], synced[k])) for k in grads
    )
    log(f"  largest per-parameter relative L2 error of the synced gradients: {worst_rel:.4f}")
    assert all(bool(torch.isfinite(v).all()) for v in synced.values())
    assert worst_rel < 0.5, worst_rel
    if cpu_check:
        t0 = time.perf_counter()
        os.environ["CGX_SRA_EPILOGUE"] = "fused"
        try:
            plain = gradient_sync({k: v.cpu() for k, v in grads.items()})
        finally:
            os.environ.pop("CGX_SRA_EPILOGUE")
        mismatched = [k for k in grads if not _same_bits(synced[k].cpu(), plain[k])]
        log(f"  kernel-path sync vs plain CPU sync: {len(grads) - len(mismatched)}/{len(grads)} "
            f"parameters bit-identical ({time.perf_counter() - t0:.1f} s)")
        assert not mismatched, mismatched[:5]
    del synced, grads

    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device=dev)
    codec_cuda.reset_launch_counts()
    losses = [float(step(tokens)) for _ in range(steps)]
    sync(dev)
    launches = dict(codec_cuda.LAUNCHES)
    log(f"  losses: {losses}")
    log(f"  launches over {steps} steps: {launches}")
    assert all(np.isfinite(losses)), losses
    want = {k: v * steps for k, v in expected.items()}
    assert launches == want, (launches, want)
    return {"model": model, "tokens": tokens, "opt": opt, "step": step,
            "launches": launches, "expected": expected, "losses": losses}


# ---------------------------------------------------------------------------
# Phase 5: times.
# ---------------------------------------------------------------------------


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_kernels(dev, n: int, name: str) -> list:
    """Each kernel and its plain version at the main path's flat slice."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda

    rate = mem_rate(name)
    x = torch.from_numpy(fuzz_operand(np.random.default_rng(SEED + 1), n, 0)).to(dev)
    words, meta = codec_cuda.quantize_chunks(x, BITS, BUCKET)
    acc = x.clone()
    wire = n * BITS // 8 + 8 * n // BUCKET
    # (bytes moved, f32 operations per value) of each kernel.
    work = {
        "codec_quantize": (4 * n + wire, 8),
        "codec_dequantize": (wire + 4 * n, 4),
        "codec_sra_epilogue": (2 * wire, 12),
    }
    runs = {
        "codec_quantize": (
            lambda: codec_cuda.quantize_chunks(x, BITS, BUCKET),
            lambda: codec_cuda.quantize_chunks_plain(x, BITS, BUCKET),
        ),
        "codec_dequantize": (
            lambda: codec_cuda.dequantize_chunks(words, meta, BITS, BUCKET),
            lambda: codec_cuda.dequantize_chunks_plain(words, meta, BITS, BUCKET),
        ),
        "codec_sra_epilogue": (
            lambda: codec_cuda.sra_epilogue_chunks(words[None], meta[None], None, -1, BITS, BUCKET),
            lambda: codec_cuda.sra_epilogue_chunks_plain(
                words[None], meta[None], None, -1, BITS, BUCKET
            ),
        ),
    }
    out = []
    for k, (kern, plain) in runs.items():
        nbytes, ops = work[k]
        # Alternate kernel and plain version: kernel, plain, plain, kernel.
        k1 = time_cuda(kern)
        p1 = time_cuda(plain, iters=5)
        p2 = time_cuda(plain, iters=5)
        k2 = time_cuda(kern)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        t_bytes = nbytes / rate * 1e3
        t_ops = ops * n / F32_RATE * 1e3
        bound = max(t_bytes, t_ops)
        log(f"  {k:20s} n={n}: {ms:.4f} ms (plain {plain_ms:.3f} ms); {nbytes} bytes, "
            f"bound {bound:.4f} ms by {'bytes' if t_bytes >= t_ops else 'operations'} "
            f"= {100 * bound / ms:.1f}% of bound; {nbytes / ms / 1e6:.1f} GB/s")
        out.append({"name": k, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes})
    src = torch.empty(n, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_cuda(lambda: dst.copy_(src))
    log(f"  yardstick: device-to-device copy_ of {4 * n} bytes: {copy_ms:.4f} ms, "
        f"{8 * n / copy_ms / 1e6:.1f} GB/s read+write")
    return out


def time_steps(sl: dict, iters: int = 5) -> tuple:
    """Train-step milliseconds with the codec (``make_train_step`` under
    ``CGX_DEBUG_FORCE_CODEC``) and without it (forward, backward, Adam; no
    sync), host clock around synchronised steps, alternating."""
    import torch

    from torch_cgx_tpu_torch.models import lm_loss

    model, tokens, opt, step = sl["model"], sl["tokens"], sl["opt"], sl["step"]

    def plain_step():
        opt.zero_grad(set_to_none=True)
        lm_loss(model(tokens), tokens).backward()
        opt.step()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    p1, c1, c2, p2 = timed(plain_step), timed(lambda: step(tokens)), timed(lambda: step(tokens)), timed(plain_step)
    return min(p1, p2), min(c1, c2), plain_step


def profile_step(name: str, fn) -> None:
    """Where one step's time goes: ``torch.profiler`` over a warm step,
    device time by kernel, the codec kernels' share and the device's idle
    share of the step's wall time (the profiler's own overhead included)."""
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
    busy = sum(by_name.values())
    if not busy:
        log(f"  profile {name}: the profiler saw no device time (not measured)")
        return
    codec_ms = sum(v for k, v in by_name.items() if "cgx_" in k)
    log(f"  profile {name}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
        f"{100 * (1 - busy / wall_ms):.1f}%; codec kernels {codec_ms:.3f} ms")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {v:8.3f} ms  {k[:110]}")


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    from torch_cgx_tpu_torch.models import GPT2Config
    from torch_cgx_tpu_torch.ops import codec_cuda

    t_start = time.perf_counter()
    os.environ.update({
        "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS),
        "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
        "CGX_DEBUG_FORCE_CODEC": "1",
    })
    for k in ("CGX_SRA_EPILOGUE", "CGX_FUSION_BUFFER_SIZE_MB", "CGX_STANDALONE_LAYER_ELEMS"):
        os.environ.pop(k, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    log("== 1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name}; "
        f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    log("== 2. build")
    t0 = time.perf_counter()
    lib = codec_cuda.build(force=True)
    log(f"  nvcc built {lib.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = str(codec_cuda.BUILD_LOG.get("ptxas", ""))
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [ln.strip() for ln in ptxas.splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"  ptxas: {len(regs)} kernels, at most {max(regs, default=0)} registers a thread; "
        f"{len(spills)} with spills")
    for ln in spills:
        log("  " + ln)

    log("== 3. kernels against their plain versions")
    max_err = check_kernels(dev, FLAT_N, TAIL_N, SRA_WS)
    torch.cuda.synchronize()

    log("== 4. GPT-2 124M slice")
    sl = gpt2_slice(dev, GPT2Config.small(), BATCH, SEQ, STEPS)

    log("== 5. times")
    kern = time_kernels(dev, FLAT_N, name)
    plain_ms, codec_ms, plain_step = time_steps(sl)
    log(f"  train step, GPT-2 124M {BATCH}x{SEQ}: {plain_ms:.2f} ms without the codec, "
        f"{codec_ms:.2f} ms with it (+{100 * (codec_ms - plain_ms) / plain_ms:.1f}%); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_step("step without the codec", plain_step)
    profile_step("step with the codec", lambda: sl["step"](sl["tokens"]))
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    records = []
    for r in kern:
        records.append({
            "name": r["name"], "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[r["name"]], "launches": sl["launches"][r["name"]],
            "max_abs_err": max_err[r["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
