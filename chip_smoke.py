#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torch_cgx_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, in
order, none of whose failures is caught:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build: ``nvcc`` compiles ``torch_cgx_tpu_torch/csrc/codec.cu`` into
   ``torch_cgx_tpu_torch/_build/``;
3. kernels against their plain PyTorch versions on the card, at the shapes
   the GPT-2 124M train step gives them (the multi-row reduce at the
   two-level and the all-to-all shapes of phase 6, the matmul-quantize at
   the three dense-layer shapes of phase 6's flat SRA step): words, meta and
   decoded values must be bit-identical (tolerance 0), and the
   matmul-quantize on normal operands, whose sums the kernel and cuBLAS
   associate differently, within ``payload_close``'s tolerance (meta within
   1e-5 relative, every decoded value within one level step);
4. the GPT-2 124M slice: three compressed train steps through
   ``make_train_step`` (4 bits, bucket 512, ``CGX_DEBUG_FORCE_CODEC=1``) with
   the launch counters reset just before and read just after, held against
   the counts derived from the gradient layout; one step's gradients synced
   through the kernels and, on the CPU, through the plain versions must agree
   bit for bit;
5. times: each kernel and its plain version (CUDA events, median after
   warm-up), the matmul-quantize also against ``torch.matmul`` of the same
   product (which lacks the quantize), a device-to-device copy as the
   yardstick, the train step with and without the codec, and a
   ``torch.profiler`` breakdown of one step of each;
6. multi-rank: four spawned ranks share the card over a gloo group (NCCL
   refuses two ranks on one device), as a cross 2 x intra 2 layout, each
   with full-width GPT-2 124M and its own 2 x 512 token shard. The
   reference's default two-level scheme (intra SRA, cross Ring, leader
   scheme): one gradient sync through the kernels bit-identical to the
   same sync through the plain versions on the CPU; three train steps with
   the launch counters reset just before and read just after, held against
   the counts derived from the layout; replicas bit-identical. Then one step
   each of the flat Ring, the all-to-all and the two-level scheme with an
   uncompressed intra level, the first two also held against the plain CPU
   path on a 64 MB fusion slice. Then the flat SRA on a float32 GPT-2 124M,
   one step without producer fusion and one with it
   (``CGX_PRODUCER_FUSE=on``): before the latter, rank 0 runs one backward
   with the plane engaged and holds each of the 36 staged payloads (the
   ``attn_qkv``, ``mlp_in`` and ``mlp_out`` kernels of the 12 blocks) to a
   quantize of that layer's ``p.grad / 4`` within ``payload_close``'s
   tolerance. Gloo stages the wire through host memory: its time is not a
   card number.

The third-to-last line is the per-kernel JSON record, the second-to-last
the card's name and power limit, the last ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing as mp
import os
import queue
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np

SEED = 0
BITS = 4
BUCKET = 512
BATCH, SEQ = 8, 512
STEPS = 3
FLAT_N = 16_777_216  # a full 64 MB fusion slice: whole 32-bucket chunks
TAIL_N = 5_042_944  # the last wte slice: 307 chunks, 26 tail buckets, a partial bucket
SRA_WS = 4  # the stage-1 row count of the multi-rank epilogue check
MR_WS, MR_INTRA = 4, 2  # phase 6: 4 ranks, cross 2 x intra 2
MR_BATCH = 2  # each rank's token shard: 2 x 512, 8 x 512 in all
MR_STEPS = 3
MR_TIMEOUT_S = 600

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
    "codec_reduce_rows": "torch_cgx_tpu/ops/codec_pallas.py:1303",
    "codec_matmul_quantize": "torch_cgx_tpu/ops/fused_producer.py:537",
}
# The dense layers of GPT-2 124M whose weight gradients producer fusion
# quantizes in phase 6 (weight shape (din, o)), with the contraction of a
# rank's 2 x 512 tokens. attn_proj (768 x 768) is below
# CGX_STANDALONE_LAYER_ELEMS and stays in the fused group.
MM_SHAPES = {"mlp_in": (768, 3072), "attn_qkv": (768, 2304), "mlp_out": (3072, 768)}
MM_K = MR_BATCH * SEQ
META_RTOL = 1e-5
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


def payload_close(words, meta, want_words, want_meta, bits: int, bucket: int) -> tuple:
    """Two quantized payloads of nearly equal values (one product summed in
    two orders) against the tolerance: every meta value within ``META_RTOL``
    relative to the larger of its magnitude and its bucket's level step, and
    every decoded value within one level step of the other's, plus what the
    meta's own difference moves it. Returns ``(ok, largest meta relative
    error, largest decoded difference, largest decoded difference in level
    steps)``."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda

    m = meta.reshape(-1, 2).double()
    wm = want_meta.reshape(-1, 2).double()
    unit = wm[:, 0]
    dm = (m - wm).abs()
    scale = torch.maximum(wm.abs(), unit[:, None]).clamp_min(1e-30)
    meta_rel = float((dm / scale).max())

    def decode(w, mt):
        return codec_cuda.dequantize_chunks(
            w.reshape(-1).contiguous(), mt.reshape(-1, 2).contiguous(), bits, bucket
        ).double().view(-1, bucket)

    a, b = decode(words, meta), decode(want_words, want_meta)
    err = (a - b).abs()
    # One level step, the meta's difference, and a float32 rounding of each
    # decoded value.
    tol = (unit + dm[:, 1] + ((1 << bits) - 1) * dm[:, 0])[:, None]
    tol = tol + 2 * np.finfo(np.float32).eps * torch.maximum(a.abs(), b.abs())
    ok = meta_rel <= META_RTOL and bool((err <= tol).all())
    steps = float((err / unit.clamp_min(1e-30)[:, None]).max())
    return ok, meta_rel, float(err.max()), steps


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
    del qs, rows

    # The multi-row reduce at phase 6's shapes: the two-level intra
    # reduce-scatter (2 rows of half a 64 MB slice, the raw own row in each
    # position) and the all-to-all (4 rows of a whole slice, no raw row);
    # then other widths, recipes, and a bucket too large for the epilogue's
    # shared-memory tile.
    cases = [(MR_INTRA, flat_n // MR_INTRA, BITS, BUCKET, 0, [None, 0, 1])]
    cases += [(MR_WS, flat_n, BITS, BUCKET, 0, [None])]
    cases += [(4, flat_n // 4, b, BUCKET, 0, [2]) for b in (1, 8)]
    cases += [(2, flat_n // 8, BITS, BUCKET, k, [1]) for k in (1, 2)]
    cases += [(3, 4 * 32 * 2048, BITS, 2048, 0, [None, 1])]
    for rows_n, n, bits, b, kind, owns in cases:
        rows = torch.from_numpy(
            np.stack([fuzz_operand(rng, n, kind) * np.float32(r + 1) for r in range(rows_n)])
        ).to(dev)
        q = codec_cuda.quantize_batch(rows, bits, b)
        assert codec_cuda.supports_reduce(q, requantize=False)
        for own in owns:
            raw = None if own is None else rows[own]
            got = codec_cuda.reduce_rows_batch(q, raw_row=raw, own_idx=own)
            want = codec_cuda.reduce_rows_chunks_plain(
                q.packed, q.meta, raw, -1 if own is None else own, bits, b
            )
            label = f"rows={rows_n} n={n} bits={bits} B={b} recipe={kind} own={own}"
            record("codec_reduce_rows", label, got, want)
        del rows, q

    # The matmul-quantize at the dense-layer shapes of phase 6's flat SRA
    # step, divisor 4. Small-integer operands make every sum exact in f32, so
    # the kernel's and cuBLAS's orders agree and the bytes must too; normal
    # operands are held to payload_close's tolerance.
    for layer, (din, o) in MM_SHAPES.items():
        label = f"{layer} K={MM_K} {din}x{o} div={MR_WS}"
        xi = torch.from_numpy(rng.integers(-3, 4, (MM_K, din)).astype(np.float32)).to(dev)
        gi = torch.from_numpy(rng.integers(-3, 4, (MM_K, o)).astype(np.float32)).to(dev)
        w, m = codec_cuda.matmul_quantize_chunks(xi, gi, MR_WS, BITS, BUCKET)
        pw, pm = codec_cuda.matmul_quantize_chunks_plain(xi, gi, MR_WS, BITS, BUCKET)
        record("codec_matmul_quantize", label + " integer words", w, pw)
        record("codec_matmul_quantize", label + " integer meta", m, pm)
        xn = torch.from_numpy(rng.standard_normal((MM_K, din)).astype(np.float32)).to(dev)
        gn = torch.from_numpy(rng.standard_normal((MM_K, o)).astype(np.float32)).to(dev)
        w, m = codec_cuda.matmul_quantize_chunks(xn, gn, MR_WS, BITS, BUCKET)
        pw, pm = codec_cuda.matmul_quantize_chunks_plain(xn, gn, MR_WS, BITS, BUCKET)
        ok, meta_rel, abs_err, steps = payload_close(w, m, pw, pm, BITS, BUCKET)
        max_err["codec_matmul_quantize"] = max(max_err["codec_matmul_quantize"], abs_err)
        log(f"  {'codec_matmul_quantize':20s} {label + ' normal':44s} meta {meta_rel:.2e} rel, "
            f"decoded within {steps:.3f} level steps ({abs_err:.3e})")
        if not ok:
            raise AssertionError(f"codec_matmul_quantize {label}: outside the tolerance")
    return max_err


# ---------------------------------------------------------------------------
# Phase 4: the GPT-2 slice.
# ---------------------------------------------------------------------------


class LaunchModel:
    """Kernel launches one compressed gradient sync makes on one rank,
    derived from the gradient layout and decided by the dispatcher's own
    gates (``codec_cuda.supports``, ``dispatch.fused_epilogue_would_run``,
    ``dispatch.fused_reduce_would_run``) on layout-only stand-ins for each
    payload: each method mirrors one reducer of ``parallel/reducers.py``."""

    def __init__(self, dev):
        self.dev = dev
        self.counts = {k: 0 for k in TPU_KERNELS}

    def _stand_in(self, rows: int, n: int, cc):
        import torch

        from torch_cgx_tpu_torch.ops import codec

        nb = codec.num_buckets(n, cc.bucket_size)
        return codec.QTensor(
            packed=torch.empty((rows, 0), dtype=torch.int32, device=self.dev),
            meta=torch.empty((rows, nb, 2), device=self.dev),
            residual=torch.empty((rows, 0), device=self.dev),
            numel=n, bits=cc.bits, bucket_size=cc.bucket_size, dtype=torch.float32,
        )

    def codec(self, kernel: str, n: int, cc) -> None:
        """A quantize or decode of rows of ``n`` values: one launch when the
        chunk kernels cover the rows and they hold a whole chunk."""
        from torch_cgx_tpu_torch.ops import codec, codec_cuda

        b = cc.bucket_size
        if codec_cuda.supports(n, cc.bits, b, False) and codec.num_buckets(n, b) >= codec.CHUNK_BUCKETS:
            self.counts[kernel] += 1

    def reduce(self, rows: int, n: int, cc) -> None:
        """``dispatch.reduce_rows`` without an accumulator."""
        from torch_cgx_tpu_torch.ops import dispatch

        if dispatch.fused_reduce_would_run(self._stand_in(rows, n, cc)):
            self.counts["codec_reduce_rows"] += 1
        else:
            self.codec("codec_dequantize", n, cc)

    def proxy(self, m: int, cc) -> None:
        """The world-size-1 ``CGX_DEBUG_FORCE_CODEC`` proxy."""
        from torch_cgx_tpu_torch.ops import dispatch

        self.codec("codec_quantize", m, cc)
        if dispatch.fused_epilogue_would_run(self._stand_in(1, m, cc)):
            self.counts["codec_sra_epilogue"] += 1
            self.codec("codec_dequantize", m, cc)
        else:
            self.codec("codec_dequantize", m, cc)
            self.codec("codec_dequantize", m, cc)

    def sra(self, m: int, ws: int, cc, produced: bool = False) -> None:
        """``produced``: the backward's matmul-quantize made the stage-1
        payload, in place of the quantize."""
        from torch_cgx_tpu_torch.ops import dispatch
        from torch_cgx_tpu_torch.parallel import chunk_layout

        c = chunk_layout(m, ws)[0]
        if produced:
            self.counts["codec_matmul_quantize"] += 1
        else:
            self.codec("codec_quantize", c, cc)
        if dispatch.fused_epilogue_would_run(self._stand_in(ws, c, cc)):
            self.counts["codec_sra_epilogue"] += 1
        else:
            self.reduce(ws, c, cc)
            self.codec("codec_quantize", c, cc)
        self.codec("codec_dequantize", c, cc)

    def ring(self, m: int, ws: int, cc) -> None:
        from torch_cgx_tpu_torch.parallel import chunk_layout

        seg = chunk_layout(m, ws)[0]
        for _ in range(ws - 1):  # scatter-reduce hops: requantize, decode-add
            self.codec("codec_quantize", seg, cc)
            self.codec("codec_dequantize", seg, cc)
        self.codec("codec_quantize", seg, cc)  # the owned segment, once
        for _ in range(ws):  # its own decode and ws-1 all-gather hops
            self.codec("codec_dequantize", seg, cc)

    def alltoall(self, m: int, ws: int, cc) -> None:
        self.codec("codec_quantize", m, cc)
        self.reduce(ws, m, cc)

    def flat(self, m: int, ws: int, cc, reduction: str) -> None:
        """``reducers.quantized_allreduce``."""
        from torch_cgx_tpu_torch import config as cfg

        if ws == 1:
            if cc.enabled and cfg.force_codec():
                self.proxy(m, cc)
        elif cc.enabled and not cfg.dummy_compression() and reduction != cfg.REDUCTION_PSUM:
            {cfg.REDUCTION_SRA: self.sra, cfg.REDUCTION_RING: self.ring,
             cfg.REDUCTION_ALLTOALL: self.alltoall}[reduction](m, ws, cc)

    def two_level(self, m: int, wi: int, wc: int, cc, topo) -> None:
        """``reducers.hierarchical_allreduce``."""
        from torch_cgx_tpu_torch import config as cfg
        from torch_cgx_tpu_torch.config import CompressionConfig
        from torch_cgx_tpu_torch.parallel import chunk_layout

        intra_cc = cc if topo.intra_compress else CompressionConfig(bits=32)
        cross_cc = cc if topo.cross_compress else CompressionConfig(bits=32)
        if wi == 1 and wc == 1:
            return
        if wi == 1:
            return self.flat(m, wc, cross_cc, topo.cross_reduction)
        if wc == 1:
            return self.flat(m, wi, intra_cc, topo.intra_reduction)
        if not topo.intra_broadcast:
            self.flat(m, wi, intra_cc, topo.intra_reduction)
            return self.flat(m, wc, cross_cc, topo.cross_reduction)
        c = chunk_layout(m, wi)[0]
        compressed = intra_cc.enabled and not cfg.dummy_compression()
        if compressed:
            self.codec("codec_quantize", c, intra_cc)
            self.reduce(wi, c, intra_cc)
        self.flat(c, wc, cross_cc, topo.cross_reduction)
        if compressed:
            self.codec("codec_quantize", c, intra_cc)
            self.codec("codec_dequantize", c, intra_cc)


def expected_launches(named_grads, ws: int = 1, two_level=None, dense_k=None) -> dict:
    """Launches of one compressed gradient sync per rank, from the layout:
    each compressed fusion slice through ``quantized_allreduce`` over a
    group of ``ws`` ranks (the env's reduction type), or through the
    two-level scheme of ``topology_from_env`` when ``two_level`` gives the
    ``(intra, cross)`` sizes. ``dense_k`` maps each dense kernel's path to
    its contraction length: with producer fusion engaged, a standalone group
    whose layer ``fused_producer.decide`` sends to the kernel gets its
    stage-1 payload from the backward's matmul-quantize."""
    from torch_cgx_tpu_torch import config as cfg
    from torch_cgx_tpu_torch.ops import fused_producer
    from torch_cgx_tpu_torch.parallel import allreduce

    model = LaunchModel(next(iter(named_grads.values())).device)
    paths_leaves = allreduce.sorted_items(named_grads)
    for g in allreduce._group_leaves(paths_leaves, compress_small=False):
        if not g.cc.enabled:
            continue
        path, leaf = paths_leaves[g.indices[0]]
        produced = (
            two_level is None and dense_k is not None and len(g.indices) == 1
            and path in dense_k and fused_producer.engaged()
            and fused_producer.decide(path, tuple(leaf.shape), dense_k[path], ws)[0] is not None
        )
        n = sum(paths_leaves[i][1].numel() for i in g.indices)
        for _, ln in allreduce._fusion_slices(n, 4):
            if produced:
                model.sra(ln, ws, g.cc, produced=True)
            elif two_level is None:
                model.flat(ln, ws, g.cc, cfg.intra_reduction())
            else:
                model.two_level(ln, *two_level, g.cc, cfg.topology_from_env())
    return model.counts


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
    """Each kernel and its plain version at the main path's flat slice; the
    multi-row reduce at phase 6's two shapes, the two-level one first."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda

    rate = mem_rate(name)
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
    words, meta = codec_cuda.quantize_chunks(x, BITS, BUCKET)

    def wire(m: int) -> int:
        return m * BITS // 8 + 8 * m // BUCKET

    # (kernel, shape, kernel call, plain call, bytes moved, f32 operations,
    # the library call computing the same function or None).
    runs = [
        ("codec_quantize", f"n={n}",
         lambda: codec_cuda.quantize_chunks(x, BITS, BUCKET),
         lambda: codec_cuda.quantize_chunks_plain(x, BITS, BUCKET),
         4 * n + wire(n), 8 * n, None),
        ("codec_dequantize", f"n={n}",
         lambda: codec_cuda.dequantize_chunks(words, meta, BITS, BUCKET),
         lambda: codec_cuda.dequantize_chunks_plain(words, meta, BITS, BUCKET),
         wire(n) + 4 * n, 4 * n, None),
        ("codec_sra_epilogue", f"n={n}",
         lambda: codec_cuda.sra_epilogue_chunks(words[None], meta[None], None, -1, BITS, BUCKET),
         lambda: codec_cuda.sra_epilogue_chunks_plain(words[None], meta[None], None, -1, BITS, BUCKET),
         2 * wire(n), 12 * n, None),
    ]
    # The multi-row reduce: decode (a multiply and an add) and fold (an add)
    # per value and row. Two-level: 2 rows of half a slice with the raw own
    # row; all-to-all: 4 rows of a whole slice.
    for rows_n, m, own in ((MR_INTRA, n // MR_INTRA, 0), (MR_WS, n, None)):
        rows = torch.from_numpy(
            np.stack([fuzz_operand(rng, m, 0) for _ in range(rows_n)])
        ).to(dev)
        q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
        w, mt = q.packed.contiguous(), q.meta.contiguous()
        raw = None if own is None else rows[own].contiguous()
        o = -1 if own is None else own
        runs.append((
            "codec_reduce_rows", f"rows={rows_n} n={m} own={own}",
            lambda w=w, mt=mt, raw=raw, o=o: codec_cuda.reduce_rows_chunks(w, mt, raw, o, BITS, BUCKET),
            lambda w=w, mt=mt, raw=raw, o=o: codec_cuda.reduce_rows_chunks_plain(w, mt, raw, o, BITS, BUCKET),
            rows_n * wire(m) + (0 if own is None else 4 * m) + 4 * m, 3 * rows_n * m, None,
        ))
    # The matmul-quantize at phase 6's three dense-layer shapes, mlp_in first
    # (its record goes into the JSON line): a multiply and an add per product.
    # The library call is torch.matmul of the same product in float32 (TF32
    # off), which lacks the divide and the quantize.
    for layer, (din, o) in MM_SHAPES.items():
        x2 = torch.from_numpy(rng.standard_normal((MM_K, din)).astype(np.float32)).to(dev)
        g2 = torch.from_numpy(rng.standard_normal((MM_K, o)).astype(np.float32)).to(dev)
        runs.append((
            "codec_matmul_quantize", f"{layer} K={MM_K} {din}x{o}",
            lambda x2=x2, g2=g2: codec_cuda.matmul_quantize_chunks(x2, g2, MR_WS, BITS, BUCKET),
            lambda x2=x2, g2=g2: codec_cuda.matmul_quantize_chunks_plain(x2, g2, MR_WS, BITS, BUCKET),
            4 * MM_K * (din + o) + wire(din * o), 2 * MM_K * din * o,
            lambda x2=x2, g2=g2: torch.matmul(x2.t(), g2),
        ))
    out = []
    for k, shape, kern, plain, nbytes, ops, library in runs:
        # Alternate kernel and plain version (and the library call):
        # kernel, plain, library, library, plain, kernel.
        k1 = time_cuda(kern)
        p1 = time_cuda(plain, iters=5)
        l1 = time_cuda(library) if library else None
        l2 = time_cuda(library) if library else None
        p2 = time_cuda(plain, iters=5)
        k2 = time_cuda(kern)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        library_ms = min(l1, l2) if library else None
        t_bytes = nbytes / rate * 1e3
        t_ops = ops / F32_RATE * 1e3
        bound = max(t_bytes, t_ops)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"  {k:20s} {shape}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib}); {nbytes} bytes, "
            f"{ops} operations, bound {bound:.4f} ms by "
            f"{'bytes' if t_bytes >= t_ops else 'operations'} = {100 * bound / ms:.1f}% of bound")
        out.append({"name": k, "shape": shape, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound,
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
# Phase 6: four ranks on the card.
# ---------------------------------------------------------------------------

# The knobs of each multi-rank configuration; every other CGX_* knob is
# unset. "group" is the two-level group or the flat world; "model" the
# GPT-2 124M the steps train: the default one (bfloat16 activations) or a
# float32 one. The producer's payload is an f32 product, so the flat SRA
# pair trains the float32 model, whose p.grad is that product too.
MR_CONFIGS = {
    "two_level": ({}, "two_level", "bf16"),
    "ring": ({"CGX_INNER_REDUCTION_TYPE": "RING"}, "world", "bf16"),
    "alltoall": ({"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1"}, "world", "bf16"),
    "uncompressed_intra": ({"CGX_INTRA_COMPRESS": "0"}, "two_level", "bf16"),
    "sra": ({}, "world", "f32"),
    "sra_producer": ({"CGX_PRODUCER_FUSE": "on"}, "world", "f32"),
}
PRODUCED_LAYERS = 12 * len(MM_SHAPES)  # 36 payloads a rank and step
PROJ_LAYERS = 12  # attn_proj: below CGX_STANDALONE_LAYER_ELEMS, in the fused group


def producer_check(model, loss_fn, tokens) -> dict:
    """One backward of ``model`` with producer fusion engaged over the flat
    world: each staged payload against the dispatcher's quantize of its
    layer's ``p.grad / MR_WS`` (the rows the allreduce would otherwise
    quantize), held to ``payload_close``'s tolerance. Both come from the
    same backward."""
    from torch_cgx_tpu_torch.config import default_compression_config
    from torch_cgx_tpu_torch.ops import dispatch, fused_producer

    fused_producer.configure(None, divisor=MR_WS, active=True)
    fused_producer.begin_step()
    fused_producer.reset_counts()
    model.zero_grad(set_to_none=True)
    loss_fn(model, tokens).backward()
    counts = dict(fused_producer.COUNTS)
    cc = default_compression_config()
    checked, worst_meta, worst_steps, failed = 0, 0.0, 0.0, []
    for n, p in model.named_parameters():
        ent = fused_producer.lookup(n, p.grad)
        if ent is None:
            continue
        want = dispatch.quantize_batch((p.grad.reshape(-1) / MR_WS).view(MR_WS, -1), cc)
        ok, meta_rel, _, steps = payload_close(
            ent.q.packed, ent.q.meta, want.packed, want.meta, cc.bits, cc.bucket_size
        )
        checked += 1
        worst_meta, worst_steps = max(worst_meta, meta_rel), max(worst_steps, steps)
        if not ok:
            failed.append(n)
    fused_producer.deconfigure()
    model.zero_grad(set_to_none=True)
    return {"counts": counts, "checked": checked, "failed": failed,
            "meta_rel": worst_meta, "steps": worst_steps,
            "identity_misses": fused_producer.COUNTS["producer_fallback_identity"]}


def _configure(knobs: dict) -> None:
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ.update({
        "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS),
        "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
        **knobs,
    })


def _digests(model) -> dict:
    return {n: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
            for n, p in model.named_parameters()}


def _plain_cpu(fn, *args, **kw):
    """``fn`` on CPU tensors: the kernels' plain versions, in the fused
    lowering the card takes for every batch that supports it."""
    os.environ["CGX_SRA_EPILOGUE"] = "fused"
    try:
        return fn(*args, **kw)
    finally:
        del os.environ["CGX_SRA_EPILOGUE"]


def _rank_main(rank: int, store: str, result_q, dev_name: str, size: str, seq: int) -> None:
    """One of phase 6's ranks: a gloo group over the FileStore ``store``,
    the two-level layout, GPT-2 from the seed on ``dev_name`` and the
    rank's own tokens. Puts its results (or its traceback) on ``result_q``
    after the group is destroyed."""
    import torch
    import torch.distributed as dist

    out = {}
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from torch_cgx_tpu_torch.config import default_compression_config
        from torch_cgx_tpu_torch.models import GPT2, Dense, GPT2Config, lm_loss
        from torch_cgx_tpu_torch.ops import codec_cuda, fused_producer
        from torch_cgx_tpu_torch.parallel import (
            allreduce_flat, gradient_sync, hierarchical_groups, make_train_step,
        )

        timeout = timedelta(seconds=MR_TIMEOUT_S // 2)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=MR_WS, timeout=timeout,
        )
        tl = hierarchical_groups(intra_size=MR_INTRA, timeout=timeout)
        layout = (tl.intra_size, tl.cross_size)
        dev = torch.device(dev_name)
        cfg = getattr(GPT2Config, size)()
        model = GPT2(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        rng = np.random.default_rng(SEED + rank)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(MR_BATCH, seq))).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)

        def loss_fn(m, t):
            return lm_loss(m(t), t)

        _configure({})
        loss_fn(model, tokens).backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        synced = gradient_sync(grads, group=tl)
        sync(dev)
        plain = _plain_cpu(gradient_sync, {k: v.cpu() for k, v in grads.items()}, group=tl)
        out["sync"] = {
            "params": len(grads), "seconds": time.perf_counter() - t0,
            "mismatched": [k for k in grads if not _same_bits(synced[k].cpu(), plain[k])],
        }
        del synced, plain
        first = grads["wte.embedding"].reshape(-1)[:FLAT_N].contiguous()
        cc = default_compression_config()
        models = {"bf16": (model, opt)}
        for name, (knobs, kind, model_kind) in MR_CONFIGS.items():
            _configure(knobs)
            if model_kind not in models:
                m32 = GPT2(dataclasses.replace(cfg, dtype=torch.float32), device=dev,
                           generator=torch.Generator().manual_seed(SEED))
                models[model_kind] = (m32, torch.optim.Adam(m32.parameters(), lr=1e-4, eps=1e-8))
            mdl, optim = models[model_kind]
            dense_k = {m.kernel_path: MR_BATCH * seq for m in mdl.modules() if isinstance(m, Dense)}
            group = tl if kind == "two_level" else None
            expected = (expected_launches(grads, two_level=layout) if kind == "two_level"
                        else expected_launches(grads, ws=MR_WS, dense_k=dense_k))
            res = {"expected": expected}
            if name in ("ring", "alltoall"):
                gpu = allreduce_flat(first, cc, group=group)
                cpu = _plain_cpu(allreduce_flat, first.cpu(), cc, group=group)
                res["slice_same"] = _same_bits(gpu.cpu(), cpu)
                res["slice_n"] = first.numel()
            if name == "sra_producer" and rank == 0:
                res["check"] = producer_check(mdl, loss_fn, tokens)
            steps = MR_STEPS if name == "two_level" else 1
            step = make_train_step(mdl, loss_fn, optim, group=group, device=dev)
            sync(dev)
            codec_cuda.reset_launch_counts()
            fused_producer.reset_counts()
            t0 = time.perf_counter()
            res["losses"] = [float(step(tokens)) for _ in range(steps)]
            sync(dev)
            res["step_s"] = (time.perf_counter() - t0) / steps
            res["launches"] = dict(codec_cuda.LAUNCHES)
            res["producer"] = dict(fused_producer.COUNTS)
            res["steps"] = steps
            res["digests"] = _digests(mdl)
            out[name] = res
        dist.barrier()
    except Exception:  # reported to the parent, which fails the phase
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


def multirank_phase(dev_name: str = "cuda:0", size: str = "small", seq: int = SEQ) -> dict:
    """Spawn the ranks, collect their results within ``MR_TIMEOUT_S``, stop
    every process, and hold the results to the phase's checks."""
    ctx = mp.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        result_q = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main,
                        args=(r, os.path.join(tmp, "store"), result_q, dev_name, size, seq))
            for r in range(MR_WS)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MR_TIMEOUT_S
        try:
            while len(results) < MR_WS and time.monotonic() < deadline:
                try:
                    r, out = result_q.get(timeout=2.0)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break
                    continue
                results[r] = out
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if len(results) < MR_WS:
        codes = [p.exitcode for p in procs]
        raise AssertionError(f"phase 6: only ranks {sorted(results)} reported; exit codes {codes}")
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    if errors:
        raise AssertionError("phase 6 failed:\n" + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
    res = [results[r] for r in range(MR_WS)]

    s0 = res[0]["sync"]
    log(f"  two-level sync of one backward's gradients, kernels vs plain CPU: "
        f"{s0['params'] - len(s0['mismatched'])}/{s0['params']} parameters bit-identical "
        f"on rank 0 ({s0['seconds']:.1f} s)")
    for r, o in enumerate(res):
        assert not o["sync"]["mismatched"], (r, o["sync"]["mismatched"][:5])
    for name in MR_CONFIGS:
        c0 = res[0][name]
        log(f"  {name}: launches per rank and step derived from the layout: {c0['expected']}")
        log(f"    losses {c0['losses']}; launches on rank 0 over {c0['steps']} step(s): "
            f"{c0['launches']}; host-clock step {c0['step_s']:.2f} s (gloo, wire through host memory)")
        if "slice_same" in c0:
            log(f"    kernels vs plain CPU on a {c0['slice_n']}-value fusion slice: "
                f"{'bit-identical' if all(o[name]['slice_same'] for o in res) else 'DIFFERENT'} on every rank")
        for r, o in enumerate(res):
            c = o[name]
            assert np.all(np.isfinite(c["losses"])), (name, r, c["losses"])
            assert c["losses"] == c0["losses"], (name, r, c["losses"], c0["losses"])
            want = {k: v * c["steps"] for k, v in c["expected"].items()}
            assert c["launches"] == want, (name, r, c["launches"], want)
            assert c.get("slice_same", True), (name, r)
            diff = [k for k in c0["digests"] if c["digests"][k] != c0["digests"][k]]
            assert not diff, (name, r, diff[:5])
        log(f"    replicas: all {len(c0['digests'])} parameters bit-identical on the {MR_WS} ranks")
    assert res[0]["two_level"]["launches"]["codec_reduce_rows"] > 0
    assert res[0]["alltoall"]["launches"]["codec_reduce_rows"] > 0

    # Producer fusion: the layout-derived counts trade 36 stage-1 quantizes
    # for 36 matmul-quantizes, every rank consumed the 36 payloads, and the
    # only fallbacks are the attn_proj layers, which stay in the fused group
    # (as in the JAX package).
    plain_sra, prod = res[0]["sra"]["expected"], res[0]["sra_producer"]["expected"]
    assert plain_sra["codec_matmul_quantize"] == 0, plain_sra
    assert prod["codec_matmul_quantize"] == PRODUCED_LAYERS, prod
    assert plain_sra["codec_quantize"] - prod["codec_quantize"] == PRODUCED_LAYERS, (plain_sra, prod)
    for r, o in enumerate(res):
        pc = o["sra_producer"]["producer"]
        assert pc["producer_consumed_slices"] == PRODUCED_LAYERS, (r, pc)
        assert pc["producer_kernel_slices"] == PRODUCED_LAYERS, (r, pc)
        assert pc["producer_fallbacks"] == pc["producer_fallback_fused_group"] == PROJ_LAYERS, (r, pc)
    chk = res[0]["sra_producer"]["check"]
    log(f"  sra_producer, rank 0: {chk['checked']} staged payloads against a quantize of "
        f"p.grad / {MR_WS}: meta within {chk['meta_rel']:.2e} relative, decoded within "
        f"{chk['steps']:.3f} level steps; {len(chk['failed'])} outside the tolerance; "
        f"backward counters {({k: v for k, v in chk['counts'].items() if v})}")
    assert chk["checked"] == PRODUCED_LAYERS and not chk["failed"], chk
    assert chk["identity_misses"] == 0, chk
    assert chk["counts"]["producer_kernel_slices"] == PRODUCED_LAYERS, chk
    assert chk["counts"]["producer_fallbacks"] == chk["counts"]["producer_fallback_fused_group"], chk
    launches = dict(res[0]["two_level"]["launches"])
    launches["codec_matmul_quantize"] = res[0]["sra_producer"]["launches"]["codec_matmul_quantize"]
    return {"launches": launches, "results": res}


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
    launches = dict(sl["launches"])
    del sl, plain_step
    torch.cuda.empty_cache()

    log(f"== 6. multi-rank: {MR_WS} ranks on the card (cross {MR_WS // MR_INTRA} x intra "
        f"{MR_INTRA}), gloo, GPT-2 124M, {MR_BATCH}x{SEQ} tokens a rank")
    mr = multirank_phase()
    launches["codec_reduce_rows"] = mr["launches"]["codec_reduce_rows"]
    launches["codec_matmul_quantize"] = mr["launches"]["codec_matmul_quantize"]
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    # One record a kernel: its launches on the path that runs it (phase 4
    # for the three of the world-size-1 slice, phase 6's two-level steps for
    # the reduce, its producer-fused flat SRA step for the matmul-quantize)
    # and its time at that path's (first) shape.
    records = []
    for r in kern:
        if any(x["name"] == r["name"] for x in records):
            continue
        records.append({
            "name": r["name"], "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": max_err[r["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
