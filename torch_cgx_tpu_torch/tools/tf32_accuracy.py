"""How close the split-TF32 matmul-quantize comes to the exact product.

    python3 -m torch_cgx_tpu_torch.tools.tf32_accuracy [--steps 5] [--partials 1,2,4]

Builds build part 22 of ``csrc/codec.cu`` (the split pass and
``cgx_matmul_quantize_tf32_kernel``) once for each number of k8 steps a
partial sums before the CUDA cores add it to the sums
(``kTf32PartialSteps``, set by a text substitution this tool checks), and
parts 3 and 20 (the FFMA kernel), all at once, into a temporary directory.
Then trains a float32 GPT-2 124M from phase 7's seed for ``steps`` Adam
steps (lr 1e-4) on the mean of the four ranks' gradients of their 2 x 512
token shards (``chip_smoke.py`` phase 7 reduces them through the 4-bit
SRA; here in full precision, so the state is near phase 7's, not equal),
captures rank 0's operands of the 36 layers producer fusion quantizes, and
holds each route's payload (divisor 4, 4 bits, bucket 512) against the
quantize of the float64 product and of cuBLAS's float32 product (TF32
off) with ``chip_smoke.payload_close``: its largest meta error, the
measure of ``META_RTOL``. Last, each variant's burst at the three shapes,
in turns. Needs ``nvcc`` and the card; prints one JSON record and writes
nothing else.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import torch

from ..ops import codec_cuda

_PARTIAL = "constexpr int kTf32PartialSteps = {};"
_DEFAULT = 2


def build(work: Path, partials) -> dict:
    """Part 22 once a partial length, and the FFMA kernel's parts 3 and 20
    linked into one library: ``{name: library namespace}``."""
    source = codec_cuda.SOURCE.read_text()
    if source.count(_PARTIAL.format(_DEFAULT)) != 1:
        raise RuntimeError(f"the source no longer holds {_PARTIAL.format(_DEFAULT)!r}")
    nvcc = [codec_cuda._nvcc(), *codec_cuda.NVCC_FLAGS]
    procs = {}
    for p in partials:
        src = work / f"p{p}.cu"
        src.write_text(source.replace(_PARTIAL.format(_DEFAULT), _PARTIAL.format(p)))
        procs[f"p{p}"] = subprocess.Popen([*nvcc, "-DCGX_PART=22", "-shared", "-o", str(work / f"p{p}.so"),
                                           str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True)
    for part in (3, 20):
        procs[f"ffma{part}"] = subprocess.Popen(
            [*nvcc, f"-DCGX_PART={part}", "-c", "-o", str(work / f"ffma{part}.o"), str(codec_cuda.SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    codec_cuda._run_nvcc(list(procs.values()))
    codec_cuda._run_nvcc([subprocess.Popen(
        [codec_cuda._nvcc(), "-shared", "-o", str(work / "ffma.so"), str(work / "ffma3.o"),
         str(work / "ffma20.o")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    mm_args = [vp, vp, ll, i, i, f, vp, vp, vp, ll, ll, vp, vp, i, i, f, i, i, i, vp]
    libs = {}
    for p in partials:
        lib = ctypes.CDLL(str(work / f"p{p}.so"))
        lib.cgx_matmul_quantize_tf32.argtypes = mm_args
        lib.cgx_tf32_split.argtypes = [vp, vp, ll, i, i, ll, vp, vp, vp]
        lib.cgx_matmul_quantize_tf32.restype = lib.cgx_tf32_split.restype = ctypes.c_int
        libs[f"p{p}"] = types.SimpleNamespace(
            cgx_matmul_quantize_tf32=lib.cgx_matmul_quantize_tf32, cgx_tf32_split=lib.cgx_tf32_split,
            cgx_error_name=lambda e: b"CUDA error %d" % e)
    lib = ctypes.CDLL(str(work / "ffma.so"))
    lib.cgx_matmul_quantize.argtypes = mm_args
    lib.cgx_matmul_quantize.restype = ctypes.c_int
    libs["ffma"] = types.SimpleNamespace(cgx_matmul_quantize=lib.cgx_matmul_quantize,
                                         cgx_error_name=lambda e: b"CUDA error %d" % e)
    return libs


def operands(cs, dev, steps: int) -> dict:
    """Rank 0's (x2, g2) of the produced layers after ``steps`` full-precision
    steps of the four ranks' mean gradient (``cs``: chip_smoke, for phase
    7's seed, shards and shapes)."""
    from ..models import GPT2, Dense, GPT2Config, lm_loss
    from .hookprof import rank_tokens

    cfg = dataclasses.replace(GPT2Config.small(), dtype=torch.float32)
    model = GPT2(cfg, device=dev, generator=torch.Generator().manual_seed(cs.SEED))
    shards = [torch.from_numpy(rank_tokens(cfg.vocab_size, r, cs.MR_BATCH, cs.SEQ, cs.SEED)).to(dev)
              for r in range(cs.MR_WS)]
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    for _ in range(steps):
        total = None
        for t in shards:
            model.zero_grad(set_to_none=True)
            lm_loss(model(t), t).backward()
            g = [p.grad.clone() for p in model.parameters()]
            total = g if total is None else [a + b for a, b in zip(total, g)]
        for p, g in zip(model.parameters(), total):
            p.grad = g / cs.MR_WS
        opt.step()
    model.zero_grad(set_to_none=True)
    ops = {}
    for m in model.modules():
        if isinstance(m, Dense) and any(t in m.kernel_path for t in ("attn_qkv", "mlp_in", "mlp_out")):
            def fwd(mod, inp, out, path=m.kernel_path):
                ops.setdefault(path, {})["x2"] = inp[0].detach().reshape(-1, inp[0].shape[-1]).contiguous()

            def bwd(mod, gin, gout, path=m.kernel_path):
                ops[path]["g2"] = gout[0].detach().reshape(-1, gout[0].shape[-1]).contiguous()

            m.register_forward_hook(fwd)
            m.register_full_backward_hook(bwd)
    lm_loss(model(shards[0]), shards[0]).backward()
    torch.cuda.synchronize()
    return ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--partials", default="1,2,4")
    a = ap.parse_args(argv)
    sys.path.insert(0, str(Path(codec_cuda.__file__).resolve().parents[2]))  # the checkout's root
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    partials = [int(p) for p in a.partials.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = build(Path(tmp), partials)
        record = {"build_s": time.perf_counter() - t0, "card": torch.cuda.get_device_name(0),
                  "steps": a.steps}
        ops = operands(cs, dev, a.steps)
        bits, bucket, div = 4, 512, 4
        routes = ["cublas", *libs]
        worst = {"vs_exact": {r: 0.0 for r in routes}, "vs_cublas": {r: 0.0 for r in routes}}
        by_layer = {}
        for path, d in sorted(ops.items()):
            x2, g2 = d["x2"], d["g2"]
            exact = ((x2.double().t() @ g2.double()).reshape(-1) / div).float()
            cublas = (x2.t() @ g2).reshape(-1) / div
            refs = {k: codec_cuda.quantize_chunks_plain(v, bits, bucket)
                    for k, v in (("vs_exact", exact), ("vs_cublas", cublas))}
            by_layer[path] = {}
            for route in routes:
                if route == "cublas":
                    w, m = codec_cuda.quantize_chunks_plain(cublas, bits, bucket)
                else:
                    codec_cuda._LIB = libs[route]
                    w, m = codec_cuda.matmul_quantize_chunks(
                        x2, g2, div, bits, bucket, _route="ffma" if route == "ffma" else None)
                for k, (rw, rm) in refs.items():
                    rel = cs.payload_close(w.cpu(), m.cpu(), rw.cpu(), rm.cpu(), bits, bucket)[1]
                    worst[k][route] = max(worst[k][route], rel)
                    by_layer[path][f"{route} {k}"] = rel
        record["meta_rel"] = worst
        record["attn_qkv"] = {k: v for k, v in by_layer.items() if "attn_qkv" in k}
        bursts = {}
        tc = [r for r in libs if r != "ffma"]
        for layer, (din, o) in cs.MM_SHAPES.items():
            x2 = torch.randn(cs.MM_K, din, device=dev)
            g2 = torch.randn(cs.MM_K, o, device=dev)
            bursts[layer] = {}
            for route in tc + tc[::-1]:
                codec_cuda._LIB = libs[route]
                ms = cs.time_burst(lambda: codec_cuda.matmul_quantize_chunks(
                    x2, g2, div, bits, bucket, own_row=(1, cs.MR_WS)))
                bursts[layer][route] = min(bursts[layer].get(route, float("inf")), ms)
        record["burst_ms"] = bursts
    codec_cuda._LIB = None
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
