"""Where the tensor-core matmul-quantize's time goes, at GPT-2 124M's shapes.

    python3 -m torch_cgx_tpu_torch.tools.mmtc_split [--iters 20] [--groups 3]

Builds the parts of ``csrc/codec.cu`` that hold B8's tensor-core kernels
(build part 21: ``cgx_matmul_quantize_tc_kernel``, bf16 and f16; part 22:
the split pass ``cgx_tf32_split_kernel`` and ``cgx_matmul_quantize_tf32_kernel``,
float32 as split TF32) three times each into a temporary directory, from
their shared body (``matmul_quantize_tc_body``) as it is (``full``),
without the chunk quantize after the tiles (``no_quantize``: the mainloop,
the stores to the workspace and the raw row, the arrival counters), and
without the stores too (``mainloop``: the loop over the chunks and the
stores' condition made false by text substitutions that this tool
checks). Each variant runs at K = 1,024 on bf16 and on float32 operands
of ``mlp_in``, ``attn_qkv`` and ``mlp_out`` (divisor 4, 4 bits, bucket
512, the own raw row of rank 1 of 4), ``iters`` launches under
``torch.profiler``, each kernel's device time over the launches (the
float32 route's split pass apart), the least of ``groups`` groups in
turns; the full variant's bytes must equal the plain version's on
small-integer operands. The differences are the quantize's and the
stores' shares. Needs ``nvcc`` and the card; prints one JSON record and
writes nothing else.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import codec, codec_cuda

SHAPES = {"mlp_in": (768, 3072), "attn_qkv": (768, 2304), "mlp_out": (3072, 768)}
K, DIV, BITS, BUCKET, OWN = 1024, 4, 4, 512, (1, 4)
_BODY = "__device__ __forceinline__ void matmul_quantize_tc_body("
_CHUNKS = "for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {"
_STORES = "if (row < din && col < o) {"
# The build part and the C entry point of each operand dtype's route.
ROUTES = {"bfloat16": (21, "cgx_matmul_quantize_tc"), "float32": (22, "cgx_matmul_quantize_tf32")}


def variants(source: str) -> dict:
    """The kernels' source as it is and with their shared body's quantize
    (and its stores) cut out; only that body's text changes."""
    head, body = source.split(_BODY, 1)
    kernel, rest = body.split("\n}\n", 1)
    for text in (_CHUNKS, _STORES):
        if kernel.count(text) != 1:
            raise RuntimeError(f"the tensor-core body no longer holds {text!r}")
    no_quantize = kernel.replace(_CHUNKS, _CHUNKS.replace("c < chunks", "c < 0 * chunks"))
    mainloop = no_quantize.replace(_STORES, "if (row < din && col < o && k_total < 0) {")
    return {name: head + _BODY + k + "\n}\n" + rest
            for name, k in (("full", kernel), ("no_quantize", no_quantize), ("mainloop", mainloop))}


def build(work: Path) -> dict:
    """Each variant's parts 21 and 22 as shared libraries, all compiled at
    once: ``{(variant, dtype): library}``."""
    procs = {}
    for name, text in variants(codec_cuda.SOURCE.read_text()).items():
        src = work / f"{name}.cu"
        src.write_text(text)
        for dtype, (part, _) in ROUTES.items():
            procs[(name, dtype)] = subprocess.Popen(
                [codec_cuda._nvcc(), *codec_cuda.NVCC_FLAGS, f"-DCGX_PART={part}", "-shared", "-o",
                 str(work / f"{name}{part}.so"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    codec_cuda._run_nvcc(list(procs.values()))
    libs = {}
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    for (name, dtype) in procs:
        part, entry = ROUTES[dtype]
        lib = ctypes.CDLL(str(work / f"{name}{part}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = [vp, vp, ll, i, i, f, vp, vp, vp, ll, ll, vp, vp, i, i, f, i, i, i, vp]
        fn.restype = ctypes.c_int
        if dtype == "float32":
            lib.cgx_tf32_split.argtypes = [vp, vp, ll, i, i, ll, vp, vp, vp]
            lib.cgx_tf32_split.restype = ctypes.c_int
        libs[(name, dtype)] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--groups", type=int, default=3)
    a = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's float32 product
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = build(Path(tmp))
        record = {"build_s": time.perf_counter() - t0, "card": torch.cuda.get_device_name(0),
                  "shapes": {}}
        for dtype in ROUTES:
            kernel = ("cgx_matmul_quantize_tf32_kernel" if dtype == "float32"
                      else "cgx_matmul_quantize_tc_kernel")
            for layer, (din, o) in SHAPES.items():
                x2, g2 = (torch.from_numpy(rng.integers(-3, 4, (K, c)).astype(np.float32))
                          .to(getattr(torch, dtype)).to(dev) for c in (din, o))
                n, chunks = din * o, din * o // (32 * BUCKET)
                words = torch.empty(chunks * BITS * BUCKET, dtype=torch.int32, device=dev)
                meta = torch.empty((chunks * 32, 2), device=dev)
                work, raw = torch.empty(n, device=dev), torch.empty(n // OWN[1], device=dev)
                arrivals = torch.zeros((a.iters + 1, chunks), dtype=torch.int32, device=dev)
                lo, ln = codec_cuda._own_span(n, OWN)
                kp = -(-K // codec_cuda.MM_TF32_BK) * codec_cuda.MM_TF32_BK
                xs = torch.empty((2, din, kp), device=dev)
                gs = torch.empty((2, o, kp), device=dev)

                def launch(lib, row):
                    stream = torch.cuda.current_stream().cuda_stream
                    if dtype == "float32":
                        err = lib.cgx_tf32_split(x2.data_ptr(), g2.data_ptr(), K, din, o, kp,
                                                 xs.data_ptr(), gs.data_ptr(), stream)
                        if err:
                            raise RuntimeError(f"split launch failed: CUDA error {err}")
                        ops, k, wire = (xs, gs), kp, 0
                    else:
                        ops, k, wire = (x2, g2), K, 1
                    err = getattr(lib, ROUTES[dtype][1])(
                        ops[0].data_ptr(), ops[1].data_ptr(), k, din, o, float(DIV), work.data_ptr(),
                        arrivals[row].data_ptr(), raw.data_ptr(), lo, ln, words.data_ptr(),
                        meta.data_ptr(), BUCKET, BITS, codec.unit_scale(BITS), 0, 0, wire, stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")

                ms, split_ms = {}, []
                for _ in range(a.groups):
                    for name in ("full", "no_quantize", "mainloop"):
                        lib = libs[(name, dtype)]
                        arrivals.zero_()
                        launch(lib, 0)
                        torch.cuda.synchronize()
                        if name == "full":
                            pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(
                                x2, g2, DIV, BITS, BUCKET, own_row=OWN)
                            if not (torch.equal(words, pw) and torch.equal(meta, pm)
                                    and torch.equal(raw, praw)):
                                raise AssertionError(f"{layer} {dtype}: the kernel's bytes differ from the plain version")
                        with profile(activities=[ProfilerActivity.CUDA]) as prof:
                            for row in range(1, a.iters + 1):
                                launch(lib, row)
                            torch.cuda.synchronize()
                        by = prof.key_averages()
                        dev_us = sum(e.device_time_total for e in by if kernel in e.key)
                        split_us = sum(e.device_time_total for e in by if "cgx_tf32_split_kernel" in e.key)
                        if dev_us > 0:  # a group the profiler saw nothing of is left out
                            ms[name] = min(ms.get(name, float("inf")), dev_us / a.iters / 1e3)
                        if split_us > 0:
                            split_ms.append(split_us / a.iters / 1e3)
                if len(ms) < 3 or (dtype == "float32" and not split_ms):
                    raise RuntimeError(f"{layer} {dtype}: the profiler saw no launch of a variant in any group")
                record["shapes"][f"{layer} {dtype}"] = {
                    **{f"{k}_ms": v for k, v in ms.items()},
                    "quantize_ms": ms["full"] - ms["no_quantize"],
                    "stores_ms": ms["no_quantize"] - ms["mainloop"],
                    **({"split_ms": min(split_ms)} if dtype == "float32" else {}),
                    "tiles": int(np.prod(codec_cuda.mm_tc_tiles(din, o))), "chunks": chunks,
                }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
