"""Where the tensor-core matmul-quantize's time goes, at GPT-2 124M's shapes.

    python3 -m torch_cgx_tpu_torch.tools.mmtc_split [--iters 20] [--groups 3]

Builds the part of ``csrc/codec.cu`` that holds B8's tensor-core kernel
(``cgx_matmul_quantize_tc_kernel``, build part 21) three times into a
temporary directory: as it is (``full``), without the chunk quantize after
the tiles (``no_quantize``: the mainloop, the stores to the workspace and
the raw row, the arrival counters), and without the stores too
(``mainloop``: the loop over the chunks and the stores' condition made
false by text substitutions that this tool checks). Each variant runs at
K = 1,024 on bf16 operands of ``mlp_in``, ``attn_qkv`` and ``mlp_out``
(divisor 4, 4 bits, bucket 512, the own raw row of rank 1 of 4), ``iters``
launches under ``torch.profiler``, its kernel's device time over the
launches, the least of ``groups`` groups in turns; the full variant's bytes
must equal the plain version's on small-integer operands. The differences
are the quantize's and the stores' shares. Needs ``nvcc`` and the card;
prints one JSON record and writes nothing else.
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
_KERNEL = "    cgx_matmul_quantize_tc_kernel(const __grid_constant__"
_CHUNKS = "for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {"
_STORES = "if (row < din && col < o) {"


def variants(source: str) -> dict:
    """The kernel's source as it is and with its quantize (and its stores)
    cut out; only the tensor-core kernel's text changes."""
    head, body = source.split(_KERNEL, 1)
    kernel, rest = body.split("\n}\n", 1)
    for text in (_CHUNKS, _STORES):
        if kernel.count(text) != 1:
            raise RuntimeError(f"the tensor-core kernel no longer holds {text!r}")
    no_quantize = kernel.replace(_CHUNKS, _CHUNKS.replace("c < chunks", "c < 0 * chunks"))
    mainloop = no_quantize.replace(_STORES, "if (row < din && col < o && k_total < 0) {")
    return {name: head + _KERNEL + k + "\n}\n" + rest
            for name, k in (("full", kernel), ("no_quantize", no_quantize), ("mainloop", mainloop))}


def build(work: Path) -> dict:
    """Each variant's part 21 as a shared library, all compiled at once."""
    procs = {}
    for name, text in variants(codec_cuda.SOURCE.read_text()).items():
        src = work / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [codec_cuda._nvcc(), *codec_cuda.NVCC_FLAGS, "-DCGX_PART=21", "-shared", "-o",
             str(work / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    codec_cuda._run_nvcc(list(procs.values()))
    libs = {}
    for name in procs:
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.cgx_matmul_quantize_tc.argtypes = [
            vp, vp, ll, i, i, f, vp, vp, vp, ll, ll, vp, vp, i, i, f, i, i, i, vp]
        lib.cgx_matmul_quantize_tc.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--groups", type=int, default=3)
    a = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = build(Path(tmp))
        record = {"build_s": time.perf_counter() - t0, "card": torch.cuda.get_device_name(0),
                  "shapes": {}}
        for layer, (din, o) in SHAPES.items():
            x2, g2 = (torch.from_numpy(rng.integers(-3, 4, (K, c)).astype(np.float32))
                      .bfloat16().to(dev) for c in (din, o))
            n, chunks = din * o, din * o // (32 * BUCKET)
            words = torch.empty(chunks * BITS * BUCKET, dtype=torch.int32, device=dev)
            meta = torch.empty((chunks * 32, 2), device=dev)
            work, raw = torch.empty(n, device=dev), torch.empty(n // OWN[1], device=dev)
            arrivals = torch.zeros((a.iters + 1, chunks), dtype=torch.int32, device=dev)
            lo, ln = codec_cuda._own_span(n, OWN)

            def launch(lib, row):
                err = lib.cgx_matmul_quantize_tc(
                    x2.data_ptr(), g2.data_ptr(), K, din, o, float(DIV), work.data_ptr(),
                    arrivals[row].data_ptr(), raw.data_ptr(), lo, ln, words.data_ptr(),
                    meta.data_ptr(), BUCKET, BITS, codec.unit_scale(BITS), 0, 0, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            ms = {}
            for _ in range(a.groups):
                for name, lib in libs.items():
                    arrivals.zero_()
                    launch(lib, 0)
                    torch.cuda.synchronize()
                    if name == "full":
                        pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(
                            x2, g2, DIV, BITS, BUCKET, own_row=OWN)
                        if not (torch.equal(words, pw) and torch.equal(meta, pm)
                                and torch.equal(raw, praw)):
                            raise AssertionError(f"{layer}: the kernel's bytes differ from the plain version")
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for row in range(1, a.iters + 1):
                            launch(lib, row)
                        torch.cuda.synchronize()
                    dev_us = sum(e.device_time_total for e in prof.key_averages()
                                 if "cgx_matmul_quantize_tc_kernel" in e.key)
                    ms[name] = min(ms.get(name, float("inf")), dev_us / a.iters / 1e3)
            record["shapes"][layer] = {
                **{f"{k}_ms": v for k, v in ms.items()},
                "quantize_ms": ms["full"] - ms["no_quantize"],
                "stores_ms": ms["no_quantize"] - ms["mainloop"],
                "tiles": int(np.prod(codec_cuda.mm_tc_tiles(din, o))), "chunks": chunks,
            }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
