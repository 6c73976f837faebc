#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, and with the right result.

Several ranks that share one GPU cannot use NCCL ("Duplicate GPU
detected"), so they run gloo, and ``torch_cgx_tpu_torch/parallel/group.py``
hands gloo the CUDA tensors as they are. This probe records what gloo does
with CUDA tensors, op by op, on two spawned ranks that share ``cuda:0``.
Run on a machine with a GPU:

    python3 tools/gloo_cuda_probe.py

Prints one JSON object: each op -> "ok", "wrong result" or the error gloo
raised.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
import tempfile
from datetime import timedelta

WS = 2
N = 1024


def _rank(rank: int, store: str, result_q) -> None:
    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WS, timeout=timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    x = torch.full((WS * N,), float(rank + 1), device=dev)
    total = float(sum(range(1, WS + 1)))

    def all_to_all_splits():
        send, recv = [0] * WS, [0] * WS
        send[(rank + 1) % WS] = N
        recv[(rank - 1) % WS] = N
        out = torch.empty(N, device=dev)
        dist.all_to_all_single(out, x[:N].contiguous(), recv, send)
        return bool((out == float((rank - 1) % WS + 1)).all())

    def all_gather_into_tensor():
        out = torch.empty(WS * N, device=dev)
        dist.all_gather_into_tensor(out, x[:N].contiguous())
        return bool((out.view(WS, N)[:, 0].cpu() == torch.arange(1, WS + 1)).all())

    def all_gather_list():
        outs = [torch.empty(N, device=dev) for _ in range(WS)]
        dist.all_gather(outs, x[:N].contiguous())
        return all(bool((o == r + 1).all()) for r, o in enumerate(outs))

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == total).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return bool((y == 1.0).all())

    def all_to_all_even():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return bool((out.view(WS, N)[:, 0].cpu() == torch.arange(1, WS + 1)).all())

    def reduce_scatter_tensor():
        out = torch.empty(N, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return bool((out == total).all())

    ops = [all_reduce, broadcast, all_gather_list, all_gather_into_tensor,
           all_to_all_even, all_to_all_splits, reduce_scatter_tensor]
    out = {}
    for op in ops:
        try:
            ok = op()
            torch.cuda.synchronize()
            out[op.__name__] = "ok" if ok else "wrong result"
        except Exception as e:  # the probe's answer: gloo refused the op
            out[op.__name__] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        dist.barrier()
    dist.destroy_process_group()
    result_q.put((rank, out))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank, args=(r, os.path.join(tmp, "store"), q))
                 for r in range(WS)]
        for p in procs:
            p.start()
        try:
            results = dict(q.get(timeout=300) for _ in range(WS))
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    print(json.dumps({"torch": torch.__version__, "ops": results[0],
                      "agree": results[0] == results[1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
