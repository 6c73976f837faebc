"""Where the DDP hook's step goes: ``torch.profiler`` over one rank-step of
``chip_smoke.py`` phase 7's ``ddp_hook`` configuration, on every rank.

    python3 torch_cgx_tpu_torch/tools/hookprof.py [--root DIR] [--steps 3] [--trace FILE]

``--root`` names the checkout whose ``torch_cgx_tpu_torch`` runs (by
default the one this file belongs to), so that one call can profile a
parent and a change in turns, a process tree each. Four ranks share
``cuda:0`` over gloo (a FileStore in a temporary directory); each builds
phase 7's DDP configuration (:func:`ddp_setup`, :func:`rank_tokens`:
GPT-2 124M in float32 from seed 0, ``cgx_hook`` with
``CGXState(None, {"bits": 4, "bucket_size": 512})``, Adam, its own
2 x 512 tokens) under SRA. Steps 0-3 warm up (the layers register at step
2); then every rank times ``--steps`` steps on the host clock and
profiles one more step. Every rank times the bucket allreduce, the gloo
collectives the port calls (``all_to_all_single``,
``all_gather_into_tensor``, ``all_reduce``) and the step's phases on the
host clock, on whichever thread runs them; the profiler gives the
kernels. The JSON record splits rank 0's profiled step into:

* ``gloo_ms``: the collectives' host time, through host memory;
* ``loop_ms``: the bucket allreduces less their collectives: the Python
  loop over a bucket's segments and the launches it makes;
* ``codec_ms``: rank 0's codec kernels' device time (``cgx_*``);
* ``copy_ms``: rank 0's copy kernels' device time (DDP's bucket copies and
  the rest of the step's);
* ``busy_ms``: the union of rank 0's own device intervals (the profiler
  sees only its own process's kernels), and ``idle_share``, one less it
  over the step's wall time: rank 0's share, not the card's;
* ``card_busy_ms``: the union of all four ranks' device intervals inside
  rank 0's profiled step, each rank's put on the shared monotonic clock
  by an anchor range it records, and ``card_idle_share``, one less it
  over that step's wall time: the card's share;
* ``forward_ms``, ``backward_ms`` (DDP's wait for the buckets included),
  ``optimizer_ms``: the host spans of the step's phases.

It prints one JSON record and writes nothing but ``--trace`` (a Chrome
trace of rank 0's profiled step).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

WS = 4
SEED = 0
BITS, BUCKET = 4, 512
BATCH, SEQ = 2, 512
WARMUP = 4
TIMEOUT_S = 600
COLLECTIVES = ("all_to_all_single", "all_gather_into_tensor", "all_reduce")


# Host spans (name, start, end) on the host clock, from every thread: the
# profiler records the CPU ranges of the threads it was started on, and the
# bucket allreduces may run on the hook's worker thread. Kernels it sees on
# every stream.
_SPANS: list = []
# perf_counter() at the ``cgx.anchor`` range of the profiled step.
_ANCHOR = [0.0]


def _span(name: str, fn):
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            _SPANS.append((name, t0, time.perf_counter()))

    return wrapped


def _union_ms(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals, in ms (intervals
    in microseconds)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def device_intervals(prof) -> list:
    """``(start, end)`` of the profiled process's kernels and copies on
    the card, in seconds of ``time.perf_counter`` (CLOCK_MONOTONIC, one
    clock for every process of the machine), placed by the ``cgx.anchor``
    range recorded at a known ``perf_counter`` time."""
    import torch

    events = prof.events()
    anchor = next(e for e in events if e.name == "cgx.anchor")
    shift = _ANCHOR[0] - anchor.time_range.start / 1e6
    return [(e.time_range.start / 1e6 + shift, e.time_range.end / 1e6 + shift)
            for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def split(prof, wall_ms: float, spans) -> dict:
    """Rank 0's profiled step (see the module docstring); ``spans`` the
    step's host spans in seconds."""
    import torch

    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    def of(name):
        return [(s, e) for n, s, e in spans if n == name]

    def ms(iv):
        return sum(e - s for s, e in iv) * 1e3

    ar, gloo = of("cgx.bucket_allreduce"), of("cgx.gloo")
    phase = {k: of(f"cgx.{k}") for k in ("forward", "backward", "optimizer")}
    codec = sum(e.time_range.elapsed_us() for e in dev if "cgx_" in e.name) / 1e3
    copy = sum(e.time_range.elapsed_us() for e in dev
               if "cgx_" not in e.name and ("copy" in e.name.lower() or "memcpy" in e.name.lower())) / 1e3
    busy_ms = _union_ms([(e.time_range.start, e.time_range.end) for e in dev])
    return {
        "wall_ms": wall_ms, "buckets": len(ar), "collectives": len(gloo),
        "allreduce_ms": ms(ar), "gloo_ms": ms(gloo), "loop_ms": ms(ar) - ms(gloo),
        "codec_ms": codec, "copy_ms": copy, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        **{f"{k}_ms": ms(v) for k, v in phase.items()},
    }


def card_share(window, intervals_of_ranks) -> dict:
    """The card's busy time inside ``window`` (rank 0's step, seconds on
    the shared clock): the union of every rank's device intervals, clipped
    to it."""
    lo, hi = window
    clipped = [(max(s, lo) * 1e6, min(e, hi) * 1e6)
               for iv in intervals_of_ranks for s, e in iv if min(e, hi) > max(s, lo)]
    busy = _union_ms(clipped)
    return {"card_busy_ms": busy, "card_idle_share": 1.0 - busy / ((hi - lo) * 1e3)}


def rank_tokens(vocab: int, rank: int, batch: int = BATCH, seq: int = SEQ, seed: int = SEED):
    """Rank ``rank``'s token shard (numpy int64, ``batch`` x ``seq``), as
    ``chip_smoke.py`` phase 7 makes it."""
    return np.random.default_rng(seed + rank).integers(0, vocab, size=(batch, seq))


def ddp_setup(dev, gcfg, seed: int = SEED):
    """Phase 7's DDP configuration on ``dev``: GPT-2 of ``gcfg`` in float32,
    random weights from ``seed``, wrapped in ``DistributedDataParallel``
    over the default group with ``cgx_hook`` and
    ``CGXState(None, {"bits": 4, "bucket_size": 512})``, and Adam. Returns
    ``(model, ddp, state, opt)``."""
    import torch

    from torch_cgx_tpu_torch.models import GPT2
    from torch_cgx_tpu_torch.torch_backend import CGXState, cgx_hook

    model = GPT2(dataclasses.replace(gcfg, dtype=torch.float32), device=dev,
                 generator=torch.Generator().manual_seed(seed))
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    state = CGXState(None, {"bits": BITS, "bucket_size": BUCKET})
    ddp.register_comm_hook(state, cgx_hook)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    return model, ddp, state, opt


def _rank_main(rank: int, store: str, result_q, steps: int, trace: str) -> None:
    out = {}
    import torch
    import torch.distributed as dist

    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from torch.profiler import ProfilerActivity, profile, record_function

        from torch_cgx_tpu_torch.models import GPT2Config, lm_loss
        from torch_cgx_tpu_torch.torch_backend import backend

        for name in COLLECTIVES:
            setattr(dist, name, _span("cgx.gloo", getattr(dist, name)))
        backend.allreduce = _span("cgx.bucket_allreduce", backend.allreduce)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=WS,
                                timeout=timedelta(seconds=TIMEOUT_S // 2))
        dev = torch.device("cuda", 0)
        gcfg = GPT2Config.small()
        _, ddp, _, opt = ddp_setup(dev, gcfg)
        tokens = torch.from_numpy(rank_tokens(gcfg.vocab_size, rank)).to(dev)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = _span("cgx.forward", lambda: lm_loss(ddp(tokens), tokens))()
            _span("cgx.backward", loss.backward)()
            _span("cgx.optimizer", opt.step)()

        for _ in range(WARMUP):
            step()
        torch.cuda.synchronize()
        ts = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("cgx.anchor"):
                _ANCHOR[0] = time.perf_counter()
            _SPANS.clear()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        out = {"steps_ms": ts, "window": (t0, t1), "device": device_intervals(prof)}
        if rank == 0:
            out["profiled"] = split(prof, (t1 - t0) * 1e3, list(_SPANS))
            if trace:
                prof.export_chrome_trace(trace)
        dist.barrier()
    except Exception:  # reported to the parent
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("hookprof: no CUDA device; it profiles the hook's step on the card")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.utils.device import card_line

    if root not in Path(codec_cuda.__file__).resolve().parents:
        raise RuntimeError(f"imported {codec_cuda.__file__}, not the checkout at {root}")
    cache = tempfile.TemporaryDirectory()
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ.update({"CGX_COMPRESSION_QUANTIZATION_BITS": "4", "CGX_COMPRESSION_BUCKET_SIZE": "512",
                       "CGX_INNER_REDUCTION_TYPE": "SRA", "CGX_AUTOTUNE_DIR": cache.name})
    t0 = time.perf_counter()
    codec_cuda.build()
    build_s = time.perf_counter() - t0
    ctx = mp.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        result_q = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, os.path.join(tmp, "store"), result_q, args.steps, args.trace))
                 for r in range(WS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while len(results) < WS and time.monotonic() < deadline:
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
    cache.cleanup()
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    if len(results) < WS or errors:
        raise SystemExit(f"hookprof: ranks {sorted(results)} reported; errors {errors}")
    rec = {"root": str(root), "card": card_line(), "build_s": build_s,
           "steps_ms": {r: results[r]["steps_ms"] for r in range(WS)},
           "step_ms_rank0": float(np.median(results[0]["steps_ms"])),
           "profiled": {**results[0]["profiled"],
                        **card_share(results[0]["window"], [results[r]["device"] for r in range(WS)])}}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
