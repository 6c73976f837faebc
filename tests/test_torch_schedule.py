"""The port's pipelined SRA (``CGX_SCHEDULE=on``, ``parallel/schedule.py``)
and its layout cache against the JAX package, on the CPU.

* ``chunk_table`` (which the port's hook uses too) against the JAX
  ``schedule.chunk_table`` and the JAX backend's ``_sched_chunk_table``,
  over widths, depths and buckets; ``compiled_schedule``'s gates, tables
  and cache keys against the JAX ones.
* Spawned gloo worlds of 2 and 4 ranks (each spawned once for the module,
  every wait bounded) run the pipelined SRA over a matrix of depths
  (``CGX_SCHED_CHUNKS`` 2, 4, 7), bits (2, 4, 8), buckets (128, 512),
  lengths (whole rows and padded ones) and dtypes (float32, bfloat16), on
  decode-exact grids and random data. Each block's stage-1 payload equals
  the JAX ``pipelined_quantized_allreduce``'s (its per-block quantize of
  the same rows) byte for byte; the output equals the JAX pipelined SRA's
  (8-device CPU mesh, ``CGX_SCHEDULE=on``) bit for bit on the grids and
  stays within ``allreduce_error_bound`` of it and of the exact sum on
  random data; and output and wire round trip (``with_wire``) equal the
  port's monolithic SRA bit for bit on any data.
* The 2-rank world also runs a tiny float32 GPT-2 through
  ``make_train_step`` under ``on`` and ``off``: plain, with error feedback,
  with producer fusion (per-block payloads consumed, ``dw`` kept) and with
  the nonfinite guard, the parameters bit-identical.
* The producer's per-block payloads against the JAX ``_maybe_stash`` under
  ``CGX_SCHEDULE=on`` on integer operands; the layout cache's hits, misses
  on a knob or registry change, and its invalidation with the schedule
  cache.

The rank bodies import only torch and the port; JAX is imported in the
test functions.
"""

import functools
import multiprocessing as mp
import os
import queue
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch import config as tcfg
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.ops import codec
from torch_cgx_tpu_torch.parallel import allreduce, schedule
from torch_cgx_tpu_torch.parallel.reducers import chunk_layout
from torch_cgx_tpu_torch.torch_backend import backend as pb

SPAWN_TIMEOUT_S = 240.0
# (bits, bucket, CGX_SCHED_CHUNKS, geometry, dtype): every value of each
# parameter at least once, both geometries at each depth.
CASES = [
    (4, 128, 4, "aligned", "float32"),
    (4, 128, 7, "padded", "float32"),
    (2, 512, 2, "aligned", "float32"),
    (8, 512, 4, "padded", "float32"),
    (2, 128, 2, "padded", "float32"),
    (8, 128, 7, "aligned", "float32"),
    (4, 512, 7, "aligned", "float32"),
    (4, 512, 4, "padded", "bfloat16"),
    (4, 128, 2, "aligned", "bfloat16"),
]
CASE_IDS = [f"b{b}_B{B}_c{c}_{g}_{d}" for b, B, c, g, d in CASES]
DATA = ("grid", "random")
GPT2_STEPS = 2


def _row_width(bucket: int) -> int:
    """Each rank's row: eight aligned units at bucket 512 (seven blocks
    fit), 64 at bucket 128 (blocks of whole 32-bucket chunks at depth 2)."""
    return 8 * 512 if bucket == 512 else 64 * 128


def _n(ws: int, bucket: int, geom: str) -> int:
    """Whole rows, or rows padded by the SRA layout (a partial last bucket
    and an edge-padded tail in the last row)."""
    n = ws * _row_width(bucket)
    return n if geom == "aligned" else n - 3 * bucket - 37


def _inputs(ws: int):
    """Per case and data kind, every rank's flat input (float32; the
    bfloat16 cases cast it, every value exact in bfloat16). The grids are
    integers in [0, 2^bits - 1] whose every bucket of the wire rows holds 0
    and 2^bits - 1, so each stage-1 level decodes exactly."""
    out = {}
    rng = np.random.default_rng(100 + ws)
    for (bits, bucket, chunks, geom, dtype), cid in zip(CASES, CASE_IDS):
        n = _n(ws, bucket, geom)
        chunk = chunk_layout(n, ws)[0]
        levels = (1 << bits) if dtype == "float32" else min(1 << bits, 256)
        grid = []
        for r in range(ws):
            rows = (np.arange(ws * chunk) * (2 * r + 3) % levels).astype(np.float32).reshape(ws, chunk)
            rows[:, ::bucket] = 0
            rows[:, 1::bucket] = levels - 1
            grid.append(rows.reshape(-1)[:n])
        out[(cid, "grid")] = np.stack(grid)
        out[(cid, "random")] = rng.standard_normal((ws, n)).astype(np.float32)
    return out


def _to(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _gpt2_runs(rank: int):
    """Two steps of a tiny float32 GPT-2 under each (name, knobs), from one
    seed: the losses, the parameters and the counters."""
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.ops import fused_producer
    from torch_cgx_tpu_torch.parallel import make_train_step

    runs = {
        "plain": ({}, {}),
        "ef": ({}, {"error_feedback": True}),
        "producer": ({"CGX_PRODUCER_FUSE": "on", "CGX_STANDALONE_LAYER_ELEMS": "32768"}, {}),
        "guard": ({}, {"nonfinite_guard": "skip"}),
    }
    tokens = torch.from_numpy(np.random.default_rng(rank).integers(0, 512, size=(2, 32)))
    out = {}
    for name, (knobs, kw) in runs.items():
        for mode in ("off", "on"):
            os.environ.update({"CGX_SCHEDULE": mode, **knobs})
            schedule.reset_counts()
            fused_producer.reset_counts()
            model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                         generator=torch.Generator().manual_seed(0))
            step = make_train_step(model, lambda m, b: lm_loss(m(b), b),
                                   torch.optim.Adam(model.parameters(), lr=1e-3), device="cpu", **kw)
            losses = [float(step(tokens)) for _ in range(GPT2_STEPS)]
            out[(name, mode)] = {
                "losses": losses,
                "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
                "sched": dict(schedule.COUNTS), "producer": dict(fused_producer.COUNTS),
            }
            for k in knobs:
                del os.environ[k]
    del os.environ["CGX_SCHEDULE"]
    return out


def _rank_main(rank, ws, init_file, inputs, result_q):
    """One rank: every case's pipelined SRA (the block payloads it sent,
    the output, the round trip) and its monolithic SRA, then (2 ranks) the
    tiny GPT-2 runs."""
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    import torch.distributed as dist

    from torch_cgx_tpu_torch.parallel import reducers

    torch.set_num_threads(1)  # ws ranks share the test machine's cores
    out = {}
    sent = []
    real = reducers._exchange_async

    def capture(q, group):
        sent.append((q.packed.numpy().copy(), q.meta.float().numpy().copy()))
        return real(q, group)

    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=ws, timeout=timedelta(seconds=120))
        reducers._exchange_async = capture
        for (bits, bucket, chunks, geom, dtype), cid in zip(CASES, CASE_IDS):
            cc = CompressionConfig(bits=bits, bucket_size=bucket)
            os.environ["CGX_SCHED_CHUNKS"] = str(chunks)
            for data in DATA:
                x = _to(inputs[(cid, data)][rank], dtype)
                os.environ["CGX_SCHEDULE"] = "off"
                mono, mono_rt = allreduce.allreduce_flat(x, cc, return_roundtrip=True)
                os.environ["CGX_SCHEDULE"] = "on"
                sent.clear()
                y = allreduce.allreduce_flat(x, cc)
                blocks = list(sent)
                y2, rt = allreduce.allreduce_flat(x, cc, return_roundtrip=True)
                out[(cid, data)] = {
                    "y": y.float().numpy(), "rt": rt.float().numpy(), "blocks": blocks,
                    "same": torch.equal(y.view(torch.int16 if y.element_size() == 2 else torch.int32),
                                        mono.view(torch.int16 if y.element_size() == 2 else torch.int32)),
                    "rt_same": torch.equal(rt, mono_rt) and torch.equal(y2, y),
                }
        reducers._exchange_async = real
        del os.environ["CGX_SCHEDULE"], os.environ["CGX_SCHED_CHUNKS"]
        if ws == 2:
            os.environ.update({"CGX_COMPRESSION_QUANTIZATION_BITS": "4",
                               "CGX_COMPRESSION_BUCKET_SIZE": "128"})
            out["gpt2"] = _gpt2_runs(rank)
        dist.barrier()
    except Exception:  # reported to the parent, which fails the test
        import traceback

        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put(((ws, rank), out))


WORLD_SIZES = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds spawned at once: ws -> (inputs, results by rank)."""
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    inputs = {ws: _inputs(ws) for ws in WORLD_SIZES}
    procs = []
    for ws in WORLD_SIZES:
        init_file = str(tmp_path_factory.mktemp(f"gloo_sched_ws{ws}") / "store")
        procs += [ctx.Process(target=_rank_main, args=(r, ws, init_file, inputs[ws], result_q),
                              daemon=True) for r in range(ws)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < len(procs) and time.monotonic() < deadline:
            try:
                key, out = result_q.get(timeout=2.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            results[key] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert len(results) == len(procs), f"only {sorted(results)} reported"
    errors = {k: o["error"] for k, o in results.items() if "error" in o}
    assert not errors, errors
    return {ws: (inputs[ws], [results[(ws, r)] for r in range(ws)]) for ws in WORLD_SIZES}


# ---------------------------------------------------------------------------
# The JAX side.
# ---------------------------------------------------------------------------


def _jcc(bits, bucket):
    from torch_cgx_tpu.config import CompressionConfig as JCC

    return JCC(bits=bits, bucket_size=bucket)


def _jax_sched(n, ws, bits, bucket):
    from torch_cgx_tpu.parallel import schedule as jsched

    return jsched.compiled_schedule(n, ws, _jcc(bits, bucket), route="staged")


def _jax_dtype(dtype):
    import jax.numpy as jnp

    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


@functools.lru_cache(maxsize=None)
def _jax_pipelined_fn(n, ws, bits, bucket, chunks, dtype):
    """The jitted JAX pipelined SRA over a ``ws``-device CPU mesh, one per
    plan (the grid and the random data share it): each device's output
    and the stage-1 payload of each block it quantized in its pipeline's
    ``start`` (the same quantize of the same column block of its padded
    rows)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.parallel import reducers as jreducers
    from torch_cgx_tpu.parallel import schedule as jsched
    from torch_cgx_tpu.utils.compat import shard_map

    sched = _jax_sched(n, ws, bits, bucket)
    assert sched.depth == min(chunks, _row_width(bucket) // schedule.chunk_alignment(bucket))
    cc = _jcc(bits, bucket)

    def body(x):
        y = jsched.pipelined_quantized_allreduce(x[0], "dp", ws, cc, "SRA", None, sched)
        xs = jreducers._pad_rows(x[0], ws, sched.chunk)
        blocks = [jreducers._quantize_rows(lax.slice(xs, (0, off), (ws, off + w)), cc)
                  for off, w in sched.table]
        return (y[None].astype(jnp.float32), tuple(q.packed[None] for q in blocks),
                tuple(q.meta[None].astype(jnp.float32) for q in blocks))

    mesh = Mesh(np.asarray(jax.devices()[:ws]), ("dp",))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"), check_vma=False))
    return lambda per_rank: jax.tree.map(np.asarray, fn(jnp.asarray(per_rank, _jax_dtype(dtype))))


def _jax_pipelined(per_rank, ws, bits, bucket, chunks, dtype):
    """(outputs by rank, [(packed, meta) by block] by rank) of the JAX
    pipelined SRA."""
    y, packed, meta = _jax_pipelined_fn(per_rank.shape[1], ws, bits, bucket, chunks, dtype)(per_rank)
    return y, [[(p[r], m[r]) for p, m in zip(packed, meta)] for r in range(ws)]


# ---------------------------------------------------------------------------
# Plans, gates and keys.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", [32, 96, 128, 512, 1760])
def test_chunk_table_matches_jax(bucket):
    from torch_cgx_tpu.parallel import schedule as jsched
    from torch_cgx_tpu.torch_backend import backend as jb

    for width in [0, 1, 31, 32, 33, 127, 128, 511, 512, 513, 1024, 4096 + 32, 5 * 1760, 65536 + 96]:
        for chunks in (1, 2, 3, 4, 7, 16):
            want = jsched.chunk_table(width, chunks, bucket)
            assert schedule.chunk_table(width, chunks, bucket) == want, (width, chunks)
            assert tuple(jb._sched_chunk_table(width, chunks, bucket)) == want, (width, chunks)
            if want:
                assert sum(w for _, w in want) == width
    assert schedule.chunk_alignment(bucket) == jsched.chunk_alignment(bucket)


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
def test_compiled_schedule_gates_and_tables_match_jax(monkeypatch, mode):
    """The same plan or None under each mode (JAX ``auto`` on the CPU, the
    port's ``auto`` everywhere: monolithic), for each gate: one rank,
    compression off, the dummy codec, the Ring and the all-to-all, a row
    too narrow for two blocks."""
    from torch_cgx_tpu import config as jcfg
    from torch_cgx_tpu.parallel import schedule as jsched

    monkeypatch.setenv("CGX_SCHEDULE", mode)
    for chunks in ("2", "4", "7"):
        monkeypatch.setenv("CGX_SCHED_CHUNKS", chunks)
        for n, ws, bits, bucket in [(1 << 16, 2, 4, 512), (1 << 16, 4, 2, 128), (3000, 4, 4, 512),
                                    (5000, 1, 4, 128), (1 << 16, 2, 32, 128), (70001, 4, 8, 128)]:
            for red in (jcfg.REDUCTION_SRA, jcfg.REDUCTION_RING, jcfg.REDUCTION_ALLTOALL):
                j = jsched.compiled_schedule(n, ws, _jcc(bits, bucket), reduction=red, route="staged")
                p = schedule.compiled_schedule(n, ws, CompressionConfig(bits=bits, bucket_size=bucket),
                                               reduction=red)
                assert (j is None) == (p is None), (mode, n, ws, bits, red)
                if p is not None:
                    assert (p.table, p.n, p.ws, p.chunk, p.depth) == (j.table, j.n, j.ws, j.chunk, j.depth)
    monkeypatch.setenv("CGX_DEBUG_DUMMY_COMPRESSION", "1")
    cc = CompressionConfig(bits=4, bucket_size=128)
    assert schedule.compiled_schedule(1 << 16, 2, cc) is None
    assert jsched.compiled_schedule(1 << 16, 2, _jcc(4, 128), route="staged") is None
    assert schedule.engaged() == (mode == "on") and jsched.engaged() == (mode == "on")


def test_schedule_cache_hits_misses_and_key(monkeypatch):
    """A plan is cached by what its table reads: (n, ws, config, depth),
    the JAX key without the dtype, the chip and the route (the table reads
    none of them, and the port has one plane); negative results are cached
    too; a depth change misses, a registry change does not (the config in
    the key is the resolved one); ``invalidate_layout_cache`` clears it."""
    monkeypatch.setenv("CGX_SCHEDULE", "on")
    cc = CompressionConfig(bits=4, bucket_size=128)
    allreduce.invalidate_layout_cache()
    assert schedule.schedule_cache_stats() == {"hits": 0, "misses": 0}
    a = schedule.compiled_schedule(1 << 16, 2, cc)
    assert schedule.compiled_schedule(1 << 16, 2, cc) is a
    assert schedule.compiled_schedule(100, 2, cc) is None
    assert schedule.compiled_schedule(100, 2, cc) is None
    assert schedule.schedule_cache_stats() == {"hits": 2, "misses": 2}
    monkeypatch.setenv("CGX_SCHED_CHUNKS", "2")
    assert schedule.compiled_schedule(1 << 16, 2, cc).depth == 2
    tcfg.set_layer_pattern_config(r"^nothing$", cc)
    try:
        schedule.compiled_schedule(1 << 16, 2, cc)
    finally:
        tcfg.clear_registry()
    assert schedule.schedule_cache_stats() == {"hits": 3, "misses": 3}
    assert len(schedule._SCHED_CACHE) == 3
    assert schedule._schedule_key(1 << 16, 2, cc, 2) == (1 << 16, 2, cc, 2)
    allreduce.invalidate_layout_cache()
    assert schedule.schedule_cache_stats() == {"hits": 0, "misses": 0}


def test_layout_cache_hits_misses_and_invalidation(monkeypatch):
    """The tree's layout is cached: the second call hits, a knob the
    grouping reads or a registry change misses, the outputs are unchanged
    (one rank under ``CGX_DEBUG_FORCE_CODEC``, the codec's full kernel
    sequence), and ``invalidate_layout_cache`` cycles both caches."""
    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "4")
    monkeypatch.setenv("CGX_COMPRESSION_BUCKET_SIZE", "128")
    monkeypatch.setenv("CGX_DEBUG_FORCE_CODEC", "1")
    rng = np.random.default_rng(0)
    tree = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in (("a.kernel", (64, 128)), ("b.kernel", (32, 256)), ("b.bias", (256,)))}
    allreduce.invalidate_layout_cache()
    first = allreduce.allreduce_tree(tree)
    assert allreduce.layout_cache_stats()["misses"] == 1
    again = allreduce.allreduce_tree(tree)
    assert allreduce.layout_cache_stats()["hits"] == 1
    assert all(torch.equal(first[k], again[k]) for k in tree)
    assert list(again) == list(first)
    monkeypatch.setenv("CGX_STANDALONE_LAYER_ELEMS", "8192")  # a knob the grouping reads
    allreduce.allreduce_tree(tree)
    assert allreduce.layout_cache_stats()["misses"] == 2
    tcfg.set_layer_pattern_config(r"b\.kernel$", CompressionConfig(bits=2, bucket_size=128))
    try:
        two = allreduce.allreduce_tree(tree)
        assert allreduce.layout_cache_stats()["misses"] == 3
        assert not torch.equal(two["b.kernel"], first["b.kernel"])  # the new config took effect
    finally:
        tcfg.clear_registry()
    monkeypatch.delenv("CGX_STANDALONE_LAYER_ELEMS")
    assert all(torch.equal(allreduce.allreduce_tree(tree)[k], first[k]) for k in tree)
    assert allreduce.layout_cache_stats()["misses"] == 4  # the registry's version moved on
    invalidations = allreduce.layout_cache_stats()["invalidations"]
    allreduce.invalidate_layout_cache()
    stats = allreduce.layout_cache_stats()
    assert stats["hits"] == stats["misses"] == 0 and stats["invalidations"] == invalidations + 1
    assert schedule.schedule_cache_stats() == {"hits": 0, "misses": 0}
    assert all(torch.equal(allreduce.allreduce_tree(tree)[k], first[k]) for k in tree)


# ---------------------------------------------------------------------------
# The pipelined SRA on the gloo worlds.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws", WORLD_SIZES, ids=lambda ws: f"ws{ws}")
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_block_payloads_and_output_match_jax(worlds, monkeypatch, case, ws):
    """Each block's stage-1 payload byte for byte on both data kinds; the
    output bit for bit on the grids, and on random data within the
    allreduce envelope of the JAX output and of the exact sum."""
    inputs, results = worlds[ws]
    bits, bucket, chunks, _, dtype = CASES[case]
    cid = CASE_IDS[case]
    monkeypatch.setenv("CGX_SCHEDULE", "on")
    monkeypatch.setenv("CGX_SCHED_CHUNKS", str(chunks))
    for data in DATA:
        x = inputs[(cid, data)]
        ref, want = _jax_pipelined(x, ws, bits, bucket, chunks, dtype)
        for r in range(ws):
            got = results[r][(cid, data)]["blocks"]
            assert len(got) == len(want[r]) >= 2, (data, r)
            for c, ((gp, gm), (wp, wm)) in enumerate(zip(got, want[r])):
                np.testing.assert_array_equal(gp.view(np.uint32), wp, err_msg=f"{data} rank {r} block {c}")
                np.testing.assert_array_equal(gm, wm, err_msg=f"{data} rank {r} block {c}")
        if data == "grid":
            for r in range(ws):
                np.testing.assert_array_equal(results[r][(cid, data)]["y"], ref[r], err_msg=f"rank {r}")
            continue
        xq = _to(x, dtype).float().numpy()
        step = float((xq.max() - xq.min()) / bucket)
        bound = codec.allreduce_error_bound(x.shape[1], bits, bucket, ws, step)
        if dtype == "bfloat16":  # the output rounds to bfloat16
            bound += float(np.abs(xq.astype(np.float64).sum(axis=0)).max()) * 2.0**-7
        got = results[0][(cid, data)]["y"]
        assert np.abs(got - xq.astype(np.float64).sum(axis=0)).max() <= bound
        assert np.abs(got - ref[0]).max() <= bound


@pytest.mark.parametrize("ws", WORLD_SIZES, ids=lambda ws: f"ws{ws}")
@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_pipelined_equals_monolithic(worlds, case, data, ws):
    """Output and wire round trip bit-identical to the monolithic SRA's on
    every rank, and the replicas identical."""
    _, results = worlds[ws]
    cid = CASE_IDS[case]
    y0 = results[0][(cid, data)]["y"]
    for r in range(ws):
        o = results[r][(cid, data)]
        assert o["same"] and o["rt_same"], (r, o["same"], o["rt_same"])
        np.testing.assert_array_equal(o["y"].view(np.uint32), y0.view(np.uint32))


@pytest.mark.parametrize("ws", WORLD_SIZES, ids=lambda ws: f"ws{ws}")
def test_roundtrip_is_the_sent_blocks(worlds, ws):
    """The round trip is the decode of the blocks this rank sent, its own
    row raw: on the grids (decode-exact) it is the input itself."""
    inputs, results = worlds[ws]
    for cid in CASE_IDS:
        for r in range(ws):
            rt = results[r][(cid, "grid")]["rt"]
            np.testing.assert_array_equal(rt, inputs[(cid, "grid")][r], err_msg=f"{cid} rank {r}")


@pytest.mark.parametrize("run", ["plain", "ef", "producer", "guard"])
def test_gpt2_train_step_on_equals_off(worlds, run):
    """The tiny GPT-2 on the 2-rank world: ``on`` pipelined and equals
    ``off`` bit for bit."""
    _, results = worlds[2]
    for r, res in enumerate(results):
        on, off = res["gpt2"][(run, "on")], res["gpt2"][(run, "off")]
        assert on["sched"]["pipelined_slices"] > 0 and off["sched"]["pipelined_slices"] == 0
        # One join of the decoded blocks a slice, two with the round trip.
        joins = on["sched"]["pipelined_slices"] * (2 if run == "ef" else 1)
        assert on["sched"]["join_copies"] == joins, (run, on["sched"])
        assert on["losses"] == off["losses"], (r, on["losses"], off["losses"])
        for p, v in off["params"].items():
            np.testing.assert_array_equal(on["params"][p].view(np.uint32), v.view(np.uint32),
                                          err_msg=f"{run} rank {r} {p}")
        if run == "producer":
            n_layer = 2
            pc, po = on["producer"], off["producer"]
            # Under the schedule every standalone layer's per-block payloads
            # were consumed and its dw kept; no matmul-quantize ran.
            assert pc["producer_consumed_slices"] == pc["producer_staged"] == 3 * n_layer * GPT2_STEPS, pc
            assert pc["producer_dw_skipped"] == pc["producer_kernel_slices"] == 0, pc
            assert po["producer_dw_skipped"] == po["producer_kernel_slices"] == 3 * n_layer * GPT2_STEPS


# ---------------------------------------------------------------------------
# Producer fusion's per-block payloads against the JAX ``_maybe_stash``.
# ---------------------------------------------------------------------------


def test_producer_block_payloads_match_jax(monkeypatch):
    """Under ``CGX_SCHEDULE=on`` the JAX ``_maybe_stash`` (inside
    ``shard_map`` over 2 CPU devices) and the port's backward stage the same
    table and, per block, the same payload bytes and raw own row, on
    integer operands (exact products)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.ops import fused_producer as jfp
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu_torch.ops import fused_producer as fp

    ws, din, o, k = 2, 64, 256, 16
    for key, v in {"CGX_SCHEDULE": "on", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
                   "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "4096",
                   "CGX_PRODUCER_FUSE": "on"}.items():
        monkeypatch.setenv(key, v)
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, size=(ws, k, din)).astype(np.float32)
    g = rng.integers(-3, 4, size=(ws, k, o)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:ws]), ("dp",))
    w = jax.ShapeDtypeStruct((din, o), jnp.float32)
    captured = {}

    def body(xb, gb):
        dw = xb[0].T @ gb[0]
        jfp._maybe_stash("big.kernel", w, dw, xb[0], gb[0])
        ent = jfp._STASH[id(dw)]
        captured["table"] = ent.table
        return (tuple(q.packed[None] for q in ent.q_blocks), tuple(q.meta[None] for q in ent.q_blocks),
                ent.raw_row[None])

    fn = shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=P("dp"), check_vma=False)
    jfp.configure(mesh, ("dp",), divisor=ws, active=True)
    try:
        jfp.begin_step()
        packed, meta, raw = jax.tree.map(np.asarray, jax.jit(fn)(jnp.asarray(x), jnp.asarray(g)))
    finally:
        jfp.deconfigure()
    cc = CompressionConfig(bits=4, bucket_size=128)
    table = fp._schedule_table(cc, ws, din * o)
    assert table == captured["table"] and len(table) == 4
    for r in range(ws):
        dw = torch.from_numpy(x[r]).t() @ torch.from_numpy(g[r])
        blocks, raw_row = fp._block_payloads(dw, cc, ws=ws, div=ws, own=r, table=table)
        for c, q in enumerate(blocks):
            np.testing.assert_array_equal(q.packed.numpy().view(np.uint32), packed[c][r], err_msg=f"{r} {c}")
            np.testing.assert_array_equal(q.meta.numpy(), meta[c][r], err_msg=f"{r} {c}")
        np.testing.assert_array_equal(raw_row.numpy(), raw[r])
