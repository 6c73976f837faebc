"""The port's step planner (``parallel/planner.py``) and bit allocator
(``parallel/adaptive.py``) against the JAX package, on the CPU.

* The cost model: its defaults and file format, the ``CGX_PLANNER_MODEL``
  file (a rewrite within one mtime tick included), calibration from span
  files written here, and every prediction equal to the JAX model's over a
  ``hypothesis`` grid (``==``: both run the same float arithmetic on the
  host).
* The solve: the depth candidates, the production solve against the port's
  brute force and the JAX solve at three block costs, the average-bits
  solve over GPT-2 124M's fusion slices, and ``adaptive``'s measurement,
  solver and registry write against the JAX ones.
* ``plan_for_layout`` on GPT-2 124M's layout (shapes only, no model built)
  at ws 2 and 4 under the default model, a bit budget and a model file,
  equal to the JAX ``plan_for_layout`` decision for decision; the plan
  LRU, its gates and its invalidation; ``bridge_chunks`` against the JAX
  planner and the JAX bridge's copy; ``StepPlanner`` and the refusals.
* Spawned gloo worlds of 2 and 4 ranks (each spawned once for the module):
  ``allreduce_tree`` under ``CGX_PLANNER=on`` equal to the unplanned SRA bit
  for bit, its plan equal to JAX's; under ``CGX_PLANNER_AVG_BITS`` each
  group equal to the SRA at its planned width; a tiny GPT-2's
  ``make_train_step`` under ``on`` equal to ``off`` (plain and with producer
  fusion). The producer's per-block payloads under the planner
  against the JAX ``_maybe_stash``. The DDP hook at ws 2 under the planner
  against the JAX "cgx" ranks is ``tests/test_torch_ddp_hook.py``'s
  ``sra_planned``.

The rank bodies import only torch and the port; JAX is imported in the
test functions.
"""

import dataclasses
import json
import multiprocessing as mp
import os
import queue
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_cgx_tpu_torch import config as tcfg
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.ops import codec
from torch_cgx_tpu_torch.parallel import adaptive, allreduce, planner, schedule
from torch_cgx_tpu_torch.parallel import group as group_mod

BUCKET = 512
SPAWN_TIMEOUT_S = 240.0
GPT2_STEPS = 2
# A model whose cost a block is negligible: the solve then pipelines every
# compressed slice as deep as its row allows.
DEEP_MODEL = {"chunk_overhead_s": 1e-12, "source": "test"}


def _jp():
    from torch_cgx_tpu.parallel import planner as jp

    return jp


def _reset(jp=None):
    planner.set_cost_model(None)
    planner._PLAN_VERSION = 0
    planner.reset_counts()
    schedule.invalidate_schedule_cache()
    if jp is not None:
        jp.set_cost_model(None)
        jp._PLAN_VERSION = 0
        jp.plan_cache_clear()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("CGX_PLANNER", "CGX_PLANNER_AVG_BITS", "CGX_PLANNER_MODEL", "CGX_METRICS_DIR",
              "CGX_MEMLEDGER", "CGX_SCHEDULE", "CGX_DEBUG_DUMMY_COMPRESSION",
              "CGX_COMPRESSION_FAKE_RATIO"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "4")
    monkeypatch.setenv("CGX_COMPRESSION_BUCKET_SIZE", str(BUCKET))
    _reset(_jp())
    yield monkeypatch
    tcfg.clear_registry()
    _reset(_jp())


def _cc(bits=4, bucket=BUCKET):
    return CompressionConfig(bits=bits, bucket_size=bucket)


def _jcc(cc):
    from torch_cgx_tpu.config import CompressionConfig as JCC

    return JCC(bits=cc.bits, bucket_size=cc.bucket_size,
               skip_incomplete_buckets=cc.skip_incomplete_buckets, stochastic=cc.stochastic)


def _jmodel(m):
    return _jp().CostModel.from_dict(m.as_dict())


def _dec(d):
    return (d.n, d.ws, d.bits, d.chunks, d.route, d.predicted_s)


def _plan_tuple(p):
    return ([[_dec(d) for d in g] for g in p.decisions], tuple(p.order), p.predicted_s, p.version,
            tuple(p.pred_components))


# ---------------------------------------------------------------------------
# GPT-2 124M's layout, from the parameter shapes alone.
# ---------------------------------------------------------------------------


def _gpt2_shapes(vocab, n_layer, d, max_seq):
    out = {"wte.embedding": (vocab, d), "wpe.embedding": (max_seq, d)}
    for i in range(n_layer):
        h = f"h_{i}"
        out.update({
            f"{h}.ln_1.scale": (d,), f"{h}.ln_1.bias": (d,),
            f"{h}.attn.attn_qkv.kernel": (d, 3 * d), f"{h}.attn.attn_qkv.bias": (3 * d,),
            f"{h}.attn.attn_proj.kernel": (d, d), f"{h}.attn.attn_proj.bias": (d,),
            f"{h}.ln_2.scale": (d,), f"{h}.ln_2.bias": (d,),
            f"{h}.mlp.mlp_in.kernel": (d, 4 * d), f"{h}.mlp.mlp_in.bias": (4 * d,),
            f"{h}.mlp.mlp_out.kernel": (4 * d, d), f"{h}.mlp.mlp_out.bias": (d,),
        })
    out.update({"ln_f.scale": (d,), "ln_f.bias": (d,)})
    return out


def test_gpt2_shapes_are_the_models():
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config

    cfg = GPT2Config.tiny(dtype=torch.float32)
    model = GPT2(cfg, device="meta")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == _gpt2_shapes(
        cfg.vocab_size, cfg.n_layer, cfg.d_model, cfg.max_seq)


def _layouts():
    """GPT-2 124M's layout in both packages (shapes only)."""
    import jax
    from torch_cgx_tpu.parallel import allreduce as jar
    from torch_cgx_tpu_torch.models import GPT2Config

    c = GPT2Config.small()
    shapes = _gpt2_shapes(c.vocab_size, c.n_layer, c.d_model, c.max_seq)
    pl = allreduce.sorted_items({n: torch.empty(s, device="meta") for n, s in shapes.items()})
    groups = allreduce._tree_layout(pl, False).groups
    jl = [(n, jax.ShapeDtypeStruct(tuple(t.shape), np.float32)) for n, t in pl]
    jgroups = jar._tree_layout(jl, None, False).groups
    assert [(g.cc.bits, g.slices) for g in groups] == [(g.cc.bits, g.slices) for g in jgroups]
    return groups, jgroups


# ---------------------------------------------------------------------------
# The cost model.
# ---------------------------------------------------------------------------


def test_cost_model_defaults_and_file_format(tmp_path):
    jp = _jp()
    m = planner.CostModel.default()
    assert m.as_dict() == jp.CostModel.default().as_dict()
    cal = dataclasses.replace(m, quantize_gbps=3.5, overlap_frac=0.25, source="cal")
    assert planner.CostModel.from_dict({**cal.as_dict(), "unknown": 1}) == cal
    assert _jmodel(cal).as_dict() == cal.as_dict()
    cal.save(str(tmp_path / "m.json"))
    assert jp.CostModel.from_dict(json.load(open(tmp_path / "m.json"))).as_dict() == cal.as_dict()


def test_cost_model_file_resolution(tmp_path, monkeypatch):
    """CGX_PLANNER_MODEL wins over the default, an in-process install over
    the file; a rewrite within one mtime tick (same mtime_ns, other size)
    is read anew; a bad or missing file gives the default."""
    path = tmp_path / "model.json"
    dataclasses.replace(planner.CostModel.default(), quantize_gbps=3.5, source="cal").save(str(path))
    monkeypatch.setenv("CGX_PLANNER_MODEL", str(path))
    assert planner.cost_model().quantize_gbps == 3.5
    planner.set_cost_model(planner.CostModel.default())
    assert planner.cost_model() == planner.CostModel.default()
    planner.set_cost_model(None)
    mtime = os.stat(path).st_mtime_ns
    dataclasses.replace(planner.CostModel.default(), quantize_gbps=12.25, source="cal2").save(str(path))
    os.utime(path, ns=(mtime, mtime))
    assert os.stat(path).st_mtime_ns == mtime
    assert planner.cost_model().quantize_gbps == 12.25
    path.write_text("{not json")
    assert planner.cost_model() == planner.CostModel.default()
    monkeypatch.setenv("CGX_PLANNER_MODEL", str(tmp_path / "missing.json"))
    assert planner.cost_model() == planner.CostModel.default()


def _write_spans(path, rows, torn=False):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        if torn:
            f.write('{"kind": "span", "torn tail')


SPANS = [
    {"kind": "meta", "rank": 0},
    {"kind": "span", "name": "codec.compress", "cat": "quantize", "t_mono": 0.0, "dur_s": 1.0,
     "elems": 5e8, "bytes": 2.5e8},
    {"kind": "span", "name": "codec.decompress", "cat": "quantize", "t_mono": 1.0, "dur_s": 0.5,
     "elems": 5e8, "bytes": 2.5e8},
    {"kind": "span", "name": "codec.sra_epilogue", "cat": "quantize", "t_mono": 2.0, "dur_s": 9.0,
     "elems": 9e9, "bytes": 9e9},
    {"kind": "span", "name": "shm.put", "cat": "wire", "t_mono": 1.0, "dur_s": 1.0, "bytes": 5e8},
    {"kind": "span", "name": "shm.take.wait", "cat": "wait", "t_mono": 2.0, "dur_s": 0.01},
    {"kind": "span", "name": "allreduce", "cat": "collective", "t_mono": 0.0, "dur_s": 1.0},
    {"kind": "span", "name": "backward", "cat": "span", "t_mono": 0.5, "dur_s": 1.0},
    {"kind": "instant", "name": "noise", "cat": "trace", "t_mono": 0.1},
]


def test_from_spans_matches_jax(tmp_path):
    """The rates from the codec spans' float32 counts (not their wire
    bytes; the epilogue spans skipped), the link from the wire spans, the
    cost a block from the mean wait span, the overlap per rank (rank 1's
    compute does not cover rank 0's collective): the JAX model's, to the
    last bit. An empty directory keeps the defaults."""
    jp = _jp()
    one = tmp_path / "one"
    one.mkdir()
    _write_spans(one / "spans-rank0.jsonl", SPANS, torn=True)
    m = planner.CostModel.from_spans(str(one))
    assert m.as_dict() == jp.CostModel.from_spans(str(one)).as_dict()
    assert (m.quantize_gbps, m.dequantize_gbps, m.wire_gbps) == (2.0, 4.0, 0.5)
    assert m.chunk_overhead_s == 0.01 and m.overlap_frac == 0.5
    assert m.source == "spans:codec+wire+overhead+overlap"
    per_rank = tmp_path / "per_rank"
    per_rank.mkdir()
    _write_spans(per_rank / "spans-rank0.jsonl", [
        {"kind": "span", "name": "ar", "cat": "collective", "t_mono": 0.0, "dur_s": 1.0},
        {"kind": "span", "name": "c", "cat": "span", "t_mono": 10.0, "dur_s": 1.0}])
    _write_spans(per_rank / "spans-rank1.jsonl", [
        {"kind": "span", "name": "c", "cat": "span", "t_mono": 0.0, "dur_s": 1.0}])
    m = planner.CostModel.from_spans(str(per_rank))
    assert m.overlap_frac == 0.0 and m.as_dict() == jp.CostModel.from_spans(str(per_rank)).as_dict()
    only_q = tmp_path / "only_q"
    only_q.mkdir()
    _write_spans(only_q / "spans-rank0.jsonl", SPANS[1:2])
    m = planner.CostModel.from_spans(str(only_q))
    assert m.dequantize_gbps == 2 * m.quantize_gbps
    assert m.as_dict() == jp.CostModel.from_spans(str(only_q)).as_dict()
    empty = tmp_path / "empty"
    empty.mkdir()
    m = planner.CostModel.from_spans(str(empty))
    assert m == dataclasses.replace(planner.CostModel.default(), source="spans:none")
    assert m.as_dict() == jp.CostModel.from_spans(str(empty)).as_dict()


def test_from_telemetry_reads_spans_and_the_autotune_memo(tmp_path, monkeypatch):
    """``CGX_METRICS_DIR``'s spans, then the autotune memo's best rate where
    the spans left the quantize rate at its default (the JAX rule), named
    in ``source``; with neither, the default model."""
    from torch_cgx_tpu_torch.ops import autotune

    assert planner.CostModel.from_telemetry() == planner.CostModel.default()
    monkeypatch.setenv("CGX_METRICS_DIR", str(tmp_path))
    _write_spans(tmp_path / "spans-rank0.jsonl", SPANS[4:5])  # the wire only
    with autotune._LOCK:
        saved = dict(autotune._MEMO)
        autotune._MEMO.clear()
        autotune._MEMO[("k",)] = autotune.TunedConfig(tc=1, gbps=123.5)
        autotune._MEMO[("k2",)] = autotune.TunedConfig(tc=1, gbps=99.0)
    try:
        m = planner.CostModel.from_telemetry()
    finally:
        with autotune._LOCK:
            autotune._MEMO.clear()
            autotune._MEMO.update(saved)
    assert (m.quantize_gbps, m.dequantize_gbps, m.wire_gbps) == (123.5, 247.0, 0.5)
    assert m.source == "spans:wire+autotune"
    assert planner.CostModel.from_telemetry(str(tmp_path)).source == "spans:wire"


MODELS = [
    planner.CostModel.default(),
    planner.CostModel(quantize_gbps=612.5, dequantize_gbps=1225.0, wire_gbps=0.75,
                      overlap_frac=0.3, chunk_overhead_s=3.5e-5, compute_s=0.05, source="card"),
]


@settings(max_examples=300, deadline=None, derandomize=True)
@given(n=st.integers(-1, 1 << 26), ws=st.integers(1, 9), bits=st.sampled_from([0, 1, 2, 3, 4, 5, 7, 8, 9, 32]),
       bucket=st.integers(0, 16384), chunks=st.integers(0, 17), mi=st.sampled_from([0, 1]))
def test_predictions_equal_jax(n, ws, bits, bucket, chunks, mi):
    """predict_slice, its components, wire_bytes and predict_step: ``==``
    to the JAX model's on the same inputs."""
    m = MODELS[mi]
    j = _jmodel(m)
    assert m.predict_slice(n, ws, bits, bucket, chunks) == j.predict_slice(n, ws, bits, bucket, chunks)
    assert m.predict_slice_components(n, ws, bits, bucket, chunks) == j.predict_slice_components(
        n, ws, bits, bucket, chunks)
    if n >= 0:
        assert m.wire_bytes(n, bits, bucket) == j.wire_bytes(n, bits, bucket)
    times = [m.predict_slice(n, ws, bits, bucket, c) for c in (1, 2, 4)]
    assert m.predict_step(times) == j.predict_step(times)
    assert m.predict_step(times, compute_s=0.01, reverse_order=False) == j.predict_step(
        times, compute_s=0.01, reverse_order=False)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(n=st.integers(0, 1 << 24), bits=st.integers(1, 8), bucket=st.integers(1, 8192),
       elem=st.sampled_from([2, 4]))
def test_wire_bytes_equals_jax(n, bits, bucket, elem):
    from torch_cgx_tpu.ops import codec as jcodec

    assert codec.wire_bytes(n, bits, bucket, elem) == jcodec.wire_bytes(n, bits, bucket, elem)


# ---------------------------------------------------------------------------
# The solve and the bit allocation.
# ---------------------------------------------------------------------------


def test_chunk_candidates_match_jax():
    jp = _jp()
    for n in (0, 1, 4096, 100_000, 1 << 20, (1 << 22) + 37, 16_777_216):
        for ws in (1, 2, 3, 4, 8):
            for bucket in (32, 128, 512, 1760):
                assert planner.chunk_candidates(n, ws, bucket) == jp.chunk_candidates(n, ws, bucket)


@pytest.mark.parametrize("overhead_s", [0.0, 100e-6, 10e-3])
def test_solve_matches_bruteforce_and_jax(overhead_s):
    """On random slice lists (compressed at several widths and buckets,
    raw ones among them) the solve equals the brute force and the JAX
    solve, decision for decision."""
    jp = _jp()
    model = dataclasses.replace(planner.CostModel.default(), chunk_overhead_s=overhead_s)
    rng = np.random.default_rng(int(overhead_s * 1e6) + 1)
    for trial in range(12):
        k = int(rng.integers(1, 5))
        slices = []
        for _ in range(k):
            n = int(rng.choice([4096, 65536, 1 << 18, 1 << 20, (1 << 22) + 511, 3_000_001]))
            bits = int(rng.choice([2, 4, 8, 32]))
            slices.append((n, _cc(bits, int(rng.choice([128, 512])))))
        ws = int(rng.choice([2, 4, 8]))
        got = planner.solve(slices, ws, model=model)
        assert [_dec(d) for d in got] == [_dec(d) for d in planner.solve_bruteforce(slices, ws, model=model)]
        want = jp.solve([(n, _jcc(cc)) for n, cc in slices], ws, model=_jmodel(model), route=planner.ROUTE)
        assert [_dec(d) for d in got] == [_dec(d) for d in want], trial
        assert all(d.chunks == 1 and d.bits == 32 for d, (_, cc) in zip(got, slices) if not cc.enabled)


def test_avg_bits_solve_on_gpt2_matches_jax():
    """GPT-2 124M's 41 fusion slices at ws 4 under a 3.5-bit budget: the
    JAX allocation (the MLP slices and the attention projection's group at
    3 bits, the first attention QKV slice at 5, the rest at 4), within the
    budget."""
    jp = _jp()
    groups, _ = _layouts()
    flat = [(ln, g.cc) for g in groups for (_o, ln) in g.slices]
    got = planner.solve(flat, 4, avg_bits=3.5)
    want = jp.solve([(n, _jcc(cc)) for n, cc in flat], 4, avg_bits=3.5, route=planner.ROUTE)
    assert [_dec(d) for d in got] == [_dec(d) for d in want]
    comp = [(d, n) for d, (n, cc) in zip(got, flat) if cc.enabled]
    assert sum(d.bits * n for d, n in comp) <= 3.5 * sum(n for _, n in comp)
    assert sorted({d.bits for d, _ in comp}) == [3, 4, 5]
    assert sum(d.bits == 3 for d, _ in comp) == 25


def test_adaptive_matches_jax(monkeypatch):
    """measure_layer_stats, solve_bit_allocation and apply_bit_allocation
    on the same seeded gradients: the JAX stats, allocation and registry
    entries; the port's registry version moves on."""
    from torch_cgx_tpu import config as jcfg
    from torch_cgx_tpu.parallel import adaptive as jad

    rng = np.random.default_rng(7)
    shapes = {"a.kernel": (64, 96), "b.kernel": (33, 50), "c.kernel": (512, 8), "d.bias": (96,),
              "e.kernel": (2, 2)}
    scales = {"a.kernel": 0.01, "b.kernel": 3.0, "c.kernel": 0.3, "d.bias": 1.0, "e.kernel": 1.0}
    g = {k: (rng.standard_normal(s) * scales[k]).astype(np.float32) for k, s in shapes.items()}
    for bucket in (None, 128):
        got = adaptive.measure_layer_stats({k: torch.from_numpy(v) for k, v in g.items()},
                                           bucket_size=bucket)
        want = jad.measure_layer_stats(g, bucket_size=bucket)
        assert set(got) == set(want) == {"a.kernel", "b.kernel", "c.kernel"}
        for k in got:
            assert got[k].numel == want[k].numel and got[k].mean_sq_range == want[k].mean_sq_range
            assert (got[k].cc.bits, got[k].cc.bucket_size) == (want[k].cc.bits, want[k].cc.bucket_size)
    for avg in (2.0, 2.5, 3.0, 4.0, 5.25, 8.0):
        for lo, hi in ((2, 8), (1, 4), (3, 3)):
            if avg < lo:
                with pytest.raises(ValueError, match="floor"):
                    adaptive.solve_bit_allocation(got, avg, bits_range=(lo, hi))
                continue
            a = adaptive.solve_bit_allocation(got, avg, bits_range=(lo, hi))
            assert a == jad.solve_bit_allocation(want, avg, bits_range=(lo, hi)), (avg, lo, hi)
    with pytest.raises(ValueError, match="bits_range"):
        adaptive.solve_bit_allocation({}, 4.0, bits_range=(0, 8))
    alloc = adaptive.solve_bit_allocation(got, 3.0)
    assert len(set(alloc.values())) > 1, alloc
    v0 = tcfg.registry_version()
    adaptive.apply_bit_allocation(alloc, got, bucket_size=256)
    assert tcfg.registry_version() == v0 + len(alloc)
    jcfg.clear_registry()
    try:
        jad.apply_bit_allocation(alloc, want, bucket_size=256)
        for k in alloc:
            p, j = tcfg.resolve_pattern_config(k), jcfg.resolve_pattern_config(k)
            assert (p.bits, p.bucket_size) == (j.bits, j.bucket_size) == (alloc[k], 256)
        assert tcfg.resolve_pattern_config("a.kernelx") is None
    finally:
        jcfg.clear_registry()
    # adapt_bits: measure, solve and apply in one call.
    tcfg.clear_registry()
    assert adaptive.adapt_bits({k: torch.from_numpy(v) for k, v in g.items()}, 3.0) == alloc


# ---------------------------------------------------------------------------
# plan_for_layout on GPT-2 124M, the plan LRU and its gates.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["default", "file"])
@pytest.mark.parametrize("avg_bits", ["", "3.5"])
@pytest.mark.parametrize("ws", [2, 4])
def test_gpt2_plan_matches_jax(tmp_path, monkeypatch, ws, avg_bits, model):
    """The port's StepPlan for GPT-2 124M (decisions, order, prediction and
    its parts) equals the JAX ``plan_for_layout``'s; with the default model
    and no budget the ws-4 plan runs 192 compressed blocks (depth 16 on the
    two 64 MB ``wte`` slices, 8 on its tail and on the attention
    projection's group, 4 on the 36 standalone dense slices), ws 2 172."""
    jp = _jp()
    monkeypatch.setenv("CGX_PLANNER", "on")
    monkeypatch.setenv("CGX_PLANNER_AVG_BITS", avg_bits)
    if model == "file":
        planner.CostModel(quantize_gbps=612.5, dequantize_gbps=1225.0, wire_gbps=3.25,
                          chunk_overhead_s=2.5e-5, overlap_frac=0.2, source="card").save(
            str(tmp_path / "m.json"))
        monkeypatch.setenv("CGX_PLANNER_MODEL", str(tmp_path / "m.json"))
    groups, jgroups = _layouts()
    got = planner.plan_for_layout(groups, ws, reduction="SRA")
    want = jp.plan_for_layout(jgroups, ws, route=planner.ROUTE, reduction="SRA")
    assert _plan_tuple(got) == _plan_tuple(want)
    assert got.order == tuple(reversed(range(len(groups))))
    if model == "default" and not avg_bits:
        decs = [d for g in got.decisions for d in g if d.bits <= 8]
        assert sum(d.chunks for d in decs) == {4: 192, 2: 172}[ws]
        if ws == 4:
            wte, tail = got.decisions[-3][0], got.decisions[-3][2]
            assert (wte.n, wte.chunks, tail.chunks) == (16_777_216, 16, 8)
            # The depth-16 wte block: ws x w is exactly the fused epilogue's gate.
            table = schedule.compiled_schedule(wte.n, 4, _cc(), chunks=wte.chunks).table
            assert {w for _, w in table} == {262_144} and 4 * 262_144 == tcfg.DEFAULT_SRA_EPILOGUE_MIN_ELEMS
            assert sorted({d.chunks for d in decs}) == [4, 8, 16]


def _one(n=1 << 22, bits=4):
    return [planner._OneGroup(cc=_cc(bits), slices=((0, n),))]


def test_plan_lru_hits_misses_invalidation_and_gates(monkeypatch):
    monkeypatch.setenv("CGX_PLANNER", "on")
    p1 = planner.plan_for_layout(_one(), 4, reduction="SRA")
    assert planner.plan_for_layout(_one(), 4, reduction="SRA") is p1
    assert planner.plan_cache_stats() == {"hits": 1, "misses": 1}
    assert planner.COUNTS["compiled"] == 1 and planner.COUNTS["cache_hits"] == 1
    tcfg.set_layer_pattern_config(r"^nothing$", _cc())  # a registry write misses
    assert planner.plan_for_layout(_one(), 4, reduction="SRA") == p1
    assert planner.plan_cache_stats()["misses"] == 2
    planner.set_cost_model(dataclasses.replace(planner.CostModel.default(), chunk_overhead_s=1.0))
    assert planner.plan_for_layout(_one(), 4, reduction="SRA").decisions[0][0].chunks == 1
    planner.set_cost_model(None)
    planner.plan_for_layout(_one(), 4, reduction="SRA")
    assert len(planner._PLAN_CACHE) == 1
    allreduce.invalidate_layout_cache()
    assert len(planner._PLAN_CACHE) == 0 and planner.plan_cache_stats() == {"hits": 0, "misses": 0}
    assert planner.COUNTS["cache_invalidations"] == 1
    # The gates: one rank, the Ring, the all-to-all, no compressed slice,
    # the dummy codec, the fake ratio.
    assert planner.plan_for_layout(_one(), 1, reduction="SRA") is None
    assert planner.plan_for_layout(_one(), 4, reduction="RING") is None
    assert planner.plan_for_layout(_one(), 4, reduction="ALLTOALL") is None
    assert planner.plan_for_layout(_one(4096, 32), 4, reduction="SRA") is None
    monkeypatch.setenv("CGX_COMPRESSION_FAKE_RATIO", "0.5")
    assert planner.plan_for_layout(_one(), 4, reduction="SRA") is None
    monkeypatch.delenv("CGX_COMPRESSION_FAKE_RATIO")
    monkeypatch.setenv("CGX_DEBUG_DUMMY_COMPRESSION", "1")
    assert planner.plan_for_layout(_one(), 4, reduction="SRA") is None
    assert len(planner._PLAN_CACHE) == 0


class _Wire(Exception):
    pass


@pytest.mark.parametrize("mode", ["auto", "off", "on"])
def test_auto_and_off_inert_on_is_engaged(monkeypatch, mode):
    """Standing in for a rank of two (every collective raises): under
    "auto" and "off" no plan is solved, the producer's table and the hook's
    depth are the unplanned ones; under "on" the tree's call solves one."""
    monkeypatch.setenv("CGX_PLANNER", mode)
    monkeypatch.setattr(group_mod, "world_size", lambda group=None: 2)
    monkeypatch.setattr(group_mod, "rank", lambda group=None: 0)
    for name in ("all_to_all_rows", "all_to_all_rows_async", "all_reduce_sum"):
        monkeypatch.setattr(group_mod, name, lambda *a, **k: (_ for _ in ()).throw(_Wire()))
    with pytest.raises(_Wire):
        allreduce.allreduce_tree({"a.kernel": torch.ones(64, 4096)})
    assert planner.COUNTS["compiled"] == (mode == "on")
    assert planner.engaged() == planner.engaged_bridge() == (mode == "on")
    assert (planner.decide_slice(1 << 22, 4, _cc(), "SRA") is None) == (mode != "on")
    assert (planner.bridge_chunks(1 << 20, BUCKET, 4, 4, 7) == 7) == (mode != "on")
    from torch_cgx_tpu_torch.ops import fused_producer

    table = fused_producer._schedule_table(_cc(), 4, 1 << 22)
    assert (table is None) == (mode != "on")


def test_cache_key_component_tracks_mode_model_and_version(monkeypatch):
    monkeypatch.setenv("CGX_PLANNER", "on")
    k1 = planner.cache_key_component()
    monkeypatch.setenv("CGX_PLANNER", "off")
    assert planner.cache_key_component() != k1
    monkeypatch.setenv("CGX_PLANNER", "on")
    planner.set_cost_model(dataclasses.replace(planner.CostModel.default(), wire_gbps=2.0))
    assert planner.cache_key_component() != k1
    planner.set_cost_model(None)
    assert planner.cache_key_component() == k1
    planner._PLAN_VERSION += 1
    assert planner.cache_key_component() != k1


@pytest.mark.parametrize("model", ["default", "file"])
def test_bridge_chunks_match_jax_planner_and_bridge(tmp_path, monkeypatch, model):
    """One port function against both JAX ones: the JAX planner's
    ``bridge_chunks`` and the JAX bridge's copy ``_plan_bridge_chunks``
    (``default`` where they answer it)."""
    from torch_cgx_tpu.torch_backend import backend as jb

    jp = _jp()
    monkeypatch.setenv("CGX_PLANNER", "on")
    if model == "file":
        planner.CostModel(quantize_gbps=300.0, dequantize_gbps=650.0, wire_gbps=0.4,
                          chunk_overhead_s=4e-5, source="card").save(str(tmp_path / "m.json"))
        monkeypatch.setenv("CGX_PLANNER_MODEL", str(tmp_path / "m.json"))
    seen = set()
    for width in (0, 512, 4096, 1344, 1 << 18, 1 << 20, 4_194_304, 1 << 23):
        for ws in (1, 2, 4, 8):
            for bits in (2, 3, 4, 8, 32):
                for bucket in (128, 512):
                    got = planner.bridge_chunks(width, bucket, ws, bits, 9)
                    assert got == jp.bridge_chunks(width, bucket, ws, bits, 9), (width, ws, bits)
                    if width > 0 and ws > 1:
                        assert got == jb._plan_bridge_chunks(width, bucket, ws, bits), (width, ws, bits)
                    seen.add(got)
    assert {1, 9} < seen and len(seen) >= 4, seen


def test_step_planner_update_is_idempotent_and_adopts(tmp_path, monkeypatch):
    monkeypatch.setenv("CGX_PLANNER", "on")
    plr = planner.StepPlanner(every=2, spans_dir=str(tmp_path))
    planner.plan_for_layout(_one(), 4, reduction="SRA")
    assert plr.update() is False and planner._PLAN_VERSION == 0
    assert len(planner._PLAN_CACHE) == 1 and planner.COUNTS["replan_noops"] == 1
    _write_spans(tmp_path / "spans-rank0.jsonl", [
        {"kind": "span", "name": "codec.compress", "cat": "quantize", "t_mono": 0.0, "dur_s": 1.0,
         "elems": 7.5e8}])
    assert plr.update() is True and planner._PLAN_VERSION == 1
    assert len(planner._PLAN_CACHE) == 0 and planner.COUNTS["replans"] == 1
    assert planner.cost_model().quantize_gbps == 3.0
    assert plr.update() is False and planner._PLAN_VERSION == 1
    assert plr.step() is False and plr.step() is True and plr.updates == 4
    # With CGX_PLANNER_MODEL every rank adopts the file's bytes.
    path = tmp_path / "m.json"
    plr.calibrate_to(str(path))
    assert planner.CostModel.from_dict(json.load(open(path))).quantize_gbps == 3.0
    dataclasses.replace(planner.CostModel.default(), wire_gbps=7.0).save(str(path))
    monkeypatch.setenv("CGX_PLANNER_MODEL", str(path))
    assert plr.update() is True and planner.cost_model().wire_gbps == 7.0
    assert plr.update() is False and planner._PLAN_VERSION == 2
    with pytest.raises(ValueError, match="every"):
        planner.StepPlanner(every=-1)


def test_refusals(monkeypatch):
    """``StepPlanner(avg_bits=)`` names the wire plane's controller (A11);
    ``CGX_MEMLEDGER`` under the planner names the knobs, at the plan; the
    JAX package's knob validation of ``CGX_PLANNER_AVG_BITS``."""
    from torch_cgx_tpu import config as jcfg

    with pytest.raises(NotImplementedError, match="A11"):
        planner.StepPlanner(avg_bits=4)
    monkeypatch.setenv("CGX_PLANNER", "on")
    monkeypatch.setenv("CGX_MEMLEDGER", "1")
    with pytest.raises(NotImplementedError, match="CGX_PLANNER=on with CGX_MEMLEDGER"):
        planner.plan_for_layout(_one(), 4, reduction="SRA")
    with pytest.raises(NotImplementedError, match="CGX_MEMLEDGER"):
        planner.decide_slice(1 << 22, 4, _cc(), "SRA")
    monkeypatch.setenv("CGX_MEMLEDGER", "0")
    assert planner.plan_for_layout(_one(), 4, reduction="SRA") is not None
    for raw in ("0", "1", "3.5", "8", "0.5", "9", "x"):
        monkeypatch.setenv("CGX_PLANNER_AVG_BITS", raw)
        try:
            want = jcfg.planner_avg_bits()
        except ValueError:
            with pytest.raises(ValueError, match="CGX_PLANNER_AVG_BITS"):
                tcfg.planner_avg_bits()
            continue
        assert tcfg.planner_avg_bits() == want


# ---------------------------------------------------------------------------
# The producer's per-block payloads under the planner against JAX.
# ---------------------------------------------------------------------------


def test_producer_block_payloads_match_jax(tmp_path, monkeypatch):
    """Under ``CGX_PLANNER=on`` (the schedule knob unset) with a model file
    that pipelines, the JAX ``_maybe_stash`` (inside ``shard_map`` over 2
    CPU devices) and the port's backward stage the same table, at the
    planner's depth for the layer's slice, and per block the same payload
    bytes and raw own row, on integer operands (exact products)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.ops import fused_producer as jfp
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu_torch.ops import fused_producer as fp

    ws, din, o, k = 2, 64, 256, 16
    path = tmp_path / "m.json"
    dataclasses.replace(planner.CostModel.default(), **DEEP_MODEL).save(str(path))
    for key, v in {"CGX_PLANNER": "on", "CGX_PLANNER_MODEL": str(path),
                   "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "4096",
                   "CGX_PRODUCER_FUSE": "on"}.items():
        monkeypatch.setenv(key, v)
    rng = np.random.default_rng(5)
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
    cc = _cc(4, 128)
    table = fp._schedule_table(cc, ws, din * o)
    assert table == captured["table"] and len(table) == 16, table
    assert schedule.engaged() is False  # the planner's depth, not CGX_SCHEDULE's
    for r in range(ws):
        dw = torch.from_numpy(x[r]).t() @ torch.from_numpy(g[r])
        blocks, raw_row = fp._block_payloads(dw, cc, ws=ws, div=ws, own=r, table=table)
        for c, q in enumerate(blocks):
            np.testing.assert_array_equal(q.packed.numpy().view(np.uint32), packed[c][r], err_msg=f"{r} {c}")
            np.testing.assert_array_equal(q.meta.numpy(), meta[c][r], err_msg=f"{r} {c}")
        np.testing.assert_array_equal(raw_row.numpy(), raw[r])


# ---------------------------------------------------------------------------
# The gloo worlds.
# ---------------------------------------------------------------------------


TREE_SHAPES = {"a.kernel": (64, 512), "b.kernel": (96, 256), "c.kernel": (48, 64), "c.bias": (64,),
               "d.kernel": (256, 520)}
TREE_ENV = {"CGX_COMPRESSION_QUANTIZATION_BITS": "4", "CGX_COMPRESSION_BUCKET_SIZE": "128",
            "CGX_STANDALONE_LAYER_ELEMS": "16384"}


def _tree(rank):
    rng = np.random.default_rng(200 + rank)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in TREE_SHAPES.items()}


def _bits(t):
    return t.detach().contiguous().view(torch.int32).numpy().copy()


def _gpt2_runs(rank):
    """Two steps of a tiny float32 GPT-2 under the planner off and on (the
    model file), plain and with producer fusion."""
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.ops import fused_producer
    from torch_cgx_tpu_torch.parallel import make_train_step

    runs = {"plain": ({}, {}),
            "producer": ({"CGX_PRODUCER_FUSE": "on", "CGX_STANDALONE_LAYER_ELEMS": "32768"}, {})}
    tokens = torch.from_numpy(np.random.default_rng(rank).integers(0, 512, size=(2, 32)))
    out = {}
    for name, (knobs, kw) in runs.items():
        for mode in ("off", "on"):
            os.environ.update({"CGX_PLANNER": mode, **knobs})
            schedule.reset_counts()
            planner.reset_counts()
            fused_producer.reset_counts()
            model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                         generator=torch.Generator().manual_seed(0))
            step = make_train_step(model, lambda m, b: lm_loss(m(b), b),
                                   torch.optim.Adam(model.parameters(), lr=1e-3), device="cpu", **kw)
            losses = [float(step(tokens)) for _ in range(GPT2_STEPS)]
            out[(name, mode)] = {"losses": losses, "params": {n: _bits(p) for n, p in model.named_parameters()},
                                 "sched": dict(schedule.COUNTS), "plan": dict(planner.COUNTS),
                                 "producer": dict(fused_producer.COUNTS)}
            for k in knobs:
                del os.environ[k]
    del os.environ["CGX_PLANNER"]
    return out


def _rank_main(rank, ws, init_file, model_path, result_q):
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=ws,
                                timeout=timedelta(seconds=120))
        os.environ.update(TREE_ENV)
        tree = _tree(rank)
        mono = allreduce.allreduce_tree(tree, average=True)
        os.environ.update({"CGX_PLANNER": "on", "CGX_PLANNER_MODEL": model_path})
        schedule.reset_counts()
        planned = allreduce.allreduce_tree(tree, average=True)
        groups = allreduce._tree_layout(allreduce.sorted_items(tree), False).groups
        plan = planner.plan_for_layout(groups, ws, reduction="SRA")
        out["tree"] = {
            "same": {k: bool(np.array_equal(_bits(planned[k]), _bits(mono[k]))) for k in tree},
            "keys": list(planned) == list(mono), "sched": dict(schedule.COUNTS),
            "plan": [[(d.n, d.bits, d.chunks, d.predicted_s) for d in g] for g in plan.decisions],
            "order": plan.order,
        }
        # Under a bit budget each group equals the unplanned SRA of its
        # fused buffer at its planned width.
        os.environ["CGX_PLANNER_AVG_BITS"] = "3.5"
        planned = allreduce.allreduce_tree(tree)
        plan = planner.plan_for_layout(groups, ws, reduction="SRA")
        del os.environ["CGX_PLANNER"], os.environ["CGX_PLANNER_AVG_BITS"]
        same, bits = {}, []
        pl = allreduce.sorted_items(tree)
        for g, decs in zip(groups, plan.decisions):
            fused = torch.cat([pl[i][1].reshape(-1) for i in g.indices])
            bits.append([d.bits for d in decs])
            if g.cc.enabled:
                ref = allreduce.allreduce_flat(fused, allreduce.planned_config(g.cc, decs[0]))
            else:
                ref = allreduce.group_mod.all_reduce_sum(fused.clone(), None)
            got = torch.cat([planned[pl[i][0]].reshape(-1) for i in g.indices])
            same[tuple(pl[i][0] for i in g.indices)] = bool(np.array_equal(_bits(got), _bits(ref)))
        out["bits"] = {"same": same, "bits": bits}
        del os.environ["CGX_PLANNER_MODEL"]
        if ws == 2:
            os.environ["CGX_PLANNER_MODEL"] = model_path
            out["gpt2"] = _gpt2_runs(rank)
        dist.barrier()
    except Exception:
        import traceback

        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put(((ws, rank), out))


WORLD_SIZES = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds spawned at once: ws -> results by rank."""
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    tmp = tmp_path_factory.mktemp("planner")
    model_path = str(tmp / "model.json")
    dataclasses.replace(planner.CostModel.default(), **DEEP_MODEL).save(model_path)
    procs = []
    for ws in WORLD_SIZES:
        init_file = str(tmp / f"store_ws{ws}")
        procs += [ctx.Process(target=_rank_main, args=(r, ws, init_file, model_path, result_q), daemon=True)
                  for r in range(ws)]
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
    return {ws: [results[(ws, r)] for r in range(ws)] for ws in WORLD_SIZES}


def _jax_tree_plan(ws, model_path, avg_bits=""):
    """The JAX plan of the worlds' tree layout under the same knobs."""
    import jax
    from torch_cgx_tpu.parallel import allreduce as jar

    jp = _jp()
    env = dict(os.environ)
    try:
        os.environ.update({**TREE_ENV, "CGX_PLANNER": "on", "CGX_PLANNER_MODEL": model_path,
                           "CGX_PLANNER_AVG_BITS": avg_bits})
        jl = [(n, jax.ShapeDtypeStruct(s, np.float32)) for n, s in
              allreduce.sorted_items(TREE_SHAPES)]
        groups = jar._tree_layout(jl, None, False).groups
        return jp.plan_for_layout(groups, ws, route=planner.ROUTE, reduction="SRA")
    finally:
        os.environ.clear()
        os.environ.update(env)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_planned_tree_equals_monolithic_and_jax_plan(worlds, tmp_path, ws):
    """allreduce_tree under CGX_PLANNER=on (every compressed slice
    pipelined as deep as its row allows) equals the unplanned SRA bit for
    bit on random data, on every rank, keys in group order; its plan is the
    JAX plan of the same layout."""
    path = str(tmp_path / "m.json")
    dataclasses.replace(planner.CostModel.default(), **DEEP_MODEL).save(path)
    want = _jax_tree_plan(ws, path)
    for r, o in enumerate(worlds[ws]):
        t = o["tree"]
        assert all(t["same"].values()) and t["keys"], (r, t["same"])
        assert t["plan"] == [[(d.n, d.bits, d.chunks, d.predicted_s) for d in g] for g in want.decisions]
        assert t["order"] == want.order
        deep = sum(d.chunks for g in want.decisions for d in g if d.chunks > 1)
        assert t["sched"]["blocks"] == deep > 0, (t["sched"], deep)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_avg_bits_groups_equal_the_sra_at_their_width(worlds, tmp_path, ws):
    """Under CGX_PLANNER_AVG_BITS=3.5 each group equals the unplanned SRA of
    its buffer at the width the plan gave it, and the widths are JAX's
    (not all the resolved 4)."""
    path = str(tmp_path / "m.json")
    dataclasses.replace(planner.CostModel.default(), **DEEP_MODEL).save(path)
    want = _jax_tree_plan(ws, path, "3.5")
    for r, o in enumerate(worlds[ws]):
        b = o["bits"]
        assert all(b["same"].values()), (r, b["same"])
        assert b["bits"] == [[d.bits for d in g] for g in want.decisions]
    flat = {x for g in worlds[ws][0]["bits"]["bits"] for x in g if x <= 8}
    assert len(flat) > 1, flat


@pytest.mark.parametrize("run", ["plain", "producer"])
def test_gpt2_train_step_on_equals_off(worlds, run):
    """The tiny GPT-2 on the 2-rank world: under the planner it planned and
    pipelined, and equals ``off`` bit for bit; under producer fusion the
    per-block payloads of every standalone layer were consumed (its ``dw``
    kept), none fell back."""
    for r, res in enumerate(worlds[2]):
        on, off = res["gpt2"][(run, "on")], res["gpt2"][(run, "off")]
        assert on["sched"]["pipelined_slices"] > 0 and off["sched"]["pipelined_slices"] == 0
        assert on["plan"]["compiled"] + on["plan"]["cache_hits"] >= 1
        assert off["plan"]["compiled"] + off["plan"]["cache_hits"] == 0
        assert on["losses"] == off["losses"], (r, on["losses"], off["losses"])
        for p, v in off["params"].items():
            np.testing.assert_array_equal(on["params"][p], v, err_msg=f"{run} rank {r} {p}")
        if run == "producer":
            pc = on["producer"]
            assert pc["producer_consumed_slices"] == pc["producer_staged"] == 3 * 2 * GPT2_STEPS, pc
            assert pc["producer_dw_skipped"] == pc["producer_kernel_slices"] == 0, pc
            assert pc["producer_fallback_plan"] == 0, pc
