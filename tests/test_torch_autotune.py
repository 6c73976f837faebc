"""The port's codec autotuner (``torch_cgx_tpu_torch.ops.autotune``).

The semantics of the JAX package's ``tests/test_autotune.py`` (miss, hit,
persistence across ``invalidate``, mode ``off``, a corrupt file tolerated,
``tune`` skipping candidates that raise, encode-era keys,
``snap_to_divisor``, ``_use_db`` under on/off/auto), then parity with the
JAX package: a cache document written by either package loads in the
other as the same ``TunedConfig``s, and for the same layouts and an empty
cache the port's batch functions on CPU tensors look up the same keys as
``codec_pallas``'s in interpret mode.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cgx_tpu.ops import autotune as jautotune
from torch_cgx_tpu.ops import codec_pallas
from torch_cgx_tpu_torch.ops import autotune, codec_cuda


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("CGX_AUTOTUNE_DIR", str(tmp_path))
    for k in ("CGX_AUTOTUNE", "CGX_PALLAS_DB", "CGX_PALLAS_TILE_CHUNKS", "CGX_PALLAS_PACK",
              "CGX_CODEC_ENCODE"):
        monkeypatch.delenv(k, raising=False)
    autotune.invalidate("test setup")
    jautotune.invalidate("test setup")
    yield tmp_path
    autotune.invalidate("test teardown")
    jautotune.invalidate("test teardown")


def _flat(n_chunks=64, **kw):
    return autotune.lookup(autotune.KIND_FLAT, n_chunks=n_chunks, bucket_size=512, bits=4, **kw)


def test_lookup_miss_counts_and_returns_none():
    assert _flat() is None
    s = autotune.stats()
    assert s["misses"] == 1 and s["hits"] == 0


def test_record_then_hit():
    autotune.record(autotune.KIND_FLAT, autotune.TunedConfig(tc=4, pack="sum", db=True),
                    n_chunks=64, bucket_size=512, bits=4)
    hit = _flat()
    assert hit == autotune.TunedConfig(tc=4, pack="sum", db=True)
    assert autotune.stats()["hits"] == 1
    assert _flat(n_chunks=128) is None  # another shape, another key


def test_persistence_across_invalidation():
    autotune.record(autotune.KIND_EPILOGUE, autotune.TunedConfig(tc=2, db=True),
                    n_chunks=8, bucket_size=512, bits=4, ws=4)
    path = autotune.cache_path()
    assert path.exists() and path.name == "autotune-cpu.json"
    autotune.invalidate("simulated restart")
    assert autotune.stats() == {"hits": 0, "misses": 0, "loads": 0, "tuned": 0}
    hit = autotune.lookup(autotune.KIND_EPILOGUE, n_chunks=8, bucket_size=512, bits=4, ws=4)
    assert hit is not None and hit.tc == 2 and hit.db is True
    assert autotune.stats()["loads"] == 1


def test_record_without_persist_lives_in_the_memo_only():
    autotune.record(autotune.KIND_FLAT, autotune.TunedConfig(tc=8),
                    n_chunks=64, bucket_size=512, bits=4, persist=False)
    assert _flat() is not None
    assert not autotune.cache_path().exists()
    autotune.invalidate("drop")
    assert _flat() is None


def test_mode_off_never_consults(monkeypatch):
    autotune.record(autotune.KIND_FLAT, autotune.TunedConfig(tc=4),
                    n_chunks=64, bucket_size=512, bits=4)
    monkeypatch.setenv("CGX_AUTOTUNE", "off")
    assert _flat() is None
    assert autotune.tune(autotune.KIND_FLAT, [autotune.TunedConfig(tc=1)], lambda c: 1.0,
                         n_chunks=64, bucket_size=512, bits=4) is None


def test_corrupt_cache_file_tolerated():
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text("{not json")
    assert _flat() is None  # no raise
    autotune.invalidate("reset")
    doc = {"entries": {"flat/c64/b512/q4/w0/ediv": {"tc": 4}, "garbage": {"tc": "x"},
                       "flat/c65/b512/q4/w0/ediv": {"tc": 0}}}
    autotune.cache_path().write_text(json.dumps(doc))
    hit = _flat()
    assert hit is not None and hit.tc == 4
    assert _flat(n_chunks=65) is None  # tc < 1 is dropped


def test_tune_skips_failing_candidates():
    def measure(cand):
        if cand.tc == 8:
            raise RuntimeError("launch refused")
        return 0.5 if cand.tc == 4 else 1.0

    win = autotune.tune(
        autotune.KIND_CHUNKS, [autotune.TunedConfig(tc=t) for t in (2, 4, 8)], measure,
        n_chunks=64, bucket_size=512, bits=4, input_bytes=10**9,
    )
    assert win is not None and win.tc == 4 and win.gbps == pytest.approx(2.0)
    assert autotune.lookup(autotune.KIND_CHUNKS, n_chunks=64, bucket_size=512, bits=4).tc == 4
    assert autotune.stats()["tuned"] == 1

    def fail(cand):
        raise RuntimeError("every candidate fails")

    assert autotune.tune(autotune.KIND_CHUNKS, [autotune.TunedConfig(tc=1)], fail,
                         n_chunks=32, bucket_size=512, bits=4) is None


def test_env_fingerprint_separates_encode_eras(monkeypatch):
    autotune.record(autotune.KIND_FLAT, autotune.TunedConfig(tc=4),
                    n_chunks=64, bucket_size=512, bits=4)
    monkeypatch.setenv("CGX_CODEC_ENCODE", "mul")
    assert _flat() is None


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="autotune kind"):
        autotune.lookup("grid", n_chunks=1, bucket_size=512)


@pytest.mark.parametrize("tc,n,cap,want", [(16, 48, 64, 16), (10, 48, 64, 8), (100, 48, 7, 6),
                                           (0, 48, 64, 1), (5, 7, 64, 1)])
def test_snap_to_divisor(tc, n, cap, want):
    assert autotune.snap_to_divisor(tc, n, cap) == want
    assert jautotune.snap_to_divisor(tc, n, cap) == want


def test_use_db_modes(monkeypatch):
    assert not codec_cuda._use_db(None)
    assert codec_cuda._use_db(autotune.TunedConfig(tc=4, db=True))
    assert not codec_cuda._use_db(autotune.TunedConfig(tc=4, db=False))
    monkeypatch.setenv("CGX_PALLAS_DB", "off")
    assert not codec_cuda._use_db(autotune.TunedConfig(tc=4, db=True))
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    assert codec_cuda._use_db(None)
    # The JAX package's rule, knob for knob.
    for mode in ("on", "off", "auto"):
        monkeypatch.setenv("CGX_PALLAS_DB", mode)
        for tuned in (None, (4, True), (4, False)):
            want = codec_pallas._use_db(None if tuned is None else jautotune.TunedConfig(*tuned[:1], db=tuned[1]))
            got = codec_cuda._use_db(None if tuned is None else autotune.TunedConfig(*tuned[:1], db=tuned[1]))
            assert got == want, (mode, tuned)


def test_tile_chunks_tiers(monkeypatch):
    """The override beats the tuned entry, which beats the heuristic; all
    are capped by the slots a block's shared memory holds and snapped to a
    divisor of the chunk count."""
    tuned = autotune.TunedConfig(tc=3)
    assert codec_cuda._pipe_tc(12, 7, None) == 1  # one chunk a slot: every SM gets tiles
    assert codec_cuda._pipe_tc(12, 7, tuned) == 3
    assert codec_cuda._pipe_tc(12, 7, autotune.TunedConfig(tc=5)) == 4
    assert codec_cuda._pipe_tc(12, 7, autotune.TunedConfig(tc=40)) == 6
    monkeypatch.setenv("CGX_PALLAS_TILE_CHUNKS", "4")
    assert codec_cuda._pipe_tc(12, 7, tuned) == 4
    assert codec_cuda._pipe_tc(12, 2, tuned) == 2
    assert codec_cuda._tile_chunks(3, 7, tuned) == 3


# ---------------------------------------------------------------------------
# Parity with the JAX package.
# ---------------------------------------------------------------------------

ENTRIES = [
    (autotune.KIND_FLAT, dict(tc=2, db=True), dict(n_chunks=8, bucket_size=512, bits=4)),
    (autotune.KIND_CHUNKS, dict(tc=4, pack="sum"), dict(n_chunks=12, bucket_size=96, bits=2)),
    (autotune.KIND_EPILOGUE, dict(tc=1, db=False, gbps=12.5), dict(n_chunks=4, bucket_size=128,
                                                                 bits=8, ws=4)),
]


def test_cache_document_written_by_jax_loads_in_the_port(monkeypatch):
    monkeypatch.setattr(jautotune, "_chip_slug", autotune._chip_slug)
    for kind, cfg, key in ENTRIES:
        jautotune.record(kind, jautotune.TunedConfig(**cfg), **key)
    assert jautotune.cache_path() == autotune.cache_path()
    for kind, cfg, key in ENTRIES:
        assert autotune.lookup(kind, **key) == autotune.TunedConfig(**cfg)


def test_cache_document_written_by_the_port_loads_in_jax(monkeypatch):
    monkeypatch.setattr(jautotune, "_chip_slug", autotune._chip_slug)
    for kind, cfg, key in ENTRIES:
        autotune.record(kind, autotune.TunedConfig(**cfg), **key)
    doc = json.loads(autotune.cache_path().read_text())
    assert doc["chip"] == "cpu" and "flat/c8/b512/q4/w0/ediv" in doc["entries"]
    for kind, cfg, key in ENTRIES:
        assert jautotune.lookup(kind, **key) == jautotune.TunedConfig(**cfg)


LAYOUTS = {
    "flat": (2, 4 * 32 * 512, 4, 512),  # both packages' flat path: kind "flat"
    "tail": (1, 32 * 512 + 5 * 512 + 100, 4, 512),  # chunks and a dense tail: kind "chunks"
    "bucket96": (2, 2 * 32 * 96, 3, 96),  # whole chunks of non-128 buckets: kind "chunks"
    "small": (1, 5 * 128, 2, 128),  # a tail only: no lookup
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_batch_functions_look_up_as_jax_does(layout, monkeypatch):
    """Same layout, empty cache: the port's quantize and dequantize batch
    functions (with and without an accumulator) count the lookups the JAX
    package's count, and under CGX_PALLAS_DB=on give the same bytes."""
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    rows, m, bits, b = LAYOUTS[layout]
    rng = np.random.default_rng(m)
    x = rng.standard_normal((rows, m)).astype(np.float32)
    acc = rng.standard_normal((rows, m)).astype(np.float32)
    jq = codec_pallas.quantize_batch(jnp.asarray(x), bits, b, interpret=True)
    codec_pallas.dequantize_batch(jq, interpret=True)
    codec_pallas.dequantize_batch(jq, add_to=jnp.asarray(acc), interpret=True)
    q = codec_cuda.quantize_batch(torch.from_numpy(x), bits, b)
    codec_cuda.dequantize_batch(q)
    codec_cuda.dequantize_batch(q, add_to=torch.from_numpy(acc))
    want = {k: v for k, v in jautotune.stats().items()}
    assert autotune.stats() == want
    assert want["misses"] == (0 if layout == "small" else 3)
    np.testing.assert_array_equal(np.asarray(jq.packed).view(np.int32), q.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jq.meta), q.meta.numpy())


@pytest.mark.parametrize("own", [None, 1])
def test_epilogue_and_reduce_look_up_as_jax_does(own):
    ws, bits, b = 4, 4, 128
    x = np.random.default_rng(7).standard_normal((ws, 3 * 32 * b)).astype(np.float32)
    jq = codec_pallas.quantize_batch(jnp.asarray(x), bits, b, interpret=True)
    q = codec_cuda.quantize_batch(torch.from_numpy(x), bits, b)
    jraw = None if own is None else jnp.asarray(x[own])
    raw = None if own is None else torch.from_numpy(x[own])
    jown = None if own is None else jnp.int32(own)
    codec_pallas.sra_epilogue_batch(jq, raw_row=jraw, own_idx=jown, interpret=True)
    codec_pallas.reduce_rows_batch(jq, raw_row=jraw, own_idx=jown, interpret=True)
    codec_cuda.sra_epilogue_batch(q, raw_row=raw, own_idx=own)
    codec_cuda.reduce_rows_batch(q, raw_row=raw, own_idx=own)
    assert autotune.stats() == jautotune.stats()
    assert autotune.stats()["misses"] == 3  # the stage-1 quantize, the epilogue, the reduce
