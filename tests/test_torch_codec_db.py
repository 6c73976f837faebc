"""The port's pipelined (``CGX_PALLAS_DB``) codec path against the JAX
package's double-buffered kernels (B7a-c) in interpret mode, on the CPU.

On the CPU a pipelined wrapper runs its plain version (the single-stage
one: the kernels give the same bytes), so these tests hold the routing and
the glue around the kernels to the JAX package: under ``CGX_PALLAS_DB=on``
the quantize words and meta byte for byte at bits {1, 4, 8}, buckets {128,
512}, 2 rows x 4 chunks; the dequantize bit for bit with and without the
fused add (on decode-exact data: in interpret mode XLA fuses the decode's
multiply-add, which moves random data by up to one ulp); the epilogue at
ws 4, own 1 byte for byte (decode-exact rows). Then the routing itself:
``db_would_run`` under on/off/auto and a recorded entry, the geometry
gate where B7b's ring does not fit (ROADMAP C7) and B7a's and B7c's old
gates, which now run pipelined, the knobs' errors, and a tiny GPT-2 step
under ``CGX_PALLAS_DB=on`` bit-identical to ``off``.

The kernels themselves run only on the card: ``test_torch_kernels.py``
(marker ``cuda``) and ``chip_smoke.py`` hold them to their plain versions
and to the single-stage kernels there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cgx_tpu.ops import codec_pallas
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
from torch_cgx_tpu_torch.ops import autotune, codec, codec_cuda, dispatch
from torch_cgx_tpu_torch.parallel import make_train_step


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("CGX_AUTOTUNE_DIR", str(tmp_path))
    for k in ("CGX_PALLAS_DB", "CGX_AUTOTUNE", "CGX_PALLAS_TILE_CHUNKS", "CGX_PALLAS_PACK",
              "CGX_SRA_EPILOGUE", "CGX_SRA_EPILOGUE_MIN_ELEMS"):
        monkeypatch.delenv(k, raising=False)
    autotune.invalidate("test setup")
    codec_cuda.reset_launch_counts()
    yield
    autotune.invalidate("test teardown")


def _exact_rows(rows: int, n: int, bits: int, seed: int) -> np.ndarray:
    """Integer levels 0..2^bits-1 with both ends in every 32-value group
    (so in every bucket): each unit is exactly 1 and every decode, sum and
    fused multiply-add exact."""
    top = (1 << bits) - 1
    x = np.random.default_rng(seed).integers(0, top + 1, (rows, n)).astype(np.float32)
    x[:, ::32] = 0
    x[:, 1::32] = top
    return x


CASES = [(bits, b) for bits in (1, 4, 8) for b in (128, 512)]


@pytest.mark.parametrize("bits,bucket", CASES)
def test_quantize_db_matches_jax_db_kernel(bits, bucket, monkeypatch):
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    x = np.random.default_rng(bits + bucket).standard_normal((2, 4 * 32 * bucket)).astype(np.float32)
    jq = codec_pallas.quantize_batch(jnp.asarray(x), bits, bucket, interpret=True)
    q = codec_cuda.quantize_batch(torch.from_numpy(x), bits, bucket)
    assert dispatch.db_would_run(q, "quantize")
    np.testing.assert_array_equal(np.asarray(jq.packed).view(np.int32), q.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jq.meta).view(np.uint32), q.meta.numpy().view(np.uint32))


@pytest.mark.parametrize("bits,bucket", CASES)
def test_dequantize_db_matches_jax_db_kernel(bits, bucket, monkeypatch):
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    n = 4 * 32 * bucket
    x = _exact_rows(2, n, bits, bits * bucket)
    acc = np.random.default_rng(bits).integers(-50, 50, (2, n)).astype(np.float32)
    jq = codec_pallas.quantize_batch(jnp.asarray(x), bits, bucket, interpret=True)
    q = codec_cuda.quantize_batch(torch.from_numpy(x), bits, bucket)
    for add in (None, acc):
        jy = codec_pallas.dequantize_batch(
            jq, add_to=None if add is None else jnp.asarray(add), interpret=True
        )
        y = codec_cuda.dequantize_batch(q, add_to=None if add is None else torch.from_numpy(add))
        assert dispatch.db_would_run(q, "dequantize", with_add=add is not None)
        np.testing.assert_array_equal(np.asarray(jy).view(np.uint32), y.numpy().view(np.uint32))
        np.testing.assert_array_equal(y.numpy(), x if add is None else x + add)


@pytest.mark.parametrize("bits,bucket", [(4, 128), (4, 512), (8, 128)])
def test_epilogue_db_matches_jax_db_kernel(bits, bucket, monkeypatch):
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    ws, own = 4, 1
    x = _exact_rows(ws, 2 * 32 * bucket, bits, bucket)
    jq = codec_pallas.quantize_batch(jnp.asarray(x), bits, bucket, interpret=True)
    jout = codec_pallas.sra_epilogue_batch(
        jq, raw_row=jnp.asarray(x[own]), own_idx=jnp.int32(own), interpret=True
    )
    cc = CompressionConfig(bits=bits, bucket_size=bucket)
    q = dispatch.quantize_batch(torch.from_numpy(x), cc)
    assert dispatch.db_would_run(q, "epilogue")
    out = dispatch.reduce_rows_requantize(q, cc, raw_rows=torch.from_numpy(x), own_idx=own)
    np.testing.assert_array_equal(np.asarray(jout.packed).view(np.int32), out.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jout.meta), out.meta.numpy())
    monkeypatch.setenv("CGX_PALLAS_DB", "off")
    single = dispatch.reduce_rows_requantize(q, cc, raw_rows=torch.from_numpy(x), own_idx=own)
    assert torch.equal(single.packed, out.packed) and torch.equal(single.meta, out.meta)


def _layout(rows: int, n: int, bits: int = 4, bucket: int = 512) -> codec.QTensor:
    nb = codec.num_buckets(n, bucket)
    return codec.QTensor(
        packed=torch.empty((rows, 0), dtype=torch.int32), meta=torch.empty((rows, nb, 2)),
        residual=torch.empty((rows, 0)), numel=n, bits=bits, bucket_size=bucket,
        dtype=torch.float32,
    )


def test_db_would_run_follows_the_knob_and_the_cache(monkeypatch):
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    q = _layout(2, 4 * 32 * 512)
    kernels = ("quantize", "dequantize", "epilogue")
    assert not any(dispatch.db_would_run(q, k) for k in kernels)  # auto, empty cache
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    assert all(dispatch.db_would_run(q, k) for k in kernels)
    monkeypatch.setenv("CGX_PALLAS_DB", "off")
    assert not any(dispatch.db_would_run(q, k) for k in kernels)
    monkeypatch.setenv("CGX_PALLAS_DB", "auto")
    autotune.record(autotune.KIND_FLAT, autotune.TunedConfig(tc=2, db=True),
                    n_chunks=8, bucket_size=512, bits=4)
    autotune.record(autotune.KIND_EPILOGUE, autotune.TunedConfig(tc=1, db=False),
                    n_chunks=4, bucket_size=512, bits=4, ws=2)
    assert dispatch.db_would_run(q, "quantize") and dispatch.db_would_run(q, "dequantize")
    assert not dispatch.db_would_run(q, "epilogue")
    # A different shape has no entry; the tail and non-128 geometries never
    # take a pipelined kernel.
    assert not dispatch.db_would_run(_layout(1, 4 * 32 * 512), "quantize")
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    assert not dispatch.db_would_run(_layout(2, 4 * 32 * 512 + 512), "quantize")
    assert not dispatch.db_would_run(_layout(2, 4 * 32 * 96, bucket=96), "dequantize")
    # The batch functions route as the predicate says and count nothing
    # on the CPU (the plain versions ran).
    monkeypatch.setenv("CGX_PALLAS_DB", "auto")
    autotune.record(autotune.KIND_FLAT, autotune.TunedConfig(tc=2, db=True),
                    n_chunks=8, bucket_size=128, bits=4)
    x = torch.randn(2, 4 * 32 * 128)
    calls = []
    monkeypatch.setattr(codec_cuda, "quantize_chunks_db",
                        lambda *a, **kw: calls.append(a[3]) or codec_cuda.quantize_chunks_plain(*a[:3]))
    codec_cuda.quantize_batch(x, 4, 128)
    # The tuned tile within the cap: 8 chunks over the clusters the card
    # holds at once (hundreds) leave one chunk a tile; over four clusters,
    # two.
    monkeypatch.setattr(codec_cuda, "db_clusters", lambda *a, **kw: 4)
    codec_cuda.quantize_batch(x, 4, 128)
    assert calls == [1, 2]
    assert all(v == 0 for v in codec_cuda.LAUNCHES.values())


@pytest.mark.parametrize("kernel,bits,bucket,add,gated", [
    ("quantize", 4, 1024, False, False),  # B7a's old gate: a share slot holds it now
    ("dequantize", 8, 1024, True, True),  # two slots of words, meta and accumulator do not fit
    ("epilogue", 4, 1536, False, False),  # B7c's old gate: share slots hold it now
])
def test_geometry_gate_runs_the_single_stage_kernel(kernel, bits, bucket, add, gated, monkeypatch):
    """Where a pipelined kernel's shared memory does not fit, CGX_PALLAS_DB=on
    still runs the single-stage kernel (same bytes) and the event is
    counted: ROADMAP C7. B7a and B7c stream a CTA's share of a chunk, so
    the shapes their whole-chunk rings could not hold (B7a at B >= 1024,
    B7c at 4 bits and B >= 1280) now take the pipelined kernel, and nothing
    is gated."""
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    rows = 2
    cap = codec_cuda.db_tc_cap(kernel, bits, bucket, with_add=add, chunks=rows)
    assert (cap == 0) == gated
    x = torch.from_numpy(_exact_rows(rows, 32 * bucket, bits, bucket))
    cc = CompressionConfig(bits=bits, bucket_size=bucket)
    q = dispatch.quantize_batch(x, cc)
    assert dispatch.db_would_run(q, kernel, with_add=add) != gated
    wrapper = {"quantize": "quantize_chunks_db", "dequantize": "dequantize_chunks_db",
               "epilogue": "sra_epilogue_chunks_db"}[kernel]
    calls = []
    real = getattr(codec_cuda, wrapper)
    monkeypatch.setattr(codec_cuda, wrapper, lambda *a, **kw: calls.append(a) or real(*a, **kw))
    codec_cuda.reset_launch_counts()
    if kernel == "quantize":
        got = dispatch.quantize_batch(x, cc)
        assert torch.equal(got.packed, q.packed) and torch.equal(got.meta, q.meta)
    elif kernel == "dequantize":
        y = dispatch.dequantize_batch(q, add_to=x)
        assert torch.equal(y, x + x)
    else:
        assert dispatch.fused_epilogue_would_run(q)
        dispatch.reduce_rows_requantize(q, cc, raw_rows=x, own_idx=0)
    assert codec_cuda.DB_GATED == {k: int(gated and k == kernel) for k in codec_cuda.DB_GATED}
    assert len(calls) == int(not gated)
    if gated:  # one size down, the ring fits and nothing is gated
        assert codec_cuda.db_tc_cap(kernel, bits, bucket // 2, with_add=add) >= 1


@pytest.mark.parametrize("knob,value", [
    ("CGX_PALLAS_DB", "2"), ("CGX_AUTOTUNE", "maybe"), ("CGX_PALLAS_TILE_CHUNKS", "0"),
    ("CGX_PALLAS_TILE_CHUNKS", "x"), ("CGX_PALLAS_PACK", "zigzag"),
])
def test_bad_knobs_raise_naming_the_knob(knob, value, monkeypatch):
    monkeypatch.setenv(knob, value)
    x = torch.randn(1, 2 * 32 * 128)
    with pytest.raises(ValueError, match=knob):
        codec_cuda.quantize_batch(x, 4, 128)


def test_butterfly_pack_is_refused(monkeypatch):
    """No longer refused: ``CGX_PALLAS_PACK=butterfly`` reaches the quantize
    wrappers of both lowerings and gives the bytes of "sum"."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 4 * 32 * 128)).astype(np.float32))
    seen = []
    for name in ("quantize_chunks", "quantize_chunks_db"):
        real = getattr(codec_cuda, name)
        monkeypatch.setattr(codec_cuda, name,
                            lambda *a, _real=real, **kw: seen.append(kw["pack"]) or _real(*a, **kw))
    out = {}
    for db in ("off", "on"):
        monkeypatch.setenv("CGX_PALLAS_DB", db)
        for pack in ("butterfly", "sum"):
            monkeypatch.setenv("CGX_PALLAS_PACK", pack)
            out[db, pack] = codec_cuda.quantize_batch(x, 4, 128)
    assert seen == ["butterfly", "sum", "butterfly", "sum"]
    for key, q in out.items():
        assert torch.equal(q.packed, out["off", "sum"].packed), key
        assert torch.equal(q.meta, out["off", "sum"].meta), key


def test_stochastic_epilogue_is_refused_without_a_lookup():
    """A stochastic epilogue (a seed) runs and makes no autotune lookup, as
    the JAX package's keeps the heuristic tile; a deterministic one looks
    the shape up."""
    q = codec_cuda.quantize_batch(torch.randn(2, 32 * 128), 4, 128)
    before = autotune.stats()
    out = codec_cuda.sra_epilogue_batch(q, seed=12345)
    assert autotune.stats() == before
    want = codec_cuda.quantize_batch(codec_cuda.reduce_rows_batch(q)[None], 4, 128, seed=12345)
    assert torch.equal(out.packed, want.packed) and torch.equal(out.meta, want.meta)
    codec_cuda.sra_epilogue_batch(q)
    assert autotune.stats() != before


def _tiny_steps(db: str, monkeypatch, steps: int = 2):
    for k, v in {
        "CGX_PALLAS_DB": db, "CGX_DEBUG_FORCE_CODEC": "1", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
        "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "16384",
        "CGX_SRA_EPILOGUE": "fused",
    }.items():
        monkeypatch.setenv(k, v)
    cfg = GPT2Config.tiny()
    model = GPT2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device="cpu")
    losses = [float(step(tokens)) for _ in range(steps)]
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}


def test_tiny_gpt2_step_db_on_matches_off(monkeypatch):
    """A CUDA-less tiny GPT-2 step: CGX_PALLAS_DB=on routes every flat slice
    to the pipelined wrappers (their plain versions here) and leaves the
    parameters bit-identical to off."""
    calls = {"quantize": 0, "dequantize": 0, "epilogue": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(codec_cuda, "quantize_chunks_db",
                        counting("quantize", codec_cuda.quantize_chunks_db))
    monkeypatch.setattr(codec_cuda, "dequantize_chunks_db",
                        counting("dequantize", codec_cuda.dequantize_chunks_db))
    monkeypatch.setattr(codec_cuda, "sra_epilogue_chunks_db",
                        counting("epilogue", codec_cuda.sra_epilogue_chunks_db))
    losses_on, on = _tiny_steps("on", monkeypatch)
    assert all(v > 0 for v in calls.values()), calls
    seen = dict(calls)
    losses_off, off = _tiny_steps("off", monkeypatch)
    assert calls == seen  # off never reaches them
    assert losses_on == losses_off and all(np.isfinite(losses_on))
    for k in on:
        assert torch.equal(on[k].view(torch.int32), off[k].view(torch.int32)), k
