"""The int8 fold (``CGX_SRA_ACCUM=int8``) of the port against the JAX
package, on the CPU.

The JAX package's reduce kernels (``codec_pallas._decode_accumulate``,
``accum="int8"``) fold the peer rows in the level domain: per bucket the
rows' units snap to 12-bit fixed-point multiples ``s_r`` of their largest
``U`` (the own row's included), ``sum_r level_r * s_r`` accumulates in
int32, and ``bsum + (usafe * 2^-12) * float(acc)`` plus the raw own row
gives each value. The port's plain versions (what its wrappers run on CPU
tensors, and what the card's kernels are held to) must give the same:

* B4 (``_reduce_rows_impl``) and B3 (``_sra_epilogue_impl``) in interpret
  mode: bytes equal on payloads built so that every product is exact
  (power-of-two units, integer levels, arbitrary mins), at bits 1-8, ws 1,
  2, 3, 4 and 8, the own row first, in the middle, last or none, f32,
  bf16 and f16 raw rows and casts. On random payloads XLA on the CPU
  contracts ``bsum + step * acc`` into one fused multiply-add (measured:
  every value agrees with the fused form) where the port rounds the
  product first, so there the reduce stays within ``eps * (ws * U *
  maxlvl + |value|)`` of the kernel's (eps = 2^-23: one ulp of the largest
  product and one of the value);
* constant buckets, a row with a zero unit, mins of both signed zeros,
  NaN and infinite units, tiny units whose scales are infinite (the
  f32 -> s32 convert: XLA's, saturating, NaN -> 0), and the world-size-1
  identity with the exact fold; the JAX package's own envelope test, on
  the port's plain path;
* the routing: both packages fuse the epilogue and the reduce at buckets
  2,048-16,384 within the block budget;
* SRA, all-to-all and the two-level scheme on spawned gloo ranks at ws 2
  and 4 against the JAX reducers on the CPU mesh under the same knobs,
  and a tiny GPT-2 through ``make_train_step`` against the JAX step;
* the DDP hook folds exactly whatever the knob says, as the JAX hook's
  numpy fold does;
* on a stand-in library, ``accum`` reaches the int8 library's entry points
  with the f32 fold's arguments, counted in ``INT8_LAUNCHES``.

The kernels themselves run only on the card (``test_torch_kernels.py``'s
``int8`` tests skip here).
"""

import multiprocessing as mp
import os
import queue
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cgx_tpu.ops import codec_pallas
from torch_cgx_tpu.ops import dispatch as jdispatch
from torch_cgx_tpu.config import CompressionConfig as JCompressionConfig
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.ops import codec, codec_cuda, dispatch

EPS = float(np.finfo(np.float32).eps)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
SPAWN_TIMEOUT_S = 300.0


@pytest.fixture(autouse=True)
def _int8(monkeypatch):
    monkeypatch.setenv("CGX_SRA_ACCUM", "int8")
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")


def _u32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy().view(np.uint32) if a.is_floating_point() else a.numpy().view(np.uint32)
    return np.asarray(a).astype(np.float32).view(np.uint32) if np.asarray(a).dtype.kind == "f" \
        else np.asarray(a).view(np.uint32)


def _payload(ws: int, chunks: int, bits: int, bucket: int, seed: int, *, exact: bool = True):
    """Words and meta of ws rows, built directly: integer levels, units
    powers of two (``exact``: every product of the fold exact; else normal
    data's units) with some zero, mins random, both signed zeros among
    them."""
    rng = np.random.default_rng(seed)
    nb = chunks * codec.CHUNK_BUCKETS
    lvl = rng.integers(0, 1 << bits, (ws, nb, bucket))
    words = torch.stack([codec.pack_levels_bucketed(torch.from_numpy(lvl[r]), bits)
                         for r in range(ws)])
    if exact:
        unit = (2.0 ** rng.integers(-24, 8, (ws, nb))).astype(np.float32)
    else:
        unit = rng.uniform(0.01, 3.0, (ws, nb)).astype(np.float32)
    unit[rng.random((ws, nb)) < 0.08] = 0.0
    mins = (rng.standard_normal((ws, nb)) * 4).astype(np.float32)
    mins[rng.random((ws, nb)) < 0.05] = 0.0
    mins[rng.random((ws, nb)) < 0.05] = -0.0
    return words, torch.from_numpy(np.stack([unit, mins], -1))


def _raw(n: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32)).to(dtype)


def _jax(t: torch.Tensor):
    jd = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16, torch.float32: jnp.float32,
          torch.int32: jnp.int32}
    return jnp.asarray(t.float().numpy() if t.is_floating_point() else t.numpy()).astype(jd[t.dtype])


def _jax_reduce(words, meta, raw, own, bits, bucket):
    ws = words.shape[0]
    return np.asarray(codec_pallas._reduce_rows_impl(
        _jax(words), _jax(meta), None if raw is None else _jax(raw), jnp.int32(own), bits=bits,
        bucket_size=bucket, ws=ws, with_raw=raw is not None, interpret=True, tc=1, accum="int8"))


def _jax_epilogue(words, meta, raw, own, bits, bucket, cast=jnp.float32):
    ws = words.shape[0]
    w, m = codec_pallas._sra_epilogue_impl(
        _jax(words), _jax(meta), None if raw is None else _jax(raw), jnp.int32(own), jnp.int32(0),
        bits=bits, bucket_size=bucket, ws=ws, with_raw=raw is not None, stochastic=False,
        interpret=True, tc=1, cast_dtype=np.dtype(cast), accum="int8")
    return np.asarray(w).reshape(-1), np.asarray(m)


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", range(1, 9))
def test_reduce_bytes_match_pallas_every_width(bits):
    """B4's int8 fold at every width, ws 4, the raw own row in the middle
    and none: the port's f32 values equal the kernel's bit for bit."""
    bucket, ws = 128, 4
    words, meta = _payload(ws, 2, bits, bucket, bits)
    n = 2 * 32 * bucket
    for own in (-1, 2):
        raw = None if own < 0 else _raw(n, torch.float32, bits)
        got = codec_cuda.reduce_rows_chunks(words, meta, raw, own, bits, bucket)
        np.testing.assert_array_equal(_u32(got), _jax_reduce(words, meta, raw, own, bits, bucket)
                                      .view(np.uint32), err_msg=f"own={own}")


@pytest.mark.parametrize("ws,own", [(1, -1), (1, 0), (2, 0), (2, 1), (3, 1), (4, -1), (4, 0),
                                    (4, 3), (8, -1), (8, 4), (8, 7)])
def test_reduce_bytes_match_pallas_rows_and_own(ws, own):
    """ws 1-8 with the own row first, in the middle, last or none (its meta
    counts in U, its words never): bytes equal the kernel's."""
    bits, bucket = 4, 256
    words, meta = _payload(ws, 1, bits, bucket, 10 * ws + own)
    raw = None if own < 0 else _raw(32 * bucket, torch.float32, ws)
    got = codec_cuda.reduce_rows_chunks(words, meta, raw, own, bits, bucket)
    np.testing.assert_array_equal(_u32(got), _jax_reduce(words, meta, raw, own, bits, bucket)
                                  .view(np.uint32))


@pytest.mark.parametrize("bits", range(1, 9))
def test_epilogue_bytes_match_pallas_every_width(bits):
    """B3's int8 fold and requantize at every width, ws 4, the raw own row
    last and none: stage-2 words and meta equal the kernel's."""
    bucket, ws = 128, 4
    words, meta = _payload(ws, 2, bits, bucket, 100 + bits)
    for own in (-1, 3):
        raw = None if own < 0 else _raw(2 * 32 * bucket, torch.float32, bits)
        w, m = codec_cuda.sra_epilogue_chunks(words, meta, raw, own, bits, bucket)
        jw, jm = _jax_epilogue(words, meta, raw, own, bits, bucket)
        np.testing.assert_array_equal(_u32(w), jw.view(np.uint32), err_msg=f"own={own}")
        np.testing.assert_array_equal(_u32(m), _u32(jm), err_msg=f"own={own}")


@pytest.mark.parametrize("ws,own", [(1, -1), (1, 0), (2, 1), (3, 0), (4, 2), (8, -1), (8, 5)])
def test_epilogue_bytes_match_pallas_rows_and_own(ws, own):
    bits, bucket = 4, 128
    words, meta = _payload(ws, 1, bits, bucket, 200 + 10 * ws + own)
    raw = None if own < 0 else _raw(32 * bucket, torch.float32, ws + 1)
    w, m = codec_cuda.sra_epilogue_chunks(words, meta, raw, own, bits, bucket)
    jw, jm = _jax_epilogue(words, meta, raw, own, bits, bucket)
    np.testing.assert_array_equal(_u32(w), jw.view(np.uint32))
    np.testing.assert_array_equal(_u32(m), _u32(jm))


@pytest.mark.parametrize("dname", ["bf16", "f16"])
def test_wire_dtypes_match_pallas(dname):
    """A bf16 or f16 raw own row (B4 and B3), and B3's cast of the folded
    chunk through the wire dtype before the requantize: equal bytes."""
    dtype, jdtype = DTYPES[dname]
    bits, bucket, ws, own = 4, 128, 4, 1
    words, meta = _payload(ws, 2, bits, bucket, 300)
    raw = _raw(2 * 32 * bucket, dtype, 301)
    got = codec_cuda.reduce_rows_chunks(words, meta, raw, own, bits, bucket)
    np.testing.assert_array_equal(_u32(got), _jax_reduce(words, meta, raw, own, bits, bucket)
                                  .view(np.uint32))
    for r, o in ((raw, own), (None, -1)):
        w, m = codec_cuda.sra_epilogue_chunks(words, meta, r, o, bits, bucket, cast_dtype=dtype)
        jw, jm = _jax_epilogue(words, meta, r, o, bits, bucket, jdtype)
        np.testing.assert_array_equal(_u32(w), jw.view(np.uint32))
        np.testing.assert_array_equal(_u32(m), _u32(jm))


@pytest.mark.parametrize("bits,ws,own", [(2, 3, 1), (4, 4, -1), (4, 8, 7), (8, 4, 0), (8, 16, 3)])
def test_random_payloads_within_the_stated_bound(bits, ws, own):
    """Rows quantized from random data (units of any value): the fold's
    product is rounded, and XLA on the CPU fuses it with the add, so the
    port's reduce may differ from the kernel's, by at most eps * (ws * U *
    maxlvl + |value|); it does somewhere (the measurement the bound rests
    on), and the epilogue's stage-2 payload decodes within one level step
    of the kernel's."""
    bucket = 128
    rng = np.random.default_rng(bits * ws)
    xs = torch.from_numpy((rng.standard_normal((ws, 2 * 32 * bucket))
                           * rng.uniform(0.1, 10, (ws, 1))).astype(np.float32))
    q = codec_cuda.quantize_batch(xs, bits, bucket)
    raw = None if own < 0 else xs[own]
    got = codec_cuda.reduce_rows_chunks(q.packed, q.meta, raw, own, bits, bucket).numpy()
    want = _jax_reduce(q.packed, q.meta, raw, own, bits, bucket)
    units = q.meta[..., 0].numpy()
    mag = np.repeat(ws * units.max(0) * ((1 << bits) - 1), bucket)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= EPS * (mag + np.abs(got))).all(), float((err / (EPS * (mag + np.abs(got)))).max())
    assert (got != want).any()
    w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, own, bits, bucket)
    jw, jm = _jax_epilogue(q.packed, q.meta, raw, own, bits, bucket)
    dec = codec_cuda.dequantize_chunks(w, m, bits, bucket).numpy()
    jdec = codec_cuda.dequantize_chunks(torch.from_numpy(jw.copy()), torch.from_numpy(jm.copy()),
                                        bits, bucket).numpy()
    step = np.repeat(np.maximum(m[:, 0].numpy(), jm[:, 0]), bucket)
    assert (np.abs(dec - jdec) <= step * 1.001 + EPS * np.abs(jdec)).all()


def test_constant_buckets_and_zero_units():
    """The JAX package's ``test_int8_accum_constant_buckets_exact`` on the
    port: constant rows reduce exactly; one row of zero units among others
    keeps the others' scales; bytes equal the kernel's."""
    ws, bucket = 4, 512
    xs = torch.full((ws, 32 * bucket), 1.5)
    q = codec_cuda.quantize_batch(xs, 4, bucket)
    red = codec_cuda.reduce_rows_batch(q)
    np.testing.assert_allclose(red.numpy(), ws * 1.5, rtol=1e-6)
    jq = codec_pallas.quantize_batch(jnp.asarray(xs.numpy()), 4, bucket, interpret=True)
    np.testing.assert_array_equal(_u32(red), _u32(codec_pallas.reduce_rows_batch(jq, interpret=True)))
    words, meta = _payload(3, 1, 4, 128, 7)
    meta[1, :, 0] = 0.0
    got = codec_cuda.reduce_rows_chunks(words, meta, None, -1, 4, 128)
    np.testing.assert_array_equal(_u32(got), _jax_reduce(words, meta, None, -1, 4, 128).view(np.uint32))


def test_signed_zero_mins():
    """Mins of both signed zeros, units 0 (a bucket of zeros): bsum starts
    at +0 and adds every row, the own row's +0 included, so the sign of the
    sum is the kernel's (-0 + -0 would keep -0; +0 + -0 is +0)."""
    ws, bucket, nb = 3, 128, 32
    words = torch.zeros((ws, 4 * bucket), dtype=torch.int32)
    meta = torch.zeros((ws, nb, 2))
    meta[:, ::2, 1] = -0.0
    meta[0, 1::4, 1] = -0.0
    for own in (-1, 0, 2):
        raw = None if own < 0 else torch.full((nb * bucket,), -0.0)
        got = codec_cuda.reduce_rows_chunks(words, meta, raw, own, 4, bucket)
        want = _jax_reduce(words, meta, raw, own, 4, bucket)
        np.testing.assert_array_equal(_u32(got), want.view(np.uint32), err_msg=f"own={own}")
        w, m = codec_cuda.sra_epilogue_chunks(words, meta, raw, own, 4, bucket)
        jw, jm = _jax_epilogue(words, meta, raw, own, 4, bucket)
        np.testing.assert_array_equal(_u32(m), _u32(jm), err_msg=f"own={own}")
        assert not torch.signbit(got).any()


def test_nan_and_infinite_units():
    """A NaN unit (a bucket holding a NaN) scales to 0 and leaves U to the
    others (usafe = 1 when U is NaN); an infinite unit makes every scale 0
    and the step infinite: NaN values, as the kernel's."""
    words, meta = _payload(3, 1, 4, 128, 11)
    meta[0, 0:4, 0] = float("nan")
    meta[1, 4:8, 0] = float("inf")
    meta[2, 8:12, 1] = float("nan")
    got = codec_cuda.reduce_rows_chunks(words, meta, None, -1, 4, 128).numpy()
    want = _jax_reduce(words, meta, None, -1, 4, 128)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))
    assert np.isnan(got.reshape(32, 128)[4:12]).all() and not np.isnan(got.reshape(32, 128)[:4]).any()


def test_scale_convert_matches_xla():
    """``round_i32``, the port's f32 -> s32 of ``jnp.round``: ties to even,
    saturating at the int32 range, NaN -> 0, as XLA's convert on the CPU
    (and the card's cvt.rni.s32.f32)."""
    x = np.array([np.inf, -np.inf, np.nan, -np.nan, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 4095.5,
                  2.0**31, -(2.0**31), 2.0**31 - 128, -(2.0**31) - 256, 3e9, -3e9, 1e38,
                  -1e-45, 4096.49], np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.round(v).astype(jnp.int32))(jnp.asarray(x)))
    np.testing.assert_array_equal(codec_cuda.round_i32(torch.from_numpy(x)).numpy(), want)


def test_tiny_units_give_infinite_scales():
    """Below U = 2^12 / FLT_MAX (about 1.2e-35) 4096 / U overflows: a kept
    row's scale saturates to 2^31 - 1 (0 where its unit is 0: inf * 0 is
    NaN), the int32 sums wrap, and the value is bsum + (U * 2^-12) *
    float(acc) in IEEE arithmetic. The port computes exactly that; XLA on
    the CPU flushes the subnormal U * 2^-12 to zero (its kernels' value is
    bsum), a difference of the CPU backend, not of the fold (ROADMAP C16).
    Just above U = 2^-114 (the step normal) the bytes are the kernel's."""
    ws, bucket, bits = 3, 128, 4
    words, meta = _payload(ws, 1, bits, bucket, 21)
    lvl = np.stack([codec.unpack_levels_bucketed(words[r], bits, 32, bucket).numpy()
                    for r in range(ws)]).astype(np.int64)
    units = np.full((ws, 32), 1e-36, np.float32)
    units[1, ::3] = 0.0
    meta[..., 0] = torch.from_numpy(units)
    got = codec_cuda.reduce_rows_chunks(words, meta, None, -1, bits, bucket).numpy()
    scale = np.where(units > 0, np.int64(2**31 - 1), 0)
    acc = (lvl * scale[:, :, None]).sum(0)
    acc = ((acc + 2**31) % 2**32 - 2**31).astype(np.int32).astype(np.float32)
    mins = meta[..., 1].numpy()
    bsum = np.zeros(32, np.float32)
    for r in range(ws):
        bsum = (bsum + mins[r]).astype(np.float32)
    step = (np.float32(1e-36) * np.float32(2.0**-12)).astype(np.float32)
    assert 0 < step < np.finfo(np.float32).tiny
    model = (bsum[:, None] + (step * acc).astype(np.float32)).astype(np.float32).reshape(-1)
    np.testing.assert_array_equal(got.view(np.uint32), model.view(np.uint32))
    meta[..., 0] = torch.from_numpy(np.where(units > 0, np.float32(2.0**-113), 0).astype(np.float32))
    got = codec_cuda.reduce_rows_chunks(words, meta, None, -1, bits, bucket)
    np.testing.assert_array_equal(_u32(got), _jax_reduce(words, meta, None, -1, bits, bucket)
                                  .view(np.uint32))


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_world_size_one_equals_the_exact_fold(bits):
    """One row, no raw row (the world-size-1 proxy's epilogue): every scale
    is 2^12 and the product is unit * level, so the int8 fold gives the
    exact fold's bytes on finite data whose U * 2^-12 is normal."""
    bucket = 256
    x = torch.from_numpy(np.random.default_rng(bits).standard_normal((1, 3 * 32 * bucket))
                         .astype(np.float32) * 100)
    q = codec_cuda.quantize_batch(x, bits, bucket)
    for accum in ("int8", "exact"):
        red = codec_cuda.reduce_rows_chunks(q.packed, q.meta, None, -1, bits, bucket, accum)
        w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, None, -1, bits, bucket, accum=accum)
        if accum == "int8":
            r8, w8, m8 = red, w, m
    assert torch.equal(r8.view(torch.int32), red.view(torch.int32))
    assert torch.equal(w8, w) and torch.equal(m8.view(torch.int32), m.view(torch.int32))


def test_envelope_on_the_port():
    """The JAX package's ``test_int8_accum_envelope`` on the port's plain
    path: the int8 reduce within ws * U * maxlvl / 2^13 of the exact one,
    and the requantized payload decoding within two of its level steps of
    the exact reduce (plus that)."""
    ws, bits, bucket = 4, 4, 512
    xs = torch.from_numpy(np.random.default_rng(24).standard_normal((ws, 2 * 32 * bucket))
                          .astype(np.float32))
    q = codec_cuda.quantize_batch(xs, bits, bucket)
    exact = codec_cuda.reduce_rows_batch(q, raw_row=xs[2], own_idx=2, accum="exact").numpy()
    fixed = codec_cuda.reduce_rows_batch(q, raw_row=xs[2], own_idx=2).numpy()
    units = q.meta[..., 0].numpy()
    bound = ws * units.max() * ((1 << bits) - 1) / (1 << 13) + 1e-6
    err = np.max(np.abs(exact - fixed))
    assert 0 < err <= bound, (err, bound)
    q2 = codec_cuda.sra_epilogue_batch(q, raw_row=xs[2], own_idx=2)
    dec = codec_cuda.dequantize_batch(q2)[0].numpy()
    unit2 = np.abs(exact).max() / ((1 << bits) - 1)
    assert np.max(np.abs(dec - exact)) <= 2 * unit2 + bound


# ---------------------------------------------------------------------------
# Routing.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws,bucket", [(2, 2048), (8, 2048), (4, 4096), (4, 8192), (2, 16384),
                                       (16, 4096), (4, 16384)])
def test_fused_routing_past_the_old_tile_gate_matches_jax(ws, bucket, monkeypatch):
    """Buckets of 2,048-16,384: both packages fuse the epilogue and the
    reduce wherever ws x 32 x B <= 2^20 (the JAX block budget), under
    ``CGX_SRA_EPILOGUE`` fused and under auto at the size crossover."""
    cc, jcc = CompressionConfig(bits=4, bucket_size=bucket), JCompressionConfig(bits=4, bucket_size=bucket)
    q = codec.QTensor(packed=torch.zeros((ws, 4 * bucket), dtype=torch.int32),
                      meta=torch.zeros((ws, 32, 2)), residual=torch.zeros((ws, 0)),
                      numel=32 * bucket, bits=4, bucket_size=bucket, dtype=torch.float32)
    jq = jdispatch.quantize_batch(jnp.zeros((ws, 32 * bucket)), jcc)
    fits = ws * 32 * bucket <= 2**20
    assert codec_cuda.supports_reduce(q) == codec_pallas.supports_reduce(jq) == fits
    assert dispatch.fused_epilogue_would_run(q) == jdispatch.fused_epilogue_would_run(jq) == fits
    assert dispatch.fused_reduce_would_run(q) == fits
    del cc


# ---------------------------------------------------------------------------
# The reducers on spawned gloo ranks against the JAX reducers on the CPU
# mesh, and a tiny GPT-2 train step.
# ---------------------------------------------------------------------------

# Two bits; every rank's leaves integer grids of its own range (0..15 on
# rank 0, so every bucket's U is 5, and 0..9, 0..12, 0..6 on the others:
# scales 4096, 2458, 3277, 1638), so the fold's products are exact and
# the two lowerings of its multiply-add agree, but the snapped scales are
# not the units: the int8 fold's values differ from the exact fold's.
TREE_ENV = {
    "CGX_COMPRESSION_QUANTIZATION_BITS": "2",
    "CGX_COMPRESSION_BUCKET_SIZE": "128",
    "CGX_STANDALONE_LAYER_ELEMS": "16384",
    "CGX_FUSION_BUFFER_SIZE_MB": "1",
    "CGX_SRA_EPILOGUE": "fused",
}
TREE_LEAVES = {"a.kernel": (64, 512), "b.kernel": (100, 200), "c.kernel": (600, 1000),
               "d.kernel": (32, 128), "e.bias": (77,)}
RANK_RANGES = (16, 10, 13, 7)
SCHEMES = {
    "sra": {},
    "sra_db": {"CGX_PALLAS_DB": "on"},
    "alltoall": {"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1"},
}


def _trees(ws: int):
    return [{p: np.float32((np.arange(int(np.prod(shape))) * (2 * i + 3 + r)) % RANK_RANGES[r])
             .reshape(shape) for i, (p, shape) in enumerate(TREE_LEAVES.items())} for r in range(ws)]


def _world_rank(rank, ws, init_file, trees, result_q):
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    import torch.distributed as dist

    from torch_cgx_tpu_torch.parallel import allreduce, gradient_sync, hierarchical_groups

    torch.set_num_threads(1)
    out = {}
    try:
        timeout = timedelta(seconds=120)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=ws, timeout=timeout)
        tl = hierarchical_groups(intra_size=2, timeout=timeout)
        os.environ.update(TREE_ENV)
        mine = {p: torch.from_numpy(v) for p, v in trees[rank].items()}
        for accum in ("int8", "exact"):
            os.environ["CGX_SRA_ACCUM"] = accum
            for scheme, knobs in SCHEMES.items():
                os.environ.update(knobs)
                out[scheme, accum] = {p: v.numpy() for p, v in allreduce.allreduce_tree(
                    {p: v.clone() for p, v in mine.items()}).items()}
                for k in knobs:
                    del os.environ[k]
            out["two_level", accum] = {p: v.numpy() for p, v in gradient_sync(
                {p: v.clone() for p, v in mine.items()}, group=tl, average=False).items()}
        dist.barrier()
    except Exception as e:  # reported to the parent, which fails the test
        out = {"error": repr(e)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


@pytest.fixture(scope="module", params=[2, 4], ids=lambda ws: f"ws{ws}")
def world(request, tmp_path_factory):
    ws = request.param
    trees = _trees(ws)
    init_file = str(tmp_path_factory.mktemp(f"gloo_int8_ws{ws}") / "store")
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = [ctx.Process(target=_world_rank, args=(r, ws, init_file, trees, result_q), daemon=True)
             for r in range(ws)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < ws and time.monotonic() < deadline:
            try:
                rank, out = result_q.get(timeout=2.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert len(results) == ws, f"only ranks {sorted(results)} reported"
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    assert not errors, errors
    return ws, trees, [results[r] for r in range(ws)]


def _jax_sync(trees, mesh, axes):
    """The JAX package's ``gradient_sync`` of the per-rank trees over
    ``mesh`` (the knobs as the environment holds them): ``{path: (ws,
    ...)}``."""
    from jax.sharding import PartitionSpec as P

    from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu.utils.tree import leaf_paths

    ws = len(trees)
    lead = tuple(mesh.devices.shape)
    tree = {}
    for path, shape in TREE_LEAVES.items():
        node = tree
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(np.stack([t[path] for t in trees]).reshape(lead + shape))
    spec = jax.tree.map(lambda _: P(*axes), tree)
    idx = (0,) * len(lead)
    body = shard_map(
        lambda t: jax.tree.map(lambda a: a[(None,) * len(lead)],
                               jgradient_sync(jax.tree.map(lambda a: a[idx], t), mesh=mesh, axes=axes,
                                              average=False)),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False,
    )
    out = dict(leaf_paths(jax.jit(body)(tree)))
    return {p: np.asarray(v).reshape((ws,) + TREE_LEAVES[p]) for p, v in out.items()}


def _jax_schemes(ws, trees, monkeypatch):
    """Each scheme of the world under each fold, through the JAX package."""
    from jax.sharding import Mesh

    flat = Mesh(np.asarray(jax.devices()[:ws]), ("dp",))
    levels = Mesh(np.asarray(jax.devices()[:ws]).reshape(ws // 2, 2), ("cross", "intra"))
    for k, v in TREE_ENV.items():
        monkeypatch.setenv(k, v)
    out = {}
    for accum in ("int8", "exact"):
        monkeypatch.setenv("CGX_SRA_ACCUM", accum)
        for scheme, knobs in SCHEMES.items():
            for k, v in knobs.items():
                monkeypatch.setenv(k, v)
            out[scheme, accum] = _jax_sync(trees, flat, ("dp",))
            for k in knobs:
                monkeypatch.delenv(k)
        out["two_level", accum] = _jax_sync(trees, levels, ("cross", "intra"))
    return out


@pytest.fixture(scope="module")
def jax_results():
    return {}


@pytest.mark.parametrize("scheme", list(SCHEMES) + ["two_level"])
def test_reducers_match_jax(world, jax_results, scheme, monkeypatch):
    """SRA (single-stage and pipelined epilogue), the all-to-all and the
    two-level scheme (intra SRA: B4 with the raw own rows; cross Ring) under
    ``CGX_SRA_ACCUM=int8`` over gloo against the JAX reducers on the CPU
    mesh under the same knobs. The all-to-all is the fold alone (B4 over
    every rank's row): bit-identical. SRA and the two-level scheme decode
    the requantized folds, whose products are not exact and which XLA on
    the CPU fuses into one multiply-add (C9): within eps * (|v| + the
    leaf's largest |v|) of the JAX values. In both packages the int8
    results differ from the exact fold's, and every rank holds the same."""
    ws, trees, results = world
    if ws not in jax_results:
        jax_results[ws] = _jax_schemes(ws, trees, monkeypatch)
    want = jax_results[ws]
    moved = jmoved = 0
    for r in range(ws):
        for path in TREE_LEAVES:
            got, ref = results[r][scheme, "int8"][path], want[scheme, "int8"][path][r]
            if scheme == "alltoall":
                np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32),
                                              err_msg=f"rank {r} {path}")
            else:
                bound = EPS * (np.abs(ref) + np.abs(ref).max())
                assert (np.abs(got - ref) <= bound).all(), (r, path, float(np.abs(got - ref).max()))
            np.testing.assert_array_equal(got, results[0][scheme, "int8"][path])
            moved += int((got != results[r][scheme, "exact"][path]).sum())
            jmoved += int((ref != want[scheme, "exact"][path][r]).sum())
    assert moved > 0 and jmoved > 0


LR = 1e-4
GPT_VOCAB = 1031
GPT_ENV = {
    "CGX_DEBUG_FORCE_CODEC": "1",
    "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
    "CGX_COMPRESSION_BUCKET_SIZE": "128",
    "CGX_FUSION_BUFFER_SIZE_MB": "1",
    "CGX_STANDALONE_LAYER_ELEMS": "40000",
    "CGX_SRA_EPILOGUE_MIN_ELEMS": "0",
}


def test_tiny_gpt2_train_step_matches_jax(monkeypatch):
    """A tiny GPT-2 through ``make_train_step`` under ``CGX_SRA_ACCUM=int8``
    with the fused epilogue (the world-size-1 proxy: quantize, the one-row
    int8 epilogue, decode) against the JAX step under the same knobs: the
    losses to a relative 1e-4 and the parameters to 3 x lr, as the float32
    step's; and the port's int8 parameters bit-identical to its exact
    ones (one row: every scale is 2^12)."""
    import optax

    from torch_cgx_tpu.models import GPT2 as JGPT2
    from torch_cgx_tpu.models import GPT2Config as JGPT2Config
    from torch_cgx_tpu.models import lm_loss as jlm_loss
    from torch_cgx_tpu.parallel import make_train_step as jmake_train_step
    from torch_cgx_tpu.parallel import replicate, shard_batch
    from torch_cgx_tpu.utils.tree import leaf_paths
    from torch_cgx_tpu_torch.models import (
        GPT2, GPT2Config, gpt2_params_from_jax, gpt2_params_to_numpy, lm_loss,
    )
    from torch_cgx_tpu_torch.parallel import make_train_step
    from jax.sharding import Mesh

    for k, v in GPT_ENV.items():
        monkeypatch.setenv(k, v)
    jmodel = JGPT2(JGPT2Config.tiny(vocab_size=GPT_VOCAB, dtype=jnp.float32))
    tokens = np.random.default_rng(3).integers(0, GPT_VOCAB, size=(2, 32)).astype(np.int32)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"])
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    opt = optax.adam(LR)
    p = replicate(jax.tree.map(jnp.asarray, params), mesh)
    st = replicate(opt.init(p), mesh)
    jstep = jmake_train_step(lambda pp, t: jlm_loss(jmodel.apply({"params": pp}, t), t), opt, mesh,
                             donate=False)
    jl = []
    for i in range(3):
        p, st, loss = jstep(p, st, shard_batch(jnp.asarray(tokens), mesh), jnp.int32(i))
        jl.append(float(loss))
    port = {}
    for accum in ("int8", "exact"):
        monkeypatch.setenv("CGX_SRA_ACCUM", accum)
        model = GPT2(GPT2Config.tiny(vocab_size=GPT_VOCAB, dtype=torch.float32), device="cpu")
        model.load_state_dict(gpt2_params_from_jax(params))
        topt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
        step = make_train_step(model, lambda m, t: lm_loss(m(t), t), topt, device="cpu")
        losses = [float(step(torch.from_numpy(tokens))) for _ in range(3)]
        port[accum] = (losses, dict(leaf_paths(gpt2_params_to_numpy(model))))
    tl, tp = port["int8"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for path, v in leaf_paths(jax.tree.map(np.asarray, p)):
        np.testing.assert_allclose(tp[path], v, rtol=0, atol=3 * LR, err_msg=path)
        np.testing.assert_array_equal(tp[path].view(np.uint32), port["exact"][1][path].view(np.uint32))
    assert tl == port["exact"][0]


# ---------------------------------------------------------------------------
# The DDP hook folds exactly under the knob.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws,me", [(2, 1), (4, 2)])
def test_hook_sra_fold_stays_exact(ws, me, monkeypatch):
    """The hook's SRA fold + requantize under ``CGX_SRA_ACCUM=int8`` and the
    fused epilogue: byte for byte the JAX hook's numpy fold
    (``_sra_fold_chunk``, ``_requantize_frames``), which reads no knob."""
    from torch_cgx_tpu.torch_backend import backend as jb
    from torch_cgx_tpu_torch.torch_backend import backend as pb

    monkeypatch.setenv("CGX_BRIDGE_DEVICE_CODEC", "off")
    monkeypatch.setenv("CGX_LAYER_ALIGNED_SPLIT", "1")
    bucket = 128
    layers = [(i * 8192, 8192, CompressionConfig(bits=4, bucket_size=bucket)) for i in range(ws)]
    n = 8192 * ws
    ranks = np.random.default_rng(ws + me).standard_normal((ws, n)).astype(np.float32)
    sizes, offs = jb._chunk_split(n, ws, layers)
    js = jb._segments_in(layers, offs[me], offs[me] + sizes[me])
    ps = [pb._Segment(s.start, s.numel, s.bits, s.bucket_size) for s in js]
    frames = {j: np.frombuffer(jb._compress_frames(ranks[j], js, False, None, np.dtype(np.float32)),
                               np.uint8) for j in range(ws) if j != me}
    want = ranks[me].copy()
    jb._sra_fold_chunk(want, offs[me], offs[me] + sizes[me], js, frames, me, ws, False,
                       np.dtype(np.float32))
    want_wire = jb._requantize_frames(want, js, False, None, np.dtype(np.float32))
    got = torch.from_numpy(ranks[me].copy())
    calls = []
    inner = codec_cuda.sra_epilogue_chunks

    def spy(*a, **kw):
        calls.append(kw.get("accum"))
        return inner(*a, **kw)

    monkeypatch.setattr(codec_cuda, "sra_epilogue_chunks", spy)
    wire = pb._sra_fold_chunk(got, ps, [None if j == me else torch.from_numpy(frames[j].copy())
                                        for j in range(ws)], me, ws, False, torch.float32)
    assert calls and set(calls) == {"exact"}
    assert wire.numpy().tobytes() == want_wire
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_hook_alltoall_fold_stays_exact(monkeypatch):
    """The hook's all-to-all fold (``_qreduce_alltoall``) under the knob:
    the reduce runs with ``accum="exact"``, bit-identical to the same
    exchange with the knob unset."""
    from torch_cgx_tpu_torch.parallel import group as group_mod
    from torch_cgx_tpu_torch.torch_backend import backend as pb

    ws, me, bucket = 4, 1, 128
    layers = [(0, 3 * 32 * bucket, CompressionConfig(bits=4, bucket_size=bucket))]
    rng = np.random.default_rng(5)
    ranks = [torch.from_numpy(rng.standard_normal(3 * 32 * bucket).astype(np.float32)) for _ in range(ws)]
    segs = pb._segments_in(layers, 0, 3 * 32 * bucket)
    wires = [pb._compress_frames(r, segs, False, torch.float32) for r in ranks]
    monkeypatch.setattr(group_mod, "world_size", lambda g=None: ws)
    monkeypatch.setattr(group_mod, "rank", lambda g=None: me)
    def exchange(sends, sizes, any_, group, dev):
        """The frames every peer would send this rank."""
        return [None if peer == me else wires[peer].clone() for peer in range(ws)]

    monkeypatch.setattr(pb, "_alltoallv", exchange)
    calls = []
    inner = codec_cuda.reduce_rows_chunks

    def spy(*a, **kw):
        calls.append(a[6] if len(a) > 6 else kw.get("accum"))
        return inner(*a, **kw)

    monkeypatch.setattr(codec_cuda, "reduce_rows_chunks", spy)
    out = {}
    for accum in ("int8", "exact"):
        monkeypatch.setenv("CGX_SRA_ACCUM", accum)
        fused = ranks[me].clone()
        pb._qreduce_alltoall(fused, layers, torch.float32, None)
        out[accum] = fused
    assert calls == ["exact", "exact"]
    assert torch.equal(out["int8"].view(torch.int32), out["exact"].view(torch.int32))


# ---------------------------------------------------------------------------
# A stand-in library: the int8 entry points and their arguments.
# ---------------------------------------------------------------------------


class _FakeLib:
    """Stands in for a built library: records each entry point's call."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(codec_cuda, "_lib", lambda: _FakeLib(calls))
    monkeypatch.setattr(codec_cuda, "_lib_int8", lambda: _FakeLib(calls))
    monkeypatch.setattr(codec_cuda, "_stream", lambda t: 0)
    monkeypatch.setattr(codec_cuda, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(codec_cuda, "_sm_count", lambda index: 132)
    codec_cuda.reset_launch_counts()
    yield calls
    codec_cuda.reset_launch_counts()


@pytest.mark.parametrize("knob,accum,suffix", [("int8", None, "_int8"), ("exact", None, ""),
                                               ("exact", "int8", "_int8"), ("int8", "exact", "")])
def test_accum_reaches_the_int8_entry_points(fake_card, monkeypatch, knob, accum, suffix):
    """B3, B7c and B4 call the int8 library's entry points (the f32 fold's
    name with ``_int8``, the same arguments) under the knob or an explicit
    ``accum``, which wins; each int8 launch is counted in INT8_LAUNCHES
    beside LAUNCHES."""
    monkeypatch.setenv("CGX_SRA_ACCUM", knob)
    ws, chunks = 4, 2
    words = torch.zeros(ws, chunks * 4 * 512, dtype=torch.int32)
    meta = torch.zeros(ws, chunks * 32, 2)
    raw = torch.zeros(chunks * 32 * 512)
    codec_cuda.sra_epilogue_chunks(words, meta, raw, 2, 4, 512, accum=accum)
    codec_cuda.sra_epilogue_chunks_db(words, meta, raw, 2, 4, 512, 1, accum=accum)
    codec_cuda.reduce_rows_chunks(words, meta, raw, 2, 4, 512, accum=accum)
    names = [n for n, _ in fake_card]
    assert names == [f"cgx_sra_epilogue{suffix}", f"cgx_sra_epilogue_db{suffix}",
                     f"cgx_reduce_rows{suffix}"]
    int8 = suffix == "_int8"
    assert codec_cuda.INT8_LAUNCHES == {"codec_sra_epilogue": int(int8),
                                        "codec_sra_epilogue_db": int(int8),
                                        "codec_reduce_rows": int(int8)}
    assert codec_cuda.LAUNCHES["codec_reduce_rows"] == 1
    (_, ea), (_, da), (_, ra) = fake_card
    assert ea[3:5] == (2, ws) and da[3:5] == (2, ws) and ra[3:5] == (2, ws)


def test_batch_and_dispatch_pass_accum(fake_card, monkeypatch):
    """``dispatch.reduce_rows`` and ``reduce_rows_requantize`` hand their
    ``accum`` to the batch functions, which hand it to the wrappers; None
    reads the knob."""
    monkeypatch.setenv("CGX_SRA_ACCUM", "exact")
    cc = CompressionConfig(bits=4, bucket_size=512)
    q = codec.QTensor(packed=torch.zeros((4, 2 * 4 * 512), dtype=torch.int32),
                      meta=torch.zeros((4, 64, 2)), residual=torch.zeros((4, 0)),
                      numel=2 * 32 * 512, bits=4, bucket_size=512, dtype=torch.float32)
    raw = torch.zeros(4, 2 * 32 * 512)
    dispatch.reduce_rows(q, raw_rows=raw, own_idx=1, accum="int8")
    dispatch.reduce_rows_requantize(q, cc, raw_rows=raw, own_idx=1, accum="int8")
    dispatch.reduce_rows(q, raw_rows=raw, own_idx=1)
    assert [n for n, _ in fake_card] == ["cgx_reduce_rows_int8", "cgx_sra_epilogue_int8",
                                         "cgx_reduce_rows"]


def test_source_int8_parts_and_keys():
    """The int8 library's parts cover every CGX_IN_INT8_PART of the source
    and its entry points carry the f32 fold's; the build report's keys mark
    the int8 instances (``ACCUM`` 1 after the element type) and leave the
    f32 fold's (0) as they were."""
    import re

    src = codec_cuda.SOURCE.read_text()
    parts = {int(k) for k in re.findall(r"CGX_IN_INT8_PART\((\d+)\)", src)}
    assert parts == set(range(codec_cuda.INT8_BUILD_PARTS))
    for entry in ("cgx_sra_epilogue", "cgx_sra_epilogue_db", "cgx_reduce_rows"):
        assert re.search(rf"^int {entry}_int8\(", src, re.M), entry

    def entry(name):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Used 40 registers, 0 bytes smem\n")

    t = codec_cuda.ptxas_instances(
        entry("_ZN12_GLOBAL__N_131cgx_sra_epilogue_cluster_kernelILi4ELi0ELi0ELb0ELb0EfLi0EEEvPKiPKfPKT4_")
        + entry("_ZN12_GLOBAL__N_131cgx_sra_epilogue_cluster_kernelILi4ELi0ELi0ELb0ELb0EfLi1EEEvPKiPKfPKT4_")
        + entry("_ZN12_GLOBAL__N_131cgx_sra_epilogue_cluster_kernelILi4ELi0ELi0ELb0ELb0EtLi1EEEvPKiPKfPKT4_")
        + entry("_ZN12_GLOBAL__N_122cgx_reduce_rows_kernelILi4ELi0ELi4ELb1EfLi1EEEvPKiPKfPKT3_"))
    assert sorted(t) == ["cgx_reduce_rows_kernel<4,0,4,1>:int8",
                         "cgx_sra_epilogue_cluster_kernel<4,0,0,0,0>",
                         "cgx_sra_epilogue_cluster_kernel<4,0,0,0,0>:int8",
                         "cgx_sra_epilogue_cluster_kernel<4,0,0,0,0>:int8:16"]
