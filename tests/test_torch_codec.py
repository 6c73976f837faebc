"""The port's codec (``torch_cgx_tpu_torch.ops``) against the JAX package's.

On the CPU the port runs its plain PyTorch versions; these must give the
JAX package's wire bytes exactly:

* quantize: packed words and meta byte-identical to ``codec_host.quantize``
  over bits 1-8, buckets {32, 96, 128, 512, 1024} and three geometries
  (whole chunks; chunks plus a dense tail and a partial bucket; less than a
  bucket), and to ``codec.quantize`` and the Pallas kernels in interpret
  mode on a spread of those cases;
* dequantize: bit-identical to ``codec_host.dequantize`` and within 1 ulp of
  ``codec.dequantize`` (XLA may fuse the decode's multiply-add; the port
  rounds the product first, like the host codec), with and without
  ``add_to``;
* the SRA epilogue (``reduce_rows_requantize``, fused and staged):
  byte-identical to ``codec_pallas.sra_epilogue_batch(interpret=True)`` and
  to the JAX staged path on decode-exact data, within the error envelope on
  random data.

The multi-row reduce (B4) is held to the JAX package's in
``test_torch_codec_reduce.py``.

The CUDA kernels themselves run only on the card: ``test_torch_kernels.py``
holds them against their plain versions there (it skips here), and
``chip_smoke.py`` does so at the GPT-2 slice's shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fuzz_operand
from torch_cgx_tpu.ops import codec as jcodec
from torch_cgx_tpu.ops import codec_host, codec_pallas
from torch_cgx_tpu.ops import dispatch as jdispatch
from torch_cgx_tpu.config import CompressionConfig as JCompressionConfig
from torch_cgx_tpu_torch import config as tcfg
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.ops import codec, codec_cuda, dispatch
from torch_cgx_tpu_torch.utils import prng

BUCKETS = (32, 96, 128, 512, 1024)
GEOMETRIES = ("chunks", "tail", "sub")


def _size(geometry: str, bucket: int) -> int:
    chunk = codec.CHUNK_BUCKETS * bucket
    if geometry == "chunks":
        return 2 * chunk
    if geometry == "tail":
        return chunk + 5 * bucket + bucket // 3  # 5 whole tail buckets + a partial one
    return bucket // 2 + 3


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _port_quantize(x: np.ndarray, bits: int, bucket: int):
    """The port's two quantize entry points on one flat buffer: the plain
    oracle and the dispatcher (chunk-kernel wrapper + dense tail)."""
    t = torch.from_numpy(x)
    q_plain = codec.quantize(t, bits, bucket)
    q_disp = dispatch.quantize_batch(t[None], CompressionConfig(bits=bits, bucket_size=bucket))
    return q_plain, q_disp


@functools.lru_cache(maxsize=None)
def _jax_quantize(bits: int, bucket: int):
    return jax.jit(lambda v: jcodec.quantize(v, bits, bucket))


# ---------------------------------------------------------------------------
# Quantize.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_quantize_matches_host_codec(geometry, bucket):
    """Every bit width, both port entry points, against ``codec_host``."""
    n = _size(geometry, bucket)
    rng = np.random.default_rng(bucket + n)
    x = rng.standard_normal(n).astype(np.float32)
    for bits in range(1, 9):
        hq = codec_host.quantize(x, bits, bucket)
        for q in _port_quantize(x, bits, bucket):
            np.testing.assert_array_equal(_u32(q.packed.reshape(-1)), hq.packed, err_msg=f"bits={bits}")
            np.testing.assert_array_equal(
                q.meta.reshape(-1, 2).numpy().view(np.uint32), hq.meta.view(np.uint32),
                err_msg=f"bits={bits}",
            )


@pytest.mark.parametrize("bits,bucket,geometry", [
    (1, 32, "chunks"), (2, 96, "tail"), (3, 128, "sub"), (4, 512, "chunks"),
    (5, 1024, "tail"), (6, 32, "tail"), (7, 128, "chunks"), (8, 512, "tail"),
    (4, 96, "chunks"), (8, 1024, "sub"),
])
def test_quantize_matches_jax_codec(bits, bucket, geometry):
    n = _size(geometry, bucket)
    x = np.random.default_rng(bits * 7 + bucket).standard_normal(n).astype(np.float32)
    jq = _jax_quantize(bits, bucket)(jnp.asarray(x))
    for q in _port_quantize(x, bits, bucket):
        np.testing.assert_array_equal(_u32(q.packed.reshape(-1)), np.asarray(jq.packed))
        np.testing.assert_array_equal(
            q.meta.reshape(-1, 2).numpy(), np.asarray(jq.meta).astype(np.float32)
        )


@pytest.mark.parametrize("bits,bucket,geometry", [
    (1, 128, "chunks"), (4, 512, "chunks"), (8, 256, "chunks"),
    (4, 512, "tail"), (3, 96, "tail"),
])
def test_quantize_matches_pallas_interpret(bits, bucket, geometry):
    """The flat (B1) and chunk (B5) Pallas kernels in interpret mode."""
    n = _size(geometry, bucket)
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    pq = codec_pallas.quantize_batch(jnp.asarray(x)[None], bits, bucket, interpret=True)
    _, q = _port_quantize(x, bits, bucket)
    np.testing.assert_array_equal(_u32(q.packed), np.asarray(pq.packed))
    np.testing.assert_array_equal(q.meta.numpy(), np.asarray(pq.meta))


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("bits,bucket,geometry", [
    (4, 512, "tail"), (2, 128, "chunks"), (8, 96, "tail"),
])
def test_quantize_fuzz_recipes(kind, bits, bucket, geometry):
    """Extreme magnitudes, denormal-scale spikes and constant runs: same
    bytes as ``codec_host`` and ``codec.quantize``, and the port's decode
    matches the host decode bit for bit."""
    n = _size(geometry, bucket)
    x = fuzz_operand(np.random.default_rng(kind), n, kind)
    hq = codec_host.quantize(x, bits, bucket)
    jq = _jax_quantize(bits, bucket)(jnp.asarray(x))
    for q in _port_quantize(x, bits, bucket):
        packed = _u32(q.packed.reshape(-1))
        np.testing.assert_array_equal(packed, hq.packed)
        np.testing.assert_array_equal(packed, np.asarray(jq.packed))
        np.testing.assert_array_equal(q.meta.reshape(-1, 2).numpy(), hq.meta)
    y = dispatch.dequantize_batch(q)[0].numpy()
    np.testing.assert_array_equal(y.view(np.uint32), codec_host.dequantize(hq).view(np.uint32))


@pytest.mark.parametrize("bucket", [32, 512])
def test_constant_buckets_decode_exactly(bucket):
    n = _size("tail", bucket)
    per_bucket = np.resize(np.float32([2.5, -7.25, 0.0, 1e-38, 3e30]), codec.num_buckets(n, bucket))
    x = np.repeat(per_bucket, bucket)[:n]
    for bits in (1, 4, 8):
        for q in _port_quantize(x, bits, bucket):
            if q.packed.dim() == 2:
                y = dispatch.dequantize_batch(q)[0]
            else:
                y = codec.dequantize(q)
            np.testing.assert_array_equal(y.numpy(), x)


def test_skip_incomplete_buckets_residual():
    """The raw final partial bucket travels in ``residual``, as in the JAX
    codec, and decodes exactly."""
    bucket, bits = 128, 4
    n = _size("tail", bucket)
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    hq = codec_host.quantize(x, bits, bucket, skip_incomplete_buckets=True)
    cc = CompressionConfig(bits=bits, bucket_size=bucket, skip_incomplete_buckets=True)
    q = dispatch.quantize_batch(torch.from_numpy(x)[None], cc)
    np.testing.assert_array_equal(_u32(q.packed[0]), hq.packed)
    np.testing.assert_array_equal(q.residual[0].numpy(), hq.residual)
    y = dispatch.dequantize_batch(q)[0].numpy()
    np.testing.assert_array_equal(y, codec_host.dequantize(hq))
    np.testing.assert_array_equal(y[-(n % bucket):], x[-(n % bucket):])


def test_quantize_rejects_bad_bits():
    with pytest.raises(ValueError):
        codec.quantize(torch.zeros(64), 0, 32)
    with pytest.raises(ValueError):
        codec.quantize(torch.zeros(64), 9, 32)


# ---------------------------------------------------------------------------
# Dequantize.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,bucket,geometry", [
    (1, 32, "tail"), (4, 512, "chunks"), (4, 512, "tail"), (8, 96, "chunks"),
    (3, 1024, "tail"), (6, 128, "sub"),
])
def test_dequantize_matches_host_and_jax(bits, bucket, geometry):
    n = _size(geometry, bucket)
    rng = np.random.default_rng(n + bits)
    x = rng.standard_normal(n).astype(np.float32)
    acc = rng.standard_normal(n).astype(np.float32)
    hq = codec_host.quantize(x, bits, bucket)
    jq = _jax_quantize(bits, bucket)(jnp.asarray(x))
    q_plain, q_disp = _port_quantize(x, bits, bucket)
    for add in (None, acc):
        want = codec_host.dequantize(hq, add_to=add)
        jax_y = np.asarray(jcodec.dequantize(jq, add_to=None if add is None else jnp.asarray(add)))
        got_plain = codec.dequantize(
            q_plain, add_to=None if add is None else torch.from_numpy(add)
        ).numpy()
        got_disp = dispatch.dequantize_batch(
            q_disp, add_to=None if add is None else torch.from_numpy(add)[None]
        )[0].numpy()
        for got in (got_plain, got_disp):
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
            np.testing.assert_array_max_ulp(got, jax_y, maxulp=1)


def test_dequantize_fused_add_matches_unfused():
    """Whole-chunk rows fuse the accumulate into the decode; the value is
    the same single float32 add either way."""
    bits, bucket = 4, 128
    n = _size("chunks", bucket)
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    q = codec_cuda.quantize_batch(xs, bits, bucket)
    fused = codec_cuda.dequantize_batch(q, add_to=acc)
    unfused = acc + codec_cuda.dequantize_batch(q)
    np.testing.assert_array_equal(fused.numpy(), unfused.numpy())


# ---------------------------------------------------------------------------
# The fused SRA epilogue.
# ---------------------------------------------------------------------------


def _grid_rows(ws: int, chunk: int) -> np.ndarray:
    """Decode-exact stage-1 rows: integer grids whose buckets all hold 0
    and 15, so every unit is exact, every level exact and every decode
    exact whether or not the multiply-add is fused."""
    return np.stack([np.float32((np.arange(chunk) * (2 * r + 3)) % 16) for r in range(ws)])


def _jax_epilogue(xs: np.ndarray, own: int, bits: int, bucket: int, mode: str):
    """JAX stage-1 quantize of the rows, then its epilogue: the Pallas
    kernel in interpret mode ("fused") or the staged ops ("staged")."""
    cc = JCompressionConfig(bits=bits, bucket_size=bucket)
    q = jdispatch.quantize_batch(jnp.asarray(xs), cc)
    raw = jnp.asarray(xs[own])
    if mode == "fused":
        return codec_pallas.sra_epilogue_batch(
            q, raw_row=raw, own_idx=jnp.int32(own), interpret=True
        )
    return jdispatch.reduce_rows_requantize(q, cc, raw_rows=jnp.asarray(xs), own_idx=jnp.int32(own))


def _port_epilogue(xs: np.ndarray, own: int, bits: int, bucket: int, mode: str, monkeypatch):
    monkeypatch.setenv(tcfg.SRA_EPILOGUE, mode)
    cc = CompressionConfig(bits=bits, bucket_size=bucket)
    t = torch.from_numpy(xs)
    q = dispatch.quantize_batch(t, cc)
    assert dispatch.fused_epilogue_would_run(q) == (mode == "fused")
    return dispatch.reduce_rows_requantize(q, cc, raw_rows=t, own_idx=own)


@pytest.mark.parametrize("ws,bits,bucket", [(1, 4, 128), (4, 4, 128), (4, 2, 256), (4, 8, 128)])
def test_epilogue_bytes_match_jax_on_decode_exact_data(ws, bits, bucket, monkeypatch):
    chunk = 2 * codec.CHUNK_BUCKETS * bucket
    xs = _grid_rows(ws, chunk)
    own = ws - 1
    ref = _jax_epilogue(xs, own, bits, bucket, "fused")
    ref_staged = _jax_epilogue(xs, own, bits, bucket, "staged")
    np.testing.assert_array_equal(np.asarray(ref.packed), np.asarray(ref_staged.packed))
    for mode in ("fused", "staged"):
        q = _port_epilogue(xs, own, bits, bucket, mode, monkeypatch)
        np.testing.assert_array_equal(_u32(q.packed), np.asarray(ref.packed), err_msg=mode)
        np.testing.assert_array_equal(q.meta.numpy(), np.asarray(ref.meta), err_msg=mode)


@pytest.mark.parametrize("ws,bits", [(4, 4), (2, 8)])
def test_epilogue_random_data_within_envelope(ws, bits, monkeypatch):
    """On random data the fused and staged port lowerings give the same
    bytes; the decoded stage-2 payload stays within the allreduce envelope
    of the exact sum and of the JAX kernel's decode."""
    bucket = 128
    chunk = 2 * codec.CHUNK_BUCKETS * bucket
    xs = np.random.default_rng(ws + bits).standard_normal((ws, chunk)).astype(np.float32)
    own = 1
    fused = _port_epilogue(xs, own, bits, bucket, "fused", monkeypatch)
    staged = _port_epilogue(xs, own, bits, bucket, "staged", monkeypatch)
    np.testing.assert_array_equal(_u32(fused.packed), _u32(staged.packed))
    np.testing.assert_array_equal(fused.meta.numpy(), staged.meta.numpy())
    got = dispatch.dequantize_batch(fused)[0].numpy()
    ref = np.asarray(jcodec.dequantize(jax.tree.map(lambda a: a[0], _jax_epilogue(xs, own, bits, bucket, "fused"))))
    exact = xs.astype(np.float64).sum(axis=0)
    step = float((xs.max() - xs.min()) / bucket)
    bound = codec.allreduce_error_bound(chunk, bits, bucket, ws, step)
    assert np.abs(got - exact).max() <= bound
    assert np.abs(got - ref).max() <= bound


def test_epilogue_refuses_unported_modes(monkeypatch):
    """Every mode of the epilogue runs (none is refused any more): under
    ``CGX_SRA_ACCUM=int8`` the fused epilogue folds in the level domain,
    giving the JAX kernel's bytes on decode-exact rows (unit 1, so every
    product is exact), an explicit ``accum`` overrides the knob, and a bad
    value raises ``ValueError``; stochastic rounding runs with a key."""
    cc = CompressionConfig(bits=4, bucket_size=128)
    xs = torch.from_numpy(_grid_rows(2, codec.CHUNK_BUCKETS * 128))
    xs[0] = torch.from_numpy(np.random.default_rng(3).standard_normal(xs.shape[1]).astype(np.float32))
    q = dispatch.quantize_batch(xs, cc)
    exact = codec_cuda.sra_epilogue_batch(q, raw_row=xs[0], own_idx=0)
    monkeypatch.setenv(tcfg.SRA_ACCUM, "int8")
    got = codec_cuda.sra_epilogue_batch(q, raw_row=xs[0], own_idx=0)
    jq = jdispatch.quantize_batch(jnp.asarray(xs.numpy()), JCompressionConfig(bits=4, bucket_size=128))
    want = codec_pallas.sra_epilogue_batch(jq, raw_row=jnp.asarray(xs[0].numpy()),
                                           own_idx=jnp.int32(0), interpret=True)
    np.testing.assert_array_equal(_u32(got.packed), np.asarray(want.packed))
    np.testing.assert_array_equal(got.meta.numpy(), np.asarray(want.meta))
    pinned = codec_cuda.sra_epilogue_batch(q, raw_row=xs[0], own_idx=0, accum="exact")
    assert torch.equal(pinned.packed, exact.packed) and torch.equal(pinned.meta, exact.meta)
    with pytest.raises(ValueError, match="accum"):
        codec_cuda.sra_epilogue_batch(q, raw_row=xs[0], own_idx=0, accum="int4")
    monkeypatch.delenv(tcfg.SRA_ACCUM)
    # Stochastic rounding is ported: with no key it rounds to nearest (the
    # JAX package's rule), with one it runs, fused epilogue included.
    monkeypatch.setenv(tcfg.STOCHASTIC_ROUNDING, "1")
    cc_s = tcfg.CompressionConfig(bits=4, bucket_size=128, stochastic=True)
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(xs.shape, dtype=np.float32))
    q = dispatch.quantize_batch(xs, cc)
    nokey = dispatch.quantize_batch(xs, cc_s)
    assert torch.equal(nokey.packed, q.packed) and torch.equal(nokey.meta, q.meta)
    k = prng.key(7)
    sq = dispatch.quantize_batch(xs, cc_s, k)
    assert torch.equal(sq.meta, q.meta) and not torch.equal(sq.packed, q.packed)
    seed = prng.seed_from_key(k)
    fused = codec_cuda.sra_epilogue_batch(q, raw_row=xs[0], own_idx=0, seed=seed)
    reduced = dispatch.reduce_rows(q, raw_rows=xs, own_idx=0)
    staged = codec_cuda.quantize_batch(reduced[None], 4, 128, seed=seed)
    assert torch.equal(fused.packed, staged.packed) and torch.equal(fused.meta, staged.meta)


def test_supports_reduce_geometry():
    cc = CompressionConfig(bits=4, bucket_size=128)
    whole = dispatch.quantize_batch(torch.zeros(1, 2 * 32 * 128), cc)
    assert codec_cuda.supports_reduce(whole)
    tail = dispatch.quantize_batch(torch.zeros(1, 33 * 128), cc)
    assert not codec_cuda.supports_reduce(tail)
    odd = dispatch.quantize_batch(torch.zeros(1, 32 * 96), CompressionConfig(bits=4, bucket_size=96))
    assert not codec_cuda.supports_reduce(odd)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A wrapper picks the plain version only for a CPU tensor: with a CUDA
    operand it builds and launches its kernel, or raises."""
    calls = []
    monkeypatch.setattr(codec_cuda, "quantize_chunks_plain", lambda *a: calls.append(a))
    x = torch.zeros(32 * 32)
    monkeypatch.setattr(codec_cuda, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(codec_cuda, "_lib", lambda: (_ for _ in ()).throw(RuntimeError("no kernel library")))
    with pytest.raises(RuntimeError, match="no kernel library"):
        codec_cuda.quantize_chunks(x, 4, 32)
    assert not calls
