"""The port's multi-row reduce (B4) against the JAX package's, on the CPU.

On the CPU the port runs its plain PyTorch versions; these must give the
JAX package's values exactly: B4's plain version, directly and through
``dispatch.reduce_rows`` in both lowerings, against the JAX package's
staged ``dispatch.reduce_rows`` (every fuzz recipe and the decode-exact
grid, ws 1-8 and 11, the raw own row in every position and none), against
``codec_pallas.reduce_rows_batch(interpret=True)`` (bit for bit on
decode-exact data, within the fused multiply-add's envelope on random
data), the rows=1 decode-add, the refusals and the int8 fold, and the
fused-reduce gate. (These tests were the largest part of
``test_torch_codec.py``; a file of their own runs on an xdist worker of its
own.)

The CUDA kernel itself runs only on the card: ``test_torch_kernels.py``
holds it against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fuzz_operand
from test_torch_codec import _grid_rows, _size, _u32
from torch_cgx_tpu.config import CompressionConfig as JCompressionConfig
from torch_cgx_tpu.ops import codec_pallas
from torch_cgx_tpu.ops import dispatch as jdispatch
from torch_cgx_tpu_torch import config as tcfg
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.ops import codec, codec_cuda, dispatch


# ---------------------------------------------------------------------------
# The fused multi-row reduce (B4) and dispatch.reduce_rows.
# ---------------------------------------------------------------------------


def _reduce_rows_inputs(ws: int, bucket: int):
    """Stage-1 rows of whole chunks: the decode-exact grid and the three
    fuzz recipes (each row scaled differently)."""
    n = 2 * codec.CHUNK_BUCKETS * bucket
    rng = np.random.default_rng(ws * 1000 + bucket)
    out = {"grid": _grid_rows(ws, n)}
    for kind in (0, 1, 2):
        out[f"recipe{kind}"] = np.stack(
            [fuzz_operand(rng, n, kind) * np.float32(r + 1) for r in range(ws)]
        )
    return out


def _jax_stage1(xs: np.ndarray, bits: int, bucket: int, monkeypatch):
    """The JAX package's stage-1 rows of ``xs``, under its staged lowering."""
    monkeypatch.setenv(tcfg.SRA_EPILOGUE, "staged")
    return jdispatch.quantize_batch(jnp.asarray(xs), JCompressionConfig(bits=bits, bucket_size=bucket))


def _jax_reduce_rows(q, xs: np.ndarray, own, monkeypatch):
    """The JAX package's staged ``dispatch.reduce_rows`` of the rows ``q``
    (quantized from ``xs``), the raw own row ``xs[own]`` or none."""
    monkeypatch.setenv(tcfg.SRA_EPILOGUE, "staged")
    kw = {} if own is None else dict(raw_rows=jnp.asarray(xs), own_idx=jnp.int32(own))
    return np.asarray(jdispatch.reduce_rows(q, **kw))


@pytest.mark.parametrize("ws", [1, 2, 3, 4, 5, 6, 7, 8, 11])
@pytest.mark.parametrize("bits,bucket", [(1, 128), (4, 128), (8, 128), (1, 512), (4, 512), (8, 512)])
def test_reduce_rows_matches_jax(ws, bits, bucket, monkeypatch):
    """B4's plain version (directly and through ``dispatch.reduce_rows`` in
    both lowerings) against the JAX package's staged ``dispatch.reduce_rows``:
    every recipe, the raw own row in every position and none; tolerance 0.
    Each recipe's rows are quantized once on each side; every own position
    runs its own JAX reduce."""
    cc = CompressionConfig(bits=bits, bucket_size=bucket)
    for name, xs in _reduce_rows_inputs(ws, bucket).items():
        t = torch.from_numpy(xs)
        q = dispatch.quantize_batch(t, cc)
        jq = _jax_stage1(xs, bits, bucket, monkeypatch)
        for own in [None] + list(range(ws)):
            want = _jax_reduce_rows(jq, xs, own, monkeypatch)
            raw = None if own is None else t[own]
            got = {
                "plain": codec_cuda.reduce_rows_chunks_plain(
                    q.packed, q.meta, raw, -1 if own is None else own, bits, bucket
                ),
            }
            kw = {} if own is None else dict(raw_rows=t, own_idx=own)
            for mode in ("staged", "fused"):
                monkeypatch.setenv(tcfg.SRA_EPILOGUE, mode)
                assert dispatch.fused_reduce_would_run(q) == (mode == "fused" and ws > 1)
                got[mode] = dispatch.reduce_rows(q, **kw)
            for k, v in got.items():
                np.testing.assert_array_equal(
                    _u32(v), want.view(np.uint32), err_msg=f"{name} own={own} {k}"
                )


@pytest.mark.parametrize("ws", [1, 2, 4])
@pytest.mark.parametrize("bits,bucket", [(1, 128), (4, 128), (8, 128), (4, 512)])
def test_reduce_rows_matches_pallas_interpret(ws, bits, bucket):
    """Against ``codec_pallas.reduce_rows_batch(interpret=True)``: bit for
    bit on decode-exact data. On random data within 2*ws ulps of the
    largest partial sum: the interpreted kernel body is compiled by XLA,
    which may fuse the decode's multiply-add; the port rounds the product
    first, as the JAX package's staged path does."""
    cc = CompressionConfig(bits=bits, bucket_size=bucket)
    inputs = _reduce_rows_inputs(ws, bucket)
    for name in ("grid", "recipe0"):
        xs = inputs[name]
        jq = jdispatch.quantize_batch(jnp.asarray(xs), JCompressionConfig(bits=bits, bucket_size=bucket))
        q = dispatch.quantize_batch(torch.from_numpy(xs), cc)
        scale = np.abs(xs).astype(np.float64).sum(axis=0).max()
        for own in [None] + list(range(ws)):
            want = np.asarray(codec_pallas.reduce_rows_batch(
                jq, raw_row=None if own is None else jnp.asarray(xs[own]),
                own_idx=None if own is None else jnp.int32(own), interpret=True,
            ))
            raw = None if own is None else torch.from_numpy(xs[own])
            got = codec_cuda.reduce_rows_batch(q, raw_row=raw, own_idx=own).numpy()
            if name == "grid":
                np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
            else:
                tol = 2 * ws * np.spacing(np.float32(scale))
                np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"own={own}")


@pytest.mark.parametrize("bits,bucket,geometry", [
    (4, 512, "chunks"), (4, 512, "tail"), (2, 128, "chunks"), (8, 96, "tail"), (3, 128, "sub"),
])
def test_reduce_rows_add_to_matches_jax(bits, bucket, geometry, monkeypatch):
    """The rows=1 decode-add (the Ring hop's accumulate) bit for bit."""
    n = _size(geometry, bucket)
    rng = np.random.default_rng(n * bits)
    x = rng.standard_normal(n).astype(np.float32)
    acc = rng.standard_normal(n).astype(np.float32)
    jq = jdispatch.quantize_batch(jnp.asarray(x)[None], JCompressionConfig(bits=bits, bucket_size=bucket))
    want = np.asarray(jdispatch.reduce_rows(jq, add_to=jnp.asarray(acc)))
    q = dispatch.quantize_batch(torch.from_numpy(x)[None], CompressionConfig(bits=bits, bucket_size=bucket))
    for mode in ("staged", "fused"):
        monkeypatch.setenv(tcfg.SRA_EPILOGUE, mode)
        got = dispatch.reduce_rows(q, add_to=torch.from_numpy(acc))
        np.testing.assert_array_equal(_u32(got), want.view(np.uint32), err_msg=mode)


def test_reduce_rows_refuses_unported_modes_and_bad_rows(monkeypatch):
    cc = CompressionConfig(bits=4, bucket_size=128)
    xs = torch.from_numpy(_grid_rows(2, codec.CHUNK_BUCKETS * 128))
    q = dispatch.quantize_batch(xs, cc)
    with pytest.raises(ValueError, match="own"):
        codec_cuda.reduce_rows_chunks(q.packed, q.meta, None, 1, 4, 128)
    with pytest.raises(ValueError, match="raw_rows or raw_row"):
        dispatch.reduce_rows(q, raw_rows=xs, raw_row=xs[0], own_idx=0)
    # CGX_SRA_ACCUM=int8 runs the level-domain fold: the JAX kernel's
    # values on decode-exact rows (unit 1: every product exact).
    monkeypatch.setenv(tcfg.SRA_ACCUM, "int8")
    got = codec_cuda.reduce_rows_batch(q, raw_row=xs[0], own_idx=0)
    jq = jdispatch.quantize_batch(jnp.asarray(xs.numpy()), JCompressionConfig(bits=4, bucket_size=128))
    jwant = codec_pallas.reduce_rows_batch(jq, raw_row=jnp.asarray(xs[0].numpy()),
                                           own_idx=jnp.int32(0), interpret=True)
    np.testing.assert_array_equal(_u32(got), np.asarray(jwant).view(np.uint32))
    monkeypatch.setenv(tcfg.SRA_ACCUM, "exact")
    want = codec_cuda.reduce_rows_batch(q)
    # The reduce has no requantize: under the mul encode it runs unchanged.
    monkeypatch.setenv(tcfg.CODEC_ENCODE, "mul")
    assert torch.equal(codec_cuda.reduce_rows_batch(q), want)


def test_supports_reduce_without_requantize_has_no_tile_limit():
    """Neither the reduce nor the epilogue keeps a (32, B) tile: a bucket
    past a block's shared memory (B >= 1,920) takes the fused kernels, the
    epilogue included, up to the JAX package's gate (ws x 32 x B within
    2^20, B at most 16,384)."""
    cc = CompressionConfig(bits=4, bucket_size=2048)
    q = dispatch.quantize_batch(torch.zeros(2, 32 * 2048), cc)
    assert 32 * 2048 * 4 > codec_cuda.MAX_EPILOGUE_TILE_BYTES
    assert codec_cuda.supports_reduce(q)
    jq = jdispatch.quantize_batch(jnp.zeros((2, 32 * 2048)), JCompressionConfig(bits=4, bucket_size=2048))
    assert codec_pallas.supports_reduce(jq)
    for rows, b in ((2, 16384), (4, 16384), (1, 32768), (4, 8192), (8, 4096), (8, 8192)):
        cc, jcc = CompressionConfig(bits=4, bucket_size=b), JCompressionConfig(bits=4, bucket_size=b)
        q = dispatch.quantize_batch(torch.zeros(rows, 32 * b), cc)
        jq = jdispatch.quantize_batch(jnp.zeros((rows, 32 * b)), jcc)
        assert codec_cuda.supports_reduce(q) == codec_pallas.supports_reduce(jq)
        assert codec_cuda.supports_reduce(q) == (rows * b <= 2**15 and b <= 16384)
