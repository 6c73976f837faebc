"""Producer fusion in the port (``ops/fused_producer.py``) against the JAX
package's, on the CPU.

* ``_kernel_geometry`` equals the JAX function over the GPT-2 124M dense
  layers, world sizes, buckets and contraction lengths; the port's one extra
  condition (the kernel's (32, B) tile must fit shared memory) is the only
  difference allowed.
* The matmul-quantize kernel's plain version against the JAX kernel in
  interpret mode (``_matmul_quantize_q(interpret=True)``, as
  ``tests/test_fused_producer.py`` runs it) and against the JAX
  ``quantize_batch`` of the same product: bytes equal on small-integer
  operands (every sum exact), meta within 1e-5 relative and decoded values
  within one level step on normal operands.
* ``Dense`` outputs and gradients bit-identical to the plain expression with
  the knob off, on but unconfigured, and engaged; engaged, one payload for
  each eligible layer.
* The stash: epoch, claim and drain; every fallback reason counted; an
  in-place or out-of-place rewrite of ``p.grad`` and a second backward in
  one step leave the entry unclaimable and are counted.
* Two spawned gloo ranks train a tiny float32 GPT-2 through
  ``make_train_step``: with ``CGX_PRODUCER_FUSE=on`` the parameters are
  bit-identical to the run with it off and every eligible payload is
  consumed; against the JAX ``make_train_step`` with the producer on over a
  2-device CPU mesh from the same weights, the consumed-slice counts are
  equal and the parameters agree within ``3 * LR``, the tolerance of
  ``test_torch_gpt2_step.py::test_train_steps_match_jax_float32``. On the
  same ranks, one producer-on ``gradient_sync`` of a dense layer's exact
  integer gradients is bit-identical to the JAX ``gradient_sync`` with the
  producer on, and to the port's own run with it off.

C4, the skipped weight gradient: inside ``make_train_step`` a wrapped
layer whose payload the sync will consume returns no ``dw``. Spawned gloo
ranks at ws 2 and 4 train a tiny float32 GPT-2 for three steps: the
parameters are bit-identical to ``CGX_PRODUCER_FUSE=off``, every eligible
layer skips (``producer_dw_skipped``) and only the fallen-back layers run
the plain product; a layer applied twice in one forward does not skip and
its gradient matches; a direct ``gradient_sync`` still gets ``p.grad``; the
one-layer sync through ``make_train_step`` with the skip is bit-identical to
the JAX producer-on sync. In one process: a forced allreduce-side mismatch
on a skipped layer raises ``RuntimeError``.

The single-process tests stand one process in for a rank of a 2-rank group
by setting the producer's recorded world size; the rank bodies import only
torch and the port.
"""

import dataclasses
import multiprocessing as mp
import os
import queue
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.models import Dense, GPT2, GPT2Config, lm_loss
from torch_cgx_tpu_torch.ops import codec_cuda, dispatch
from torch_cgx_tpu_torch.ops import fused_producer as fp
from torch_cgx_tpu_torch.parallel import allreduce

WS = 2
BITS, BUCKET = 4, 128
LR = 1e-4
STEPS = 2
SPAWN_TIMEOUT_S = 300.0
META_RTOL = 1e-5
# GPT-2 124M's dense layers (din, o).
GPT2_LAYERS = {"attn_qkv": (768, 2304), "attn_proj": (768, 768),
               "mlp_in": (768, 3072), "mlp_out": (3072, 768)}
PRODUCER_ENV = {
    "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS),
    "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
    "CGX_STANDALONE_LAYER_ELEMS": "32768",
}
# The one-layer sync case: a (256, 512) dense layer whose input is the
# identity, so its weight gradient is the loss's cotangent, an integer grid.
SYNC_DIN, SYNC_O, SYNC_BITS = 256, 512, 2
# Its bf16-compute case keeps the cotangent's first 16 rows: the bias
# gradient (a column sum, at most 16 x 15) stays an integer below 2^8, exact
# in bf16 whatever order either framework sums in.
SYNC16_ROWS = 16
# The bf16 tiny GPT-2 against the JAX package (see its test).
BF16_LOSS_RTOL = 1e-3
BF16_FAR_SHARE = 0.01


def _sync_cotangent(rank):
    """Rank ``rank``'s cotangent: each run of 16 values is a permutation of
    0..15 that starts with 0 (a seeded odd stride per run), so every bucket
    holds 0 and 15 and its minimum sits at the same places on every rank,
    while the wire rows differ. Divided by the world size and quantized at
    2 bits, each level decodes exactly (0 + 2.5 * lvl), and the stage-2
    minimum is 0 too: the port and the JAX package must agree bit for bit."""
    runs = SYNC_DIN * SYNC_O // 16
    stride = 2 * np.random.default_rng(rank).integers(0, 8, runs) + 1
    return np.float32((np.arange(16)[None, :] * stride[:, None]) % 16).reshape(SYNC_DIN, SYNC_O)


@pytest.fixture(autouse=True)
def _fresh_producer():
    fp.deconfigure()
    fp.reset_counts()
    yield
    fp.deconfigure()
    fp.reset_counts()


@pytest.fixture
def engaged(monkeypatch):
    """The plane on and configured, this process standing in for rank 0 of
    a 2-rank group."""
    for k, v in PRODUCER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CGX_PRODUCER_FUSE", "on")
    fp.configure(None, divisor=WS, active=True)
    fp._CFG.update(ws=WS, rank=0)
    fp.begin_step()
    return monkeypatch


def _operands(seed, k, din, o, integer):
    rng = np.random.default_rng(seed)
    if integer:
        return (rng.integers(-3, 4, (k, din)).astype(np.float32),
                rng.integers(-3, 4, (k, o)).astype(np.float32))
    return (rng.standard_normal((k, din)).astype(np.float32),
            rng.standard_normal((k, o)).astype(np.float32))


def _close(words, meta, want_words, want_meta, bits, bucket):
    """Meta within META_RTOL relative (to the larger of the value and its
    bucket's level step); decoded values within one level step plus what
    the meta's difference moves them."""
    m = torch.as_tensor(np.array(meta)).reshape(-1, 2).double()
    wm = torch.as_tensor(np.array(want_meta)).reshape(-1, 2).double()
    unit = wm[:, 0]
    dm = (m - wm).abs()
    assert bool((dm <= META_RTOL * torch.maximum(wm.abs(), unit[:, None])).all())

    def decode(w, mt):
        w = torch.as_tensor(np.array(w).view(np.int32)).reshape(-1)
        mt = torch.as_tensor(np.array(mt)).reshape(-1, 2).float()
        return codec_cuda.dequantize_chunks_plain(w, mt, bits, bucket).double().view(-1, bucket)

    a, b = decode(words, meta), decode(want_words, want_meta)
    tol = (unit + dm[:, 1] + ((1 << bits) - 1) * dm[:, 0])[:, None]
    tol = tol + 2 * np.finfo(np.float32).eps * torch.maximum(a.abs(), b.abs())
    assert bool(((a - b).abs() <= tol).all())


# ---------------------------------------------------------------------------
# Geometry.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws", [2, 4, 8])
@pytest.mark.parametrize("bucket", [96, 128, 512, 1024, 2048])
def test_kernel_geometry_matches_jax(ws, bucket):
    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.ops import fused_producer as jfp

    cc, jcc = CompressionConfig(bits=4, bucket_size=bucket), JCC(bits=4, bucket_size=bucket)
    tile_fits = 32 * bucket * 4 <= codec_cuda.MAX_EPILOGUE_TILE_BYTES
    for din, o in GPT2_LAYERS.values():
        chunk = din * o // ws
        for k in (64, 1000, 1024):
            want = jfp._kernel_geometry(k, din, o, ws, chunk, jcc)
            assert fp._kernel_geometry(k, din, o, ws, chunk, cc, check_tile=False) == want
            assert fp._kernel_geometry(k, din, o, ws, chunk, cc) == (want if tile_fits else None)


# ---------------------------------------------------------------------------
# The matmul-quantize's plain version against the JAX package.
# ---------------------------------------------------------------------------


def _jax_kernel_q(x2, g2, bits, bucket, div, ws=WS):
    import jax.numpy as jnp

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.ops import fused_producer as jfp

    cc = JCC(bits=bits, bucket_size=bucket)
    k, din = x2.shape
    o = g2.shape[1]
    chunk = din * o // ws
    tm, tk = jfp._kernel_geometry(k, din, o, ws, chunk, cc)
    q = jfp._matmul_quantize_q(
        jnp.asarray(x2), jnp.asarray(g2), cc, ws=ws, chunk=chunk, div=div,
        tm=tm, tk=tk, interpret=True,
    )
    return np.asarray(q.packed).reshape(-1), np.asarray(q.meta).reshape(-1, 2)


@pytest.mark.parametrize("div", [1, 2])
@pytest.mark.parametrize("bucket", [128, 512])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_plain_matches_jax_kernel_on_integers(bits, bucket, div):
    x2, g2 = _operands(bits * bucket + div, 64, 256, 512, integer=True)
    jw, jm = _jax_kernel_q(x2, g2, bits, bucket, div)
    w, m = codec_cuda.matmul_quantize_chunks_plain(
        torch.from_numpy(x2), torch.from_numpy(g2), div, bits, bucket
    )
    np.testing.assert_array_equal(w.numpy().view(np.uint32), jw.view(np.uint32))
    np.testing.assert_array_equal(m.numpy().view(np.uint32), jm.view(np.uint32))


@pytest.mark.parametrize("bucket", [128, 512])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_plain_matches_jax_kernel_divisor_3(bits, bucket):
    """At a divisor of 3 the JAX kernel divides as XLA on the CPU lowers a
    division by a constant: a multiply by the rounded reciprocal, which is
    not the IEEE quotient the port computes (``__fdiv_rn``, and ``t / ws``
    in the unfused path). Its bytes are held to the normal-operand
    tolerance, and the lowering itself is pinned here."""
    import jax
    import jax.numpy as jnp

    x2, g2 = _operands(bits * bucket + 3, 64, 256, 512, integer=True)
    jw, jm = _jax_kernel_q(x2, g2, bits, bucket, 3)
    w, m = codec_cuda.matmul_quantize_chunks_plain(
        torch.from_numpy(x2), torch.from_numpy(g2), 3, bits, bucket
    )
    _close(w.numpy(), m.numpy(), jw, jm, bits, bucket)
    dw = (torch.from_numpy(x2).t() @ torch.from_numpy(g2)).numpy()
    xla = np.asarray(jax.jit(lambda a: a / 3)(jnp.asarray(dw)))
    np.testing.assert_array_equal(xla, dw * (np.float32(1) / np.float32(3)))
    assert not np.array_equal(xla, dw / np.float32(3))


@pytest.mark.parametrize("bucket", [128, 512])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plain_matches_jax_kernel_on_normal_operands(bits, bucket):
    x2, g2 = _operands(7 * bits + bucket, 64, 256, 512, integer=False)
    jw, jm = _jax_kernel_q(x2, g2, bits, bucket, WS)
    w, m = codec_cuda.matmul_quantize_chunks_plain(
        torch.from_numpy(x2), torch.from_numpy(g2), WS, bits, bucket
    )
    _close(w.numpy(), m.numpy(), jw, jm, bits, bucket)


@pytest.mark.parametrize("div", [1, 2, 3])
@pytest.mark.parametrize("bits,bucket", [(1, 128), (4, 512), (8, 128)])
def test_plain_matches_jax_quantize_batch(bits, bucket, div):
    """The plain version equals the JAX ``quantize_batch`` of the (ws,
    chunk) rows of ``x2^T g2 / div`` (the division done in IEEE f32)."""
    import jax.numpy as jnp

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.ops import dispatch as jdispatch

    x2, g2 = _operands(bits + bucket + div, 64, 256, 512, integer=True)
    rows = (torch.from_numpy(x2).t() @ torch.from_numpy(g2) / div).numpy().reshape(WS, -1)
    q = jdispatch.quantize_batch(jnp.asarray(rows), JCC(bits=bits, bucket_size=bucket))
    w, m = codec_cuda.matmul_quantize_chunks_plain(
        torch.from_numpy(x2), torch.from_numpy(g2), div, bits, bucket
    )
    np.testing.assert_array_equal(
        w.numpy().view(np.uint32), np.asarray(q.packed).reshape(-1).view(np.uint32)
    )
    np.testing.assert_array_equal(m.numpy(), np.asarray(q.meta).reshape(-1, 2))


# The 16-bit operand form of B8: the JAX kernel reads x2 and g2 in the
# layer's compute dtype and contracts them with preferred_element_type=f32
# (fused_producer.py:573-576); its raw own row is the compute-dtype product
# dw_own.astype(w.dtype) / div (fused_producer.py:395-400).
DTYPES16 = [(torch.bfloat16, "bfloat16"), (torch.float16, "float16")]


def _operands16(seed, k, din, o, integer, jdtype):
    """``_operands`` rounded to the 16-bit dtype (integers stay exact), as
    numpy arrays of that dtype for JAX and torch tensors for the port."""
    import jax.numpy as jnp

    x2, g2 = _operands(seed, k, din, o, integer)
    jx, jg = jnp.asarray(x2, getattr(jnp, jdtype)), jnp.asarray(g2, getattr(jnp, jdtype))
    tdt = dict((j, t) for t, j in DTYPES16)[jdtype]
    return jx, jg, torch.from_numpy(x2).to(tdt), torch.from_numpy(g2).to(tdt)


def _jax_kernel_q16(jx, jg, bits, bucket, div, ws=WS):
    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.ops import fused_producer as jfp

    cc = JCC(bits=bits, bucket_size=bucket)
    k, din = jx.shape
    o = jg.shape[1]
    chunk = din * o // ws
    tm, tk = jfp._kernel_geometry(k, din, o, ws, chunk, cc)
    q = jfp._matmul_quantize_q(jx, jg, cc, ws=ws, chunk=chunk, div=div, tm=tm, tk=tk, interpret=True)
    return np.asarray(q.packed).reshape(-1), np.asarray(q.meta).reshape(-1, 2)


@pytest.mark.parametrize("div", [1, 2])
@pytest.mark.parametrize("bits,bucket", [(2, 128), (4, 512), (8, 128)])
@pytest.mark.parametrize("tdt,jdt", DTYPES16, ids=["bf16", "f16"])
def test_plain16_matches_jax_kernel_on_integers(tdt, jdt, bits, bucket, div):
    """Integer-valued 16-bit operands: every product and sum exact in f32,
    so the plain version's words and meta equal the JAX kernel's (interpret
    mode, bf16 or f16 operands) bit for bit."""
    jx, jg, x2, g2 = _operands16(bits * bucket + div, 64, 256, 512, True, jdt)
    jw, jm = _jax_kernel_q16(jx, jg, bits, bucket, div)
    w, m = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket)  # CPU: the plain version
    assert x2.dtype == tdt
    np.testing.assert_array_equal(w.numpy().view(np.uint32), jw.view(np.uint32))
    np.testing.assert_array_equal(m.numpy().view(np.uint32), jm.view(np.uint32))


@pytest.mark.parametrize("bits,bucket", [(4, 512), (8, 128)])
@pytest.mark.parametrize("tdt,jdt", DTYPES16, ids=["bf16", "f16"])
def test_plain16_matches_jax_kernel_on_normal_operands(tdt, jdt, bits, bucket):
    """Normal 16-bit operands: the f32 sums differ by their order only, so
    the bytes are held to the f32 test's tolerance (``_close``)."""
    jx, jg, x2, g2 = _operands16(11 * bits + bucket, 64, 256, 512, False, jdt)
    jw, jm = _jax_kernel_q16(jx, jg, bits, bucket, WS)
    w, m = codec_cuda.matmul_quantize_chunks_plain(x2, g2, WS, bits, bucket)
    _close(w.numpy(), m.numpy(), jw, jm, bits, bucket)


@pytest.mark.parametrize("div", [1, 2])
@pytest.mark.parametrize("tdt,jdt", DTYPES16, ids=["bf16", "f16"])
def test_plain16_raw_row_matches_jax_dw_own(tdt, jdt, div):
    """The raw own row of each rank position against the JAX package's
    route (``_maybe_stash``): the 1/ws-sized dot of the own columns of x2
    in the compute dtype, ``.astype(f32)``, then ``/ div``, on exact-sum
    data (integer operands: the f32 sums are exact, and both round them
    once to the compute dtype; sums past 2^8 round in bf16, past 2^11 in
    f16, and both occur)."""
    from jax import lax

    import jax.numpy as jnp

    rng = np.random.default_rng(17 + div)
    xn, gn = (rng.integers(-15, 16, (256, c)).astype(np.float32) for c in (256, 512))
    jx, jg = jnp.asarray(xn, getattr(jnp, jdt)), jnp.asarray(gn, getattr(jnp, jdt))
    x2, g2 = torch.from_numpy(xn).to(tdt), torch.from_numpy(gn).to(tdt)
    rows_per = 256 // WS
    for own in range(WS):
        x_own = lax.dynamic_slice(jx, (0, own * rows_per), (jx.shape[0], rows_per))
        dw_own = lax.dot_general(x_own, jg, (((0,), (0,)), ((), ())), precision=None).astype(jnp.float32)
        want = np.asarray(dw_own.reshape(-1) / div if div != 1 else dw_own.reshape(-1))
        _, _, raw = codec_cuda.matmul_quantize_chunks(x2, g2, div, 4, 128, own_row=(own, WS))
        np.testing.assert_array_equal(raw.numpy().view(np.uint32), want.view(np.uint32), err_msg=str(own))
    sums = (torch.from_numpy(np.asarray(jx, np.float32)).t() @ torch.from_numpy(np.asarray(jg, np.float32)))
    assert bool((sums.to(tdt).float() != sums).any())  # the compute dtype's rounding is exercised


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_16bit_operands_reach_the_kernel_uncast(engaged, tdt):
    """An engaged 16-bit dense backward hands the kernel wrapper its
    operands in the compute dtype, uncast, and stages the wrapper's own
    words, meta and raw row; the wrapper refuses operands of two dtypes."""
    seen = []
    real = codec_cuda.matmul_quantize_chunks

    def spy(x2, g2, *a, **kw):
        seen.append((x2.dtype, g2.dtype))
        out = real(x2, g2, *a, **kw)
        seen.append(out)
        return out

    engaged.setattr(codec_cuda, "matmul_quantize_chunks", spy)
    *_, layer = _dense_run(tdt)
    assert seen[0] == (tdt, tdt) and len(seen) == 2
    ent = fp.lookup("big.kernel", layer.kernel.grad)
    w, m, raw = seen[1]
    assert torch.equal(ent.q.packed.reshape(-1), w) and torch.equal(ent.q.meta.reshape(-1, 2), m)
    assert _same(ent.raw_row, raw)
    with pytest.raises(TypeError, match="one dtype"):
        real(torch.zeros(8, 128, dtype=tdt), torch.zeros(8, 128), 2, 4, 128)


def test_kernel_wrapper_refuses_unported_modes(monkeypatch):
    """Stochastic rounding is still refused; the mul encode is not: under
    ``CGX_CODEC_ENCODE=mul`` the wrapper gives its plain version's mul
    bytes, with the div encode's meta."""
    x2, g2 = (torch.from_numpy(t) for t in _operands(0, 64, 128, 256, integer=True))
    monkeypatch.setenv("CGX_CODEC_ENCODE", "mul")
    w, m = codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 512)
    pw, pm = codec_cuda.matmul_quantize_chunks_plain(x2, g2, 2, 4, 512, encode="mul")
    _, dm = codec_cuda.matmul_quantize_chunks_plain(x2, g2, 2, 4, 512, encode="div")
    assert torch.equal(w, pw) and torch.equal(m, pm)
    assert torch.equal(m, dm)
    monkeypatch.delenv("CGX_CODEC_ENCODE")
    monkeypatch.setenv("CGX_STOCHASTIC_ROUNDING", "1")
    with pytest.raises(NotImplementedError, match="stochastic"):
        codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 512)


# ---------------------------------------------------------------------------
# Dense.
# ---------------------------------------------------------------------------


def _dense_run(dtype, seed=0):
    torch.manual_seed(seed)
    layer = Dense(256, 512, dtype=dtype, generator=torch.Generator().manual_seed(seed))
    layer.kernel_path = "big.kernel"
    x = torch.randn(4, 16, 256, requires_grad=True)
    y = layer(x)
    (y.float() * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
    return y.detach(), x.grad, layer.kernel.grad, layer.bias.grad, layer


def _plain_expression(dtype, seed=0):
    """Today's expression, written out: cast, product, bias."""
    torch.manual_seed(seed)
    ref = Dense(256, 512, dtype=dtype, generator=torch.Generator().manual_seed(seed))
    x = torch.randn(4, 16, 256, requires_grad=True)
    xc = x.to(dtype)
    y = torch.matmul(xc, ref.kernel.to(dtype)) + ref.bias.to(dtype)
    (y.float() * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
    return y.detach(), x.grad, ref.kernel.grad, ref.bias.grad


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))


@pytest.mark.parametrize("mode", ["off", "on_unconfigured", "engaged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_bit_identical_to_plain_expression(monkeypatch, mode, dtype):
    for k, v in PRODUCER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CGX_PRODUCER_FUSE", "off" if mode == "off" else "on")
    if mode == "engaged":
        fp.configure(None, divisor=WS, active=True)
        fp._CFG.update(ws=WS, rank=1)
        fp.begin_step()
    *got, layer = _dense_run(dtype)
    want = _plain_expression(dtype)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert fp.stash_size() == (1 if mode == "engaged" else 0)
    if mode == "engaged":
        ent = fp.lookup("big.kernel", layer.kernel.grad)
        assert ent is not None and ent.q.packed.shape[0] == WS
        assert _same(ent.raw_row, (layer.kernel.grad.reshape(WS, -1)[1] / WS))


def test_knob_reads_and_validates(monkeypatch):
    from torch_cgx_tpu import config as jcfg
    from torch_cgx_tpu_torch import config as tcfg

    assert tcfg.producer_fuse() == jcfg.producer_fuse() == "auto"
    assert not fp.engaged()  # auto resolves to off in the port
    fp.configure(None, divisor=WS, active=True)
    assert not fp.active()  # the knob is read when the step configures
    monkeypatch.setenv("CGX_PRODUCER_FUSE", "ON")
    assert tcfg.producer_fuse() == "on"
    assert not fp.active()
    fp.configure(None, divisor=WS, active=True)
    assert fp.active()
    monkeypatch.setenv("CGX_PRODUCER_FUSE", "bogus")
    with pytest.raises(ValueError, match="CGX_PRODUCER_FUSE must be auto|on|off"):
        tcfg.producer_fuse()
    with pytest.raises(ValueError, match="CGX_PRODUCER_FUSE must be auto|on|off"):
        fp.configure(None, divisor=WS, active=True)
    with pytest.raises(ValueError, match="CGX_PRODUCER_FUSE must be auto|on|off"):
        jcfg.producer_fuse()


def test_engaged_gpt2_stages_one_payload_per_eligible_layer(engaged):
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, size=(2, 32)))
    lm_loss(model(tokens), tokens).backward()
    n_layer = model.cfg.n_layer
    assert fp.stash_size() == 3 * n_layer  # qkv, mlp_in, mlp_out of each block
    assert fp.COUNTS["producer_staged"] == 3 * n_layer
    assert fp.COUNTS["producer_kernel_slices"] == 3 * n_layer
    assert fp.COUNTS["producer_fallback_fused_group"] == n_layer  # attn_proj
    assert fp.COUNTS["producer_fallbacks"] == n_layer
    for n, p in model.named_parameters():
        ent = fp.lookup(n, p.grad)
        assert (ent is not None) == (n.endswith(("attn_qkv.kernel", "mlp_in.kernel", "mlp_out.kernel")))
        if ent is not None:  # the kernel's plain version: the bytes the allreduce would send
            want = dispatch.quantize_batch((p.grad.reshape(-1) / WS).view(WS, -1), ent.cc)
            assert torch.equal(ent.q.packed, want.packed) and torch.equal(ent.q.meta, want.meta)


def test_kernel_mode_on_takes_the_plain_kernel_on_cpu(engaged):
    """CPU operands take the kernel wrapper's plain version, which equals the
    quantize the unfused allreduce would make of the returned gradient."""
    *_, layer = _dense_run(torch.float32)
    assert fp.COUNTS["producer_kernel_slices"] == 1
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 0  # no card, no launch
    ent = fp.lookup("big.kernel", layer.kernel.grad)
    want = dispatch.quantize_batch((layer.kernel.grad.reshape(-1) / WS).view(WS, -1), ent.cc)
    assert torch.equal(ent.q.packed, want.packed) and torch.equal(ent.q.meta, want.meta)


# ---------------------------------------------------------------------------
# The stash and the fallbacks.
# ---------------------------------------------------------------------------


def test_stash_epoch_and_claim(engaged):
    *_, layer = _dense_run(torch.float32)
    grad = layer.kernel.grad
    ent = fp.lookup("big.kernel", grad)
    assert ent is not None and ent.epoch == fp._CFG["epoch"]
    assert fp.lookup("other.kernel", grad) is None
    fp.claim("big.kernel")
    assert fp.lookup("big.kernel", grad) is None
    fp._STASH["big.kernel"] = ent
    fp.begin_step()  # a new step: entries of the last one are gone
    assert fp.stash_size() == 0 and fp.lookup("big.kernel", grad) is None
    fp._STASH["big.kernel"] = ent  # a stale epoch is dropped on sight
    assert fp.lookup("big.kernel", grad) is None and fp.stash_size() == 0
    fp._STASH["big.kernel"] = ent
    fp.drain()
    assert fp.stash_size() == 0
    assert fp.COUNTS["producer_fallbacks"] == 0


@pytest.mark.parametrize("reason", [
    "ws1", "config", "debug_mode", "fused_group", "multi_slice", "layout", "reduction", "tile",
    "geometry",
])
def test_each_fallback_reason_is_counted(engaged, reason):
    shape = (256, 512)
    counted = "layout" if reason == "geometry" else reason
    if reason == "ws1":
        fp._CFG.update(ws=1)
    elif reason == "config":
        engaged.delenv("CGX_COMPRESSION_QUANTIZATION_BITS")
    elif reason == "debug_mode":
        engaged.setenv("CGX_DEBUG_DUMMY_COMPRESSION", "1")
    elif reason == "fused_group":
        shape = (128, 128)
    elif reason == "multi_slice":
        engaged.setenv("CGX_FUSION_BUFFER_SIZE_MB", "1")  # 262,144 values a slice
        shape = (512, 1024)
    elif reason == "layout":
        shape = (255, 512)  # an odd row count cannot split into 2 wire rows
    elif reason == "reduction":
        engaged.setenv("CGX_INNER_REDUCTION_TYPE", "RING")
    elif reason == "tile":
        # The JAX geometry aligns at B = 2048, but the (32, 2048) f32 tile
        # exceeds the kernel's shared memory.
        engaged.setenv("CGX_COMPRESSION_BUCKET_SIZE", "2048")
        shape = (256, 2048)
    elif reason == "geometry":
        shape = (256, 448)  # rows split evenly, but o % 128 != 0: no kernel tiling
    layer = Dense(*shape, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    layer.kernel_path = "big.kernel"
    layer(torch.randn(4, 16, shape[0])).sum().backward()
    assert fp.COUNTS["producer_fallbacks"] == 1
    assert fp.COUNTS[f"producer_fallback_{counted}"] == 1
    assert fp.stash_size() == 0 and fp.COUNTS["producer_staged"] == 0


@pytest.mark.parametrize("rewrite", ["in_place", "out_of_place", "second_backward", "none"])
def test_gradient_rewrites_make_the_entry_unclaimable(engaged, rewrite):
    layer = Dense(256, 512, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    layer.kernel_path = "big.kernel"
    x = torch.randn(4, 16, 256)
    layer(x).sum().backward()
    if rewrite == "in_place":
        layer.kernel.grad.mul_(1.0)
    elif rewrite == "out_of_place":
        layer.kernel.grad = layer.kernel.grad * 1.0
    elif rewrite == "second_backward":  # gradient accumulation
        layer(x).sum().backward()
    # Through the allreduce's own lookup (a one-rank world: nothing else
    # would consume it).
    grads = {"big.kernel": layer.kernel.grad}
    allreduce.allreduce_tree(grads)
    identity = fp.COUNTS["producer_fallback_identity"]
    assert identity == (0 if rewrite == "none" else 1)
    if rewrite == "none":  # matched, then refused: the world here has one rank
        assert fp.COUNTS["producer_fallback_group"] == 1
    assert fp.stash_size() == 0  # drained


@pytest.mark.parametrize("reason", ["plan", "routing"])
def test_allreduce_flat_counts_an_unusable_payload(engaged, reason):
    """A payload the buffer cannot take is ignored and counted under the
    verdict of ``fused_producer.consume_reason``, the predicate the tree
    applies too: ``plan`` when the slice's reduction is not the multi-rank
    SRA (a payload staged for this one-rank world), ``group`` (the JAX
    package's tree counts it so) when the buffer spans several fusion
    slices."""
    *_, layer = _dense_run(torch.float32)
    ent = fp.lookup("big.kernel", layer.kernel.grad)
    flat = (layer.kernel.grad / WS).reshape(-1)
    if reason == "plan":
        ent = dataclasses.replace(ent, ws=1)
    else:
        engaged.setenv("CGX_FUSION_BUFFER_SIZE_MB", "0")  # 2,048-value slices
    out = allreduce.allreduce_flat(flat, ent.cc, pre=ent)
    assert not ent.consumed
    counted = {"plan": "plan", "routing": "group"}[reason]
    assert fp.COUNTS[f"producer_fallback_{counted}"] == 1
    assert fp.COUNTS["producer_fallbacks"] == 1
    assert torch.equal(out, flat)  # one rank: the sum is the buffer


def test_quantized_allreduce_refuses_a_misrouted_payload():
    from torch_cgx_tpu_torch.parallel import quantized_allreduce

    cc = CompressionConfig(bits=4, bucket_size=128)
    with pytest.raises(ValueError, match="multi-rank SRA"):
        quantized_allreduce(torch.zeros(4096), None, 1, cc, pre=object())
    with pytest.raises(ValueError, match="multi-rank SRA"):
        quantized_allreduce(torch.zeros(4096), None, 2, cc, "RING", pre=object())


def test_reduce_rows_requantize_raw_row_equals_raw_rows(monkeypatch):
    """The pre-sliced own row stands in for ``raw_rows[own_idx]`` in both
    lowerings."""
    cc = CompressionConfig(bits=4, bucket_size=128)
    rows = torch.from_numpy(np.random.default_rng(3).standard_normal((WS, 2 * 32 * 128)).astype(np.float32))
    q = dispatch.quantize_batch(rows, cc)
    for mode in ("staged", "fused"):
        monkeypatch.setenv("CGX_SRA_EPILOGUE", mode)
        a = dispatch.reduce_rows_requantize(q, cc, raw_rows=rows, own_idx=1)
        b = dispatch.reduce_rows_requantize(q, cc, raw_row=rows[1].clone(), own_idx=1)
        assert torch.equal(a.packed, b.packed) and torch.equal(a.meta, b.meta), mode
    with pytest.raises(ValueError, match="not both"):
        dispatch.reduce_rows_requantize(q, cc, raw_rows=rows, raw_row=rows[1], own_idx=1)


# ---------------------------------------------------------------------------
# C4: the skipped weight gradient, in one process.
# ---------------------------------------------------------------------------


def _skip_configure():
    """The plane as ``make_train_step`` configures it (``skip_dw``), this
    process standing in for rank 0 of a 2-rank group."""
    fp.configure(None, divisor=WS, active=True, skip_dw=True)
    fp._CFG.update(ws=WS, rank=0)
    fp.begin_step()


@pytest.mark.parametrize("dtype,skips", [
    (torch.float32, True), (torch.bfloat16, True), (torch.float16, True),
])
def test_skip_returns_no_dw_and_stages_by_name(engaged, dtype, skips):
    """A layer whose payload the sync will consume returns no ``dw``;
    ``dx`` stays exact, and the staged payload and raw own row are the
    plain product's. A bf16 or f16 product skips too: the kernel reads its
    operands in the compute dtype, its payload quantizes the float32 sums
    of their products (exact in float32), and its raw own row is those sums
    rounded to the compute dtype, as the JAX package's ``dw_own``."""
    _skip_configure()
    seen, operands = [], []
    real = fp._plain_dw
    engaged.setattr(fp, "_plain_dw", lambda name, *a: seen.append(name) or real(name, *a))
    real_mq = codec_cuda.matmul_quantize_chunks
    engaged.setattr(codec_cuda, "matmul_quantize_chunks",
                    lambda x2, g2, *a, **kw: operands.append((x2, g2)) or real_mq(x2, g2, *a, **kw))
    _, x_grad, w_grad, b_grad, layer = _dense_run(dtype)
    _, want_x, want_w, want_b = _plain_expression(dtype)
    assert _same(x_grad, want_x) and _same(b_grad, want_b)
    assert fp.COUNTS["producer_dw_skipped"] == int(skips)
    assert fp.COUNTS["producer_staged"] == 1
    if not skips:
        assert _same(w_grad, want_w) and seen == ["big.kernel"]
        assert fp.skipped_entries() == {}
        return
    assert w_grad is None and seen == []
    ent = fp.skipped_entries()["big.kernel"]
    (x2, g2), = operands
    assert x2.dtype == g2.dtype == dtype
    sums = want_w if dtype == torch.float32 else torch.matmul(x2.float().t(), g2.float())
    rows = (sums.reshape(-1) / WS).view(WS, -1)
    assert _same(ent.raw_row, (sums.to(dtype).float().reshape(-1) / WS).view(WS, -1)[0])
    want = dispatch.quantize_batch(rows, ent.cc)
    assert torch.equal(ent.q.packed, want.packed) and torch.equal(ent.q.meta, want.meta)
    assert ent.shape == (256, 512) and ent.dtype == torch.float32
    ph = fp.placeholder(ent)
    assert ph.shape == (256, 512) and ph.reshape(-1).stride() == (0,)


def test_skip_needs_the_train_step(engaged):
    """Configured as ``gradient_sync`` users do (no ``skip_dw``), an
    engaged layer still returns its ``dw``."""
    *_, layer = _dense_run(torch.float32)
    assert layer.kernel.grad is not None
    assert fp.COUNTS["producer_dw_skipped"] == 0 and fp.skipped_entries() == {}


@pytest.mark.parametrize("mismatch", ["world", "given", "fusion_slices", "divisor"])
def test_unconsumable_skipped_layer_raises(engaged, mismatch):
    """A skipped layer that the allreduce then cannot consume is a bug: the
    allreduce raises ``RuntimeError`` naming the layer, never drops or
    zeroes the gradient. Forced here after the backward: a one-rank world
    (the payload was made for two), a gradient given under the skipped
    name, several fusion slices, another divisor (``average=False``)."""
    _skip_configure()
    *_, layer = _dense_run(torch.float32)
    assert layer.kernel.grad is None
    tree = {"big.bias": layer.bias.grad}
    average = True
    if mismatch == "given":
        tree["big.kernel"] = torch.zeros(256, 512)
    elif mismatch == "fusion_slices":
        engaged.setenv("CGX_FUSION_BUFFER_SIZE_MB", "0")  # 2,048-value slices
    elif mismatch == "divisor":
        average = False
    if mismatch != "given":
        fp._CFG.update(ws=1)  # the world the allreduce sees has one rank
    with pytest.raises(RuntimeError, match="big.kernel"):
        allreduce.allreduce_tree(tree, average=average)


def test_second_backward_after_a_skip_raises(engaged):
    """A second backward of a skipped layer in one step would lose the
    first gradient: it raises."""
    _skip_configure()
    layer = Dense(256, 512, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    layer.kernel_path = "big.kernel"
    y = layer(torch.randn(4, 16, 256))
    y.sum().backward(retain_graph=True)
    assert layer.kernel.grad is None
    with pytest.raises(RuntimeError, match="second backward"):
        y.sum().backward()


# ---------------------------------------------------------------------------
# Two spawned ranks: the train step.
# ---------------------------------------------------------------------------


class _OneLayer(torch.nn.Module):
    """One named dense layer, ``big`` (256 -> 512)."""

    def __init__(self):
        super().__init__()
        from torch_cgx_tpu_torch.models.layers import name_dense_layers

        self.big = Dense(SYNC_DIN, SYNC_O, dtype=torch.float32)
        name_dense_layers(self)

    def forward(self, x):
        return self.big(x)


def _rank_main(rank, init_file, params, tokens, result_q):
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ.update(PRODUCER_ENV)
    import torch.distributed as dist

    from torch_cgx_tpu_torch.models import GPT2, Dense, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.ops import fused_producer
    from torch_cgx_tpu_torch.parallel import gradient_sync, make_train_step

    torch.set_num_threads(1)
    out = {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=WS,
            timeout=timedelta(seconds=120),
        )
        t = torch.from_numpy(tokens[rank * (len(tokens) // WS):(rank + 1) * (len(tokens) // WS)])
        for fuse in ("off", "on"):
            os.environ["CGX_PRODUCER_FUSE"] = fuse
            model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
            model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
            opt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
            step = make_train_step(model, lambda m, b: lm_loss(m(b), b), opt, device="cpu")
            consumed = []
            losses = []
            for _ in range(STEPS):
                fused_producer.reset_counts()
                losses.append(float(step(t)))
                consumed.append(fused_producer.COUNTS["producer_consumed_slices"])
            out[fuse] = {
                "losses": losses, "consumed": consumed,
                "counts": dict(fused_producer.COUNTS),
                "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
            }
        # The default model: bf16 compute, f32 parameters; the producer on,
        # its 16-bit products skipping their dw.
        os.environ["CGX_PRODUCER_FUSE"] = "on"
        model = GPT2(GPT2Config.tiny(), device="cpu")
        model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
        opt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
        step = make_train_step(model, lambda m, b: lm_loss(m(b), b), opt, device="cpu")
        res16 = {"losses": [], "consumed": [], "skipped": []}
        for _ in range(STEPS):
            fused_producer.reset_counts()
            res16["losses"].append(float(step(t)))
            res16["consumed"].append(fused_producer.COUNTS["producer_consumed_slices"])
            res16["skipped"].append(fused_producer.COUNTS["producer_dw_skipped"])
        res16["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        out["bf16_on"] = res16
        # One backward of a single layer and one gradient_sync, fed exact
        # integer gradients (see _sync_cotangent).
        os.environ["CGX_COMPRESSION_QUANTIZATION_BITS"] = str(SYNC_BITS)
        layer = Dense(SYNC_DIN, SYNC_O, dtype=torch.float32)
        layer.kernel_path = "big.kernel"
        x = torch.eye(SYNC_DIN)
        c = torch.from_numpy(_sync_cotangent(rank))
        for fuse in ("off", "on"):
            os.environ["CGX_PRODUCER_FUSE"] = fuse
            fused_producer.configure(None, divisor=WS, active=True)
            fused_producer.begin_step()
            fused_producer.reset_counts()
            layer.zero_grad(set_to_none=True)
            (layer(x) * c).sum().backward()
            synced = gradient_sync({"big.kernel": layer.kernel.grad, "big.bias": layer.bias.grad})
            out[f"sync_{fuse}"] = {
                "synced": {k: v.numpy().copy() for k, v in synced.items()},
                "skipped": fused_producer.COUNTS["producer_dw_skipped"],
                "consumed": fused_producer.COUNTS["producer_consumed_slices"],
                "kernel_slices": fused_producer.COUNTS["producer_kernel_slices"],
            }
        # The same gradients through make_train_step: the backward skips the
        # kernel's dw and p.grad is written from the consumed payload.
        os.environ["CGX_PRODUCER_FUSE"] = "on"
        one = _OneLayer()
        one.big.load_state_dict(layer.state_dict())
        step = make_train_step(one, lambda m, b: (m(b[0]) * b[1]).sum(),
                               torch.optim.SGD(one.parameters(), lr=0.0), device="cpu")
        fused_producer.reset_counts()
        step((x, c))
        out["sync_step"] = {
            "synced": {"big.kernel": one.big.kernel.grad.numpy().copy(),
                       "big.bias": one.big.bias.grad.numpy().copy()},
            "consumed": fused_producer.COUNTS["producer_consumed_slices"],
            "skipped": fused_producer.COUNTS["producer_dw_skipped"],
        }
        # The bf16-compute layer (f32 parameters): the producer on through a
        # direct gradient_sync, then through make_train_step with the skip.
        layer16 = Dense(SYNC_DIN, SYNC_O, dtype=torch.bfloat16)
        layer16.load_state_dict(layer.state_dict())
        layer16.kernel_path = "big.kernel"
        c16 = c.clone()
        c16[SYNC16_ROWS:] = 0
        fused_producer.configure(None, divisor=WS, active=True)
        fused_producer.begin_step()
        fused_producer.reset_counts()
        (layer16(x) * c16).sum().backward()
        synced = gradient_sync({"big.kernel": layer16.kernel.grad, "big.bias": layer16.bias.grad})
        out["sync16_on"] = {
            "synced": {k: v.numpy().copy() for k, v in synced.items()},
            "consumed": fused_producer.COUNTS["producer_consumed_slices"],
            "skipped": fused_producer.COUNTS["producer_dw_skipped"],
        }
        one16 = _OneLayer()
        one16.big = layer16
        layer16.zero_grad(set_to_none=True)
        step = make_train_step(one16, lambda m, b: (m(b[0]) * b[1]).sum(),
                               torch.optim.SGD(one16.parameters(), lr=0.0), device="cpu")
        fused_producer.reset_counts()
        step((x, c16))
        out["sync16_step"] = {
            "synced": {"big.kernel": layer16.kernel.grad.numpy().copy(),
                       "big.bias": layer16.bias.grad.numpy().copy()},
            "consumed": fused_producer.COUNTS["producer_consumed_slices"],
            "skipped": fused_producer.COUNTS["producer_dw_skipped"],
        }
        fused_producer.deconfigure()
        dist.barrier()
    except Exception as e:  # reported to the parent, which fails the test
        out = {"error": repr(e)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


def _jax_setup():
    import jax

    from torch_cgx_tpu.models import GPT2 as JGPT2
    from torch_cgx_tpu.models import GPT2Config as JGPT2Config

    import jax.numpy as jnp

    model = JGPT2(JGPT2Config.tiny(dtype=jnp.float32))
    tokens = np.random.default_rng(5).integers(0, 512, size=(2 * WS, 32)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"]
    return model, jax.tree.map(np.asarray, params), tokens


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from torch_cgx_tpu_torch.models import gpt2_params_from_jax

    jmodel, jparams, tokens = _jax_setup()
    params = {k: v.numpy() for k, v in gpt2_params_from_jax(jparams).items()}
    init_file = str(tmp_path_factory.mktemp("gloo_producer") / "store")
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(r, init_file, params, tokens, result_q), daemon=True)
        for r in range(WS)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < WS and time.monotonic() < deadline:
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
    assert len(results) == WS, f"only ranks {sorted(results)} reported"
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    assert not errors, errors
    return (jmodel, jparams, tokens), [results[r] for r in range(WS)]


def test_two_ranks_producer_on_is_bit_identical_to_off(world):
    _, results = world
    n_layer = GPT2Config.tiny().n_layer
    for r, res in enumerate(results):
        assert res["on"]["losses"] == res["off"]["losses"]
        assert res["on"]["consumed"] == [3 * n_layer] * STEPS
        assert res["off"]["consumed"] == [0] * STEPS
        counts = res["on"]["counts"]
        assert counts["producer_fallbacks"] == counts["producer_fallback_fused_group"] == n_layer
        for p, v in res["off"]["params"].items():
            np.testing.assert_array_equal(res["on"]["params"][p].view(np.uint32), v.view(np.uint32),
                                          err_msg=f"rank {r} {p}")
            np.testing.assert_array_equal(results[0]["on"]["params"][p].view(np.uint32),
                                          res["on"]["params"][p].view(np.uint32))


def test_two_ranks_match_jax_producer_on(world, monkeypatch):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from torch_cgx_tpu.models import lm_loss as jlm_loss
    from torch_cgx_tpu.parallel import make_train_step as jmake_train_step
    from torch_cgx_tpu.parallel import replicate, shard_batch
    from torch_cgx_tpu.utils.logging import metrics
    from torch_cgx_tpu.utils.tree import leaf_paths

    (jmodel, jparams, tokens), results = world
    for k, v in PRODUCER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CGX_PRODUCER_FUSE", "on")
    mesh = Mesh(np.asarray(jax.devices()[:WS]), ("dp",))
    opt = optax.adam(LR)
    p = replicate(jax.tree.map(jnp.asarray, jparams), mesh)
    s = replicate(opt.init(p), mesh)
    step = jmake_train_step(
        lambda pp, t: jlm_loss(jmodel.apply({"params": pp}, t), t), opt, mesh, donate=False
    )
    before = metrics.get("cgx.codec.producer_consumed_slices") or 0.0
    losses = []
    for i in range(STEPS):
        p, s, loss = step(p, s, shard_batch(jnp.asarray(tokens), mesh), jnp.int32(i))
        losses.append(float(loss))
    # The JAX counter counts at trace time: one traced step consumed this many.
    consumed = (metrics.get("cgx.codec.producer_consumed_slices") or 0.0) - before
    assert consumed == results[0]["on"]["consumed"][0]
    np.testing.assert_allclose(results[0]["on"]["losses"], losses, rtol=1e-4)
    got = results[0]["on"]["params"]
    for path, v in leaf_paths(jax.tree.map(np.asarray, p)):
        np.testing.assert_allclose(got[path], v, rtol=0, atol=3 * LR, err_msg=path)


def test_two_ranks_sync_matches_jax_producer_on(world, monkeypatch):
    """One producer-on ``gradient_sync`` on the two gloo ranks against the JAX
    ``gradient_sync`` with the producer on (its matmul-quantize kernel in
    interpret mode) over a 2-device mesh, on exact integer gradients: the
    synced gradients are bit-identical, one payload is consumed on each
    side, and the codec really ran (2 bits cannot carry the exact mean)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.models.layers import CgxDense
    from torch_cgx_tpu.ops import fused_producer as jfp
    from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu.utils.logging import metrics
    from torch_cgx_tpu.utils.tree import leaf_paths

    class _One(nn.Module):
        @nn.compact
        def __call__(self, x):
            return CgxDense(SYNC_O, dtype=jnp.float32, name="big")(x)

    _, results = world
    for k, v in PRODUCER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", str(SYNC_BITS))
    monkeypatch.setenv("CGX_PRODUCER_FUSE", "on")
    monkeypatch.setenv("CGX_PRODUCER_KERNEL", "on")
    mesh = Mesh(np.asarray(jax.devices()[:WS]), ("dp",))
    model = _One()
    x = np.tile(np.eye(SYNC_DIN, dtype=np.float32), (WS, 1))
    c = np.concatenate([_sync_cotangent(r) for r in range(WS)])
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]

    def body(p, xb, cb):
        jfp.begin_step()
        g = jax.grad(lambda pp: jnp.sum(model.apply({"params": pp}, xb) * cb))(p)
        return jgradient_sync(g, mesh=mesh, axes=("dp",))

    fn = shard_map(body, mesh=mesh, in_specs=(P(), P("dp"), P("dp")), out_specs=P(),
                   check_vma=False)
    before = metrics.get("cgx.codec.producer_consumed_slices") or 0.0
    jfp.configure(mesh, ("dp",), divisor=WS, active=True)
    try:
        want = dict(leaf_paths(jax.tree.map(np.asarray, jax.jit(fn)(params, x, c))))
    finally:
        jfp.deconfigure()
    assert (metrics.get("cgx.codec.producer_consumed_slices") or 0.0) - before == 1
    mean = (_sync_cotangent(0) + _sync_cotangent(1)) / WS
    assert want.keys() == results[0]["sync_on"]["synced"].keys()
    for r, res in enumerate(results):
        assert res["sync_on"]["consumed"] == res["sync_on"]["kernel_slices"] == 1
        assert res["sync_off"]["consumed"] == 0
        assert res["sync_on"]["skipped"] == 0  # a direct gradient_sync keeps p.grad
        # Through make_train_step the kernel's dw is skipped and p.grad comes
        # from the consumed payload: the same bytes.
        assert res["sync_step"]["consumed"] == res["sync_step"]["skipped"] == 1
        for p, v in want.items():
            for fuse in ("on", "off", "step"):
                np.testing.assert_array_equal(res[f"sync_{fuse}"]["synced"][p].view(np.uint32),
                                              v.view(np.uint32), err_msg=f"rank {r} {fuse} {p}")
    assert np.abs(want["big.kernel"] - mean).max() > 0


def test_two_ranks_bf16_gpt2_matches_jax_producer_on(world, monkeypatch):
    """The tiny GPT-2 at its default bf16 compute (f32 parameters) on the
    two gloo ranks, producer on, every eligible 16-bit product skipping its
    dw, against the JAX ``make_train_step`` with the producer on (its bf16
    matmul-quantize in interpret mode) from the same weights: the consumed
    counts equal; losses within BF16_LOSS_RTOL; the produced kernels
    (qkv, mlp_in, mlp_out) within 3 x LR of JAX's but for a share
    BF16_FAR_SHARE of their entries. The float32 test's tolerances (1e-4,
    every entry within 3 x LR) do not hold for a bf16 model with or without
    the producer: the two frameworks round the bf16 forward at different
    places (step 0's loss, before any sync, differs by 1.4e-4 relative), and
    the tiny bf16 gradients whose sign that flips move Adam's first steps up
    to 2 x LR a step apart in every layer, produced or not (0.1-0.5 % of the
    entries). A wrong payload would move most of a produced kernel's
    entries."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from torch_cgx_tpu.models import GPT2 as JGPT2
    from torch_cgx_tpu.models import GPT2Config as JGPT2Config
    from torch_cgx_tpu.models import lm_loss as jlm_loss
    from torch_cgx_tpu.parallel import make_train_step as jmake_train_step
    from torch_cgx_tpu.parallel import replicate, shard_batch
    from torch_cgx_tpu.utils.logging import metrics
    from torch_cgx_tpu.utils.tree import leaf_paths

    (_, jparams, tokens), results = world
    n_layer = GPT2Config.tiny().n_layer
    for r, res in enumerate(results):
        assert res["bf16_on"]["consumed"] == res["bf16_on"]["skipped"] == [3 * n_layer] * STEPS, r
    for k, v in PRODUCER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CGX_PRODUCER_FUSE", "on")
    jmodel = JGPT2(JGPT2Config.tiny())
    assert jmodel.cfg.dtype == jnp.bfloat16
    mesh = Mesh(np.asarray(jax.devices()[:WS]), ("dp",))
    opt = optax.adam(LR)
    p = replicate(jax.tree.map(jnp.asarray, jparams), mesh)
    s = replicate(opt.init(p), mesh)
    step = jmake_train_step(
        lambda pp, t: jlm_loss(jmodel.apply({"params": pp}, t), t), opt, mesh, donate=False
    )
    before = metrics.get("cgx.codec.producer_consumed_slices") or 0.0
    losses = []
    for i in range(STEPS):
        p, s, loss = step(p, s, shard_batch(jnp.asarray(tokens), mesh), jnp.int32(i))
        losses.append(float(loss))
    consumed = (metrics.get("cgx.codec.producer_consumed_slices") or 0.0) - before
    assert consumed == results[0]["bf16_on"]["consumed"][0]
    np.testing.assert_allclose(results[0]["bf16_on"]["losses"], losses, rtol=BF16_LOSS_RTOL)
    got = results[0]["bf16_on"]["params"]
    far, total = 0, 0
    for path, v in leaf_paths(jax.tree.map(np.asarray, p)):
        if path.endswith(("attn_qkv.kernel", "mlp_in.kernel", "mlp_out.kernel")):
            far += int((np.abs(got[path] - v) > 3 * LR).sum())
            total += v.size
    assert total and far <= BF16_FAR_SHARE * total, (far, total)


def test_two_ranks_sync_matches_jax_producer_on_bf16(world, monkeypatch):
    """The one-layer sync of ``test_two_ranks_sync_matches_jax_producer_on``
    with the layer computing in bf16 (``CgxDense(dtype=jnp.bfloat16)``, f32
    parameters; the JAX kernel reads bf16 operands in interpret mode): the
    synced gradients bit-identical to the JAX ones on the exact integer
    gradients, through a direct ``gradient_sync`` (p.grad kept) and through
    ``make_train_step`` (the 16-bit product's dw skipped), one payload
    consumed on each side, and the codec really ran. The cotangent keeps
    its first SYNC16_ROWS rows, so that the bf16 bias gradient is exact in
    both frameworks."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.models.layers import CgxDense
    from torch_cgx_tpu.ops import fused_producer as jfp
    from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu.utils.logging import metrics
    from torch_cgx_tpu.utils.tree import leaf_paths

    class _One(nn.Module):
        @nn.compact
        def __call__(self, x):
            return CgxDense(SYNC_O, dtype=jnp.bfloat16, name="big")(x)

    _, results = world
    for k, v in PRODUCER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", str(SYNC_BITS))
    monkeypatch.setenv("CGX_PRODUCER_FUSE", "on")
    monkeypatch.setenv("CGX_PRODUCER_KERNEL", "on")
    mesh = Mesh(np.asarray(jax.devices()[:WS]), ("dp",))
    model = _One()
    x = np.tile(np.eye(SYNC_DIN, dtype=np.float32), (WS, 1))
    cs = [_sync_cotangent(r) for r in range(WS)]
    for cr in cs:
        cr[SYNC16_ROWS:] = 0
    c = np.concatenate(cs)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    assert params["big"]["kernel"].dtype == jnp.float32

    def body(p, xb, cb):
        jfp.begin_step()
        g = jax.grad(lambda pp: jnp.sum(model.apply({"params": pp}, xb) * cb))(p)
        return jgradient_sync(g, mesh=mesh, axes=("dp",))

    fn = shard_map(body, mesh=mesh, in_specs=(P(), P("dp"), P("dp")), out_specs=P(),
                   check_vma=False)
    before = metrics.get("cgx.codec.producer_consumed_slices") or 0.0
    jfp.configure(mesh, ("dp",), divisor=WS, active=True)
    try:
        want = dict(leaf_paths(jax.tree.map(np.asarray, jax.jit(fn)(params, x, c))))
    finally:
        jfp.deconfigure()
    assert (metrics.get("cgx.codec.producer_consumed_slices") or 0.0) - before == 1
    for r, res in enumerate(results):
        assert res["sync16_on"]["consumed"] == 1 and res["sync16_on"]["skipped"] == 0
        assert res["sync16_step"]["consumed"] == res["sync16_step"]["skipped"] == 1
        for p, v in want.items():
            for case in ("sync16_on", "sync16_step"):
                np.testing.assert_array_equal(res[case]["synced"][p].view(np.uint32),
                                              v.view(np.uint32), err_msg=f"rank {r} {case} {p}")
    assert np.abs(want["big.kernel"] - sum(cs) / WS).max() > 0


# ---------------------------------------------------------------------------
# C4 on spawned ranks at ws 2 and 4: the train step with the skip.
# ---------------------------------------------------------------------------

SKIP_STEPS = 3
TWICE_N = 256  # a (256, 256) layer applied twice in one forward


class _Twice(torch.nn.Module):
    """One named square layer applied twice: its dw is the sum of two
    backward products, so it must never skip."""

    def __init__(self):
        super().__init__()
        from torch_cgx_tpu_torch.models.layers import name_dense_layers

        self.big = Dense(TWICE_N, TWICE_N, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(3))
        name_dense_layers(self)

    def forward(self, x):
        return self.big(self.big(x))


def _skip_rank_main(rank, ws, init_file, tokens, result_q):
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ.update(PRODUCER_ENV)
    import torch.distributed as dist

    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.ops import fused_producer
    from torch_cgx_tpu_torch.parallel import gradient_sync, make_train_step

    torch.set_num_threads(1)
    plain = []  # layers whose backward ran the plain dw product
    real = fused_producer._plain_dw
    fused_producer._plain_dw = lambda name, *a: plain.append(name) or real(name, *a)
    out = {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=ws,
            timeout=timedelta(seconds=120),
        )
        t = torch.from_numpy(tokens[2 * rank:2 * rank + 2])
        cfg = GPT2Config.tiny(dtype=torch.float32)
        for fuse in ("off", "on"):
            os.environ["CGX_PRODUCER_FUSE"] = fuse
            model = GPT2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            opt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
            step = make_train_step(model, lambda m, b: lm_loss(m(b), b), opt, device="cpu")
            res = {"losses": [], "skipped": [], "consumed": [], "plain": [], "fallbacks": []}
            for _ in range(SKIP_STEPS):
                fused_producer.reset_counts()
                plain.clear()
                res["losses"].append(float(step(t)))
                res["skipped"].append(fused_producer.COUNTS["producer_dw_skipped"])
                res["consumed"].append(fused_producer.COUNTS["producer_consumed_slices"])
                res["fallbacks"].append(fused_producer.COUNTS["producer_fallbacks"])
                res["plain"].append(sorted(plain))
            res["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
            out[fuse] = res
        # A layer applied twice in one forward.
        rng = np.random.default_rng(10 + rank)
        x = torch.from_numpy(rng.standard_normal((32, TWICE_N)).astype(np.float32))
        c = torch.from_numpy(rng.standard_normal((32, TWICE_N)).astype(np.float32))
        for fuse in ("off", "on"):
            os.environ["CGX_PRODUCER_FUSE"] = fuse
            twice = _Twice()
            step = make_train_step(twice, lambda m, b: (m(b[0]) * b[1]).sum(),
                                   torch.optim.SGD(twice.parameters(), lr=0.1), device="cpu")
            fused_producer.reset_counts()
            step((x, c))
            out[f"twice_{fuse}"] = {
                "grad": twice.big.kernel.grad.numpy().copy(),
                "kernel": twice.big.kernel.detach().numpy().copy(),
                "counts": dict(fused_producer.COUNTS),
            }
        # A direct gradient_sync: configured without the skip, p.grad exists.
        os.environ["CGX_PRODUCER_FUSE"] = "on"
        model = GPT2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        fused_producer.configure(None, divisor=ws, active=True)
        fused_producer.begin_step()
        fused_producer.reset_counts()
        lm_loss(model(t), t).backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        out["direct"] = {
            "missing": sorted(n for n, g in grads.items() if g is None),
            "skipped": fused_producer.COUNTS["producer_dw_skipped"],
        }
        gradient_sync(grads)
        out["direct"]["consumed"] = fused_producer.COUNTS["producer_consumed_slices"]
        fused_producer.deconfigure()
        dist.barrier()
    except Exception:  # reported to the parent, which fails the test
        import traceback

        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


@pytest.fixture(scope="module", params=[2, 4], ids=["ws2", "ws4"])
def skip_world(request, tmp_path_factory):
    ws = request.param
    tokens = np.random.default_rng(7).integers(0, 512, size=(2 * ws, 32)).astype(np.int64)
    init_file = str(tmp_path_factory.mktemp(f"gloo_skip{ws}") / "store")
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = [
        ctx.Process(target=_skip_rank_main, args=(r, ws, init_file, tokens, result_q), daemon=True)
        for r in range(ws)
    ]
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
    return ws, [results[r] for r in range(ws)]


def test_skip_steps_bit_identical_to_off(skip_world):
    """Three steps with the skip: losses and every parameter bit-identical
    to producer fusion off, on every rank, and the replicas identical."""
    ws, results = skip_world
    for r, res in enumerate(results):
        assert res["on"]["losses"] == res["off"]["losses"]
        for p, v in res["off"]["params"].items():
            np.testing.assert_array_equal(res["on"]["params"][p].view(np.uint32), v.view(np.uint32),
                                          err_msg=f"ws {ws} rank {r} {p}")
            np.testing.assert_array_equal(results[0]["on"]["params"][p].view(np.uint32),
                                          res["on"]["params"][p].view(np.uint32))


def test_skip_counts_every_eligible_layer_and_no_plain_product(skip_world):
    """Each step skips the dw of every eligible layer (qkv, mlp_in, mlp_out
    of each block), consumes their payloads, and runs the plain product
    only in the layers that fall back (attn_proj, in the fused group)."""
    ws, results = skip_world
    n_layer = GPT2Config.tiny().n_layer
    proj = sorted(f"h_{i}.attn.attn_proj.kernel" for i in range(n_layer))
    for res in results:
        on, off = res["on"], res["off"]
        assert on["skipped"] == on["consumed"] == [3 * n_layer] * SKIP_STEPS
        assert on["fallbacks"] == [n_layer] * SKIP_STEPS
        assert on["plain"] == [proj] * SKIP_STEPS
        assert off["skipped"] == off["consumed"] == [0] * SKIP_STEPS
        assert off["plain"] == [[]] * SKIP_STEPS  # off: autograd's matmul, not the wrapper


def test_layer_applied_twice_does_not_skip(skip_world):
    """A layer applied twice in one forward returns its dw (the sum of its
    two backward products); the second product makes the payload
    unclaimable, and the synced gradient and the step equal fusion off."""
    ws, results = skip_world
    for r, res in enumerate(results):
        on, off = res["twice_on"], res["twice_off"]
        assert on["counts"]["producer_dw_skipped"] == 0
        assert on["counts"]["producer_staged"] == 1
        assert on["counts"]["producer_fallback_identity"] == 1
        assert on["counts"]["producer_consumed_slices"] == 0
        np.testing.assert_array_equal(on["grad"].view(np.uint32), off["grad"].view(np.uint32),
                                      err_msg=f"ws {ws} rank {r}")
        np.testing.assert_array_equal(on["kernel"].view(np.uint32), off["kernel"].view(np.uint32))


def test_direct_gradient_sync_keeps_p_grad(skip_world):
    """Outside ``make_train_step`` nothing skips: every parameter has its
    ``p.grad`` and the sync still consumes the payloads."""
    ws, results = skip_world
    n_layer = GPT2Config.tiny().n_layer
    for res in results:
        assert res["direct"]["missing"] == [] and res["direct"]["skipped"] == 0
        assert res["direct"]["consumed"] == 3 * n_layer
