"""B9 and the two quantize lowerings it carries, in the port against the JAX
package, on the CPU.

On the CPU every wrapper runs its plain version, so these tests hold the
plain versions and the routing around the kernels to the JAX Pallas kernels
in interpret mode (as ``tests/test_qbench_kernels.py`` runs them), at its
size (N = 65,536 values, tile 2) and parametrised over bits {1, 2, 4, 8} and
bucket {128, 512}. The tolerance is zero for words and meta throughout:

* each B9 variant's plain version (and ``run_variant`` on the CPU) against
  ``tools/qbench.run_variant_kernel(name, interpret=True)``;
* under ``CGX_CODEC_ENCODE=mul``: ``quantize_batch`` (a flat slice and one
  with a dense tail, which keeps the div encode), ``sra_epilogue_batch``
  (ws 4, the raw own row) and the matmul-quantize at divisors 1, 2, 4 and 8
  against ``codec_pallas`` / ``fused_producer`` under mul. The operands are
  ``qbench.tie_operand``'s, on which mul and div pick different levels.
  XLA on the CPU fuses the interpreted kernels' ``(x - min) * inv + 0.5``
  into one multiply-add, where the port (and the JAX source) rounds the
  product first, so the tie operand keeps only the ties the two roundings
  agree on (``fused_agree``);
* under ``CGX_PALLAS_PACK=butterfly``: the same paths equal "sum" and the
  JAX butterfly, and a cached ``pack="butterfly"`` entry reaches the
  lowering;
* a tiny GPT-2 ``make_train_step`` under each knob against the JAX step
  with ``CGX_CODEC_IMPL=pallas`` (its kernels in interpret mode), to the
  tolerance of ``test_torch_gpt2_step.py::test_train_steps_match_jax_float32``;
* the tool's arguments, its record's fields (``--device cpu``) and its
  refusal to run with no card and no device.

The kernels themselves run only on the card: ``test_torch_kernels.py``
(marker ``cuda``) and ``chip_smoke.py`` hold them to these plain versions.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from torch_cgx_tpu.models import GPT2 as JGPT2
from torch_cgx_tpu.models import GPT2Config as JGPT2Config
from torch_cgx_tpu.models import lm_loss as jlm_loss
from torch_cgx_tpu.ops import codec_pallas
from torch_cgx_tpu.parallel import make_train_step as jmake_train_step
from torch_cgx_tpu.parallel import replicate, shard_batch
from torch_cgx_tpu.utils.tree import leaf_paths
from torch_cgx_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_jax, gpt2_params_to_numpy, lm_loss
from torch_cgx_tpu_torch.ops import autotune, codec, codec_cuda
from torch_cgx_tpu_torch.parallel import make_train_step
from torch_cgx_tpu_torch.tools import qbench

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import qbench as jqbench  # noqa: E402  (the repository's JAX tool)

N, TC = 65_536, 2
CASES = [(bits, b) for bits in (1, 2, 4, 8) for b in (128, 512)]


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("CGX_AUTOTUNE_DIR", str(tmp_path))
    for k in ("CGX_CODEC_ENCODE", "CGX_PALLAS_PACK", "CGX_PALLAS_DB", "CGX_AUTOTUNE",
              "CGX_PALLAS_TILE_CHUNKS", "CGX_SRA_EPILOGUE", "CGX_CODEC_IMPL"):
        monkeypatch.delenv(k, raising=False)
    autotune.invalidate("test setup")
    yield
    autotune.invalidate("test teardown")


def _u32(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a).view(np.uint32)


def _same(got, want) -> None:
    np.testing.assert_array_equal(_u32(got), _u32(want))


def _normal(bits: int, b: int) -> np.ndarray:
    return np.random.default_rng(bits * b).standard_normal(N).astype(np.float32) * np.float32(37)


def _tie(n: int, b: int, bits: int) -> np.ndarray:
    return qbench.tie_operand(n, b, bits, seed=bits + b, fused_agree=True)


def _levels(words: torch.Tensor, bits: int, nb: int, b: int) -> torch.Tensor:
    return codec.unpack_levels_bucketed(words.reshape(-1), bits, nb, b)


# ---------------------------------------------------------------------------
# B9's variants.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,bucket", CASES)
@pytest.mark.parametrize("name", qbench.KERNEL_VARIANTS)
def test_variant_plain_matches_jax_interpret(name, bits, bucket):
    operands = [_normal(bits, bucket)]
    if name == "mul":
        operands.append(_tie(N, bucket, bits))
    for x in operands:
        xj = jnp.asarray(x)[None]
        jw, jm = jqbench.run_variant_kernel(name, xj, bits, bucket, TC, interpret=True)(xj)
        w, m = qbench.quantize_variant_plain(name, torch.from_numpy(x), bits, bucket, TC)
        assert tuple(w.shape) == jw.shape and tuple(m.shape) == jm.shape
        _same(w, jw)
        _same(m, jm)
        rw, rm = qbench.run_variant(name, torch.from_numpy(x)[None], bits, bucket, TC, device="cpu")
        _same(rw, w)
        _same(rm, m)


def test_variant_shapes_and_tile_parity():
    x = torch.from_numpy(_normal(4, 512))
    w, m = qbench.run_variant("metalane", x, 4, 512, TC, device="cpu")
    assert tuple(w.shape) == (N * 4 // 32 // 128, 128) and tuple(m.shape) == (N // (32 * 512), 128)
    w, m = qbench.run_variant("read", x, 4, 512, TC, device="cpu")
    assert tuple(m.shape) == (N // 512, 2)
    assert bool((w.view(-1, 4 * 512) == w.view(-1, 4 * 512)[:, :1]).all())  # one word a chunk
    with pytest.raises(ValueError, match="tc=3"):
        qbench.run_variant("nometa", x, 4, 512, 3, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        qbench.run_variant("nometa", x, 4, 96, 1, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        codec_cuda.quantize_variant_chunks(x, "bogus", 4, 512)


def test_read_word_truncates_and_saturates():
    units = torch.tensor([0.0, 2.9, -0.0, 3.0e9, float("nan"), 7.99])
    got = codec_cuda._trunc_i32(units)
    assert got.tolist() == [0, 2, 0, 2**31 - 1, 0, 7]


# ---------------------------------------------------------------------------
# The mul encode.
# ---------------------------------------------------------------------------


def test_tie_operand_splits_the_encodes_by_one_level():
    for bits in (1, 2, 4, 8):
        x = torch.from_numpy(qbench.tie_operand(N, 128, bits))
        lv = {}
        for enc in ("div", "mul"):
            w, _ = codec_cuda.quantize_chunks_plain(x, bits, 128, encode=enc)
            lv[enc] = _levels(w, bits, N // 128, 128)
        diff = (lv["mul"] - lv["div"]).abs()
        assert int(diff.max()) == 1 and int((diff > 0).sum()) > 0, bits


@pytest.mark.parametrize("bits,bucket", CASES)
def test_quantize_batch_mul_matches_jax(bits, bucket, monkeypatch):
    """A flat slice (2 rows of 4 chunks) and one with a dense tail (3 chunks,
    5 tail buckets and a partial bucket): mul bytes equal JAX's mul bytes,
    differ from div in the chunks, and equal div in the tail."""
    flat = _tie(2 * 4 * 32 * bucket, bucket, bits).reshape(2, -1)
    tail_n = 3 * 32 * bucket + 5 * bucket + 7
    tail = _tie(3 * 32 * bucket + 6 * bucket, bucket, bits)[:tail_n][None]
    for x in (flat, tail):
        monkeypatch.setenv("CGX_CODEC_ENCODE", "mul")
        jq = codec_pallas.quantize_batch(jnp.asarray(x), bits, bucket, interpret=True)
        q = codec_cuda.quantize_batch(torch.from_numpy(x), bits, bucket)
        _same(q.packed, jq.packed)
        _same(q.meta, jq.meta)
        monkeypatch.setenv("CGX_CODEC_ENCODE", "div")
        qd = codec_cuda.quantize_batch(torch.from_numpy(x), bits, bucket)
        head = 3 * bits * bucket  # the chunk words of the first row
        assert not torch.equal(q.packed[:, :head], qd.packed[:, :head])
        if x is tail:
            assert torch.equal(q.packed[:, head:], qd.packed[:, head:])  # the tail stays div


@pytest.mark.parametrize("bits,bucket", CASES)
def test_sra_epilogue_mul_matches_jax(bits, bucket, monkeypatch):
    """ws 4, the raw own row at 1. Peers of zeros decode to exact zeros, so
    the reduced chunk is the raw tie row and its requantize shows mul; then
    decode-exact integer peers."""
    ws, own, n = 4, 1, 2 * 32 * bucket
    top = (1 << bits) - 1
    grid = np.random.default_rng(bits).integers(0, top + 1, (ws, n)).astype(np.float32)
    grid[:, ::32], grid[:, 1::32] = 0, top
    ties = np.zeros((ws, n), np.float32)
    ties[own] = _tie(n, bucket, bits)
    monkeypatch.setenv("CGX_CODEC_ENCODE", "mul")
    for x in (ties, grid):
        jq = codec_pallas.quantize_batch(jnp.asarray(x), bits, bucket, interpret=True)
        jout = codec_pallas.sra_epilogue_batch(
            jq, raw_row=jnp.asarray(x[own]), own_idx=jnp.int32(own), interpret=True
        )
        q = codec_cuda.quantize_batch(torch.from_numpy(x), bits, bucket)
        out = codec_cuda.sra_epilogue_batch(q, raw_row=torch.from_numpy(x[own]), own_idx=own)
        _same(out.packed, jout.packed)
        _same(out.meta, jout.meta)
    monkeypatch.setenv("CGX_CODEC_ENCODE", "div")
    q = codec_cuda.quantize_batch(torch.from_numpy(ties), bits, bucket)
    div = codec_cuda.sra_epilogue_batch(q, raw_row=torch.from_numpy(ties[own]), own_idx=own)
    monkeypatch.setenv("CGX_CODEC_ENCODE", "mul")
    mul = codec_cuda.sra_epilogue_batch(q, raw_row=torch.from_numpy(ties[own]), own_idx=own)
    assert not torch.equal(mul.packed, div.packed)


def _jax_producer_q(x2, g2, bits, bucket, div, ws=2):
    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.ops import fused_producer as jfp

    cc = JCC(bits=bits, bucket_size=bucket)
    k, din = x2.shape
    o = g2.shape[1]
    chunk = din * o // ws
    tm, tk = jfp._kernel_geometry(k, din, o, ws, chunk, cc)
    q = jfp._matmul_quantize_q(jnp.asarray(x2), jnp.asarray(g2), cc, ws=ws, chunk=chunk,
                               div=div, tm=tm, tk=tk, interpret=True)
    return np.asarray(q.packed).reshape(-1), np.asarray(q.meta).reshape(-1, 2)


@pytest.mark.parametrize("bits,bucket", CASES)
def test_matmul_quantize_mul_matches_jax(bits, bucket, monkeypatch):
    """``x2`` the identity, so ``dw = g2 / div`` exactly: ``g2`` is the tie
    operand times the divisor (1, 2, 4, 8: ROADMAP C2)."""
    din, o = 256, 512
    x2 = np.eye(din, dtype=np.float32)
    tie = _tie(din * o, bucket, bits).reshape(din, o)
    monkeypatch.setenv("CGX_CODEC_ENCODE", "mul")
    for div in (1, 2, 4, 8):
        g2 = tie * np.float32(div)
        jw, jm = _jax_producer_q(x2, g2, bits, bucket, div)
        w, m = codec_cuda.matmul_quantize_chunks(torch.from_numpy(x2), torch.from_numpy(g2), div, bits, bucket)
        _same(w, jw)
        _same(m, jm)
        dw, _ = codec_cuda.matmul_quantize_chunks_plain(
            torch.from_numpy(x2), torch.from_numpy(g2), div, bits, bucket, encode="div")
        assert not torch.equal(w, dw), div


# ---------------------------------------------------------------------------
# The butterfly pack.
# ---------------------------------------------------------------------------


def _recording(monkeypatch, names):
    seen = []
    for name in names:
        real = getattr(codec_cuda, name)
        monkeypatch.setattr(
            codec_cuda, name,
            lambda *a, _real=real, _name=name, **kw: seen.append((_name, kw.get("pack"))) or _real(*a, **kw),
        )
    return seen


@pytest.mark.parametrize("bits,bucket", CASES)
def test_butterfly_matches_sum_and_jax(bits, bucket, monkeypatch):
    seen = _recording(monkeypatch, ["quantize_chunks", "sra_epilogue_chunks"])
    x = _normal(bits, bucket)
    rows = x.reshape(4, -1)
    tail = x[: 3 * 32 * bucket + 5 * bucket + 7][None]
    out = {}
    for pack in ("sum", "butterfly"):
        monkeypatch.setenv("CGX_PALLAS_PACK", pack)
        qs = [codec_cuda.quantize_batch(torch.from_numpy(a), bits, bucket) for a in (rows, tail)]
        ep = codec_cuda.sra_epilogue_batch(qs[0], raw_row=torch.from_numpy(rows[2]), own_idx=2)
        mm = codec_cuda.matmul_quantize_chunks_plain(
            torch.from_numpy(rows[:, :256]), torch.from_numpy(rows[:, 256:768]), 2, bits, bucket)
        out[pack] = [qs[0].packed, qs[0].meta, qs[1].packed, qs[1].meta, ep.packed, ep.meta, *mm]
        if pack == "butterfly":
            for a, q in zip((rows, tail), qs):
                jq = codec_pallas.quantize_batch(jnp.asarray(a), bits, bucket, interpret=True)
                _same(q.packed, jq.packed)
                _same(q.meta, jq.meta)
    assert set(seen) == {(n, p) for n in ("quantize_chunks", "sra_epilogue_chunks")
                         for p in ("sum", "butterfly")}
    for a, b in zip(out["sum"], out["butterfly"]):
        _same(a, b)


@pytest.mark.parametrize("kind", [autotune.KIND_FLAT, autotune.KIND_CHUNKS, autotune.KIND_EPILOGUE])
def test_cached_butterfly_entry_reaches_the_lowering(kind, monkeypatch):
    """With ``CGX_PALLAS_PACK`` unset a tuned entry's pack is used, as in
    ``codec_pallas._pack_strategy``; an explicit env value wins over it."""
    bucket = 128 if kind != autotune.KIND_CHUNKS else 96
    rows, n = 2, 4 * 32 * bucket
    ws = rows if kind == autotune.KIND_EPILOGUE else 0
    chunks = 4 if kind == autotune.KIND_EPILOGUE else rows * 4
    autotune.record(kind, autotune.TunedConfig(tc=1, pack="butterfly"),
                    n_chunks=chunks, bucket_size=bucket, bits=4, ws=ws)
    seen = _recording(monkeypatch, ["quantize_chunks", "sra_epilogue_chunks"])
    x = torch.from_numpy(_normal(4, 512)[: rows * n].reshape(rows, n))
    q = codec_cuda.quantize_batch(x, 4, bucket)
    if kind == autotune.KIND_EPILOGUE:
        codec_cuda.sra_epilogue_batch(q, raw_row=x[0], own_idx=0)
        want = [("quantize_chunks", "sum"), ("sra_epilogue_chunks", "butterfly")]
    else:
        want = [("quantize_chunks", "butterfly")]
    assert seen == want
    monkeypatch.setenv("CGX_PALLAS_PACK", "sum")
    seen.clear()
    q = codec_cuda.quantize_batch(x, 4, bucket)
    if kind == autotune.KIND_EPILOGUE:
        codec_cuda.sra_epilogue_batch(q, raw_row=x[0], own_idx=0)
    assert {p for _, p in seen} == {"sum"}


def test_producer_passes_the_resolved_lowerings(monkeypatch):
    from torch_cgx_tpu_torch.config import CompressionConfig
    from torch_cgx_tpu_torch.ops import fused_producer as fp

    seen = []
    real = codec_cuda.matmul_quantize_chunks
    monkeypatch.setattr(codec_cuda, "matmul_quantize_chunks",
                        lambda *a, **kw: seen.append((kw["encode"], kw["pack"])) or real(*a, **kw))
    x2, g2 = torch.eye(256), torch.from_numpy(_tie(256 * 512, 128, 4).reshape(256, 512))
    cc = CompressionConfig(bits=4, bucket_size=128)
    for enc, pack in (("mul", "butterfly"), ("div", "sum")):
        monkeypatch.setenv("CGX_CODEC_ENCODE", enc)
        monkeypatch.setenv("CGX_PALLAS_PACK", pack)
        q = fp._matmul_quantize_q(x2, g2, cc, ws=2, chunk=256 * 256, div=1)
        w, m = codec_cuda.matmul_quantize_chunks_plain(x2, g2, 1, 4, 128, encode=enc)
        assert torch.equal(q.packed.reshape(-1), w) and torch.equal(q.meta.reshape(-1, 2), m)
    assert seen == [("mul", "butterfly"), ("div", "sum")]


# ---------------------------------------------------------------------------
# A tiny GPT-2 train step under each knob against the JAX step.
# ---------------------------------------------------------------------------

BITS, BUCKET, VOCAB, LR = 4, 384, 4099, 1e-4
SLICE_ENV = {
    "CGX_DEBUG_FORCE_CODEC": "1",
    "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS),
    "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
    "CGX_FUSION_BUFFER_SIZE_MB": "1",
    "CGX_STANDALONE_LAYER_ELEMS": "40000",
    "CGX_CODEC_IMPL": "pallas",  # the JAX side runs its kernels (interpret mode)
}


@pytest.mark.parametrize("knob,value", [("CGX_CODEC_ENCODE", "mul"), ("CGX_PALLAS_PACK", "butterfly")])
def test_tiny_gpt2_step_under_knob_matches_jax(knob, value, monkeypatch):
    for k, v in {**SLICE_ENV, knob: value}.items():
        monkeypatch.setenv(k, v)
    cfg = JGPT2Config.tiny(vocab_size=VOCAB, dtype=jnp.float32)
    jmodel = JGPT2(cfg)
    tokens = np.random.default_rng(1).integers(0, VOCAB, size=(2, 64)).astype(np.int32)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"])
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    opt = optax.adam(LR)
    p = replicate(jax.tree.map(jnp.asarray, params), mesh)
    s = replicate(opt.init(p), mesh)
    jstep = jmake_train_step(
        lambda pp, t: jlm_loss(jmodel.apply({"params": pp}, t), t), opt, mesh, donate=False
    )
    jl = []
    for i in range(3):
        p, s, loss = jstep(p, s, shard_batch(jnp.asarray(tokens), mesh), jnp.int32(i))
        jl.append(float(loss))

    seen = _recording(monkeypatch, ["quantize_chunks"])
    model = GPT2(GPT2Config.tiny(vocab_size=VOCAB, dtype=torch.float32), device="cpu")
    model.load_state_dict(gpt2_params_from_jax(params))
    topt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), topt, device="cpu")
    tl = [float(step(torch.from_numpy(tokens))) for _ in range(3)]
    assert seen and {pk for _, pk in seen} == {value if knob == "CGX_PALLAS_PACK" else "sum"}
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    got = dict(leaf_paths(gpt2_params_to_numpy(model)))
    for path, v in leaf_paths(jax.tree.map(np.asarray, p)):
        np.testing.assert_allclose(got[path], v, rtol=0, atol=3 * LR, err_msg=path)


# ---------------------------------------------------------------------------
# The tool.
# ---------------------------------------------------------------------------


def test_cli_arguments_and_defaults():
    a = qbench.parse_args(["sra_epilogue"])
    assert (a.ws, a.tc, a.mb, a.bits, a.bucket, a.k, a.device) == (8, 0, 128, 4, 512, 8, None)
    a = qbench.parse_args(["mul", "--ws", "4", "--tc", "2", "--mb", "2", "--bits", "2",
                           "--bucket", "128", "--k", "3", "--device", "cpu"])
    assert (a.variant, a.ws, a.tc, a.mb, a.bits, a.bucket, a.k, a.device) == (
        "mul", 4, 2, 2, 2, 128, 3, "cpu")
    assert set(qbench.VARIANTS) == {"current", "butterfly", "mul", "nometa", "metalane", "read",
                                    "dequant", "sra_epilogue"}
    for bad in (["nope"], ["current", "--k", "1"]):
        with pytest.raises(SystemExit):
            qbench.parse_args(bad)


@pytest.mark.parametrize("variant", ["current", "mul", "metalane", "sra_epilogue"])
def test_cli_record_on_the_cpu(variant, capsys):
    rec = qbench.main([variant, "--mb", "1", "--k", "2", "--bucket", "128", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "byte_check" in out and '"tool": "qbench"' in out
    for key in ("tool", "variant", "tc", "mb", "bits", "bucket", "pack", "encode", "t_ms",
                "gbps_in", "unresolved", "bound_ms", "pct_of_bound", "device", "card"):
        assert key in rec, key
    assert rec["device"] == "cpu" and rec["bound_ms"] is None and rec["card"] is None
    assert rec["encode"] == ("mul" if variant == "mul" else "div")
    assert os.environ.get("CGX_PALLAS_TILE_CHUNKS") is None


def test_variant_bytes_at_the_default_size():
    n = 128 * 1024 * 1024 // 4
    for name in ("current", "mul", "butterfly", "nometa", "read", "dequant"):
        assert qbench.variant_bytes(name, n, 4, 512, 8) == 151_519_232
    assert qbench.variant_bytes("metalane", n, 4, 512, 8) == 152_043_520
    assert qbench.variant_bytes("sra_epilogue", n, 4, 512, 8) == 34_078_720


def test_run_variant_without_a_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros(32 * 128)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        qbench.run_variant("nometa", x, 4, 128, 1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        qbench.main(["current", "--mb", "1"])
