"""The 16-bit wire dtypes (bf16, f16) of the port against the JAX package,
on the CPU.

The JAX package syncs a bf16 or f16 leaf in its own dtype: its quantize
kernels read the 16-bit input, the epilogue and the reduce read the raw
own row in the wire dtype, and the epilogue rounds the folded chunk
through it before the requantize (``codec_pallas._requant_cast``); the
meta travels in the leaf's dtype. Here the port's plain versions (what its
wrappers run on CPU tensors) must give the same bytes:

* quantize (``_quantize_flat_impl``, ``_quantize_chunks_impl``; the batch
  function with a dense tail and a residual): packed words and meta
  byte-identical to the Pallas kernels in interpret mode, div and mul
  encodes, on random data;
* the SRA epilogue (``_sra_epilogue_impl`` with ``cast_dtype`` and a
  16-bit raw row) and the reduce (``_reduce_rows_impl`` with a 16-bit raw
  row): byte-identical on decode-exact peer rows (an integer grid, so no
  fused multiply-add can move a decode) with a random raw own row, whose
  sums the wire dtype cannot hold, so the round trip matters;
* the decode glue: the meta and a 16-bit accumulator upcast outside the
  decode, bit-identical on decode-exact data;
* ``allreduce_tree`` over a tree of f32, bf16 and f16 leaves at the
  world-size-1 proxy and on spawned gloo ranks at ws 2 and 4 (SRA in both
  epilogue lowerings, Ring, all-to-all) and over two levels at ws 4,
  bit-identical to the JAX package on the CPU mesh, with bf16 meta on the
  wire; the JAX package's ``test_bf16_constant_exact`` at ws 2 and 4;
* a tiny GPT-2 with its parameters in bf16: the same bf16 gradient tree
  synced bit-identically by both packages' train-step sync, and three
  train steps whose losses agree within a stated bf16 tolerance;
* the converter carries a bf16 tree across unchanged;
* on a stand-in library, the wrappers hand the wire dtype's code to the
  entry points, B4 picks its width by element count, B7a's ring takes the
  element size, and another dtype raises ``ValueError``.

The kernels themselves run only on the card (``test_torch_kernels.py``,
the ``subf32`` tests, skip here). Each gloo world is spawned once per
module; the rank bodies import only torch and the port.
"""

import multiprocessing as mp
import os
import queue
import re
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cgx_tpu.ops import codec_pallas
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.ops import codec, codec_cuda, dispatch

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
SPAWN_TIMEOUT_S = 300.0


def _to_jax(t: torch.Tensor):
    """A 16-bit torch tensor as a JAX array of the same dtype (through an
    exact float32 upcast)."""
    jd = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16, torch.float32: jnp.float32}
    return jnp.asarray(t.float().numpy()).astype(jd[t.dtype])


def _f32(a) -> np.ndarray:
    """The float32 values of a torch tensor or JAX array of any float
    dtype (exact), viewed as uint32 for a bit-for-bit comparison."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy().view(np.uint32)
    return np.asarray(a).astype(np.float32).view(np.uint32)


def _u32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.numpy().view(np.uint32)
    return np.asarray(a).view(np.uint32)


def _random(shape, dtype: torch.dtype, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


def _grid(rows: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """Decode-exact rows: integer grids whose buckets hold 0 and 15."""
    return torch.from_numpy(
        np.stack([np.float32((np.arange(n) * (2 * r + 3)) % 16) for r in range(rows)])).to(dtype)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------


def _spy(monkeypatch, name: str) -> list:
    """Count the calls of ``codec_pallas.<name>``."""
    calls = []
    orig = getattr(codec_pallas, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)

    monkeypatch.setattr(codec_pallas, name, wrapped)
    return calls


@pytest.mark.parametrize("encode", ["div", "mul"])
@pytest.mark.parametrize("geometry,bucket,impl", [
    ("chunks", 128, "_quantize_flat_impl"),
    ("chunks", 96, "_quantize_chunks_impl"),
    ("tail", 128, "_quantize_chunks_impl"),
])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_quantize_matches_pallas(dname, geometry, bucket, impl, encode, monkeypatch):
    """B1 (the flat kernel) and B5 (the chunk kernel) on a bf16 or f16
    input: the port's words and meta (in the input's dtype) equal the
    Pallas kernels', at 1, 4 and 8 bits."""
    monkeypatch.setenv("CGX_CODEC_ENCODE", encode)
    dtype, jdtype = DTYPES[dname]
    chunk = codec.CHUNK_BUCKETS * bucket
    n = 2 * chunk if geometry == "chunks" else chunk + 5 * bucket + bucket // 3
    x = _random((2, n), dtype, n + bucket)
    calls = _spy(monkeypatch, impl)
    for bits in (1, 4, 8):
        jq = codec_pallas.quantize_batch(_to_jax(x), bits, bucket, interpret=True)
        q = codec_cuda.quantize_batch(x, bits, bucket)
        assert q.meta.dtype == dtype and jq.meta.dtype == jdtype
        np.testing.assert_array_equal(_u32(q.packed), _u32(jq.packed), err_msg=f"bits={bits}")
        np.testing.assert_array_equal(_f32(q.meta), _f32(jq.meta), err_msg=f"bits={bits}")
    assert len(calls) == 3


@pytest.mark.parametrize("dname", list(DTYPES))
def test_quantize_residual_and_specials_match_pallas(dname):
    """A partial final bucket carried raw in the residual (in the input's
    dtype) and a dense tail; specials of the 16-bit range (its largest
    finite values, subnormals, +-0) in the chunks. The bucket holding
    +-max has a range of twice max: past f32's own range for bf16 (an inf
    unit at every width), past f16's for its meta at 1 bit (the f32 unit
    is finite, its f16 cast inf); both packages alike."""
    dtype, _ = DTYPES[dname]
    bucket = 128
    n = codec.CHUNK_BUCKETS * bucket + 3 * bucket + 77
    x = _random((1, n), dtype, 9)
    big = torch.finfo(dtype).max
    tiny = torch.finfo(dtype).tiny / 4  # subnormal
    x[0, :6] = torch.tensor([big, -big, tiny, -tiny, 0.0, -0.0], dtype=dtype)
    for bits in (1, 4):
        jq = codec_pallas.quantize_batch(_to_jax(x), bits, bucket, interpret=True,
                                         skip_incomplete_buckets=True)
        q = codec_cuda.quantize_batch(x, bits, bucket, skip_incomplete_buckets=True)
        np.testing.assert_array_equal(_u32(q.packed), _u32(jq.packed))
        np.testing.assert_array_equal(_f32(q.meta), _f32(jq.meta))
        assert bool(torch.isinf(q.meta[0, 0, 0])) == (bits == 1 or dtype == torch.bfloat16)
        assert q.residual.dtype == dtype
        np.testing.assert_array_equal(_f32(q.residual), _f32(jq.residual))


def _epilogue_rows(ws: int, own: int, n: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """Grid peer rows (decode-exact) and a random raw own row: the folded
    sums need more bits than the wire dtype has."""
    rows = _grid(ws, n, dtype)
    if own >= 0:
        rows[own] = _random(n, dtype, seed) * 3
    return rows


@pytest.mark.parametrize("ws,own", [(1, -1), (1, 0), (4, -1), (4, 1), (4, 3)])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_sra_epilogue_matches_pallas(dname, ws, own, monkeypatch):
    """``_sra_epilogue_impl`` with ``cast_dtype`` the wire dtype and the raw
    own row in it: the port's stage-2 payload equals the kernel's, and the
    rounding through the wire dtype moved the bytes (the same fold without
    the cast gives other bytes wherever a raw row is folded into other
    rows; a raw row alone is already in the wire dtype)."""
    dtype, jdtype = DTYPES[dname]
    bits, bucket = 4, 128
    n = 2 * codec.CHUNK_BUCKETS * bucket
    rows = _epilogue_rows(ws, own, n, dtype, ws + own + 3)
    calls = _spy(monkeypatch, "_sra_epilogue_impl")
    jq = codec_pallas.quantize_batch(_to_jax(rows), bits, bucket, interpret=True)
    q = codec_cuda.quantize_batch(rows, bits, bucket)
    raw, jraw = (None, None) if own < 0 else (rows[own], _to_jax(rows[own]))
    jown = None if own < 0 else jnp.int32(own)
    want = codec_pallas.sra_epilogue_batch(jq, raw_row=jraw, own_idx=jown, out_dtype=jdtype,
                                           interpret=True)
    got = codec_cuda.sra_epilogue_batch(q, raw_row=raw, own_idx=None if own < 0 else own,
                                        out_dtype=dtype)
    assert calls == ["_sra_epilogue_impl"]
    assert got.meta.dtype == dtype and got.dtype == dtype
    np.testing.assert_array_equal(_u32(got.packed), _u32(want.packed))
    np.testing.assert_array_equal(_f32(got.meta), _f32(want.meta))
    # The staged path of both packages: reduced.astype(dtype), quantized.
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "staged")
    cc = CompressionConfig(bits=bits, bucket_size=bucket)
    staged = dispatch.reduce_rows_requantize(q, cc, raw_rows=None if own < 0 else rows,
                                             own_idx=None if own < 0 else own, out_dtype=dtype)
    np.testing.assert_array_equal(_u32(staged.packed), _u32(want.packed))
    if own >= 0 and ws > 1:
        w32, _ = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta.float(), raw.float(), own,
                                                      bits, bucket)
        assert not np.array_equal(_u32(w32), _u32(got.packed).reshape(-1))


@pytest.mark.parametrize("ws,own", [(2, 0), (2, 1), (4, 2), (5, 4)])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_reduce_rows_matches_pallas(dname, ws, own, monkeypatch):
    """``_reduce_rows_impl`` with a bf16 or f16 raw own row: the port's f32
    reduced chunk equals the kernel's bit for bit."""
    dtype, _ = DTYPES[dname]
    bits, bucket = 4, 128
    n = 3 * codec.CHUNK_BUCKETS * bucket
    rows = _epilogue_rows(ws, own, n, dtype, 10 * ws + own)
    calls = _spy(monkeypatch, "_reduce_rows_impl")
    jq = codec_pallas.quantize_batch(_to_jax(rows), bits, bucket, interpret=True)
    q = codec_cuda.quantize_batch(rows, bits, bucket)
    want = codec_pallas.reduce_rows_batch(jq, raw_row=_to_jax(rows[own]), own_idx=jnp.int32(own),
                                          interpret=True)
    got = codec_cuda.reduce_rows_batch(q, raw_row=rows[own], own_idx=own)
    assert calls == ["_reduce_rows_impl"] and got.dtype == torch.float32
    np.testing.assert_array_equal(_u32(got), _u32(want))


@pytest.mark.parametrize("geometry", ["chunks", "tail"])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_decode_glue_matches_pallas(dname, geometry):
    """The decode of a 16-bit payload (its meta upcast outside the kernel)
    with and without a 16-bit accumulator, the output in the accumulator's
    (or the payload's) dtype, on decode-exact data."""
    dtype, _ = DTYPES[dname]
    bits, bucket = 4, 128
    chunk = codec.CHUNK_BUCKETS * bucket
    n = 2 * chunk if geometry == "chunks" else chunk + 3 * bucket + 40
    x = _grid(2, n, dtype)
    acc = _random((2, n), dtype, 4)
    jq = codec_pallas.quantize_batch(_to_jax(x), bits, bucket, interpret=True)
    q = codec_cuda.quantize_batch(x, bits, bucket)
    for add in (None, acc):
        want = codec_pallas.dequantize_batch(jq, add_to=None if add is None else _to_jax(add),
                                             interpret=True)
        got = codec_cuda.dequantize_batch(q, add_to=add)
        assert got.dtype == dtype
        np.testing.assert_array_equal(_f32(got), _f32(want))


# ---------------------------------------------------------------------------
# The wrappers on a stand-in library (the arguments the entry points get).
# ---------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the built library: records each entry point's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(codec_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(codec_cuda, "_stream", lambda t: 0)
    monkeypatch.setattr(codec_cuda, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(codec_cuda, "_sm_count", lambda index: 132)
    codec_cuda.reset_launch_counts()
    yield lib
    codec_cuda.reset_launch_counts()


@pytest.mark.parametrize("dtype,wire", [(torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 2)])
def test_wire_code_reaches_the_quantize_kernels(fake_card, dtype, wire):
    """B1 and B7a get the input's dtype code just before the stream, the
    16-bit launches counted in WIRE16_LAUNCHES."""
    x = torch.zeros(4 * 32 * 512, dtype=dtype)
    codec_cuda.quantize_chunks(x, 4, 512)
    codec_cuda.quantize_chunks_db(x, 4, 512, 2)
    (q, qa), (d, da) = fake_card.calls
    assert (q, d) == ("cgx_quantize", "cgx_quantize_db")
    assert qa[-2] == da[-2] == wire
    assert codec_cuda.LAUNCHES["codec_quantize"] == codec_cuda.LAUNCHES["codec_quantize_db"] == 1
    assert codec_cuda.WIRE16_LAUNCHES["codec_quantize"] == int(wire > 0)
    assert codec_cuda.WIRE16_LAUNCHES["codec_quantize_db"] == int(wire > 0)


@pytest.mark.parametrize("cast,raw_dtype,wire", [
    (torch.float32, torch.float32, 0), (torch.bfloat16, torch.bfloat16, 1),
    (torch.float16, torch.float16, 2), (torch.bfloat16, None, 1), (torch.float16, None, 2),
])
def test_wire_code_reaches_the_epilogue_kernels(fake_card, cast, raw_dtype, wire):
    """B3 and B7c get the cast dtype's code (a raw row, if any, in it)."""
    ws, chunks = 4, 2
    words = torch.zeros(ws, chunks * 4 * 512, dtype=torch.int32)
    meta = torch.zeros(ws, chunks * 32, 2)
    raw = None if raw_dtype is None else torch.zeros(chunks * 32 * 512, dtype=raw_dtype)
    own = -1 if raw is None else 2
    codec_cuda.sra_epilogue_chunks(words, meta, raw, own, 4, 512, cast_dtype=cast)
    codec_cuda.sra_epilogue_chunks_db(words, meta, raw, own, 4, 512, 1, cast_dtype=cast)
    (e, ea), (d, da) = fake_card.calls
    assert (e, d) == ("cgx_sra_epilogue", "cgx_sra_epilogue_db") and ea[-2] == da[-2] == wire
    assert codec_cuda.WIRE16_LAUNCHES["codec_sra_epilogue"] == int(wire > 0)


def test_epilogue_refuses_a_raw_row_of_another_dtype_and_other_dtypes(fake_card):
    """On the card the raw own row must be in the wire dtype; a dtype
    outside f32, bf16 and f16 raises ValueError naming it, in every
    wrapper; nothing is launched."""
    words = torch.zeros(2, 4 * 512, dtype=torch.int32)
    meta = torch.zeros(2, 32, 2)
    raw = torch.zeros(32 * 512)
    with pytest.raises(ValueError, match="wire dtype torch.bfloat16, got torch.float32"):
        codec_cuda.sra_epilogue_chunks(words, meta, raw, 0, 4, 512, cast_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wire dtype torch.float32, got torch.float16"):
        codec_cuda.sra_epilogue_chunks_db(words, meta, raw.half(), 0, 4, 512, 1)
    for bad in (torch.float64, torch.int32):
        with pytest.raises(ValueError, match=str(bad).split(".")[1]):
            codec_cuda.quantize_chunks(raw.to(bad), 4, 512)
        with pytest.raises(ValueError, match=str(bad).split(".")[1]):
            codec_cuda.quantize_chunks_db(raw.to(bad), 4, 512, 1)
        with pytest.raises(ValueError, match=str(bad).split(".")[1]):
            codec_cuda.reduce_rows_chunks(words, meta, raw.to(bad), 0, 4, 512)
        with pytest.raises(ValueError, match=str(bad).split(".")[1]):
            codec_cuda.sra_epilogue_chunks(words, meta, None, -1, 4, 512, cast_dtype=bad)
    assert fake_card.calls == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_reduce_width_follows_the_element_count(fake_card, dtype, offset):
    """B4's full width needs the raw row aligned to four of its values (16
    bytes of f32, 8 of a 16-bit dtype): a view ``offset`` values past an
    aligned start takes it at offsets 0 and 4, the scalar width
    (REDUCE_SCALAR) at 1 and 2; the raw row's dtype code reaches the entry
    point."""
    ws, chunks = 2, 1
    words = torch.zeros(ws, chunks * 4 * 512, dtype=torch.int32)
    meta = torch.zeros(ws, chunks * 32, 2)
    n = chunks * 32 * 512
    buf = torch.zeros(n + 8, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    raw = buf[offset:offset + n]
    codec_cuda.reduce_rows_chunks(words, meta, raw, 1, 4, 512)
    (name, args), = fake_card.calls
    vec, wire = args[8], args[-2]
    assert name == "cgx_reduce_rows" and wire == codec_cuda.WIRE_DTYPES.index(dtype)
    assert vec == (4 if offset % 4 == 0 else 1)
    assert codec_cuda.REDUCE_SCALAR["launches"] == int(offset % 4 != 0)
    assert codec_cuda.WIRE16_LAUNCHES["codec_reduce_rows"] == int(dtype != torch.float32)


@pytest.mark.parametrize("chunks,bucket", [(144, 512), (2048, 512), (3, 1760), (5, 16384)])
def test_db_ring_takes_the_element_size(chunks, bucket):
    """B7a's slots hold 32 x T values of the input's size: half the bytes at
    16 bits, so its dynamic shared memory shrinks and the clusters the card
    holds do not fall; B7c's ring does not depend on it; the routing of a
    bf16 payload equals an f32 one's."""
    r4 = codec_cuda.db_ring("quantize", chunks, 4, bucket)
    r2 = codec_cuda.db_ring("quantize", chunks, 4, bucket, elem_size=2)
    assert r2.geometry == r4.geometry and r2.slots == r4.slots
    assert 2 * r2.slot_bytes == r4.slot_bytes == 32 * r4.geometry.threads * 4
    assert r2.slot_bytes % 16 == 0 and (r2.slot_bytes // 32) % 16 == 0  # bulk-copy sizes
    s4 = codec_cuda.db_smem_bytes("quantize", 1, 4, bucket, chunks=chunks)
    s2 = codec_cuda.db_smem_bytes("quantize", 1, 4, bucket, chunks=chunks, elem_size=2)
    assert s4 - s2 == r2.slots * r2.slot_bytes
    assert (codec_cuda.db_clusters("quantize", chunks, 4, bucket, elem_size=2)
            >= codec_cuda.db_clusters("quantize", chunks, 4, bucket))
    assert codec_cuda.db_ring("epilogue", chunks, 4, bucket, elem_size=2) == codec_cuda.db_ring(
        "epilogue", chunks, 4, bucket)
    for dtype in (torch.bfloat16, torch.float16):
        q16, q32 = (codec.QTensor(
            packed=torch.empty((1, 0), dtype=torch.int32), meta=torch.empty((1, chunks * 32, 2), dtype=d),
            residual=torch.empty((1, 0), dtype=d), numel=chunks * 32 * bucket, bits=4,
            bucket_size=bucket, dtype=d) for d in (dtype, torch.float32))
        for kernel in ("quantize", "dequantize", "epilogue"):
            assert codec_cuda.db_would_run(kernel, q16) == codec_cuda.db_would_run(kernel, q32)


def test_source_wire_codes_and_parts():
    """The entry points' wire codes are WIRE_DTYPES' order; the build's
    part count covers every CGX_PART of the source; the 16-bit instances
    are uint16_t instances of the same kernel templates."""
    src = codec_cuda.SOURCE.read_text()
    codes = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (kWire\w+) = (\d+);", src)}
    assert codes == {"kWireF32": 0, "kWireBf16": 1, "kWireF16": 2}
    assert codec_cuda.WIRE_DTYPES == (torch.float32, torch.bfloat16, torch.float16)
    parts = {int(k) for k in re.findall(r"CGX_IN_PART\((\d+)\)", src)}
    assert parts == set(range(codec_cuda.BUILD_PARTS))
    for entry in ("QUANTIZE_ENTRY", "EPILOGUE_ENTRY", "QUANTIZE_DB_ENTRY", "EPILOGUE_DB_ENTRY"):
        for form in ("^template", "^extern template"):
            assert len(re.findall(rf"{form} CGX_{entry}\((true|false), uint16_t\);", src, re.M)) == 2


def test_ptxas_instances_keys():
    """The build report's parser: an f32 instance keeps its key whether or
    not its mangled name carries the element type, a uint16_t one gets
    ``:16``; registers, spills and static shared memory are read; the
    comparison names every difference and every missing instance."""
    def entry(name, regs, spill, smem):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, {smem} bytes smem, 400 bytes cmem[0]\n")

    old = entry("_ZN12_GLOBAL__N_127cgx_quantize_cluster_kernelILi4ELi0ELi0ELb0ELb0EEEvPKfPiPfiif5uint2",
                64, 0, 4352)
    new = entry("_ZN12_GLOBAL__N_127cgx_quantize_cluster_kernelILi4ELi0ELi0ELb0ELb0EfEEvPKT4_Pi", 64, 0,
                4352)
    w16 = entry("_ZN12_GLOBAL__N_127cgx_quantize_cluster_kernelILi4ELi0ELi0ELb0ELb0EtEEvPKT4_Pi", 62, 8,
                4352)
    plain = entry("_ZN12_GLOBAL__N_120cgx_div_sweep_kernelEiiiiiPyPf", 40, 0, 0)
    key = "cgx_quantize_cluster_kernel<4,0,0,0,0>"
    t_old = codec_cuda.ptxas_instances(old + plain)
    t_new = codec_cuda.ptxas_instances(new + w16 + plain)
    assert t_old[key] == t_new[key] == {"registers": 64, "spill_stores": 0, "spill_loads": 0,
                                        "smem": 4352}
    assert t_new[key + ":16"]["spill_stores"] == 8 and "cgx_div_sweep_kernel" in t_new
    from torch_cgx_tpu_torch.tools import ptxas_table

    assert ptxas_table.compare(t_new, ptxas_table.f32_table(t_old)) == []
    worse = codec_cuda.ptxas_instances(new.replace("Used 64", "Used 72") + plain)
    assert [d[0] for d in ptxas_table.compare(worse, t_old)] == [key]
    assert [d[0] for d in ptxas_table.compare({}, t_old)] == sorted(t_old)


# ---------------------------------------------------------------------------
# Models: the converter and the bf16-parameter GPT-2 step.
# ---------------------------------------------------------------------------


def test_converter_round_trips_a_bf16_tree():
    """A flax tree cast to bf16 comes across as bf16 tensors with the same
    values and goes back to the same float32 values."""
    from torch_cgx_tpu.models import GPT2 as JGPT2
    from torch_cgx_tpu.models import GPT2Config as JGPT2Config
    from torch_cgx_tpu.utils.tree import leaf_paths
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_jax, gpt2_params_to_numpy

    jm = JGPT2(JGPT2Config.tiny())
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    p16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    sd = gpt2_params_from_jax(jax.tree.map(np.asarray, p16), dtype=torch.bfloat16)
    assert {t.dtype for t in sd.values()} == {torch.bfloat16}
    model = GPT2(GPT2Config.tiny(), device="cpu").to(torch.bfloat16)
    model.load_state_dict(sd)
    back = dict(leaf_paths(gpt2_params_to_numpy(model)))
    for path, v in leaf_paths(p16):
        np.testing.assert_array_equal(back[path].view(np.uint32), _f32(v), err_msg=path)


VOCAB = 512
LR = 1e-4
STEP_ENV = {
    "CGX_DEBUG_FORCE_CODEC": "1",
    "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
    "CGX_COMPRESSION_BUCKET_SIZE": "128",
    "CGX_FUSION_BUFFER_SIZE_MB": "1",
    "CGX_STANDALONE_LAYER_ELEMS": "40000",
}
# Three Adam steps of the bf16-parameter model: the two frameworks round
# the bf16 activations, the LayerNorm and the bf16 Adam moments in other
# places, and with bf16 parameters each update rounds to bf16 again. Step
# 0's loss (the same parameters, the forward alone) agrees to a relative
# 5.0e-5 (largest reading); it is held to BF16_LOSS0_RTOL. Each later
# step's fall from step 0 agrees to 6.3e-4 (largest reading over three
# steps, 8.5e-4 over six) against a fall of about 0.057 a step; it is held
# to BF16_FALL_ATOL, under a tenth of one step's fall, so an update of half
# or twice the size (off by 0.04 and 0.14 after one step), or none, fails.
BF16_LOSS0_RTOL = 2e-4
BF16_FALL_ATOL = 5e-3


def _bf16_models():
    from torch_cgx_tpu.models import GPT2 as JGPT2
    from torch_cgx_tpu.models import GPT2Config as JGPT2Config
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_jax

    jm = JGPT2(JGPT2Config.tiny(vocab_size=VOCAB))
    tokens = np.random.default_rng(1).integers(0, VOCAB, size=(2, 64)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"]
    p16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    model = GPT2(GPT2Config.tiny(vocab_size=VOCAB), device="cpu").to(torch.bfloat16)
    model.load_state_dict(gpt2_params_from_jax(jax.tree.map(np.asarray, p16), dtype=torch.bfloat16))
    return jm, p16, model, tokens


def _mesh1():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:1]), ("dp",))


def test_bf16_param_sync_matches_jax(monkeypatch):
    """The same bf16 gradient tree (the JAX model's, on its bf16
    parameters) synced by the port's ``gradient_sync`` (the sync
    ``make_train_step`` runs) and by the JAX one on a one-device mesh at
    the world-size-1 proxy: bit-identical bf16 leaves, in both epilogue
    lowerings."""
    from jax.sharding import PartitionSpec as P

    from torch_cgx_tpu.models import lm_loss as jlm_loss
    from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu.utils.tree import leaf_paths
    from torch_cgx_tpu_torch.parallel import gradient_sync

    for k, v in STEP_ENV.items():
        monkeypatch.setenv(k, v)
    jm, p16, _, tokens = _bf16_models()
    grads = jax.grad(lambda p: jlm_loss(jm.apply({"params": p}, tokens), tokens))(p16)
    assert {leaf.dtype for _, leaf in leaf_paths(grads)} == {jnp.dtype(jnp.bfloat16)}
    mesh = _mesh1()
    fn = shard_map(lambda g: jgradient_sync(g, mesh=mesh, average=False), mesh=mesh,
                   in_specs=P(), out_specs=P(), check_vma=False)
    want = dict(leaf_paths(jax.jit(fn)(grads)))
    tree = {p: torch.from_numpy(np.asarray(v).astype(np.float32)).to(torch.bfloat16)
            for p, v in leaf_paths(grads)}
    lossy = 0
    for mode in ("staged", "fused"):
        monkeypatch.setenv("CGX_SRA_EPILOGUE", mode)
        got = gradient_sync(tree, average=False)
        for p, v in want.items():
            assert got[p].dtype == torch.bfloat16
            np.testing.assert_array_equal(_f32(got[p]), _f32(v), err_msg=f"{mode} {p}")
            lossy += int((got[p] != tree[p]).sum())
    assert lossy > 0  # the codec really ran


def test_bf16_param_train_steps_match_jax(monkeypatch):
    """Three compressed train steps of the tiny GPT-2 with bf16 parameters
    in both packages (Adam on the bf16 tree, as optax's on a bf16 tree):
    finite losses, step 0's within ``BF16_LOSS0_RTOL`` of JAX's and each
    step's fall from step 0 within ``BF16_FALL_ATOL`` of JAX's, bf16
    parameters after each step, the loss falling."""
    from torch_cgx_tpu.models import lm_loss as jlm_loss
    from torch_cgx_tpu.parallel import make_train_step as jmake_train_step
    from torch_cgx_tpu.parallel import replicate, shard_batch
    import optax

    from torch_cgx_tpu_torch.models import lm_loss
    from torch_cgx_tpu_torch.parallel import make_train_step

    for k, v in STEP_ENV.items():
        monkeypatch.setenv(k, v)
    jm, p16, model, tokens = _bf16_models()
    mesh = _mesh1()
    opt = optax.adam(LR)
    p = replicate(jax.tree.map(jnp.asarray, p16), mesh)
    s = replicate(opt.init(p), mesh)
    jstep = jmake_train_step(lambda pp, t: jlm_loss(jm.apply({"params": pp}, t), t), opt, mesh,
                             donate=False)
    jl = []
    for i in range(3):
        p, s, loss = jstep(p, s, shard_batch(jnp.asarray(tokens), mesh), jnp.int32(i))
        jl.append(float(loss))
    topt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), topt, device="cpu")
    t = torch.from_numpy(tokens)
    tl = [float(step(t)) for _ in range(3)]
    assert np.all(np.isfinite(tl)) and {q.dtype for q in model.parameters()} == {torch.bfloat16}
    np.testing.assert_allclose(tl[0], jl[0], rtol=BF16_LOSS0_RTOL)
    np.testing.assert_allclose(np.subtract(tl, tl[0]), np.subtract(jl, jl[0]), rtol=0,
                               atol=BF16_FALL_ATOL)
    assert tl[-1] < tl[0]


# ---------------------------------------------------------------------------
# allreduce_tree over mixed f32 + bf16 + f16 trees: the world-size-1 proxy
# here, ws 2 and 4 (and two levels at ws 4) on spawned gloo ranks.
# ---------------------------------------------------------------------------

# Two bits cannot carry the grids' 16 levels, so a sync that bypassed the
# codec would show; the decode stays exact (unit 5, min 0).
TREE_ENV = {
    "CGX_COMPRESSION_QUANTIZATION_BITS": "2",
    "CGX_COMPRESSION_BUCKET_SIZE": "128",
    "CGX_STANDALONE_LAYER_ELEMS": "16384",
    "CGX_FUSION_BUFFER_SIZE_MB": "1",
}
# (shape, dtype name): a standalone bf16 leaf of whole chunks per rank and
# one with a tail, a 1 MB fusion slice's worth of bf16 (two slices, the
# second a tail), small leaves of each dtype fused by dtype, an f16 and an
# f32 standalone leaf.
TREE_LEAVES = {
    "a.kernel": ((64, 512), "bfloat16"),
    "b.kernel": ((100, 200), "bfloat16"),
    "c.kernel": ((600, 1000), "bfloat16"),
    "d.kernel": ((32, 128), "bfloat16"),
    "e.kernel": ((48, 128), "float16"),
    "f.kernel": ((40, 128), "float32"),
    "g.kernel": ((128, 160), "float16"),
    "h.kernel": ((96, 256), "float32"),
    "i.bias": ((77,), "bfloat16"),
}
TREE_SCHEMES = {
    "sra_staged": {"CGX_SRA_EPILOGUE": "staged"},
    "sra_fused": {"CGX_SRA_EPILOGUE": "fused"},
    "ring": {"CGX_INNER_REDUCTION_TYPE": "RING"},
    "alltoall": {"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1", "CGX_SRA_EPILOGUE": "fused"},
}


def _tree_inputs(ws: int):
    """Per-rank decode-exact leaves (integer grids, exact in every dtype),
    as float32 numpy, and the rank-constant bf16 buffer of the JAX
    package's constant test."""
    trees = []
    for r in range(ws):
        tree = {}
        for i, (path, (shape, _)) in enumerate(TREE_LEAVES.items()):
            n = int(np.prod(shape))
            tree[path] = np.float32((np.arange(n) * (2 * i + 3 + r)) % 16).reshape(shape)
        trees.append(tree)
    const = np.stack([np.full((1024,), r + 1, np.float32) for r in range(ws)])
    return trees, const


def _torch_tree(tree):
    return {p: torch.from_numpy(v).to(getattr(torch, TREE_LEAVES[p][1])) for p, v in tree.items()}


def _back(tree):
    """bf16 / f16 leaves as float32 numpy (exact), with their dtype."""
    return {p: (v.float().numpy(), str(v.dtype)) for p, v in tree.items()}


def _rank_main(rank, ws, init_file, trees, const, result_q):
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    import torch.distributed as dist

    from torch_cgx_tpu_torch.parallel import allreduce, gradient_sync, hierarchical_groups, reducers

    torch.set_num_threads(1)
    out = {}
    try:
        timeout = timedelta(seconds=120)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=ws, timeout=timeout)
        tl = hierarchical_groups(intra_size=2, timeout=timeout)
        os.environ.update(TREE_ENV)
        for scheme, knobs in TREE_SCHEMES.items():
            os.environ.update(knobs)
            out[scheme] = _back(allreduce.allreduce_tree(_torch_tree(trees[rank])))
            for k in knobs:
                del os.environ[k]
        os.environ["CGX_SRA_EPILOGUE"] = "fused"
        out["two_level"] = _back(gradient_sync(_torch_tree(trees[rank]), group=tl, average=False))
        del os.environ["CGX_SRA_EPILOGUE"]
        cc = CompressionConfig(bits=4, bucket_size=512)
        y = reducers.sra_allreduce(torch.from_numpy(const[rank]).to(torch.bfloat16), None, ws, cc)
        out["const"] = (y.float().numpy(), str(y.dtype))
        dist.barrier()
    except Exception as e:  # reported to the parent, which fails the test
        out = {"error": repr(e)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


def _spawn(ws: int, trees, const, init_file: str):
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, ws, init_file, trees, const, result_q),
                         daemon=True) for r in range(ws)]
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
    return [results[r] for r in range(ws)]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda ws: f"ws{ws}")
def world(request, tmp_path_factory):
    ws = request.param
    trees, const = _tree_inputs(ws)
    store = tmp_path_factory.mktemp(f"gloo_subf32_ws{ws}") / "store"
    return ws, trees, const, _spawn(ws, trees, const, str(store))


def _jax_tree(trees, mesh, axes, spec_axes):
    """The JAX package's ``gradient_sync`` of the per-rank trees (leaves in
    their dtypes) over ``mesh``: ``{path: (ws, ...) float32}``."""
    from jax.sharding import PartitionSpec as P

    from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu.utils.tree import leaf_paths

    ws = len(trees)
    lead = tuple(mesh.devices.shape)
    tree = {}
    for path, (shape, dname) in TREE_LEAVES.items():
        node = tree
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(np.stack([t[path] for t in trees]).reshape(lead + shape)).astype(
            getattr(jnp, dname))
    spec = jax.tree.map(lambda _: P(*spec_axes), tree)
    idx = (0,) * len(lead)
    body = shard_map(
        lambda t: jax.tree.map(lambda a: a[(None,) * len(lead)],
                               jgradient_sync(jax.tree.map(lambda a: a[idx], t), mesh=mesh, axes=axes,
                                              average=False)),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False,
    )
    out = dict(leaf_paths(jax.jit(body)(tree)))
    for path, (_, dname) in TREE_LEAVES.items():
        assert out[path].dtype == jnp.dtype(getattr(jnp, dname)), path
    return {p: np.asarray(v).astype(np.float32).reshape((ws,) + TREE_LEAVES[p][0]) for p, v in out.items()}


def _flat_mesh(ws):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:ws]), ("dp",))


@pytest.mark.parametrize("scheme", list(TREE_SCHEMES))
def test_mixed_tree_matches_jax(world, scheme, monkeypatch):
    """SRA (both epilogue lowerings), Ring and all-to-all over the mixed
    tree: each leaf back in its dtype, bit-identical to the JAX package's on
    every rank."""
    ws, trees, _, results = world
    for k, v in {**TREE_ENV, **TREE_SCHEMES[scheme]}.items():
        monkeypatch.setenv(k, v)
    want = _jax_tree(trees, _flat_mesh(ws), ("dp",), ("dp",))
    lossy = 0
    for r in range(ws):
        for path, (got, dtype) in results[r][scheme].items():
            assert dtype == f"torch.{TREE_LEAVES[path][1]}", (path, dtype)
            np.testing.assert_array_equal(got.view(np.uint32), want[path][r].view(np.uint32),
                                          err_msg=f"rank {r} {path}")
            lossy += int((got != sum(t[path] for t in trees)).sum())
    assert lossy > 0  # the codec really ran


def test_mixed_tree_two_levels_match_jax(world, monkeypatch):
    """The two-level scheme (intra SRA with the fused reduce's 16-bit raw
    rows, cross Ring) over (cross ws/2, intra 2) subgroups: bit-identical
    to the JAX package over the (cross, intra) axes (at ws 2 the cross
    level has one rank, and both packages reduce over the intra level
    alone)."""
    from jax.sharding import Mesh

    ws, trees, _, results = world
    for k, v in TREE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    mesh = Mesh(np.asarray(jax.devices()[:ws]).reshape(ws // 2, 2), ("cross", "intra"))
    want = _jax_tree(trees, mesh, ("cross", "intra"), ("cross", "intra"))
    for r in range(ws):
        for path, (got, dtype) in results[r]["two_level"].items():
            assert dtype == f"torch.{TREE_LEAVES[path][1]}"
            np.testing.assert_array_equal(got.view(np.uint32), want[path][r].view(np.uint32),
                                          err_msg=f"rank {r} {path}")


def test_bf16_constant_exact(world):
    """The JAX package's ``test_bf16_constant_exact`` at this world size:
    rank r's bf16 buffer full of r + 1, SRA-reduced, is exactly the sum on
    every rank, as the JAX package's on the CPU mesh."""
    from jax.sharding import PartitionSpec as P

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.parallel import reducers as jreducers
    from torch_cgx_tpu.utils.compat import shard_map

    ws, _, const, results = world
    body = shard_map(lambda x: jreducers.sra_allreduce(x[0], "dp", ws, JCC(bits=4, bucket_size=512))[None],
                     mesh=_flat_mesh(ws), in_specs=P("dp"), out_specs=P("dp"), check_vma=False)
    want = np.asarray(jax.jit(body)(jnp.asarray(const).astype(jnp.bfloat16))).astype(np.float32)
    expect = np.full((1024,), ws * (ws + 1) // 2, np.float32)
    for r in range(ws):
        got, dtype = results[r]["const"]
        assert dtype == "torch.bfloat16"
        np.testing.assert_array_equal(got, expect)
        np.testing.assert_array_equal(want[r], expect)


def test_mixed_tree_world_size_one_proxy_matches_jax(monkeypatch):
    """The world-size-1 proxy (``CGX_DEBUG_FORCE_CODEC=1``: quantize, the
    fused epilogue at one row rounding through the wire dtype, decode) over
    the mixed tree: bit-identical to the JAX package's on a one-device
    mesh, in both epilogue lowerings."""
    from torch_cgx_tpu_torch.parallel import allreduce

    for k, v in {**TREE_ENV, "CGX_DEBUG_FORCE_CODEC": "1"}.items():
        monkeypatch.setenv(k, v)
    trees, _ = _tree_inputs(1)
    want = _jax_tree(trees, _flat_mesh(1), ("dp",), ("dp",))
    for mode in ("staged", "fused"):
        monkeypatch.setenv("CGX_SRA_EPILOGUE", mode)
        got = allreduce.allreduce_tree(_torch_tree(trees[0]))
        for path, v in got.items():
            assert v.dtype == getattr(torch, TREE_LEAVES[path][1])
            np.testing.assert_array_equal(_f32(v), want[path][0].view(np.uint32),
                                          err_msg=f"{mode} {path}")
