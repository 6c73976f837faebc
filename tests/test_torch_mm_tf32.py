"""The matmul-quantize's (B8) float32 route on the tensor cores, on the CPU.

On the card every float32 operand pair goes to split TF32: a pass
(``cgx_tf32_split_kernel``) writes the K-major planes ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` of both operands' transposes, and
``cgx_matmul_quantize_tf32_kernel`` sums ``lo hi + hi lo + hi hi`` on the
tensor cores (``lo lo`` dropped). Here, with numpy-seeded data:

* ``tf32_round_plain`` against an independent rounding in float64 (to
  nearest, ties away from zero, 10 mantissa bits) over normal, tiny, huge,
  integer and tie data; the split's ``hi`` and ``lo`` with their 13 low
  bits zero, ``hi + lo`` within ``2^-22 |x|`` of ``x``, ``lo`` 0 on
  integers below ``2^11``;
* the split pass's plain version: planes of the transposes, K padded with
  zeros to a multiple of the ring stage, and no launch on the CPU;
* the three-product scheme's payload (``matmul_quantize_chunks_tf32_plain``)
  against the JAX kernel in interpret mode: bit-identical on integer
  operands, within ``chip_smoke.payload_close``'s tolerance on normal ones,
  and the same against the port's plain version;
* the route: float32 takes the tensor cores unless ``_route="ffma"``, and
  on CPU tensors every route runs the plain version.

The kernels run in ``tests/test_torch_kernels.py`` and ``chip_smoke.py`` on
the card.
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.ops import codec_cuda

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def _data(kind: str, n: int, seed: int) -> np.ndarray:
    """float32 data of a kind: normal, tiny (normal floats near 2^-100),
    huge (near 2^100), integer (below 2^11 in magnitude) or ties (values
    halfway between two TF32 neighbours, and their neighbours)."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.standard_normal(n)
    elif kind == "tiny":
        x = rng.standard_normal(n) * 2.0**-100
    elif kind == "huge":
        x = rng.standard_normal(n) * 2.0**100
    elif kind == "integer":
        x = rng.integers(-2047, 2048, n)
    else:
        base = rng.integers(1 << 10, 1 << 11, n).astype(np.float64)  # 11 significant bits
        x = (base + 0.5) * np.exp2(rng.integers(-20, 20, n)) * rng.choice([-1, 1], n)
        x = np.concatenate([x, np.nextafter(x.astype(np.float32), np.float32(np.inf))])
    return np.asarray(x, dtype=np.float32)


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 ``x`` to 11 significant bits (10 stored), to nearest,
    ties away from zero, in float64: the unit in the last place is 2^(e -
    11) for ``x = m 2^e``, ``m`` in [0.5, 1)."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)
    ulp = np.exp2(np.maximum(e, -125) - 11.0)
    q = x64 / ulp
    r = np.sign(q) * np.floor(np.abs(q) + 0.5) * ulp
    with np.errstate(over="ignore"):
        return r.astype(np.float32)


KINDS = ["normal", "tiny", "huge", "integer", "ties"]


@pytest.mark.parametrize("kind", KINDS)
def test_tf32_round_against_float64_reference(kind):
    x = _data(kind, 4096, KINDS.index(kind))
    got = codec_cuda.tf32_round_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _tf32_reference(x).view(np.uint32))


def test_tf32_round_specials():
    """Infinities and NaN stay as they are, zeros keep their sign, and the
    largest float32 rounds up to infinity (past TF32's largest)."""
    x = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, np.finfo(np.float32).max], dtype=np.float32)
    got = codec_cuda.tf32_round_plain(torch.from_numpy(x)).numpy()
    assert got[0] == np.inf and got[1] == -np.inf and np.isnan(got[2])
    assert got.view(np.uint32)[3] == 0 and got.view(np.uint32)[4] == 0x80000000
    assert got[5] == np.inf


@pytest.mark.parametrize("kind", KINDS)
def test_split_reconstructs_x(kind):
    """``hi`` and ``lo`` have their 13 low bits zero; ``hi + lo`` is ``x``
    within ``2^-22 |x|``; an integer below 2^11 has ``lo = 0``."""
    x = torch.from_numpy(_data(kind, 4096, 10 + KINDS.index(kind)))
    hi, lo = codec_cuda.tf32_split_plain(x)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all()), float((err / x.double().abs()).max())
    if kind == "integer":
        assert torch.equal(hi, x) and not lo.any()


@pytest.mark.parametrize("k,din,o", [(64, 96, 128), (33, 13, 4), (100, 40, 200), (1, 3, 8)])
def test_split_transpose_plain(k, din, o):
    """The planes ``[hi, lo]`` of ``x2^T`` and ``g2^T``, K padded with zeros
    to a multiple of ``MM_TF32_BK``; on CPU tensors the wrapper runs the
    plain version and counts no launch."""
    rng = np.random.default_rng(k * din + o)
    x2 = torch.from_numpy(rng.standard_normal((k, din)).astype(np.float32))
    g2 = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32))
    kp = -(-k // codec_cuda.MM_TF32_BK) * codec_cuda.MM_TF32_BK
    codec_cuda.reset_launch_counts()
    xs, gs = codec_cuda.tf32_split_transpose(x2, g2)
    assert codec_cuda.LAUNCHES["codec_tf32_split"] == 0
    for planes, t in ((xs, x2), (gs, g2)):
        assert planes.shape == (2, t.shape[1], kp) and planes.dtype == torch.float32
        hi, lo = codec_cuda.tf32_split_plain(t.t().contiguous())
        assert torch.equal(planes[0, :, :k], hi) and torch.equal(planes[1, :, :k], lo)
        assert not planes[:, :, k:].any()
    pxs, pgs = codec_cuda.tf32_split_transpose_plain(x2, g2)
    assert torch.equal(xs, pxs) and torch.equal(gs, pgs)


def _operands(seed, k, din, o, integer):
    rng = np.random.default_rng(seed)
    if integer:
        x, g = rng.integers(-3, 4, (k, din)), rng.integers(-3, 4, (k, o))
    else:
        x, g = rng.standard_normal((k, din)), rng.standard_normal((k, o))
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("bits,bucket,div", [(2, 128, 2), (4, 128, 4), (8, 256, 1)])
def test_three_products_match_jax_kernel(bits, bucket, div, integer):
    """The split-TF32 scheme's payload against the JAX kernel on float32
    operands (interpret mode, as the JAX package's tests run it):
    bit-identical on integer operands (``lo`` is 0 and every partial sum
    exact), within ``payload_close``'s tolerance on normal ones (meta within
    1e-5 relative, decoded within one level step); the raw own row equal
    to the plain version's on integers, within 1e-5 of its largest
    magnitude on normal operands."""
    import jax.numpy as jnp

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.ops import fused_producer as jfp

    k, din, o, ws = 64, 256, 512, 2
    x2, g2 = _operands(bits * bucket + div + integer, k, din, o, integer)
    cc = JCC(bits=bits, bucket_size=bucket)
    chunk = din * o // ws
    tm, tk = jfp._kernel_geometry(k, din, o, ws, chunk, cc)
    q = jfp._matmul_quantize_q(jnp.asarray(x2.numpy()), jnp.asarray(g2.numpy()), cc, ws=ws,
                               chunk=chunk, div=div, tm=tm, tk=tk, interpret=True)
    jw = torch.from_numpy(np.asarray(q.packed).reshape(-1).view(np.int32).copy())
    jm = torch.from_numpy(np.asarray(q.meta).reshape(-1, 2).copy())
    w, m, raw = codec_cuda.matmul_quantize_chunks_tf32_plain(x2, g2, div, bits, bucket, own_row=(1, ws))
    pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(x2, g2, div, bits, bucket, own_row=(1, ws))
    if integer:
        for a, b in ((w, jw), (m, jm), (w, pw), (m, pm), (raw, praw)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        return
    for want_w, want_m in ((jw, jm), (pw, pm)):
        ok, meta_rel, _, steps = chip_smoke.payload_close(w, m, want_w, want_m, bits, bucket)
        assert ok, (meta_rel, steps)
    assert float((raw - praw).abs().max()) <= chip_smoke.RAW_RTOL * float(praw.abs().max())


@pytest.mark.parametrize("din,o,x_off", [(64, 512, 0), (100, 4096, 0), (13, 4, 0), (64, 448, 1)])
def test_float32_route_and_cpu_plain(din, o, x_off):
    """float32 operands take the tensor cores at any width and alignment
    (``_route="ffma"`` forces the FFMA kernel); on CPU tensors every route
    returns the plain version's bytes, and no launch is counted."""
    buf = torch.from_numpy(np.random.default_rng(din + o).integers(-3, 4, 24 * din + x_off)
                           .astype(np.float32))
    x2 = buf[x_off:].view(24, din)
    g2 = torch.from_numpy(np.random.default_rng(o).integers(-3, 4, (24, o)).astype(np.float32))
    assert codec_cuda.mm_tc_eligible(x2, g2)
    assert codec_cuda._mm_route(x2, g2, None) == "tc"
    assert codec_cuda._mm_route(x2, g2, "ffma") == "ffma"
    bucket = 128 if din * o % (32 * 128) == 0 else None
    if bucket is None:  # not whole chunks: the wrapper's geometry check refuses it alike
        with pytest.raises(ValueError):
            codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 128)
        return
    codec_cuda.reset_launch_counts()
    want = codec_cuda.matmul_quantize_chunks_plain(x2, g2, 2, 4, bucket, own_row=(0, 2))
    for route in (None, "ffma"):
        got = codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, bucket, own_row=(0, 2), _route=route)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == codec_cuda.LAUNCHES["codec_tf32_split"] == 0
    assert codec_cuda.MM_TC_LAUNCHES["launches"] == 0


def test_mmtc_split_variants_cut_the_shared_body():
    """``tools/mmtc_split.py`` cuts the chunk quantize (and the stores) out
    of the body both tensor-core kernels share, and leaves the rest of the
    source, the split pass and both kernels' entry points, as it is."""
    from torch_cgx_tpu_torch.tools import mmtc_split

    source = codec_cuda.SOURCE.read_text()
    v = mmtc_split.variants(source)
    assert v["full"] == source
    assert "c < 0 * chunks" in v["no_quantize"] and "c < 0 * chunks" in v["mainloop"]
    assert "k_total < 0) {" in v["mainloop"] and "k_total < 0) {" not in v["no_quantize"]
    for text in v.values():
        for name in ("cgx_tf32_split_kernel", "cgx_matmul_quantize_tf32_kernel",
                     "cgx_matmul_quantize_tc_kernel", "int cgx_matmul_quantize_tf32(",
                     "int cgx_tf32_split("):
            assert name in text
    assert set(mmtc_split.ROUTES) == {"bfloat16", "float32"}


def test_tf32_accuracy_tool_finds_its_knob():
    """``tools/tf32_accuracy.py`` rebuilds the split-TF32 kernel at other
    partial lengths by substituting one line of the source: the line is
    there once, at the default the kernel ships with."""
    from torch_cgx_tpu_torch.tools import tf32_accuracy

    source = codec_cuda.SOURCE.read_text()
    line = tf32_accuracy._PARTIAL.format(tf32_accuracy._DEFAULT)
    assert source.count(line) == 1
    assert source.count("kTf32PartialSteps") >= 3  # the constant and its uses in the kernel


def test_payload_close_bounds_the_decode_rounding():
    """``chip_smoke.payload_close`` holds two payloads of nearly equal
    values to one level step, plus what the meta's difference moves a
    value, plus the float32 roundings of each decode (``min + unit *
    level``: the product's as well as the sum's). Values 1e-7 relative
    apart pass at 8 bits (this seed flips one level of a value near 0,
    where the decode's product rounds at the scale of the bucket's min,
    not of the value); a value moved by three level steps fails."""
    rng = np.random.default_rng(6)
    v = (rng.standard_normal(768 * 3072) * 8).astype(np.float32)
    p = np.where(rng.random(v.size) < 0.3, v * (1 + rng.standard_normal(v.size) * 1e-7), v)
    want = codec_cuda.quantize_chunks_plain(torch.from_numpy(v), 8, 512)
    got = codec_cuda.quantize_chunks_plain(torch.from_numpy(p.astype(np.float32)), 8, 512)
    ok, _, _, steps = chip_smoke.payload_close(*got, *want, 8, 512)
    assert ok and 1.0 < steps < 1.0001, steps
    i = int(np.argmin(np.abs(v[:512])))  # bucket 0's value nearest 0
    moved = v.copy()
    moved[i] += 3 * float(want[1][0, 0])
    got = codec_cuda.quantize_chunks_plain(torch.from_numpy(moved), 8, 512)
    assert not chip_smoke.payload_close(*got, *want, 8, 512)[0]
