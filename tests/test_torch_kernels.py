"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports only torch, numpy and the port, so it runs on a machine without
JAX; there, skip the suite's JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

``chip_smoke.py`` makes the same comparisons at the GPT-2 slice's shapes.
The tolerance is 0 throughout: words, meta and decoded values are compared
bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
from torch_cgx_tpu_torch.ops import autotune, codec, codec_cuda, dispatch
from torch_cgx_tpu_torch.parallel import gradient_sync, make_train_step
from torch_cgx_tpu_torch.tools import qbench, shapebench

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    # An empty autotune cache: CGX_PALLAS_DB=auto runs the single-stage kernels.
    monkeypatch.setenv("CGX_AUTOTUNE_DIR", str(tmp_path))
    monkeypatch.delenv("CGX_PALLAS_DB", raising=False)
    autotune.invalidate("card test")
    return torch.device("cuda", 0)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


@pytest.mark.parametrize("bits,bucket,n", [
    (1, 512, 2 * 32 * 512), (4, 512, 32 * 512 + 26 * 512 + 100), (8, 1024, 3 * 32 * 1024),
    (3, 96, 32 * 96 * 2 + 5 * 96 + 7), (6, 32, 32 * 32 * 4), (2, 128, 100),
])
def test_quantize_dequantize_match_plain(dev, bits, bucket, n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    acc = torch.from_numpy(np.random.default_rng(n + 1).standard_normal(n).astype(np.float32))
    q = codec_cuda.quantize_batch(x.to(dev)[None], bits, bucket)
    want = codec.quantize(x, bits, bucket)
    assert _bits_equal(q.packed[0], want.packed)
    assert _bits_equal(q.meta[0], want.meta)
    assert _bits_equal(codec_cuda.dequantize_batch(q)[0], codec.dequantize(want))
    got = codec_cuda.dequantize_batch(q, add_to=acc.to(dev)[None])[0]
    assert _bits_equal(got, codec.dequantize(want, add_to=acc))


@pytest.mark.parametrize("ws", [1, 3, 4])
def test_epilogue_matches_plain(dev, ws):
    bits, bucket = 4, 512
    rows = torch.from_numpy(
        np.random.default_rng(ws).standard_normal((ws, 2 * 32 * bucket)).astype(np.float32)
    )
    q_cpu = codec_cuda.quantize_batch(rows, bits, bucket)
    q = codec_cuda.quantize_batch(rows.to(dev), bits, bucket)
    assert codec_cuda.supports_reduce(q)
    for own in [None] + list(range(ws)):
        raw = None if own is None else rows[own]
        got = codec_cuda.sra_epilogue_batch(
            q, raw_row=None if raw is None else raw.to(dev), own_idx=own
        )
        w, m = codec_cuda.sra_epilogue_chunks_plain(
            q_cpu.packed, q_cpu.meta, raw, -1 if own is None else own, bits, bucket
        )
        assert _bits_equal(got.packed[0], w), own
        assert _bits_equal(got.meta[0], m), own


def test_launch_counter_counts_only_kernel_launches(dev):
    x = torch.randn(32 * 512 + 300)
    codec_cuda.reset_launch_counts()
    codec_cuda.quantize_batch(x[None], 4, 512)  # CPU: the plain version
    assert codec_cuda.LAUNCHES["codec_quantize"] == 0
    q = codec_cuda.quantize_batch(x.to(dev)[None], 4, 512)
    codec_cuda.dequantize_batch(q)
    torch.cuda.synchronize()
    x2 = torch.randint(-3, 4, (64, 128)).float()
    g2 = torch.randint(-3, 4, (64, 256)).float()
    codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 512)  # CPU: the plain version
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 0
    codec_cuda.matmul_quantize_chunks(x2.to(dev), g2.to(dev), 2, 4, 512)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES == {
        "codec_quantize": 1, "codec_dequantize": 1, "codec_sra_epilogue": 0,
        "codec_reduce_rows": 0, "codec_matmul_quantize": 1, "codec_quantize_db": 0,
        "codec_dequantize_db": 0, "codec_sra_epilogue_db": 0, "codec_quantize_variant": 0,
        "codec_tf32_split": 1,  # float32 operands: the split pass before the tensor cores
    }


def test_cuda_operands_refuse_unported_modes(dev, monkeypatch):
    """A bf16 buffer runs the kernel (the 16-bit wire dtypes are ported),
    bit-identical to its plain version, the meta in bf16; the int8 fold
    runs B4's int8 instance on the card, bit-identical to its plain
    version and counted in INT8_LAUNCHES; the mul encode runs the kernel's
    mul lowering, bit-identical to its plain version."""
    x = torch.randn(32 * 512, device=dev)
    codec_cuda.reset_launch_counts()
    q = codec_cuda.quantize_batch(x.to(torch.bfloat16)[None], 4, 512)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_quantize"] == 1 and q.meta.dtype == torch.bfloat16
    w, m = codec_cuda.quantize_chunks_plain(x.cpu().to(torch.bfloat16), 4, 512)
    assert _bits_equal(q.packed[0], w) and _bits_equal(q.meta[0], m.to(torch.bfloat16))
    monkeypatch.setenv("CGX_SRA_ACCUM", "int8")
    q2 = codec_cuda.quantize_batch(torch.stack([x, 2 * x]), 4, 512)
    got = codec_cuda.reduce_rows_batch(q2)
    torch.cuda.synchronize()
    assert codec_cuda.INT8_LAUNCHES["codec_reduce_rows"] == 1
    want = codec_cuda.reduce_rows_chunks_plain(q2.packed.cpu(), q2.meta.cpu(), None, -1, 4, 512)
    assert _bits_equal(got, want)
    monkeypatch.delenv("CGX_SRA_ACCUM")
    monkeypatch.setenv("CGX_CODEC_ENCODE", "mul")
    q = codec_cuda.quantize_batch(x[None], 4, 512)
    w, m = codec_cuda.quantize_chunks_plain(x.cpu(), 4, 512, encode="mul")
    assert _bits_equal(q.packed[0], w) and _bits_equal(q.meta[0], m)


def test_tiny_train_step_runs_the_kernels(dev, monkeypatch):
    """GPT-2 tiny on the card with the compressed sync: finite losses, every
    kernel launched, and one gradient sync bit-identical to the same sync of
    the same gradients through the plain versions on the CPU."""
    for k, v in {
        "CGX_DEBUG_FORCE_CODEC": "1", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
        "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "40000",
        "CGX_SRA_EPILOGUE_MIN_ELEMS": "0",
    }.items():
        monkeypatch.setenv(k, v)
    cfg = GPT2Config.tiny()
    model = GPT2(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    lm_loss(model(tokens.to(dev)), tokens.to(dev)).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    synced = gradient_sync(grads)
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    plain = gradient_sync({k: v.cpu() for k, v in grads.items()})
    monkeypatch.delenv("CGX_SRA_EPILOGUE")
    for k in grads:
        assert _bits_equal(synced[k], plain[k]), k
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device=dev)
    codec_cuda.reset_launch_counts()
    losses = [float(step(tokens)) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(np.isfinite(losses)), losses
    # World size 1 reduces no rows: the multi-row reduce stays idle.
    launched = {k: v > 0 for k, v in codec_cuda.LAUNCHES.items()}
    assert launched == {
        "codec_quantize": True, "codec_dequantize": True, "codec_sra_epilogue": True,
        "codec_reduce_rows": False, "codec_matmul_quantize": False,
        "codec_quantize_db": False, "codec_dequantize_db": False, "codec_sra_epilogue_db": False,
        "codec_quantize_variant": False, "codec_tf32_split": False,
    }, codec_cuda.LAUNCHES


# B4 at phase 7's launch shapes (shapebench.REDUCE_SHAPES): the two-level
# intra reduce (2 rows, the raw own row) and the all-to-all (4 rows).
REDUCE_STEP_CASES = [(rows, c * 32 * 512, 4, 512, [None, 0, 1] if own >= 0 else [None, 2])
                     for _, _, c, rows, own in shapebench.REDUCE_SHAPES]


@pytest.mark.parametrize("rows,n,bits,bucket,owns", [
    (2, 8_388_608, 4, 512, [None, 0, 1]),  # the two-level intra reduce-scatter
    (4, 16_777_216, 4, 512, [None]),  # the all-to-all
    (4, 4 * 32 * 128, 1, 128, [None, 0, 1, 2, 3]),
    (3, 2 * 32 * 512, 8, 512, [2]),
    (2, 3 * 32 * 2048, 4, 2048, [None, 1]),  # beyond the epilogue's tile
] + REDUCE_STEP_CASES)
def test_reduce_rows_matches_plain(dev, rows, n, bits, bucket, owns):
    """B4 bit for bit against its plain version on the CPU, one launch a
    call, at full width (every operand 16-byte aligned)."""
    x = torch.from_numpy(
        np.random.default_rng(n + rows).standard_normal((rows, n)).astype(np.float32)
        * np.arange(1, rows + 1, dtype=np.float32)[:, None]
    ).to(dev)
    q = codec_cuda.quantize_batch(x, bits, bucket)
    assert codec_cuda.supports_reduce(q)
    for own in owns:
        raw = None if own is None else x[own]
        codec_cuda.reset_launch_counts()
        got = codec_cuda.reduce_rows_batch(q, raw_row=raw, own_idx=own)
        torch.cuda.synchronize()
        assert codec_cuda.LAUNCHES["codec_reduce_rows"] == 1
        assert codec_cuda.REDUCE_SCALAR["launches"] == 0
        want = codec_cuda.reduce_rows_chunks_plain(
            q.packed.cpu(), q.meta.cpu(), None if raw is None else raw.cpu(),
            -1 if own is None else own, bits, bucket,
        )
        assert _bits_equal(got, want), own


def _reduce_operands(dev, rows: int, chunks: int, bits: int, bucket: int, seed: int):
    """Stage-1 rows of whole chunks (normal data, each row scaled
    differently) on the card and their payload."""
    n = chunks * 32 * bucket
    x = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((rows, n)).astype(np.float32)
        * np.arange(1, rows + 1, dtype=np.float32)[:, None]
    ).to(dev)
    q = codec_cuda.quantize_batch(x, bits, bucket)
    return x, q.packed.contiguous(), q.meta.contiguous()


def _reduce_both_widths(words, meta, raw, own, bits, bucket):
    """B4 at full width through the wrapper and forced to scalar width."""
    got = codec_cuda.reduce_rows_chunks(words, meta, raw, own, bits, bucket)
    out = torch.empty_like(got)
    scalar = codec_cuda._launch_reduce(words, meta, raw, own, bits, bucket, out, 1)
    return got, scalar


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 11])
def test_reduce_rows_every_row_count_and_width(dev, rows, bits):
    """B4 at each templated row count (1-8) and a generic one above (11: a
    stage of 8 rows, then 3), at every width, the raw own row in every
    position and none, at both widths: bit for bit the plain version's."""
    x, words, meta = _reduce_operands(dev, rows, 3, bits, 128, 100 * rows + bits)
    for own in [None] + list(range(rows)):
        raw, o = (None, -1) if own is None else (x[own], own)
        got, scalar = _reduce_both_widths(words, meta, raw, o, bits, 128)
        want = codec_cuda.reduce_rows_chunks_plain(words, meta, raw, o, bits, 128)
        assert _bits_equal(got, want) and _bits_equal(scalar, want), own


@pytest.mark.parametrize("chunks", [1, 3, 54])
@pytest.mark.parametrize("bucket", [128, 640, 2048, 16384])
def test_reduce_rows_buckets_and_chunk_counts(dev, bucket, chunks):
    """B4 at buckets 128 to 16,384 (blocks of one to 128 a chunk; 640: five)
    and 1, 3 and 54 chunks, at both widths."""
    x, words, meta = _reduce_operands(dev, 3, chunks, 4, bucket, bucket + chunks)
    for own in (None, 0, 2):
        raw, o = (None, -1) if own is None else (x[own], own)
        got, scalar = _reduce_both_widths(words, meta, raw, o, 4, bucket)
        want = codec_cuda.reduce_rows_chunks_plain(words, meta, raw, o, 4, bucket)
        assert _bits_equal(got, want) and _bits_equal(scalar, want), own


@pytest.mark.parametrize("rows,own", [(1, 0), (2, 0), (2, 1), (4, 3), (11, 9)])
def test_reduce_rows_unaligned_operands_take_the_scalar_width(dev, rows, own):
    """A raw row view 4 bytes past a 16-byte boundary, and words likewise,
    launch the scalar-width kernel (counted in REDUCE_SCALAR), bit for bit
    the plain version's; the full-width instantiation refuses them."""
    x, words, meta = _reduce_operands(dev, rows, 3, 4, 512, rows + own)
    buf = torch.empty(x.shape[1] + 1, device=dev)
    buf[1:] = x[own]
    raw = buf[1:]
    assert raw.data_ptr() % 16 == 4
    want = codec_cuda.reduce_rows_chunks_plain(words, meta, raw, own, 4, 512)
    codec_cuda.reset_launch_counts()
    got = codec_cuda.reduce_rows_batch(
        codec.QTensor(packed=words, meta=meta, residual=torch.zeros((rows, 0), device=dev),
                      numel=x.shape[1], bits=4, bucket_size=512, dtype=torch.float32),
        raw_row=raw, own_idx=own)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_reduce_rows"] == 1
    assert codec_cuda.REDUCE_SCALAR["launches"] == 1
    assert _bits_equal(got, want)
    wbuf = torch.empty(words.numel() + 1, dtype=torch.int32, device=dev)
    wbuf[1:] = words.reshape(-1)
    odd_words = wbuf[1:].view(rows, -1)
    codec_cuda.reset_launch_counts()
    assert _bits_equal(codec_cuda.reduce_rows_chunks(odd_words, meta, x[own], own, 4, 512), want)
    assert codec_cuda.REDUCE_SCALAR["launches"] == 1
    out = torch.empty_like(want)
    with pytest.raises(RuntimeError, match="codec_reduce_rows"):
        codec_cuda._launch_reduce(words, meta, raw, own, 4, 512, out, 4)


@pytest.mark.parametrize("rows,owns", [(1, [0]), (2, [None, 0, 1]), (4, [None, 1, 3]), (9, [None, 8])])
def test_reduce_rows_special_values(dev, rows, owns):
    """NaN, +-inf, +-0 and subnormals in the raw row and in the rows behind
    the payloads (NaN and inf metas), at both widths: bit for bit the plain
    version run on the card's tensors (NaN arithmetic as the card does it)."""
    n = 3 * 32 * 512
    x = torch.from_numpy(np.stack([_specials(n, 512, 7 * r + rows) * np.float32(r + 1)
                                   for r in range(rows)])).to(dev)
    q = codec_cuda.quantize_batch(x, 4, 512)
    for own in owns:
        raw, o = (None, -1) if own is None else (x[own], own)
        got, scalar = _reduce_both_widths(q.packed, q.meta, raw, o, 4, 512)
        want = codec_cuda.reduce_rows_chunks_plain(q.packed, q.meta, raw, o, 4, 512)
        assert _bits_equal(got, want) and _bits_equal(scalar, want), own


def test_reduce_rows_dispatch_tail_geometry(dev, monkeypatch):
    """A chunk with a tail takes the staged decode and sum on the card (the
    decode kernel); a whole-chunk one the fused reduce. Both agree with the
    plain path on the CPU bit for bit."""
    monkeypatch.setenv("CGX_SRA_EPILOGUE_MIN_ELEMS", "0")
    cc = CompressionConfig(bits=4, bucket_size=512)
    for n, fused in ((2 * 32 * 512, True), (32 * 512 + 26 * 512 + 100, False)):
        x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, n)).astype(np.float32))
        q_cpu = dispatch.quantize_batch(x, cc)
        q = dispatch.quantize_batch(x.to(dev), cc)
        assert dispatch.fused_reduce_would_run(q) == fused
        codec_cuda.reset_launch_counts()
        got = dispatch.reduce_rows(q, raw_rows=x.to(dev), own_idx=1)
        torch.cuda.synchronize()
        assert codec_cuda.LAUNCHES["codec_reduce_rows"] == int(fused)
        want = dispatch.reduce_rows(q_cpu, raw_rows=x, own_idx=1)
        assert _bits_equal(got, want), n


@pytest.mark.parametrize("k,din,o,div,bits,bucket", [
    (64, 256, 512, 2, 4, 512),  # small
    (1024, 768, 3072, 4, 4, 512),  # GPT-2 124M mlp_in, 2 x 512 tokens
    (96, 128, 384, 3, 2, 128),  # chunks that cross rows of dw
    (40, 64, 1792, 2, 8, 1792),  # a tile that leaves no room to stage operands
])
def test_matmul_quantize_matches_plain_on_integers(dev, k, din, o, div, bits, bucket):
    """Small-integer operands make every sum exact in float32, so the
    kernel's and cuBLAS's summation orders agree: bytes bit-identical."""
    rng = np.random.default_rng(k + din + o)
    x2 = torch.from_numpy(rng.integers(-3, 4, (k, din)).astype(np.float32)).to(dev)
    g2 = torch.from_numpy(rng.integers(-3, 4, (k, o)).astype(np.float32)).to(dev)
    w, m = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket)
    pw, pm = codec_cuda.matmul_quantize_chunks_plain(x2.cpu(), g2.cpu(), div, bits, bucket)
    assert _bits_equal(w, pw)
    assert _bits_equal(m, pm)


def test_produce_q_on_cuda_launches_the_kernel(dev, monkeypatch):
    """An engaged dense backward on the card with aligned geometry takes the
    matmul-quantize kernel, and its payload decodes
    within one level step of a quantize of the returned gradient."""
    from torch_cgx_tpu_torch.models import Dense
    from torch_cgx_tpu_torch.ops import fused_producer as fp

    for k, v in {"CGX_PRODUCER_FUSE": "on", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
                 "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "32768"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(fp, "_CFG", dict(fp._CFG))
    fp.configure(None, divisor=2, active=True)
    fp._CFG.update(ws=2, rank=1)  # one process standing in for rank 1 of 2
    fp.begin_step()
    fp.reset_counts()
    layer = Dense(256, 512, dtype=torch.float32, generator=torch.Generator().manual_seed(0)).to(dev)
    layer.kernel_path = "big.kernel"
    x = torch.randn(4, 32, 256, device=dev)
    codec_cuda.reset_launch_counts()
    layer(x).square().sum().backward()
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 1
    assert fp.COUNTS["producer_kernel_slices"] == 1
    assert fp.COUNTS["producer_fallbacks"] == 0
    ent = fp.lookup("big.kernel", layer.kernel.grad)
    assert ent is not None
    want = dispatch.quantize_batch((layer.kernel.grad.reshape(-1) / 2).view(2, -1),
                                   CompressionConfig(bits=4, bucket_size=128))
    unit = want.meta[..., 0].reshape(-1, 1)
    got_v = codec_cuda.dequantize_batch(ent.q).reshape(-1, 128)
    want_v = codec_cuda.dequantize_batch(want).reshape(-1, 128)
    assert bool(((got_v - want_v).abs() <= 1.001 * unit + 1e-6).all())
    # The raw own row comes from the kernel's sums, as the quantized rows:
    # equal to a second launch's, within f32 summation order of p.grad's row.
    x2 = x.reshape(-1, 256)
    g2 = (2 * layer(x)).detach().reshape(-1, 512)  # d(y^2)/dy
    _, _, raw = codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 128, own_row=(1, 2))
    assert _bits_equal(ent.raw_row, raw)
    want_row = layer.kernel.grad.reshape(2, -1)[1] / 2
    assert float((ent.raw_row - want_row).abs().max()) <= 1e-5 * float(want_row.abs().max())
    fp.deconfigure()


# (K, din, o, divisor, bits, bucket): the 64 x 128 tiles of dw and the
# 32-bucket chunks end at different places (o not a multiple of 128, din
# not a multiple of 64 or of 4, K not a multiple of the 16-step stage).
MM_EDGES = [
    (96, 64, 448, 2, 1, 128), (77, 256, 1344, 4, 8, 512), (130, 128, 672, 4, 4, 896),
    (50, 100, 4096, 4, 1, 128), (33, 13, 4096, 2, 3, 128), (64, 256, 512, 2, 4, 512),
    (40, 768, 2304, 4, 4, 512),  # attn_qkv's layer
]


@pytest.mark.parametrize("k,din,o,div,bits,bucket", MM_EDGES)
def test_matmul_quantize_edges_and_own_row(dev, k, din, o, div, bits, bucket):
    """Words, meta and the own raw row (each row position) bit-identical to
    the plain version on small-integer operands, one launch a call."""
    rng = np.random.default_rng(k * din + o)
    x2 = torch.from_numpy(rng.integers(-3, 4, (k, din)).astype(np.float32)).to(dev)
    g2 = torch.from_numpy(rng.integers(-3, 4, (k, o)).astype(np.float32)).to(dev)
    ws = 4 if din % 4 == 0 else 1
    codec_cuda.reset_launch_counts()
    for own in range(ws):
        w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket, own_row=(own, ws))
        pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(
            x2.cpu(), g2.cpu(), div, bits, bucket, own_row=(own, ws))
        assert _bits_equal(w, pw) and _bits_equal(m, pm), own
        assert raw.shape == (din * o // ws,) and _bits_equal(raw, praw), own
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == ws
    # float32 operands of every shape take the tensor cores, after the split pass.
    assert codec_cuda.MM_TC_LAUNCHES["launches"] == codec_cuda.LAUNCHES["codec_tf32_split"] == ws


@pytest.mark.parametrize("k,din,o,div,bits,bucket", MM_EDGES)
def test_matmul_quantize_ffma_edges_and_own_row(dev, k, din, o, div, bits, bucket):
    """The FFMA kernel, forced (``_route="ffma"``), keeps its anchor:
    words, meta and the own raw row bit-identical to the plain version on
    small-integer operands, no split pass and no tensor-core launch."""
    rng = np.random.default_rng(k * din + o + 1)
    x2 = torch.from_numpy(rng.integers(-3, 4, (k, din)).astype(np.float32)).to(dev)
    g2 = torch.from_numpy(rng.integers(-3, 4, (k, o)).astype(np.float32)).to(dev)
    ws = 4 if din % 4 == 0 else 1
    codec_cuda.reset_launch_counts()
    for own in range(ws):
        w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket, own_row=(own, ws),
                                                      _route="ffma")
        pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(
            x2.cpu(), g2.cpu(), div, bits, bucket, own_row=(own, ws))
        assert _bits_equal(w, pw) and _bits_equal(m, pm) and _bits_equal(raw, praw), own
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == ws
    assert codec_cuda.MM_TC_LAUNCHES["launches"] == codec_cuda.LAUNCHES["codec_tf32_split"] == 0


def test_matmul_quantize_back_to_back_launches_repeat_their_bytes(dev):
    """Launches of several geometries, back to back on one stream, each on
    arrival counters of its own: every repeat gives the first launch's
    bytes, one launch a call."""
    rng = np.random.default_rng(5)
    ops = []
    for k, din, o, div, bits, bucket in MM_EDGES[:3]:
        x2 = torch.from_numpy(rng.standard_normal((k, din)).astype(np.float32)).to(dev)
        g2 = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32)).to(dev)
        ops.append((x2, g2, div, bits, bucket))
    codec_cuda.reset_launch_counts()
    first = [codec_cuda.matmul_quantize_chunks(*a) for a in ops]
    for _ in range(3):
        for a, (w0, m0) in zip(ops, first):
            w, m = codec_cuda.matmul_quantize_chunks(*a)
            assert _bits_equal(w, w0) and _bits_equal(m, m0)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 4 * len(ops)


def test_skipped_backward_on_cuda_launches_one_kernel(dev, monkeypatch):
    """Configured as ``make_train_step`` does (``skip_dw``), an engaged CUDA
    layer returns no weight gradient: one matmul-quantize launch makes its
    payload and raw own row, and no plain product runs."""
    from torch_cgx_tpu_torch.models import Dense
    from torch_cgx_tpu_torch.ops import fused_producer as fp

    for k, v in {"CGX_PRODUCER_FUSE": "on", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
                 "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "32768"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(fp, "_CFG", dict(fp._CFG))
    fp.configure(None, divisor=2, active=True, skip_dw=True)
    fp._CFG.update(ws=2, rank=0)
    fp.begin_step()
    fp.reset_counts()
    seen = []
    real = fp._plain_dw
    monkeypatch.setattr(fp, "_plain_dw", lambda name, *a: seen.append(name) or real(name, *a))
    layer = Dense(256, 512, dtype=torch.float32, generator=torch.Generator().manual_seed(0)).to(dev)
    layer.kernel_path = "big.kernel"
    x = torch.randn(4, 32, 256, device=dev)
    codec_cuda.reset_launch_counts()
    layer(x).square().sum().backward()
    torch.cuda.synchronize()
    assert layer.kernel.grad is None and seen == []
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 1
    assert fp.COUNTS["producer_dw_skipped"] == 1
    ent = fp.skipped_entries()["big.kernel"]
    g2 = (2 * layer(x)).detach().reshape(-1, 512)
    w, m, raw = codec_cuda.matmul_quantize_chunks(x.reshape(-1, 256), g2, 2, 4, 128, own_row=(0, 2))
    assert _bits_equal(ent.q.packed.reshape(-1), w) and _bits_equal(ent.q.meta.reshape(-1, 2), m)
    assert _bits_equal(ent.raw_row, raw)
    fp.deconfigure()


# ---------------------------------------------------------------------------
# B8 on 16-bit operands: the layer's compute dtype read by the kernel itself.
# ---------------------------------------------------------------------------

# GPT-2 124M's produced layers (din, o), at K = 2 x 512 tokens.
MM16_SHAPES = [(768, 3072), (768, 2304), (3072, 768)]
MM16_K = 1024


def _mm16_operands(seed, k, din, o, dtype, integer, dev):
    rng = np.random.default_rng(seed)
    if integer:
        x, g = rng.integers(-3, 4, (k, din)), rng.integers(-3, 4, (k, o))
    else:
        x, g = rng.standard_normal((k, din)), rng.standard_normal((k, o))
    return (torch.from_numpy(x.astype(np.float32)).to(dtype).to(dev),
            torch.from_numpy(g.astype(np.float32)).to(dtype).to(dev))


def _upcast_route(x2, g2, div, bits, bucket, own_row):
    """The FFMA f32 instance (forced: float32 operands take the tensor
    cores) on the upcast operands: its words and meta, and the raw row its
    sums give at divisor 1, rounded to the operands' dtype and then divided
    (the FFMA 16-bit instance's raw row)."""
    w, m = codec_cuda.matmul_quantize_chunks(x2.float(), g2.float(), div, bits, bucket,
                                             _route="ffma")
    _, _, sums = codec_cuda.matmul_quantize_chunks(x2.float(), g2.float(), 1, bits, bucket,
                                                   own_row=own_row, _route="ffma")
    return w, m, sums.to(x2.dtype).float() / div


# The tolerance of one product summed in two orders (chip_smoke.py's
# payload_close and RAW_RTOL): the tensor-core kernel's sums against the
# plain version's float32 ones.
META_RTOL = 1e-5
RAW_RTOL = 1e-5


def _payload_close(words, meta, want_words, want_meta, bits, bucket):
    """Every meta value within META_RTOL relative to the larger of its
    magnitude and its bucket's level step; every decoded value within one
    level step of the other's, plus what the meta's difference moves it."""
    m, wm = meta.reshape(-1, 2).double().cpu(), want_meta.reshape(-1, 2).double().cpu()
    unit = wm[:, 0]
    dm = (m - wm).abs()
    if not bool((dm <= META_RTOL * torch.maximum(wm.abs(), unit[:, None])).all()):
        return False

    def decode(w, mt):
        return codec_cuda.dequantize_chunks_plain(
            w.reshape(-1).cpu(), mt.reshape(-1, 2).float().cpu(), bits, bucket
        ).double().view(-1, bucket)

    a, b = decode(words, meta), decode(want_words, want_meta)
    tol = (unit + dm[:, 1] + ((1 << bits) - 1) * dm[:, 0])[:, None]
    # The float32 roundings of each decode, min + unit * level (the
    # product's and the sum's): at most eps (|value| + |min|) a value.
    mins = torch.maximum(m[:, 1].abs(), wm[:, 1].abs())[:, None]
    tol = tol + 2 * np.finfo(np.float32).eps * (torch.maximum(a.abs(), b.abs()) + mins)
    return bool(((a - b).abs() <= tol).all())


def _raw_close(raw, want, dtype):
    """The raw own row within RAW_RTOL of the row's largest magnitude plus
    one unit in the last place of the operand dtype."""
    r, p = raw.double().cpu(), want.double().cpu()
    mant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    _, e = torch.frexp(torch.maximum(r.abs(), p.abs()).clamp(min=torch.finfo(dtype).tiny))
    ulp = torch.ldexp(torch.ones_like(r), e - 1 - mant)
    return bool(((r - p).abs() <= ulp + RAW_RTOL * float(p.abs().max())).all())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("din,o", MM16_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_matmul_quantize16_matches_plain_and_upcast_route(dev, dtype, din, o, bits):
    """At GPT-2 124M's shapes, where the tensor-core kernel runs: on
    small-integer operands (every partial sum exact) words, meta and raw own
    row bit-identical to the plain version, from both kernels; on normal
    operands the tensor-core kernel's words and meta within the payload
    tolerance of the plain version and its raw row within RAW_RTOL plus one
    unit of the dtype, and the FFMA kernel (``_route="ffma"``) bit-identical
    to the f32 instance on the upcast operands (a product of two 16-bit
    values is exact in f32 and the two instances sum in one order), its raw
    row to that route's sums rounded to the operand dtype, then divided."""
    bucket, div, ws = 512, 4, 4
    codec_cuda.reset_launch_counts()
    x2, g2 = _mm16_operands(din + o + bits, MM16_K, din, o, dtype, True, dev)
    assert codec_cuda.mm_tc_eligible(x2, g2)
    for own in (0, ws - 1):
        pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(
            x2.cpu(), g2.cpu(), div, bits, bucket, own_row=(own, ws))
        for route in (None, "ffma"):
            w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket,
                                                          own_row=(own, ws), _route=route)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (own, route)
            assert _bits_equal(raw, praw), (own, route)
    x2, g2 = _mm16_operands(din * o + bits, MM16_K, din, o, dtype, False, dev)
    w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket, own_row=(1, ws))
    pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(x2, g2, div, bits, bucket, own_row=(1, ws))
    assert _payload_close(w, m, pw, pm, bits, bucket)
    assert _raw_close(raw, praw, dtype)
    fw, fm, fraw = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket, own_row=(1, ws),
                                                     _route="ffma")
    uw, um, uraw = _upcast_route(x2, g2, div, bits, bucket, (1, ws))
    assert _bits_equal(fw, uw) and _bits_equal(fm, um)
    assert _bits_equal(fraw, uraw)
    torch.cuda.synchronize()
    assert codec_cuda.WIRE16_LAUNCHES["codec_matmul_quantize"] == 6
    assert codec_cuda.MM_TC_LAUNCHES["launches"] == 3
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 8


def test_matmul_quantize_tc_back_to_back_launches_repeat_their_bytes(dev):
    """Tensor-core launches of several geometries (K, din and o tails, a
    GPT-2 layer), back to back on one stream, each on arrival counters of
    its own: every repeat gives the first launch's bytes, one launch a
    call, every one on the tensor-core kernel."""
    ops = []
    for i, (k, din, o, div, bits, bucket) in enumerate([
        (96, 64, 448, 2, 1, 128), (77, 256, 1344, 4, 8, 512), (130, 128, 672, 4, 4, 896),
        (MM16_K, 768, 3072, 4, 4, 512),
    ]):
        dtype = (torch.bfloat16, torch.float16)[i % 2]
        ops.append(_mm16_operands(k + din, k, din, o, dtype, False, dev) + (div, bits, bucket))
    codec_cuda.reset_launch_counts()
    first = [codec_cuda.matmul_quantize_chunks(*a) for a in ops]
    for _ in range(3):
        for a, (w0, m0) in zip(ops, first):
            w, m = codec_cuda.matmul_quantize_chunks(*a)
            assert _bits_equal(w, w0) and _bits_equal(m, m0)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 4 * len(ops)
    assert codec_cuda.MM_TC_LAUNCHES["launches"] == 4 * len(ops)


# (K, din, o, divisor, bits, bucket, offset): the tiles and chunks end at
# different places as in MM_EDGES; din not a multiple of 8 and o = 4 mod 8
# take the FFMA kernel and its 16-bit ring's plain 2-byte fill, and an
# operand view 2 bytes off its 16-byte alignment (offset 1) takes them for
# both operands; the others take the tensor-core kernel (TMA's zero fill
# past K, din and o).
MM16_EDGES = [
    (96, 64, 448, 2, 1, 128, 0), (77, 256, 1344, 4, 8, 512, 0), (33, 13, 4096, 2, 3, 128, 0),
    (50, 100, 4096, 4, 1, 128, 0), (40, 1024, 1036, 2, 4, 128, 0), (64, 256, 512, 2, 4, 512, 1),
    (40, 768, 2304, 4, 4, 512, 1),
]


@pytest.mark.parametrize("route", [None, "ffma"])
@pytest.mark.parametrize("k,din,o,div,bits,bucket,offset", MM16_EDGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_matmul_quantize16_edges_and_own_row(dev, dtype, k, din, o, div, bits, bucket, offset,
                                             route):
    """Words, meta and the own raw row (each row position) bit-identical to
    the plain version on small-integer operands at the edge geometries and
    fill paths, one launch a call, on the kernel the shape routes to (or
    the FFMA one, forced)."""
    rng = np.random.default_rng(k * din + o + offset)

    def operand(rows, cols):
        v = torch.from_numpy(rng.integers(-3, 4, (rows, cols)).astype(np.float32)).to(dtype)
        buf = torch.empty(rows * cols + offset, dtype=dtype, device=dev)
        t = buf[offset:].view(rows, cols)
        t.copy_(v)
        return t

    x2, g2 = operand(k, din), operand(k, o)
    assert (x2.data_ptr() % 16 == 0) == (offset == 0)
    tc = route is None and din % 8 == 0 and o % 8 == 0 and offset == 0
    assert codec_cuda.mm_tc_eligible(x2, g2) is (din % 8 == 0 and o % 8 == 0 and offset == 0)
    ws = 4 if din % 4 == 0 else 1
    codec_cuda.reset_launch_counts()
    for own in range(ws):
        w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket, own_row=(own, ws),
                                                      _route=route)
        pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(
            x2.cpu(), g2.cpu(), div, bits, bucket, own_row=(own, ws))
        assert _bits_equal(w, pw) and _bits_equal(m, pm), own
        assert raw.shape == (din * o // ws,) and _bits_equal(raw, praw), own
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == ws
    assert codec_cuda.WIRE16_LAUNCHES["codec_matmul_quantize"] == ws
    assert codec_cuda.MM_TC_LAUNCHES["launches"] == (ws if tc else 0)


def test_matmul_quantize16_refuses_mixed_dtypes(dev):
    """The two operands share one dtype of the three, or the wrapper raises
    before any launch."""
    x = torch.randn(64, 128, device=dev)
    g = torch.randn(64, 512, device=dev)
    codec_cuda.reset_launch_counts()
    for a, b in ((x.bfloat16(), g.half()), (x.bfloat16(), g), (x, g.half())):
        with pytest.raises(TypeError, match="one dtype"):
            codec_cuda.matmul_quantize_chunks(a, b, 2, 4, 512)
    with pytest.raises(ValueError, match="float64"):
        codec_cuda.matmul_quantize_chunks(x.double(), g.double(), 2, 4, 512)
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 0


# ---------------------------------------------------------------------------
# B8 on float32 operands on the tensor cores: the split pass (hi and lo
# TF32 planes of both transposes) and the split-TF32 kernel.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,din,o,offset", [(1024, 768, 3072, 0), (1024, 3072, 768, 0),
                                            (1000, 100, 196, 0), (33, 13, 4, 0), (1, 3, 8, 0),
                                            (40, 256, 512, 1)])
def test_tf32_split_matches_plain(dev, k, din, o, offset):
    """The split pass against its plain version, bit for bit: normal,
    tiny (down to subnormal), huge and tie values in x2, integers in g2
    (whose lo planes are 0); K padded with zeros to a multiple of 32; rows
    read 16 bytes at a time and, where a width is not a multiple of 4 or
    an operand view sits 4 bytes off its alignment (offset 1), 4 at a
    time; one launch a call."""
    rng = np.random.default_rng(k + din + o)
    xm = rng.standard_normal((k, din)) * np.exp2(rng.integers(-140, 120, (k, din)))
    xm.reshape(-1)[:4] = [1 + 2.0**-11, -(1 + 3 * 2.0**-11), 2.0**-140, -0.0][: xm.size]
    buf = torch.empty(k * din + offset, device=dev)
    x2 = buf[offset:].view(k, din)
    x2.copy_(torch.from_numpy(xm.astype(np.float32)))
    assert (x2.data_ptr() % 16 == 0) == (offset == 0)
    g2 = torch.from_numpy(rng.integers(-2047, 2048, (k, o)).astype(np.float32)).to(dev)
    codec_cuda.reset_launch_counts()
    xs, gs = codec_cuda.tf32_split_transpose(x2, g2)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_tf32_split"] == 1
    pxs, pgs = codec_cuda.tf32_split_transpose_plain(x2.cpu(), g2.cpu())
    assert _bits_equal(xs, pxs) and _bits_equal(gs, pgs)
    assert xs.shape[2] % codec_cuda.MM_TF32_BK == 0 and not gs[1].any()


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("din,o", MM16_SHAPES)
def test_matmul_quantize_tf32_matches_plain(dev, din, o, bits):
    """At GPT-2 124M's shapes (K = 2 x 512 tokens): on small-integer
    operands (lo planes 0, every partial sum exact) words, meta and raw own
    row bit-identical to the plain version on the tensor cores and on the
    FFMA kernel; on normal operands both routes' words and meta within the
    payload tolerance of the plain version (meta within 1e-5 relative) and
    their raw rows within RAW_RTOL of the row's largest magnitude. Each
    tensor-core launch runs one split pass."""
    bucket, div, ws = 512, 4, 4
    codec_cuda.reset_launch_counts()
    x2, g2 = _mm16_operands(din + o + bits, MM16_K, din, o, torch.float32, True, dev)
    for own in (0, ws - 1):
        pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(
            x2.cpu(), g2.cpu(), div, bits, bucket, own_row=(own, ws))
        for route in (None, "ffma"):
            w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket,
                                                          own_row=(own, ws), _route=route)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (own, route)
            assert _bits_equal(raw, praw), (own, route)
    x2, g2 = _mm16_operands(din * o + bits, MM16_K, din, o, torch.float32, False, dev)
    pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(x2, g2, div, bits, bucket, own_row=(1, ws))
    for route in (None, "ffma"):
        w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket, own_row=(1, ws),
                                                      _route=route)
        assert _payload_close(w, m, pw, pm, bits, bucket), route
        assert float((raw - praw).abs().max()) <= RAW_RTOL * float(praw.abs().max()), route
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 6
    assert codec_cuda.MM_TC_LAUNCHES["launches"] == codec_cuda.LAUNCHES["codec_tf32_split"] == 3
    assert codec_cuda.WIRE16_LAUNCHES["codec_matmul_quantize"] == 0


def test_matmul_quantize_tf32_nonfinite_operands(dev):
    """A nonfinite float32 operand gives nonfinite sums on both routes (the
    split gives NaN, lo = inf - inf, where the FFMA kernel may give +-inf):
    the payload's meta is nonfinite in the buckets it reaches either way,
    and finite elsewhere."""
    rng = np.random.default_rng(9)
    x2 = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32)).to(dev)
    g2 = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32)).to(dev)
    x2[3, 5] = float("inf")
    rows = {}
    for route in (None, "ffma"):
        _, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 128, own_row=(0, 2), _route=route)
        torch.cuda.synchronize()
        bad = (~torch.isfinite(m).all(dim=1)).nonzero().reshape(-1).tolist()
        rows[route] = bad
        assert bad == [20, 21, 22, 23], (route, bad)  # row 5 of dw: buckets 20-23 of 128 values
        assert not bool(torch.isfinite(raw).all()), route
    assert rows[None] == rows["ffma"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_skipped_backward16_on_cuda_launches_one_kernel(dev, monkeypatch, dtype):
    """A bf16 or f16 layer configured as ``make_train_step`` does returns no
    weight gradient: one 16-bit launch on the uncast operands, on the
    tensor-core kernel, makes its payload and raw own row, and no plain
    product runs. The payload is within the payload tolerance of the FFMA
    kernel's, which is bit-identical to the upcast route."""
    from torch_cgx_tpu_torch.models import Dense
    from torch_cgx_tpu_torch.ops import fused_producer as fp

    for k, v in {"CGX_PRODUCER_FUSE": "on", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
                 "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "32768"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(fp, "_CFG", dict(fp._CFG))
    fp.configure(None, divisor=2, active=True, skip_dw=True)
    fp._CFG.update(ws=2, rank=1)
    fp.begin_step()
    fp.reset_counts()
    seen = []
    real = fp._plain_dw
    monkeypatch.setattr(fp, "_plain_dw", lambda name, *a: seen.append(name) or real(name, *a))
    layer = Dense(256, 512, dtype=dtype, generator=torch.Generator().manual_seed(0)).to(dev)
    layer.kernel_path = "big.kernel"
    x = torch.randn(4, 32, 256, device=dev)
    codec_cuda.reset_launch_counts()
    layer(x).float().square().sum().backward()
    torch.cuda.synchronize()
    assert layer.kernel.grad is None and seen == []
    assert codec_cuda.LAUNCHES["codec_matmul_quantize"] == 1
    assert codec_cuda.WIRE16_LAUNCHES["codec_matmul_quantize"] == 1
    assert codec_cuda.MM_TC_LAUNCHES["launches"] == 1
    assert fp.COUNTS["producer_dw_skipped"] == 1
    ent = fp.skipped_entries()["big.kernel"]
    x2 = x.to(dtype).reshape(-1, 256)
    g2 = (2 * layer(x).float()).to(dtype).detach().reshape(-1, 512)  # d(y^2)/dy in the compute dtype
    w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 128, own_row=(1, 2))
    assert _bits_equal(ent.q.packed.reshape(-1), w) and _bits_equal(ent.q.meta.reshape(-1, 2), m)
    assert _bits_equal(ent.raw_row, raw)
    fw, fm, fraw = codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 128, own_row=(1, 2), _route="ffma")
    uw, um, uraw = _upcast_route(x2, g2, 2, 4, 128, (1, 2))
    assert _bits_equal(fw, uw) and _bits_equal(fm, um) and _bits_equal(fraw, uraw)
    assert _payload_close(w, m, fw, fm, 4, 128) and _raw_close(raw, fraw, dtype)
    fp.deconfigure()


# ---------------------------------------------------------------------------
# The pipelined kernels (B7a-c) against the single-stage kernels and the
# plain versions.
# ---------------------------------------------------------------------------

# Chunk counts around the persistent grid (132 SMs, one or a few blocks
# each) and far above it.
DB_CHUNKS = (1, 131, 133, 1061)
PLAIN_UP_TO = 133  # chunk counts also held against the plain version on the CPU


def _db_tcs(kernel, chunks, bits, bucket, add=False):
    """Tiles to try: one chunk a tile, and the most the cap allows that
    divide the chunks (B7b: what its slots hold; B7a, B7c: a tile for
    every cluster the card holds)."""
    cap = codec_cuda.db_tc_cap(kernel, bits, bucket, with_add=add, chunks=chunks)
    return [] if cap < 1 else sorted({1, autotune.snap_to_divisor(cap, chunks, cap)})


@pytest.mark.parametrize("bucket", [128, 512, 896])
@pytest.mark.parametrize("bits", range(1, 9))
def test_db_quantize_dequantize_match(dev, bits, bucket):
    rng = np.random.default_rng(bits * bucket)
    for chunks in DB_CHUNKS:
        n = chunks * 32 * bucket
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * (bits + 1)).to(dev)
        w1, m1 = codec_cuda.quantize_chunks(x, bits, bucket)
        for tc in _db_tcs("quantize", chunks, bits, bucket):
            w, m = codec_cuda.quantize_chunks_db(x, bits, bucket, tc)
            assert _bits_equal(w, w1) and _bits_equal(m, m1), (chunks, tc)
        acc = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        for add in (None, acc):
            y1 = codec_cuda.dequantize_chunks(w1, m1, bits, bucket, add_to=add)
            tcs = _db_tcs("dequantize", chunks, bits, bucket, add is not None)
            if not tcs:
                with pytest.raises(ValueError, match="shared memory"):
                    codec_cuda.dequantize_chunks_db(w1, m1, bits, bucket, 1, add_to=add)
            for tc in tcs:
                y = codec_cuda.dequantize_chunks_db(w1, m1, bits, bucket, tc, add_to=add)
                assert _bits_equal(y, y1), (chunks, tc, add is None)
            if chunks <= PLAIN_UP_TO:
                want = codec_cuda.dequantize_chunks_db_plain(
                    w1.cpu(), m1.cpu(), bits, bucket, None if add is None else add.cpu()
                )
                assert _bits_equal(y1, want)
        if chunks <= PLAIN_UP_TO:
            pw, pm = codec_cuda.quantize_chunks_db_plain(x.cpu(), bits, bucket)
            assert _bits_equal(w1, pw) and _bits_equal(m1, pm)


@pytest.mark.parametrize("bucket", [128, 512, 896])
@pytest.mark.parametrize("bits", range(1, 9))
def test_db_epilogue_matches(dev, bits, bucket):
    rng = np.random.default_rng(bits + bucket)
    for ws, chunks in ((1, 133), (2, 131), (4, 67), (8, 17)):
        n = chunks * 32 * bucket
        rows = torch.from_numpy(
            rng.standard_normal((ws, n)).astype(np.float32) * np.arange(1, ws + 1, dtype=np.float32)[:, None]
        ).to(dev)
        q = codec_cuda.quantize_batch(rows, bits, bucket)
        for own in sorted({-1, 0, ws - 1}):
            raw = None if own < 0 else rows[own]
            w1, m1 = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, own, bits, bucket)
            tcs = _db_tcs("epilogue", chunks, bits, bucket)
            assert tcs, (bits, bucket)
            for tc in tcs:
                w, m = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, raw, own, bits, bucket, tc)
                assert _bits_equal(w, w1) and _bits_equal(m, m1), (ws, own, tc)
            if own == ws - 1 and ws <= 4:
                pw, pm = codec_cuda.sra_epilogue_chunks_db_plain(
                    q.packed.cpu(), q.meta.cpu(), None if raw is None else raw.cpu(), own,
                    bits, bucket,
                )
                assert _bits_equal(w1, pw) and _bits_equal(m1, pm), (ws, own)


def test_db_wrappers_refuse_misaligned_strided_and_oversized(dev, monkeypatch):
    n = 2 * 32 * 128
    buf = torch.randn(n + 4, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        codec_cuda.quantize_chunks_db(buf[1 : n + 1], 4, 128, 1)
    with pytest.raises(ValueError, match="contiguous"):
        codec_cuda.quantize_chunks_db(torch.randn(2 * n, device=dev)[::2], 4, 128, 1)
    with pytest.raises(ValueError, match="divide"):
        codec_cuda.quantize_chunks_db(buf[:n], 4, 128, 3)
    w, m = codec_cuda.quantize_chunks(buf[:n], 4, 128)
    # B7b's tile does not fit at 8 bits, bucket 1024, with the accumulator
    # (B7a's and B7c's rings hold a CTA's share at every tile).
    big = torch.randn(32 * 1024, device=dev)
    bw, bm = codec_cuda.quantize_chunks(big, 8, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        codec_cuda.dequantize_chunks_db(bw, bm, 8, 1024, 1, add_to=big)
    wbuf = torch.empty(w.numel() + 1, dtype=torch.int32, device=dev)
    wbuf[1:] = w
    with pytest.raises(ValueError, match="aligned"):
        codec_cuda.dequantize_chunks_db(wbuf[1:], m, 4, 128, 1)
    with pytest.raises(ValueError, match="aligned"):
        codec_cuda.sra_epilogue_chunks_db(w[None], m[None], buf[1 : n + 1], 0, 4, 128, 1)
    # The batch functions copy a misaligned row before a pipelined launch.
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    codec_cuda.reset_launch_counts()
    q = codec_cuda.quantize_batch(buf[1 : n + 1][None], 4, 128)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_quantize_db"] == 1
    want = codec.quantize(buf[1 : n + 1].cpu(), 4, 128)
    assert _bits_equal(q.packed[0], want.packed) and _bits_equal(q.meta[0], want.meta)


def test_tiny_train_step_db_on_matches_off(dev, monkeypatch):
    """GPT-2 tiny on the card: CGX_PALLAS_DB=on launches the three pipelined
    kernels and leaves the parameters bit-identical to off."""
    for k, v in {
        "CGX_DEBUG_FORCE_CODEC": "1", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
        "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "16384",
        "CGX_SRA_EPILOGUE_MIN_ELEMS": "0",
    }.items():
        monkeypatch.setenv(k, v)
    cfg = GPT2Config.tiny()
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1)).to(dev)
    params, launches = {}, {}
    for db in ("on", "off"):
        monkeypatch.setenv("CGX_PALLAS_DB", db)
        model = GPT2(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
        step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device=dev)
        codec_cuda.reset_launch_counts()
        for _ in range(3):
            step(tokens)
        torch.cuda.synchronize()
        launches[db] = dict(codec_cuda.LAUNCHES)
        params[db] = {n: p.detach().clone() for n, p in model.named_parameters()}
    db_keys = ("codec_quantize_db", "codec_dequantize_db", "codec_sra_epilogue_db")
    assert all(launches["on"][k] > 0 for k in db_keys), launches["on"]
    assert all(launches["off"][k] == 0 for k in db_keys), launches["off"]
    for n in params["on"]:
        assert _bits_equal(params["on"][n], params["off"][n]), n


# ---------------------------------------------------------------------------
# B7a and B7c on the cluster body: a persistent grid of clusters, each CTA's
# share of a chunk streamed through a bulk-copy ring. Bit for bit against
# the plain versions run on the card's tensors (NaN payloads round there as
# in the kernels), at every width, buckets 96 to 16,384 (past the register
# budget at 1,760, 8,192 and 16,384), every cluster size, tiles of 1, 2 and
# many chunks, walks shorter and far longer than the grid, ws 1, 4 and 8
# with and without the raw own row.
# ---------------------------------------------------------------------------

DB_BUCKETS = [96, 128, 512, 544, 896, 1024, 1536, 1760, 2048, 4096, 8192, 16384]


def _specials(n: int, bucket: int, seed: int) -> np.ndarray:
    """Normal data with specials: in every third bucket NaN, +-inf, +-0 and
    subnormals; every third bucket all -0; in the rest +-0 and subnormals
    among the normal values. (A bucket whose extremes are zeros of both
    signs has no defined max or min sign: torch.amax and the kernels take
    either, so no bucket here has such extremes.)"""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    b = x.reshape(-1, bucket)
    b[::3, :8] = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -1e-40, 3e-39], dtype=np.float32)
    b[1::3, :] = np.float32(-0.0)
    b[2::3, 8:12] = np.array([0.0, -0.0, 1e-45, -1e-40], dtype=np.float32)
    return x


def _operands(n: int, bucket: int, bits: int):
    return (np.random.default_rng(bits * bucket).standard_normal(n).astype(np.float32),
            qbench.adversarial_operand(n, bucket, bits, seed=bits),
            _specials(n, bucket, bits))


@pytest.mark.parametrize("bucket", DB_BUCKETS)
@pytest.mark.parametrize("bits", range(1, 9))
def test_db_cluster_quantize_matches_plain(dev, bits, bucket):
    """B7a at every width and bucket, in every lowering, on normal,
    adversarial and special data: one launch a call, bytes equal the plain
    version's."""
    chunks = 3
    for x in _operands(chunks * 32 * bucket, bucket, bits):
        x = torch.from_numpy(x).to(dev)
        for enc, pack in _lowerings():
            codec_cuda.reset_launch_counts()
            w, m = codec_cuda.quantize_chunks_db(x, bits, bucket, 1, encode=enc, pack=pack)
            torch.cuda.synchronize()
            assert codec_cuda.LAUNCHES["codec_quantize_db"] == 1
            pw, pm = codec_cuda.quantize_chunks_plain(x, bits, bucket, encode=enc)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (enc, pack)


@pytest.mark.parametrize("bucket", [128, 512, 1536, 1760, 4096, 8192])
@pytest.mark.parametrize("bits", range(1, 9))
def test_db_cluster_epilogue_matches_plain(dev, bits, bucket):
    """B7c at every width, ws 1, 4 and 8, without the raw row and with it at
    row 0 and in the middle, in every lowering; row 0 adversarial, row 1
    special."""
    chunks = 3
    n = chunks * 32 * bucket
    normal, adversarial, special = _operands(n, bucket, bits)
    for ws, owns in ((1, [None, 0]), (4, [None, 0, 2]), (8, [None, 4])):
        rows = np.stack([normal * np.float32(r + 1) for r in range(ws)])
        rows[0] = adversarial
        if ws > 1:
            rows[1] = special
        rows = torch.from_numpy(rows).to(dev)
        q = codec_cuda.quantize_batch(rows, bits, bucket)
        for own in owns:
            raw, o = (None, -1) if own is None else (rows[own], own)
            for enc, pack in _lowerings():
                codec_cuda.reset_launch_counts()
                w, m = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, raw, o, bits, bucket, 1,
                                                         encode=enc, pack=pack)
                torch.cuda.synchronize()
                assert codec_cuda.LAUNCHES["codec_sra_epilogue_db"] == 1
                pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, raw, o, bits, bucket,
                                                              encode=enc)
                assert _bits_equal(w, pw) and _bits_equal(m, pm), (ws, own, enc, pack)


@pytest.mark.parametrize("chunks", [18, 108, 4096])
def test_db_cluster_geometries_tiles_and_walks(dev, chunks):
    """B7a and B7c (ws 2, the raw row at 1) at every cluster size bucket 512
    takes, forced, and tiles of 1, 2 and chunks/2 (or /8): walks below the
    grid's clusters (18, 108 chunks) and far above them (4,096)."""
    b = 512
    n = chunks * 32 * b
    rng = np.random.default_rng(chunks)
    rows = torch.from_numpy(np.stack([rng.standard_normal(n).astype(np.float32) * (r + 1)
                                      for r in range(2)])).to(dev)
    pw, pm = codec_cuda.quantize_chunks_plain(rows[0], 4, b)
    q = codec_cuda.quantize_batch(rows, 4, b)
    ew, em = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, rows[1], 1, 4, b)
    big = chunks // 8 if chunks > 1000 else chunks // 2
    for g in codec_cuda.cluster_geometries(b):
        for tc in (1, 2, big):
            w, m = codec_cuda._launch_quantize_db(rows[0], 4, b, tc, "div", "sum", g)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (g, tc)
            w, m = codec_cuda._launch_epilogue_db(q.packed, q.meta, rows[1], 1, 4, b, tc, "div",
                                                  "sum", g)
            assert _bits_equal(w, ew) and _bits_equal(m, em), (g, tc)


@pytest.mark.parametrize("bucket,chunks", [(544, 300), (1760, 144), (8192, 64), (16384, 5)])
def test_db_cluster_ring_depths(dev, bucket, chunks):
    """Past the register budget (rounds re-read through the ring; 544 is
    17 warps, one round a warp), walks of several chunks a cluster, ring
    depths other than the wrappers' (powers of two: B7a one or two slots of
    up to 64 KB, B7c one to eight small ones), in both packs: the bytes do
    not move."""
    n = chunks * 32 * bucket
    rng = np.random.default_rng(bucket)
    rows = torch.from_numpy(np.stack([rng.standard_normal(n).astype(np.float32) * (r + 1)
                                      for r in range(4)])).to(dev)
    pw, pm = codec_cuda.quantize_chunks_plain(rows[0], 4, bucket)
    q = codec_cuda.quantize_batch(rows, 4, bucket)
    ew, em = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, rows[2], 2, 4, bucket)
    assert codec_cuda.db_ring("quantize", chunks, 4, bucket).geometry.positions > 1
    for slots in (1, 2, 4, 8):
        for pack in codec_cuda.PACKS:
            if slots <= 2:
                w, m = codec_cuda._launch_quantize_db(rows[0], 4, bucket, 1, "div", pack, slots=slots)
                assert _bits_equal(w, pw) and _bits_equal(m, pm), (slots, pack)
            w, m = codec_cuda._launch_epilogue_db(q.packed, q.meta, rows[2], 2, 4, bucket, 1, "div",
                                                  pack, slots=slots)
            assert _bits_equal(w, ew) and _bits_equal(m, em), (slots, pack)


# ---------------------------------------------------------------------------
# B9's variant kernel, and the mul encode and butterfly pack of every
# quantizing kernel (B1, B3, B7a, B7c, B8).
# ---------------------------------------------------------------------------

VARIANT_BUCKETS = [128, 512, 896, 8192]


def _variant_edges(bucket: int, bits: int) -> np.ndarray:
    """Four chunks at the edges of ``read``'s word (the largest unit of a
    chunk's 32 buckets, toward zero): every bucket constant (units 0, the
    encode's divisor 1: the word 0), a NaN in one bucket (the word 0), one
    bucket's unit past 2^31 (the word saturates), units below 1 (the word 0
    by truncation)."""
    x = np.random.default_rng(bits + bucket).standard_normal((4, 32, bucket)).astype(np.float32)
    x[0] = np.arange(32, dtype=np.float32)[:, None] - np.float32(7.25)
    x[1, 5, 3] = np.nan
    x[2, 9] *= np.float32(1e13)
    x[3] *= np.float32(1e-3)
    return x.reshape(-1)


def _forced_geometries(bucket: int) -> list:
    """Every geometry within the register budget, and for each k that splits
    the bucket's warps one with positions in rounds (REREAD): half of B/k
    threads, at most 512, so a thread takes two positions or more."""
    out = list(codec_cuda.cluster_geometries(bucket))
    for k in codec_cuda.CLUSTER_SIZES:
        span = bucket // k
        if bucket % (32 * k) == 0 and span >= 64:
            out.append(codec_cuda.ClusterGeometry(k, min(512, 32 * (span // 64))))
    return out


@pytest.mark.parametrize("bucket", VARIANT_BUCKETS)
@pytest.mark.parametrize("bits", range(1, 9))
def test_quantize_variant_matches_plain(dev, bits, bucket):
    """B9 on B1's cluster body: at B1's own geometry for one chunk, chunk
    counts at which the rule picks k = 8, 4 and 1 on this card, and 144 (the step's
    mlp_in launch; bucket 8192 is past the register budget: positions in
    rounds), then at every geometry of the bucket forced (in registers and
    in rounds) on normal, ``qbench.adversarial_operand`` and the word's edge
    data: one launch a call, bytes equal the plain version's run on the
    card's tensors."""
    rng = np.random.default_rng(100 * bits + bucket)
    sms = codec_cuda._sm_count(dev.index or 0)

    def check(x, g, label):
        for variant in codec_cuda.VARIANTS:
            codec_cuda.reset_launch_counts()
            w, m = codec_cuda.quantize_variant_chunks(x, variant, bits, bucket, g)
            torch.cuda.synchronize()
            assert codec_cuda.LAUNCHES["codec_quantize_variant"] == 1
            pw, pm = _plain_on(dev, codec_cuda.quantize_variant_chunks_plain, x, variant, bits, bucket)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (label, g, variant)

    picked = set()
    for chunks in (1, sms // 8, sms // 4, 144, 2 * sms):
        x = torch.from_numpy(rng.standard_normal(chunks * 32 * bucket).astype(np.float32) * 40).to(dev)
        g = codec_cuda._geometry(x, chunks, bucket, bits)
        picked.add(g.k)
        check(x, None, f"chunks={chunks}")
    if bucket == 512:
        assert picked == {1, 4, 8}, picked
    n = 3 * 32 * bucket
    for label, x in (("normal", rng.standard_normal(n).astype(np.float32)),
                     ("adversarial", qbench.adversarial_operand(n, bucket, bits, seed=bits)),
                     ("edges", _variant_edges(bucket, bits))):
        x = torch.from_numpy(x).to(dev)
        for g in _forced_geometries(bucket):
            check(x, g, label)


def test_quantize_variant_read_word_edges(dev):
    """read's word on the edge chunks, against the numbers: 0 for the
    constant chunk and the NaN one, 2^31 - 1 where a unit passes 2^31, 0
    below 1."""
    x = torch.from_numpy(_variant_edges(512, 8)).to(dev)
    w, _ = codec_cuda.quantize_variant_chunks(x, "read", 8, 512)
    assert w.view(4, -1)[:, 0].tolist() == [0, 0, 2**31 - 1, 0]
    assert bool((w.view(4, -1) == w.view(4, -1)[:, :1]).all())


def _lowerings():
    return [(e, p) for e in codec_cuda.ENCODES for p in codec_cuda.PACKS]


@pytest.mark.parametrize("bucket", [128, 512, 896])
@pytest.mark.parametrize("bits", range(1, 9))
def test_quantize_lowerings_match_plain(dev, bits, bucket):
    """B1 and B7a in each (encode, pack) pair on the tie operand (every
    value near a level boundary): bit-identical to the plain version of
    that encode, butterfly equal to sum, and mul differing from div by at
    most one level somewhere."""
    for chunks in (1, 131):
        n = chunks * 32 * bucket
        x = torch.from_numpy(qbench.tie_operand(n, bucket, bits, seed=bits)).to(dev)
        got = {}
        for enc, pack in _lowerings():
            w, m = codec_cuda.quantize_chunks(x, bits, bucket, encode=enc, pack=pack)
            pw, pm = codec_cuda.quantize_chunks_plain(x.cpu(), bits, bucket, encode=enc)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (chunks, enc, pack)
            for tc in _db_tcs("quantize", chunks, bits, bucket):
                dw, dm = codec_cuda.quantize_chunks_db(x, bits, bucket, tc, encode=enc, pack=pack)
                assert _bits_equal(dw, w) and _bits_equal(dm, m), (chunks, enc, pack, tc)
            got[enc, pack] = w
        for enc in codec_cuda.ENCODES:
            assert _bits_equal(got[enc, "butterfly"], got[enc, "sum"]), enc
        lv = {e: codec.unpack_levels_bucketed(got[e, "sum"].cpu(), bits, n // bucket, bucket)
              for e in codec_cuda.ENCODES}
        diff = (lv["mul"] - lv["div"]).abs()
        if chunks > 1:
            assert int(diff.max()) == 1, chunks


@pytest.mark.parametrize("bucket", [128, 512, 896])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_epilogue_lowerings_match_plain(dev, bits, bucket):
    """B3 and B7c in each (encode, pack) pair at ws 4, the raw own row a
    tie row: bit-identical to the plain version, butterfly equal to sum."""
    ws, own, chunks = 4, 1, 33
    n = chunks * 32 * bucket
    rows = np.stack([np.random.default_rng(r).standard_normal(n).astype(np.float32) for r in range(ws)])
    rows[own] = qbench.tie_operand(n, bucket, bits, seed=bits)
    rows = torch.from_numpy(rows).to(dev)
    q = codec_cuda.quantize_batch(rows, bits, bucket)
    for enc in codec_cuda.ENCODES:
        pw, pm = codec_cuda.sra_epilogue_chunks_plain(
            q.packed.cpu(), q.meta.cpu(), rows[own].cpu(), own, bits, bucket, encode=enc)
        for pack in codec_cuda.PACKS:
            w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, rows[own], own, bits, bucket,
                                                  encode=enc, pack=pack)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (enc, pack)
            for tc in _db_tcs("epilogue", chunks, bits, bucket):
                dw, dm = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, rows[own], own, bits,
                                                           bucket, tc, encode=enc, pack=pack)
                assert _bits_equal(dw, pw) and _bits_equal(dm, pm), (enc, pack, tc)


@pytest.mark.parametrize("k,din,o,div,bits,bucket", [
    (64, 256, 512, 2, 4, 512), (1024, 768, 3072, 4, 4, 512), (96, 128, 384, 3, 2, 128),
    (40, 64, 1792, 2, 8, 1792),
])
def test_matmul_quantize_lowerings_match_plain(dev, k, din, o, div, bits, bucket):
    """B8 in each (encode, pack) pair on small-integer operands."""
    rng = np.random.default_rng(k + din + o + 1)
    x2 = torch.from_numpy(rng.integers(-3, 4, (k, din)).astype(np.float32)).to(dev)
    g2 = torch.from_numpy(rng.integers(-3, 4, (k, o)).astype(np.float32)).to(dev)
    for enc, pack in _lowerings():
        w, m = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket, encode=enc, pack=pack)
        pw, pm = codec_cuda.matmul_quantize_chunks_plain(x2.cpu(), g2.cpu(), div, bits, bucket, encode=enc)
        assert _bits_equal(w, pw) and _bits_equal(m, pm), (enc, pack)


def test_knobs_reach_the_kernels(dev, monkeypatch):
    """The env knobs, through quantize_batch: mul differs from div on the
    tie operand; butterfly equals sum; both counted as kernel launches."""
    x = torch.from_numpy(qbench.tie_operand(64 * 32 * 512, 512, 4)).to(dev)[None]
    out = {}
    for enc, pack in _lowerings():
        monkeypatch.setenv("CGX_CODEC_ENCODE", enc)
        monkeypatch.setenv("CGX_PALLAS_PACK", pack)
        codec_cuda.reset_launch_counts()
        out[enc, pack] = codec_cuda.quantize_batch(x, 4, 512).packed
        torch.cuda.synchronize()
        assert codec_cuda.LAUNCHES["codec_quantize"] == 1
    assert _bits_equal(out["div", "butterfly"], out["div", "sum"])
    assert _bits_equal(out["mul", "butterfly"], out["mul", "sum"])
    assert not _bits_equal(out["mul", "sum"], out["div", "sum"])


def test_qbench_runs_each_variant_on_the_card(dev, capsys):
    for variant in qbench.VARIANTS:
        rec = qbench.main([variant, "--mb", "16", "--k", "3"])
        assert rec["device"] == torch.cuda.get_device_name(0) and rec["bound_ms"] > 0, rec
    assert "byte_check: ok" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The cluster kernels (B1/B5 and B3): bytes equal to the plain versions at
# the step's launch shapes, every width, bucket, lowering and row count, and
# on adversarial buckets; the reciprocal quotient equal to the IEEE divide.
# ---------------------------------------------------------------------------

# Chunks a launch of the GPT-2 124M step (bucket 512): one mlp layer's
# ws-8 share, attn_qkv, mlp_in/mlp_out, the wte tail (B5), attn_proj + wpe,
# a wte slice; and phase 7's ws-4 flat-SRA epilogue.
STEP_CHUNKS = (18, 108, 144, 307, 480, 1024)


def _plain_on(dev, fn, *args, **kw):
    """A plain version run on the card's own tensors: NaN payloads and the
    card's float rounding of NaN arithmetic match the kernel's there."""
    return fn(*[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args], **kw)


@pytest.mark.parametrize("chunks", STEP_CHUNKS)
def test_cluster_quantize_step_shapes(dev, chunks):
    """B1 (B5 at 307 chunks) at each launch shape of the step, in every
    lowering: bytes equal the plain version's; one launch a call."""
    n = chunks * 32 * 512
    x = torch.from_numpy(np.random.default_rng(chunks).standard_normal(n).astype(np.float32)).to(dev)
    assert codec_cuda.cluster_geometry(chunks, 512, 4).positions == 1
    for enc, pack in _lowerings():
        codec_cuda.reset_launch_counts()
        w, m = codec_cuda.quantize_chunks(x, 4, 512, encode=enc, pack=pack)
        torch.cuda.synchronize()
        assert codec_cuda.LAUNCHES["codec_quantize"] == 1
        pw, pm = codec_cuda.quantize_chunks_plain(x, 4, 512, encode=enc)
        assert _bits_equal(w, pw) and _bits_equal(m, pm), (enc, pack)


@pytest.mark.parametrize("bucket", [96, 128, 256, 512, 896, 1024, 1760, 1792, 2048, 4096, 6144,
                                    16384])
@pytest.mark.parametrize("bits", range(1, 9))
def test_cluster_quantize_bits_buckets(dev, bits, bucket):
    """B1 at every width and at buckets whose geometry takes 1, 2, 4 or 8
    CTAs a chunk (up to 8 x 512 threads at 4096) and past the register
    budget (1760, 6144, 16384: positions in rounds, re-read), in every
    lowering, on normal and adversarial data."""
    chunks = 3
    n = chunks * 32 * bucket
    rng = np.random.default_rng(bits * bucket)
    for x in (rng.standard_normal(n).astype(np.float32),
              qbench.adversarial_operand(n, bucket, bits, seed=bits)):
        x = torch.from_numpy(x).to(dev)
        for enc, pack in _lowerings():
            w, m = codec_cuda.quantize_chunks(x, bits, bucket, encode=enc, pack=pack)
            pw, pm = codec_cuda.quantize_chunks_plain(x, bits, bucket, encode=enc)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (enc, pack)


@pytest.mark.parametrize("chunks,ws,owns", [
    (108, 1, [None]), (144, 1, [None]), (307, 1, [None]), (480, 1, [None]), (1024, 1, [None]),
    (256, 4, [None, 0, 3]), (18, 8, [None, 5]),
])
def test_cluster_epilogue_step_shapes(dev, chunks, ws, owns):
    """B3 at the step's shapes with one row and no raw row, at phase 7's ws 4
    x 256 chunks with the raw row, and at one mlp layer's ws-8 share, in
    every lowering: bytes equal the plain version's."""
    n = chunks * 32 * 512
    rng = np.random.default_rng(chunks + ws)
    rows = torch.from_numpy(
        np.stack([rng.standard_normal(n).astype(np.float32) * (r + 1) for r in range(ws)])).to(dev)
    q = codec_cuda.quantize_batch(rows, 4, 512)
    for own in owns:
        raw, o = (None, -1) if own is None else (rows[own], own)
        for enc, pack in _lowerings():
            codec_cuda.reset_launch_counts()
            w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, o, 4, 512, encode=enc, pack=pack)
            torch.cuda.synchronize()
            assert codec_cuda.LAUNCHES["codec_sra_epilogue"] == 1
            pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, raw, o, 4, 512, encode=enc)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (own, enc, pack)


@pytest.mark.parametrize("bucket", [128, 512, 896, 1760, 1792, 6144])
@pytest.mark.parametrize("bits", range(1, 9))
def test_cluster_epilogue_bits_buckets(dev, bits, bucket):
    """B3 at every width, at buckets up to the batch path's gate and past
    the register budget (1760, 6144: positions in rounds, each folded again
    for the encode), ws 1 and 4, with and without the raw row, the rows and
    the raw row adversarial."""
    chunks, rng = 5, np.random.default_rng(bits + bucket)
    n = chunks * 32 * bucket
    for ws, owns in ((1, [None, 0]), (4, [None, 2])):
        rows = np.stack([rng.standard_normal(n).astype(np.float32) for _ in range(ws)])
        rows[0] = qbench.adversarial_operand(n, bucket, bits, seed=bits)
        rows = torch.from_numpy(rows).to(dev)
        q = codec_cuda.quantize_batch(rows, bits, bucket)
        for own in owns:
            raw, o = (None, -1) if own is None else (rows[own], own)
            for enc, pack in _lowerings():
                w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, o, bits, bucket,
                                                      encode=enc, pack=pack)
                pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, raw, o, bits, bucket,
                                                              encode=enc)
                assert _bits_equal(w, pw) and _bits_equal(m, pm), (ws, own, enc, pack)


@pytest.mark.parametrize("bucket,chunks", [(1760, 144), (8192, 3), (16384, 2)])
def test_cluster_past_the_register_budget(dev, bucket, chunks):
    """Buckets no cluster holds one position a thread: 1760 (55 warps of
    positions, no k splits them into at most 512 threads) and 8192, 16384
    (beyond 8 x 512). B1 and B3 (ws 4, raw row) run the same kernels with
    positions in rounds: one launch each, bytes equal the plain versions'."""
    g = codec_cuda.cluster_geometry(chunks, bucket, 4)
    assert g.positions > 1, g
    n = chunks * 32 * bucket
    rng = np.random.default_rng(bucket)
    rows = torch.from_numpy(np.stack([rng.standard_normal(n).astype(np.float32) * (r + 1)
                                      for r in range(4)])).to(dev)
    for enc, pack in _lowerings():
        codec_cuda.reset_launch_counts()
        w, m = codec_cuda.quantize_chunks(rows[0], 4, bucket, encode=enc, pack=pack)
        q = codec_cuda.quantize_batch(rows, 4, bucket)
        codec_cuda.reset_launch_counts()
        ew, em = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, rows[1], 1, 4, bucket,
                                                encode=enc, pack=pack)
        torch.cuda.synchronize()
        assert codec_cuda.LAUNCHES["codec_sra_epilogue"] == 1
        pw, pm = codec_cuda.quantize_chunks_plain(rows[0], 4, bucket, encode=enc)
        assert _bits_equal(w, pw) and _bits_equal(m, pm), (enc, pack)
        pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, rows[1], 1, 4, bucket,
                                                      encode=enc)
        assert _bits_equal(ew, pw) and _bits_equal(em, pm), (enc, pack)


def test_reciprocal_quotient_equals_the_ieee_divide(dev):
    """The div encode's reciprocal quotient on the card: every divisor
    significand at exponent 0 against every level boundary and level of 8
    bits (one ulp each side) and pseudo-random numerators; every 64th
    significand at the range's edge exponents; and the special pairs. Not
    one quotient differs from __fdiv_rn's, nor one level."""
    full = codec_cuda.reciprocal_sweep(dev, e2=0)
    assert full["pairs"] > 10**10, full
    assert full["quotients_differ"] == 0 and full["levels_differ"] == 0, full
    for e2 in (-64, -63, 62, 63, -65, 64):
        edge = codec_cuda.reciprocal_sweep(dev, e2=e2, m_step=64, extra=16)
        assert edge["quotients_differ"] == 0 and edge["levels_differ"] == 0, (e2, edge)
    tiny, huge = np.float32(2.0**-64), np.float32(2.0**64)
    ds = [1.0, 3.0, tiny, np.nextafter(tiny, np.float32(0)), np.nextafter(huge, np.float32(0)), huge,
          np.float32(1e-40), np.float32(1.4e-45), np.inf, np.float32(3.4e38)]
    as_ = [0.0, -0.0, np.float32(1e-45), np.float32(1e-38), 0.5, 255.5, np.float32(3e38), np.inf, np.nan]
    a = torch.tensor([x for x in as_ for _ in ds], dtype=torch.float32, device=dev)
    d = torch.tensor([y for _ in as_ for y in ds], dtype=torch.float32, device=dev)
    fast, ref = codec_cuda.reciprocal_pairs(a, d)
    same = ((fast.view(torch.int32) == ref.view(torch.int32))
            | (torch.isnan(fast) & torch.isnan(ref)))
    # The pairs the kernels can meet: a divisor outside the range (the IEEE
    # divide runs), or a NaN numerator, or a finite one in the level domain
    # a <= 257 d (a = x - min <= max - min = unit * (2^bits - 1), rounded).
    # An infinite numerator never meets an in-range divisor: a bucket with
    # an inf entry has an infinite unit. Quotients equal bit for bit (NaN
    # any NaN), and levels (floor(q + 1/2) clamped to 8 bits, NaN -> 0).
    in_range = torch.tensor([codec_cuda.rcp_in_range(float(y)) for _ in as_ for y in ds], device=dev)
    checked = ~in_range | torch.isnan(a) | (torch.isfinite(a) & (a.abs() <= 257 * d))
    assert bool(same[checked].all())

    def level(q):
        return torch.nan_to_num(torch.floor(q + 0.5), nan=0.0).clamp(0, 255)

    assert bool((level(fast) == level(ref))[checked].all())


# The DDP hook's frame codec (``torch_backend/backend.py``): layers below 32
# values, below one bucket, of whole 32-bucket chunks, with tails, at three
# (bits, bucket) pairs, one of them a bucket the fused kernels do not take.
HOOK_LAYERS = [(20, 4, 512), (300, 4, 512), (32 * 512, 4, 512), (3 * 512 + 5, 2, 128),
               (2 * 32 * 512 + 3 * 512 + 7, 4, 512), (31, 8, 96), (3 * 32 * 96 + 50, 8, 96)]


def _hook_layers():
    out, off = [], 0
    for n, bits, b in HOOK_LAYERS:
        out.append((off, n, CompressionConfig(bits=bits, bucket_size=b)))
        off += n
    return out, off


@pytest.mark.parametrize("epilogue", ["auto", "fused"])
@pytest.mark.parametrize("aligned", [False, True], ids=["equal", "layer_aligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_hook_frames_match_plain(dev, monkeypatch, dtype, aligned, epilogue):
    """Frame compress, decompress (with and without the add), requantize,
    the SRA fold and the all-to-all reduce on the card against the plain
    versions on the CPU, bit for bit: bytes and decoded values. The buffer
    is a bucket of ``dtype`` upcast to f32; the meta travels in the
    bucket's wire dtype."""
    from torch_cgx_tpu_torch.torch_backend import backend as hb

    monkeypatch.setenv("CGX_SRA_EPILOGUE", epilogue)
    if aligned:
        monkeypatch.setenv("CGX_LAYER_ALIGNED_SPLIT", "1")
    layers, n = _hook_layers()
    ws, me = 4, 1
    wdt = hb._wire_dtype(dtype)
    rng = np.random.default_rng(int(aligned) + 2 * (dtype == torch.bfloat16))
    ranks = torch.from_numpy(rng.standard_normal((ws, n)).astype(np.float32)).to(dtype).float()
    sizes, offs = hb._chunk_split(n, ws, layers)
    segs = [hb._segments_in(layers, offs[r], offs[r] + sizes[r]) for r in range(ws)]
    assert any(s.numel < 32 for sg in segs for s in sg)
    frames = {}
    for r in range(ws):
        cpu = hb._compress_frames(ranks[r], segs[me], False, wdt)
        card = hb._compress_frames(ranks[r].to(dev), segs[me], False, wdt)
        assert _bits_equal(card, cpu), r
        frames[r] = cpu
    for add in (False, True):
        cpu, card = ranks[0].clone(), ranks[0].to(dev)
        hb._decompress_frames(frames[2], segs[me], cpu, False, add, wdt)
        hb._decompress_frames(frames[2].to(dev), segs[me], card, False, add, wdt)
        assert _bits_equal(card, cpu), add
    cpu, card = ranks[me].clone(), ranks[me].to(dev)
    peer = [None if r == me else frames[r] for r in range(ws)]
    w_cpu = hb._sra_fold_chunk(cpu, segs[me], peer, me, ws, False, wdt)
    w_card = hb._sra_fold_chunk(card, segs[me], [None if f is None else f.to(dev) for f in peer],
                                me, ws, False, wdt)
    assert _bits_equal(w_card, w_cpu) and _bits_equal(card, cpu)
    cpu, card = ranks[3].clone(), ranks[3].to(dev)
    w_cpu = hb._requantize_frames(cpu, segs[me], False, wdt)
    w_card = hb._requantize_frames(card, segs[me], False, wdt)
    assert _bits_equal(w_card, w_cpu) and _bits_equal(card, cpu)
    off = 0
    for s in segs[me]:
        nb = hb.frame_bytes(s, wdt, False)
        rows = [frames[r][off : off + nb] for r in range(ws)]
        off += nb
        got = dispatch.reduce_rows(hb._stack_frames([x.to(dev) for x in rows], s, wdt))
        assert _bits_equal(got, dispatch.reduce_rows(hb._stack_frames(rows, s, wdt))), s


@pytest.mark.parametrize("intra_compress", [True, False], ids=["intra_q", "intra_raw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hier_frames_match_plain(dev, dtype, intra_compress):
    """The two-level scheme's frame work (``backend._qreduce_hier``) on the
    card against the plain versions on the CPU, bit for bit: two
    non-leaders' whole-buffer stage-1 frames, the leader's fold of them in
    ascending local index (the decode's fused add), its stage-3 requantize
    and self-decode, and a local's decode of that frame. Under
    ``CGX_INTRA_COMPRESS=0`` the intra frames are raw values."""
    from torch_cgx_tpu_torch.torch_backend import backend as hb

    layers, n = _hook_layers()
    wdt = hb._wire_dtype(dtype)
    raw = not intra_compress
    segs = hb._segments_in(layers, 0, n)
    rng = np.random.default_rng(11 + int(raw))
    ranks = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32)).to(dtype).float()
    frames = []
    for r in (1, 2):
        cpu = hb._compress_frames(ranks[r], segs, raw, wdt)
        card = hb._compress_frames(ranks[r].to(dev), segs, raw, wdt)
        assert _bits_equal(card, cpu), r
        frames.append(cpu)
    cpu, card = ranks[0].clone(), ranks[0].to(dev)
    for f in frames:
        hb._decompress_frames(f, segs, cpu, raw, True, wdt)
        hb._decompress_frames(f.to(dev), segs, card, raw, True, wdt)
        assert _bits_equal(card, cpu)
    w_cpu = hb._requantize_frames(cpu, segs, raw, wdt)
    w_card = hb._requantize_frames(card, segs, raw, wdt)
    assert _bits_equal(w_card, w_cpu) and _bits_equal(card, cpu)
    cpu, card = ranks[1].clone(), ranks[1].to(dev)
    hb._decompress_frames(w_cpu, segs, cpu, raw, False, wdt)
    hb._decompress_frames(w_card, segs, card, raw, False, wdt)
    assert _bits_equal(card, cpu)


def test_async_bucket_runs_on_the_workers_stream(dev, monkeypatch):
    """``backend.allreduce_async`` on a card tensor: the job runs on the
    group's worker thread on its own stream, after what the caller's stream
    wrote to the tensor, and the CUDA-aware future orders the waiter's
    stream after the job's writes."""
    from torch_cgx_tpu_torch.torch_backend import backend as hb

    seen = {}

    def job(t, group=None, op=None, bucket_key=None):
        seen["stream"] = torch.cuda.current_stream(t.device)
        seen["key"] = bucket_key
        t.mul_(2)
        return t

    monkeypatch.setattr(hb, "allreduce", job)
    x = torch.zeros(1 << 24, device=dev)
    torch.cuda._sleep(50_000_000)  # keep the caller's stream busy
    x.add_(1)
    fut = hb.allreduce_async(x, None, ("b", 0))
    out = fut.wait()
    assert out is x and seen["key"] == ("b", 0)
    assert seen["stream"] != torch.cuda.current_stream(dev)
    assert float(x.sum()) == 2.0 * x.numel()
    hb.release(None)


# ---------------------------------------------------------------------------
# Stochastic rounding in B1/B5, B3, B7a and B7c: the kernels' Philox stream
# against the plain versions' (utils/prng.py), bit for bit.
# ---------------------------------------------------------------------------

SR_SEED = 0x0123456789ABCDEF


@pytest.mark.parametrize("bucket", [128, 512, 1760, 16384])
@pytest.mark.parametrize("bits", range(1, 9))
def test_stochastic_quantize_matches_plain(dev, bits, bucket):
    """B1 and B7a under stochastic rounding at every width, buckets within
    and past the register budget, in every lowering, on normal, adversarial
    and special data: one launch a call, the bytes of the plain version,
    B7a's equal to B1's; the meta equal to round-to-nearest's."""
    for x in _operands(3 * 32 * bucket, bucket, bits):
        x = torch.from_numpy(x).to(dev)
        for enc, pack in _lowerings():
            codec_cuda.reset_launch_counts()
            w, m = codec_cuda.quantize_chunks(x, bits, bucket, encode=enc, pack=pack, seed=SR_SEED)
            dw, dm = codec_cuda.quantize_chunks_db(x, bits, bucket, 1, encode=enc, pack=pack,
                                                   seed=SR_SEED)
            torch.cuda.synchronize()
            assert codec_cuda.LAUNCHES["codec_quantize"] == codec_cuda.LAUNCHES["codec_quantize_db"] == 1
            pw, pm = codec_cuda.quantize_chunks_plain(x, bits, bucket, encode=enc, seed=SR_SEED)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (enc, pack)
            assert _bits_equal(dw, pw) and _bits_equal(dm, pm), (enc, pack)
            assert _bits_equal(m, codec_cuda.quantize_chunks(x, bits, bucket, encode=enc)[1])


@pytest.mark.parametrize("bucket", [512, 1760])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_stochastic_epilogue_matches_plain(dev, bits, bucket):
    """B3 and B7c under stochastic rounding at ws 1, 4 and 8, with and
    without the raw own row, in every lowering: the plain version's bytes,
    B7c's equal to B3's."""
    n = 3 * 32 * bucket
    normal, adversarial, special = _operands(n, bucket, bits)
    for ws, owns in ((1, [None, 0]), (4, [None, 2]), (8, [None, 5])):
        rows = np.stack([normal * np.float32(r + 1) for r in range(ws)])
        rows[0] = adversarial
        if ws > 1:
            rows[1] = special
        rows = torch.from_numpy(rows).to(dev)
        q = codec_cuda.quantize_batch(rows, bits, bucket)
        for own in owns:
            raw, o = (None, -1) if own is None else (rows[own], own)
            for enc, pack in _lowerings():
                w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, o, bits, bucket,
                                                      encode=enc, pack=pack, seed=SR_SEED)
                dw, dm = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, raw, o, bits, bucket, 1,
                                                           encode=enc, pack=pack, seed=SR_SEED)
                pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, raw, o, bits, bucket,
                                                              encode=enc, seed=SR_SEED)
                assert _bits_equal(w, pw) and _bits_equal(m, pm), (ws, own, enc, pack)
                assert _bits_equal(dw, pw) and _bits_equal(dm, pm), (ws, own, enc, pack)


@pytest.mark.parametrize("bucket,chunks", [(512, 18), (1760, 4), (16384, 2)])
def test_stochastic_geometries_tiles_and_rings(dev, bucket, chunks):
    """Every cluster size the bucket takes (and the wrappers' geometry past
    the register budget), forced, tiles of one and two chunks, ring depths
    1-8 of B7a and B7c: the stochastic bytes do not move."""
    n = chunks * 32 * bucket
    rng = np.random.default_rng(bucket)
    rows = torch.from_numpy(np.stack([rng.standard_normal(n).astype(np.float32) * (r + 1)
                                      for r in range(4)])).to(dev)
    pw, pm = codec_cuda.quantize_chunks_plain(rows[0], 4, bucket, seed=SR_SEED)
    q = codec_cuda.quantize_batch(rows, 4, bucket)
    ew, em = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, rows[2], 2, 4, bucket, seed=SR_SEED)
    geoms = set(codec_cuda.cluster_geometries(bucket)) | {
        codec_cuda.cluster_geometry(chunks, bucket, 4), codec_cuda.db_geometry(chunks, bucket, 4)}
    for g in geoms:
        w, m = codec_cuda._launch_quantize(rows[0], 4, bucket, "div", "sum", g, seed=SR_SEED)
        assert _bits_equal(w, pw) and _bits_equal(m, pm), g
        w, m = codec_cuda._launch_epilogue(q.packed, q.meta, rows[2], 2, 4, bucket, "div", "sum", g,
                                           seed=SR_SEED)
        assert _bits_equal(w, ew) and _bits_equal(m, em), g
        if (bucket // g.k) % g.threads:
            continue
        for tc in (1, 2):
            for slots in (1, 2, 4, 8):
                # B7a's slots hold 32 x T floats: as many as fit beside the butterfly stage.
                if (codec_cuda.DB_BAR_BYTES + (slots + 1) * 128 * g.threads
                        + codec_cuda.DB_CLUSTER_STATIC_BYTES <= codec_cuda.SMEM_BLOCK_BYTES):
                    w, m = codec_cuda._launch_quantize_db(rows[0], 4, bucket, tc, "div", "butterfly",
                                                          g, slots, seed=SR_SEED)
                    assert _bits_equal(w, pw) and _bits_equal(m, pm), (g, tc, slots)
                w, m = codec_cuda._launch_epilogue_db(q.packed, q.meta, rows[2], 2, 4, bucket, tc,
                                                      "div", "sum", g, slots, seed=SR_SEED)
                assert _bits_equal(w, ew) and _bits_equal(m, em), (g, tc, slots)


def test_stochastic_fused_epilogue_equals_staged_and_refusals(dev, monkeypatch):
    """The dispatcher's fused stochastic epilogue (B3) equals the staged one
    (decode, sum, then B1) on the card; B8 under CGX_STOCHASTIC_ROUNDING
    still raises."""
    from torch_cgx_tpu_torch.utils import prng

    monkeypatch.setenv("CGX_STOCHASTIC_ROUNDING", "1")
    cc = CompressionConfig(bits=4, bucket_size=512, stochastic=True)
    rows = torch.randn(4, 8 * 32 * 512, device=dev)
    q = dispatch.quantize_batch(rows, cc, prng.key(3))
    got = {}
    for mode in ("fused", "staged"):
        monkeypatch.setenv("CGX_SRA_EPILOGUE", mode)
        codec_cuda.reset_launch_counts()
        got[mode] = dispatch.reduce_rows_requantize(q, cc, raw_rows=rows, own_idx=1, key=prng.key(4))
        torch.cuda.synchronize()
        fused = mode == "fused"
        assert codec_cuda.LAUNCHES["codec_sra_epilogue"] == int(fused), (mode, codec_cuda.LAUNCHES)
        assert codec_cuda.LAUNCHES["codec_quantize"] == int(not fused), (mode, codec_cuda.LAUNCHES)
    assert _bits_equal(got["fused"].packed, got["staged"].packed)
    assert _bits_equal(got["fused"].meta, got["staged"].meta)
    with pytest.raises(NotImplementedError, match="stochastic"):
        codec_cuda.matmul_quantize_chunks(torch.randn(64, 128, device=dev),
                                          torch.randn(64, 128, device=dev), 2, 4, 512)


# ---------------------------------------------------------------------------
# Sub-f32 wire dtypes: B1/B5 and B7a read a bf16 or f16 input, B3, B7c and
# B4 a bf16 or f16 raw own row, inside the kernels; B3 and B7c round the
# folded chunk through the wire dtype before the requantize. Each against
# its plain version on the card's tensors (NaN payloads and conversions as
# the card does them), bit for bit, at every width, within and past the
# register budget, in every lowering, round to nearest and stochastic.
# ---------------------------------------------------------------------------

SUBF32 = [torch.bfloat16, torch.float16]


def _wire_operands(n: int, bucket: int, bits: int, dtype: torch.dtype):
    """normal, adversarial and special data in ``dtype`` (f16 takes the
    adversarial ranges' overflow as inf, which both versions see alike).
    Values below the dtype's range become zeros of their sign, so a bucket
    can end up holding +0 and -0 as its extreme, whose sign is undefined
    (torch.amax and the kernels may take either; ``_specials`` keeps its
    f32 buckets free of such extremes): in a bucket holding both, the -0
    become +0."""
    out = []
    for x in _operands(n, bucket, bits):
        t = torch.from_numpy(x).to(dtype)
        b = t.view(-1, bucket)
        neg = (b == 0) & torch.signbit(b)
        both = (neg.any(dim=1) & ((b == 0) & ~torch.signbit(b)).any(dim=1))[:, None]
        b[neg & both] = 0.0
        out.append(t)
    return out


@pytest.mark.parametrize("bucket", [96, 128, 512, 1760, 4096, 16384])
@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("dtype", SUBF32, ids=["bf16", "f16"])
def test_subf32_quantize_matches_plain(dev, dtype, bits, bucket):
    """B1 and B7a on a bf16 or f16 input at every width, at buckets of 1-8
    CTAs a chunk and past the register budget, in every lowering, round to
    nearest and stochastic, on normal, adversarial and special data: one
    launch a call, the plain version's bytes, B7a's equal to B1's."""
    for x in _wire_operands(3 * 32 * bucket, bucket, bits, dtype):
        x = x.to(dev)
        for enc, pack in _lowerings():
            for seed in (None, SR_SEED):
                codec_cuda.reset_launch_counts()
                w, m = codec_cuda.quantize_chunks(x, bits, bucket, encode=enc, pack=pack, seed=seed)
                dw, dm = codec_cuda.quantize_chunks_db(x, bits, bucket, 1, encode=enc, pack=pack,
                                                       seed=seed)
                torch.cuda.synchronize()
                assert codec_cuda.LAUNCHES["codec_quantize"] == 1
                assert codec_cuda.LAUNCHES["codec_quantize_db"] == 1
                pw, pm = codec_cuda.quantize_chunks_plain(x, bits, bucket, encode=enc, seed=seed)
                assert _bits_equal(w, pw) and _bits_equal(m, pm), (enc, pack, seed)
                assert _bits_equal(dw, pw) and _bits_equal(dm, pm), (enc, pack, seed)


@pytest.mark.parametrize("bucket", [128, 512, 1760, 8192])
@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("dtype", SUBF32, ids=["bf16", "f16"])
def test_subf32_epilogue_matches_plain(dev, dtype, bits, bucket):
    """B3 and B7c in a bf16 or f16 wire dtype at ws 1, 4 and 8, without the
    raw row and with it (in the wire dtype) at row 0 and in the middle, in
    every lowering, round to nearest and stochastic; row 0 adversarial, row
    1 special: the plain version's bytes, B7c's equal to B3's."""
    n = 3 * 32 * bucket
    normal, adversarial, special = _wire_operands(n, bucket, bits, dtype)
    for ws, owns in ((1, [None, 0]), (4, [None, 0, 2]), (8, [None, 5])):
        rows = torch.stack([(normal.float() * (r + 1)).to(dtype) for r in range(ws)])
        rows[0] = adversarial
        if ws > 1:
            rows[1] = special
        rows = rows.to(dev)
        q = codec_cuda.quantize_batch(rows, bits, bucket)
        meta = q.meta.float()
        for own in owns:
            raw, o = (None, -1) if own is None else (rows[own], own)
            for enc, pack in _lowerings():
                for seed in (None, SR_SEED):
                    kw = dict(cast_dtype=dtype, encode=enc, pack=pack, seed=seed)
                    w, m = codec_cuda.sra_epilogue_chunks(q.packed, meta, raw, o, bits, bucket, **kw)
                    dw, dm = codec_cuda.sra_epilogue_chunks_db(q.packed, meta, raw, o, bits, bucket,
                                                               1, **kw)
                    pw, pm = codec_cuda.sra_epilogue_chunks_plain(
                        q.packed, meta, raw, o, bits, bucket, dtype, enc, seed=seed)
                    assert _bits_equal(w, pw) and _bits_equal(m, pm), (ws, own, enc, pack, seed)
                    assert _bits_equal(dw, pw) and _bits_equal(dm, pm), (ws, own, enc, pack, seed)


@pytest.mark.parametrize("bucket,chunks", [(512, 18), (544, 300), (1760, 144), (16384, 5)])
@pytest.mark.parametrize("dtype", SUBF32, ids=["bf16", "f16"])
def test_subf32_geometries_tiles_and_rings(dev, dtype, bucket, chunks):
    """Every cluster size the bucket takes and the wrappers' geometry past
    the register budget, forced, tiles of one and two chunks (where two
    divide them), ring depths 1-8 of B7a (slots of 32 x T 16-bit values)
    and B7c, both packs, round to nearest and stochastic: the bytes do not
    move."""
    n = chunks * 32 * bucket
    rng = np.random.default_rng(bucket)
    rows = torch.from_numpy(np.stack([rng.standard_normal(n).astype(np.float32) * (r + 1)
                                      for r in range(4)])).to(dtype).to(dev)
    q = codec_cuda.quantize_batch(rows, 4, bucket)
    meta = q.meta.float()
    geoms = set(codec_cuda.cluster_geometries(bucket)) | {
        codec_cuda.cluster_geometry(chunks, bucket, 4), codec_cuda.db_geometry(chunks, bucket, 4)}
    for seed in (None, SR_SEED):
        pw, pm = codec_cuda.quantize_chunks_plain(rows[0], 4, bucket, seed=seed)
        ew, em = codec_cuda.sra_epilogue_chunks_plain(q.packed, meta, rows[2], 2, 4, bucket, dtype,
                                                      seed=seed)
        for g in geoms:
            w, m = codec_cuda._launch_quantize(rows[0], 4, bucket, "div", "sum", g, seed=seed)
            assert _bits_equal(w, pw) and _bits_equal(m, pm), (g, seed)
            w, m = codec_cuda._launch_epilogue(q.packed, meta, rows[2], 2, 4, bucket, "div", "sum", g,
                                               seed=seed, cast_dtype=dtype)
            assert _bits_equal(w, ew) and _bits_equal(m, em), (g, seed)
            if (bucket // g.k) % g.threads:
                continue
            for tc in (t for t in (1, 2) if chunks % t == 0):  # a tile divides the chunks
                for slots in (1, 2, 4, 8):
                    for pack in codec_cuda.PACKS:
                        if (codec_cuda.DB_BAR_BYTES + slots * 64 * g.threads + 128 * g.threads
                                + codec_cuda.DB_CLUSTER_STATIC_BYTES <= codec_cuda.SMEM_BLOCK_BYTES):
                            w, m = codec_cuda._launch_quantize_db(rows[0], 4, bucket, tc, "div",
                                                                  pack, g, slots, seed=seed)
                            assert _bits_equal(w, pw) and _bits_equal(m, pm), (g, tc, slots, pack)
                        w, m = codec_cuda._launch_epilogue_db(q.packed, meta, rows[2], 2, 4, bucket,
                                                              tc, "div", pack, g, slots, seed=seed,
                                                              cast_dtype=dtype)
                        assert _bits_equal(w, ew) and _bits_equal(m, em), (g, tc, slots, pack)


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 11])
@pytest.mark.parametrize("dtype", SUBF32, ids=["bf16", "f16"])
def test_subf32_reduce_rows_every_row_count_and_width(dev, dtype, rows, bits):
    """B4 with a bf16 or f16 raw own row at each templated row count and a
    generic one, in every position, at both widths: the plain version's
    bytes."""
    x, words, meta = _reduce_operands(dev, rows, 3, bits, 128, 100 * rows + bits)
    x = x.to(dtype)
    for own in range(rows):
        got, scalar = _reduce_both_widths(words, meta, x[own], own, bits, 128)
        want = codec_cuda.reduce_rows_chunks_plain(words, meta, x[own], own, bits, 128)
        assert _bits_equal(got, want) and _bits_equal(scalar, want), own


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("dtype", SUBF32, ids=["bf16", "f16"])
def test_subf32_reduce_rows_alignment_by_element_count(dev, dtype, offset):
    """A 16-bit raw row is read four values (8 bytes) a load at full width:
    views 0 and 4 values past an aligned start take it, 1 and 2 values past
    take the scalar width (counted in REDUCE_SCALAR); every result the plain
    version's; special values in the raw row."""
    rows, own = 4, 2
    x, words, meta = _reduce_operands(dev, rows, 3, 4, 512, 40 + offset)
    raw_val = torch.from_numpy(_specials(x.shape[1], 512, offset)).to(dtype).to(dev)
    buf = torch.empty(x.shape[1] + 8, dtype=dtype, device=dev)
    buf[offset:offset + x.shape[1]] = raw_val
    raw = buf[offset:offset + x.shape[1]]
    want = codec_cuda.reduce_rows_chunks_plain(words, meta, raw, own, 4, 512)
    codec_cuda.reset_launch_counts()
    got = codec_cuda.reduce_rows_chunks(words, meta, raw, own, 4, 512)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_reduce_rows"] == 1
    assert codec_cuda.REDUCE_SCALAR["launches"] == int(offset % 4 != 0)
    assert _bits_equal(got, want)
    if offset % 4:
        with pytest.raises(RuntimeError, match="codec_reduce_rows"):
            codec_cuda._launch_reduce(words, meta, raw, own, 4, 512, torch.empty_like(want), 4)


@pytest.mark.parametrize("dtype", SUBF32, ids=["bf16", "f16"])
def test_subf32_batch_functions_match_the_plain_path(dev, dtype, monkeypatch):
    """The batch functions on a bf16 or f16 buffer with a dense tail, a
    residual, a sub-f32 accumulator and the fused epilogue and reduce with
    a raw row in the wire dtype, on the card and through the plain versions
    on the CPU: bit for bit; the meta in the tensor's dtype; the kernels
    read the 16-bit operands themselves (no launch sees an f32 copy)."""
    monkeypatch.setenv("CGX_SRA_EPILOGUE_MIN_ELEMS", "0")
    cc = CompressionConfig(bits=4, bucket_size=512)
    rng = np.random.default_rng(5)
    n = 32 * 512 + 26 * 512 + 100
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32)).to(dtype)
    acc = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32)).to(dtype)
    q = codec_cuda.quantize_batch(x.to(dev), 4, 512)
    qc = codec_cuda.quantize_batch(x, 4, 512)
    assert q.meta.dtype == dtype and _bits_equal(q.packed, qc.packed) and _bits_equal(q.meta, qc.meta)
    assert _bits_equal(codec_cuda.dequantize_batch(q, add_to=acc.to(dev)),
                       codec_cuda.dequantize_batch(qc, add_to=acc))
    rows = torch.from_numpy(rng.standard_normal((4, 4 * 32 * 512)).astype(np.float32)).to(dtype)
    for seed in (None, SR_SEED):
        qd, qh = dispatch.quantize_batch(rows.to(dev), cc), dispatch.quantize_batch(rows, cc)
        assert codec_cuda.supports_reduce(qd)
        got = codec_cuda.sra_epilogue_batch(qd, raw_row=rows[1].to(dev), own_idx=1, out_dtype=dtype,
                                            seed=seed)
        want = codec_cuda.sra_epilogue_batch(qh, raw_row=rows[1], own_idx=1, out_dtype=dtype,
                                             seed=seed)
        assert got.meta.dtype == dtype
        assert _bits_equal(got.packed, want.packed) and _bits_equal(got.meta, want.meta), seed
        assert _bits_equal(codec_cuda.reduce_rows_batch(qd, raw_row=rows[3].to(dev), own_idx=3),
                           codec_cuda.reduce_rows_batch(qh, raw_row=rows[3], own_idx=3))


def test_subf32_refusals(dev):
    """Another dtype raises ValueError naming it; an epilogue's raw row in
    another dtype than the wire dtype is refused on the card; the
    matmul-quantize (B8) refuses operands of two dtypes."""
    x = torch.randn(32 * 512, device=dev)
    with pytest.raises(ValueError, match="float64"):
        codec_cuda.quantize_chunks(x.double(), 4, 512)
    with pytest.raises(ValueError, match="float64"):
        codec_cuda.reduce_rows_chunks(torch.zeros(2, 4 * 512, dtype=torch.int32, device=dev),
                                      torch.zeros(2, 32, 2, device=dev), x.double(), 0, 4, 512)
    q = codec_cuda.quantize_batch(torch.stack([x, x]).to(torch.bfloat16), 4, 512)
    with pytest.raises(ValueError, match="wire dtype"):
        codec_cuda.sra_epilogue_chunks(q.packed, q.meta.float(), x, 0, 4, 512,
                                       cast_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int8"):
        codec_cuda.sra_epilogue_chunks(q.packed, q.meta.float(), None, -1, 4, 512,
                                       cast_dtype=torch.int8)
    with pytest.raises(TypeError, match="one dtype"):
        codec_cuda.matmul_quantize_chunks(torch.randn(64, 128, device=dev).bfloat16(),
                                          torch.randn(64, 128, device=dev), 2, 4, 512)


def test_tiny_bf16_param_step_runs_the_kernels(dev, monkeypatch):
    """GPT-2 tiny with its parameters cast to bf16 on the card: one gradient
    sync of the bf16 tree bit-identical to the plain versions' on the CPU,
    the quantize and epilogue kernels launched on bf16 operands, finite
    losses over three steps."""
    for k, v in {
        "CGX_DEBUG_FORCE_CODEC": "1", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
        "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STANDALONE_LAYER_ELEMS": "40000",
        "CGX_SRA_EPILOGUE_MIN_ELEMS": "0",
    }.items():
        monkeypatch.setenv(k, v)
    model = GPT2(GPT2Config.tiny(), device=dev,
                 generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tokens = torch.randint(0, 512, (2, 64), generator=torch.Generator().manual_seed(1))
    lm_loss(model(tokens.to(dev)), tokens.to(dev)).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.bfloat16}
    codec_cuda.reset_launch_counts()
    synced = gradient_sync(grads)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES["codec_quantize"] > 0 and codec_cuda.LAUNCHES["codec_sra_epilogue"] > 0
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    plain = gradient_sync({k: v.cpu() for k, v in grads.items()})
    monkeypatch.delenv("CGX_SRA_EPILOGUE")
    for k in grads:
        assert synced[k].dtype == torch.bfloat16 and _bits_equal(synced[k], plain[k]), k
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device=dev)
    losses = [float(step(tokens)) for _ in range(3)]
    assert np.all(np.isfinite(losses)), losses


def test_f32_instances_keep_their_registers(dev):
    """The f32 instances' registers and spills equal those of the source
    before the 16-bit instances existed (``csrc/ptxas_f32.json``, written
    by ``tools/ptxas_table.py``): the 16-bit instances add code beside
    them, not to them. B9's instances on B1's cluster body are in the
    table. Uses this process's build report, or builds anew."""
    import json
    from pathlib import Path

    from torch_cgx_tpu_torch.tools import ptxas_table

    if "ptxas" not in codec_cuda.BUILD_LOG:
        codec_cuda.build(force=True)
    table = codec_cuda.ptxas_instances(codec_cuda.BUILD_LOG["ptxas"])
    baseline = json.loads((Path(codec_cuda.SOURCE).parent / "ptxas_f32.json").read_text())
    assert len(baseline) > 700
    assert ptxas_table.compare(table, baseline) == []
    # B8's 16-bit instances: 8 bits x 4 lowerings on the FFMA kernel, and
    # x 2 formats on the tensor-core kernel.
    assert sum(k.endswith(":16") for k in table) == 4 * 128 + 80 + 32 + 64
    assert sum(k.startswith("cgx_matmul_quantize_tc_kernel<") for k in table) == 64
    # B8's float32 operands on the tensor cores: 8 bits x 4 lowerings, and
    # the split pass; outside the f32 table.
    assert sum(k.startswith("cgx_matmul_quantize_tf32_kernel<") for k in table) == 32
    assert "cgx_tf32_split_kernel" in table
    # B9 on B1's cluster body: 8 bits x 3 variants x REREAD, inside the f32
    # table.
    assert sum(k.startswith("cgx_quantize_variant_cluster_kernel<") for k in baseline) == 48
    assert not any(k.startswith("cgx_quantize_variant_kernel<") for k in table)


# ---------------------------------------------------------------------------
# The int8 fold (CGX_SRA_ACCUM=int8): B3, B7c and B4's int8 instances (a
# library of their own, codec_cuda.build_int8) against their plain versions
# run on the card's tensors, bit for bit: every width, ws 1-8 and 11, the
# raw row in every place and none, every lowering, round to nearest and
# stochastic, f32 and 16-bit wire dtypes, buckets inside and past the
# register budget and past the old epilogue gate (2,048-16,384), every
# cluster size, tile and ring depth, B4 at both widths.
# ---------------------------------------------------------------------------


def _int8_rows(ws: int, n: int, bucket: int, bits: int, dtype=torch.float32):
    """ws rows of normal data at different scales, row 0 adversarial (tiny,
    huge and constant buckets: the int8 scales' edges), row 1 special (NaN,
    +-inf, +-0, subnormals)."""
    if dtype == torch.float32:
        normal, adversarial, special = (torch.from_numpy(x) for x in _operands(n, bucket, bits))
    else:
        normal, adversarial, special = _wire_operands(n, bucket, bits, dtype)
    rows = torch.stack([(normal.float() * (r + 1)).to(dtype) for r in range(ws)])
    rows[0] = adversarial
    if ws > 1:
        rows[1] = special
    return rows


@pytest.mark.parametrize("bucket", [128, 512, 1760, 2048, 8192])
@pytest.mark.parametrize("bits", range(1, 9))
def test_int8_epilogue_matches_plain(dev, bits, bucket):
    """B3 and B7c's int8 instances at every width, ws 1, 4 and 8, the raw
    row none, first and in the middle, every lowering, round to nearest and
    stochastic: one launch each, counted in INT8_LAUNCHES, the plain int8
    fold's bytes."""
    n = 3 * 32 * bucket
    for ws, owns in ((1, [None, 0]), (4, [None, 0, 2]), (8, [None, 5])):
        rows = _int8_rows(ws, n, bucket, bits).to(dev)
        q = codec_cuda.quantize_batch(rows, bits, bucket)
        for own in owns:
            raw, o = (None, -1) if own is None else (rows[own], own)
            for enc, pack in _lowerings():
                for seed in (None, SR_SEED):
                    kw = dict(encode=enc, pack=pack, seed=seed, accum="int8")
                    codec_cuda.reset_launch_counts()
                    w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, o, bits, bucket, **kw)
                    dw, dm = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, raw, o, bits, bucket,
                                                               1, **kw)
                    torch.cuda.synchronize()
                    assert codec_cuda.INT8_LAUNCHES == {
                        "codec_sra_epilogue": 1, "codec_sra_epilogue_db": 1, "codec_reduce_rows": 0}
                    pw, pm = codec_cuda.sra_epilogue_chunks_plain(
                        q.packed, q.meta, raw, o, bits, bucket, encode=enc, seed=seed, accum="int8")
                    assert _bits_equal(w, pw) and _bits_equal(m, pm), (ws, own, enc, pack, seed)
                    assert _bits_equal(dw, pw) and _bits_equal(dm, pm), (ws, own, enc, pack, seed)


def _meta_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Meta bit for bit, but a zero min of either sign: a bucket whose
    folded values hold zeros of both signs as its least has no defined
    min sign (torch.amin and the kernels may take either; the words do not
    depend on it)."""
    a, b = a.cpu().reshape(-1, 2), b.cpu().reshape(-1, 2)
    both_zero = (a[:, 1] == 0) & (b[:, 1] == 0)
    a, b = a.clone(), b.clone()
    a[both_zero, 1] = 0.0
    b[both_zero, 1] = 0.0
    return _bits_equal(a, b)


@pytest.mark.parametrize("bucket", [128, 1760, 4096])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("dtype", SUBF32, ids=["bf16", "f16"])
def test_int8_epilogue_subf32_matches_plain(dev, dtype, bits, bucket):
    """The 16-bit int8 instances of B3 and B7c: the raw row in the wire
    dtype, the folded chunk rounded through it, both roundings. In the
    adversarial row's tiny buckets (U below 2^12 / FLT_MAX: the scales
    saturate, the step is subnormal) the fold's tiny values of both signs
    round to zeros of both signs in the wire dtype, so a zero min's sign
    is free there (``_meta_equal``); everything else bit for bit."""
    n = 3 * 32 * bucket
    for ws, owns in ((1, [None, 0]), (4, [None, 2])):
        rows = _int8_rows(ws, n, bucket, bits, dtype).to(dev)
        q = codec_cuda.quantize_batch(rows, bits, bucket)
        meta = q.meta.float()
        for own in owns:
            raw, o = (None, -1) if own is None else (rows[own], own)
            for seed in (None, SR_SEED):
                kw = dict(cast_dtype=dtype, seed=seed, accum="int8")
                w, m = codec_cuda.sra_epilogue_chunks(q.packed, meta, raw, o, bits, bucket, **kw)
                dw, dm = codec_cuda.sra_epilogue_chunks_db(q.packed, meta, raw, o, bits, bucket, 1,
                                                           **kw)
                pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, meta, raw, o, bits, bucket,
                                                              dtype, seed=seed, accum="int8")
                assert _bits_equal(w, pw) and _meta_equal(m, pm), (ws, own, seed)
                assert _bits_equal(dw, pw) and _meta_equal(dm, pm), (ws, own, seed)


@pytest.mark.parametrize("bucket,chunks", [(512, 18), (544, 300), (1760, 144), (16384, 5)])
def test_int8_geometries_tiles_and_rings(dev, bucket, chunks):
    """Every cluster size the bucket takes and the wrappers' geometry,
    forced, for B3 and B7c (tiles of one and two chunks, ring depths 1-8,
    both packs) in the int8 fold: the bytes do not move."""
    n = chunks * 32 * bucket
    rng = np.random.default_rng(bucket)
    rows = torch.from_numpy(np.stack([rng.standard_normal(n).astype(np.float32) * (r + 1)
                                      for r in range(4)])).to(dev)
    q = codec_cuda.quantize_batch(rows, 4, bucket)
    ew, em = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, rows[2], 2, 4, bucket,
                                                  accum="int8")
    geoms = codec_cuda.cluster_geometries(bucket) or [codec_cuda.cluster_geometry(chunks, bucket, 4)]
    for g in geoms:
        w, m = codec_cuda._launch_epilogue(q.packed, q.meta, rows[2], 2, 4, bucket, "div", "sum", g,
                                           accum="int8")
        assert _bits_equal(w, ew) and _bits_equal(m, em), g
    dg = codec_cuda.db_geometry(chunks, bucket, 4)
    for tc in [t for t in (1, 2) if chunks % t == 0]:
        for slots in (1, 2, 4, 8):
            for pack in codec_cuda.PACKS:
                w, m = codec_cuda._launch_epilogue_db(q.packed, q.meta, rows[2], 2, 4, bucket, tc,
                                                      "div", pack, dg, slots=slots, accum="int8")
                assert _bits_equal(w, ew) and _bits_equal(m, em), (tc, slots, pack)


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 8, 11])
def test_int8_reduce_rows_matches_plain(dev, rows, bits):
    """B4's int8 instance (the any-count one) at every width and row count,
    full and scalar width, the raw own row (f32, bf16, f16) first, last and
    none: the plain int8 fold's values, bit for bit."""
    bucket, n = 512, 3 * 32 * 512
    x = _int8_rows(rows, n, bucket, bits).to(dev)
    q = codec_cuda.quantize_batch(x, bits, bucket)
    for own in sorted({None, 0, rows - 1}, key=lambda o: -1 if o is None else o):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            if own is None and dtype != torch.float32:
                continue
            raw, o = (None, -1) if own is None else (x[own].to(dtype), own)
            want = codec_cuda.reduce_rows_chunks_plain(q.packed, q.meta, raw, o, bits, bucket,
                                                       accum="int8")
            for vec in (4, 1):
                out = torch.empty(n, device=dev)
                got = codec_cuda._launch_reduce(q.packed, q.meta, raw, o, bits, bucket, out, vec,
                                                accum="int8")
                assert _bits_equal(got, want), (own, dtype, vec)


@pytest.mark.parametrize("ws,bucket", [(2, 2048), (8, 2048), (4, 4096), (4, 8192), (2, 16384)])
def test_int8_batch_functions_past_the_old_gate(dev, ws, bucket, monkeypatch):
    """Buckets of 2,048-16,384 within the JAX package's block budget
    (ws x 32 x B <= 2^20): the dispatcher fuses the epilogue (B3, and
    under CGX_PALLAS_DB=on B7c) and the reduce (B4), under both folds, and
    each equals its plain version on the CPU (the int8 fold's too)."""
    n = 2 * 32 * bucket
    rows = torch.from_numpy(np.random.default_rng(bucket).standard_normal((ws, n)).astype(np.float32))
    cc = CompressionConfig(bits=4, bucket_size=bucket)
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    for accum in ("exact", "int8"):
        monkeypatch.setenv("CGX_SRA_ACCUM", accum)
        for db in ("off", "on"):
            monkeypatch.setenv("CGX_PALLAS_DB", db)
            q = dispatch.quantize_batch(rows.to(dev), cc)
            assert dispatch.fused_epilogue_would_run(q) and dispatch.fused_reduce_would_run(q)
            codec_cuda.reset_launch_counts()
            e = dispatch.reduce_rows_requantize(q, cc, raw_rows=rows.to(dev), own_idx=ws - 1)
            r = dispatch.reduce_rows(q, raw_rows=rows.to(dev), own_idx=0)
            torch.cuda.synchronize()
            kernel = "codec_sra_epilogue_db" if db == "on" else "codec_sra_epilogue"
            assert codec_cuda.LAUNCHES[kernel] == 1 and codec_cuda.LAUNCHES["codec_reduce_rows"] == 1
            assert sum(codec_cuda.INT8_LAUNCHES.values()) == (2 if accum == "int8" else 0)
            qc = dispatch.quantize_batch(rows, cc)
            pe = dispatch.reduce_rows_requantize(qc, cc, raw_rows=rows, own_idx=ws - 1)
            pr = dispatch.reduce_rows(qc, raw_rows=rows, own_idx=0)
            assert _bits_equal(e.packed, pe.packed) and _bits_equal(e.meta, pe.meta), (accum, db)
            assert _bits_equal(r, pr), (accum, db)


def test_int8_world_size_one_equals_exact(dev):
    """One row, no raw row (the world-size-1 proxy's epilogue): every scale
    is 2^12, so the int8 fold gives the exact fold's bytes, on the card as
    in the plain version."""
    for bucket in (512, 2048):
        x = torch.from_numpy(np.random.default_rng(bucket).standard_normal(
            (1, 5 * 32 * bucket)).astype(np.float32)).to(dev)
        q = codec_cuda.quantize_batch(x, 4, bucket)
        for db in (False, True):
            run = (functools.partial(codec_cuda.sra_epilogue_chunks_db, tc=1) if db
                   else codec_cuda.sra_epilogue_chunks)
            w8, m8 = run(q.packed, q.meta, None, -1, 4, bucket, accum="int8")
            we, me = run(q.packed, q.meta, None, -1, 4, bucket, accum="exact")
            assert _bits_equal(w8, we) and _bits_equal(m8, me), (bucket, db)


def test_int8_library_instances(dev):
    """The int8 library holds the int8 instances alone: B3 and B7c 128 each
    at f32 and 128 each at 16 bits (every bits x lowering x REREAD x
    rounding), B4 the any-count instance at both widths (8 x 2 with an f32
    raw row or none, 8 x 2 with a 16-bit one); none in the default
    library."""
    codec_cuda._lib_int8()
    if "ptxas" not in codec_cuda.INT8_BUILD_LOG:
        codec_cuda.build_int8(force=True)
    table = codec_cuda.ptxas_instances(codec_cuda.INT8_BUILD_LOG["ptxas"])
    assert all(":int8" in k for k in table), [k for k in table if ":int8" not in k][:5]
    for kernel in ("cgx_sra_epilogue_cluster_kernel", "cgx_sra_epilogue_db_cluster_kernel"):
        for wire16 in (False, True):
            mine = [k for k in table if k.startswith(kernel + "<") and k.endswith(":16") == wire16]
            assert len(mine) == 128, (kernel, wire16, len(mine))
    b4 = [k for k in table if k.startswith("cgx_reduce_rows_kernel<")]
    assert len(b4) == 48 and all(k.split("<")[1].split(",")[1] == "0" for k in b4), b4[:5]
    if "ptxas" in codec_cuda.BUILD_LOG:
        assert not any(":int8" in k for k in codec_cuda.ptxas_instances(codec_cuda.BUILD_LOG["ptxas"]))


# ---------------------------------------------------------------------------
# Error feedback's round trip: the ``*_with_wire`` reducers through
# ``allreduce_flat(..., return_roundtrip=True)`` on four gloo ranks sharing
# the card, against the same reducers on the CPU tensors (the plain
# versions, fused lowering) over the same group.
# ---------------------------------------------------------------------------

WIRE_WS = 4
WIRE_CASES = {
    "sra": ({}, False),
    "alltoall": ({"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1"}, False),
    "ring": ({"CGX_INNER_REDUCTION_TYPE": "RING"}, False),
    "two_level_leader": ({}, True),
    "two_level_two_pass": ({"CGX_INTRA_BROADCAST": "0"}, True),
}


def _wire_rank(rank, store, result_q):
    import os
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    from torch_cgx_tpu_torch.parallel import allreduce_flat, hierarchical_groups
    from torch_cgx_tpu_torch.utils import prng

    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    out = {}
    try:
        timeout = timedelta(seconds=120)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=WIRE_WS, timeout=timeout)
        tl = hierarchical_groups(intra_size=2, timeout=timeout)
        dev = torch.device("cuda", 0)
        n = WIRE_WS * (3 * 32 + 5) * 512 + 77  # chunks, tail buckets, a partial bucket
        x32 = torch.from_numpy(np.random.default_rng(rank).standard_normal(n).astype(np.float32))
        for name, (knobs, two) in WIRE_CASES.items():
            for dtype in (torch.float32, torch.bfloat16):
                for stochastic in (False, True):
                    os.environ.update({"CGX_SRA_EPILOGUE": "fused", **knobs})
                    if stochastic:
                        os.environ["CGX_STOCHASTIC_ROUNDING"] = "1"
                    cc = CompressionConfig(bits=4, bucket_size=512, stochastic=stochastic)
                    key = prng.key(5) if stochastic else None
                    group = tl if two else None
                    x = x32.to(dtype)
                    codec_cuda.reset_launch_counts()
                    card, card_rt = allreduce_flat(x.to(dev), cc, group=group, key=key,
                                                   return_roundtrip=True)
                    torch.cuda.synchronize()
                    launches = sum(codec_cuda.LAUNCHES.values())
                    plain, plain_rt = allreduce_flat(x, cc, group=group, key=key,
                                                     return_roundtrip=True)
                    out[(name, str(dtype), stochastic)] = (
                        _bits_equal(card, plain), _bits_equal(card_rt, plain_rt),
                        launches, not _bits_equal(card_rt, x),
                    )
                    for k in list(knobs) + ["CGX_SRA_EPILOGUE", "CGX_STOCHASTIC_ROUNDING"]:
                        os.environ.pop(k, None)
        dist.barrier()
    except Exception:  # reported to the parent, which fails the test
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


@pytest.fixture(scope="module")
def wire_world(tmp_path_factory):
    import multiprocessing as mp
    import queue
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    codec_cuda._lib()  # built once here, before the ranks load it
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    store = str(tmp_path_factory.mktemp("wire_world") / "store")
    procs = [ctx.Process(target=_wire_rank, args=(r, store, result_q)) for r in range(WIRE_WS)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + 300
    try:
        while len(results) < WIRE_WS and time.monotonic() < deadline:
            try:
                r, out = result_q.get(timeout=2.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            results[r] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert len(results) == WIRE_WS, f"only ranks {sorted(results)} reported"
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    assert not errors, "\n".join(f"rank {r}:\n{e}" for r, e in errors.items())
    return [results[r] for r in range(WIRE_WS)]


@pytest.mark.parametrize("stochastic", [False, True], ids=["nearest", "stochastic"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("name", list(WIRE_CASES))
def test_roundtrip_reducers_match_plain(wire_world, name, dtype, stochastic):
    """``(reduced, rt)`` of the flat SRA, all-to-all and Ring and of the
    two-level scheme with and without the leader scheme, on the card
    against the plain versions, bit for bit, on every rank; the kernels
    launched and the round trip moved the values."""
    for r, o in enumerate(wire_world):
        same, same_rt, launches, moved = o[(name, dtype, stochastic)]
        assert same and same_rt, (r, same, same_rt)
        assert launches > 0 and moved, (r, launches)


# ---------------------------------------------------------------------------
# The pipelined SRA (CGX_SCHEDULE=on, parallel/schedule.py): each column
# block's quantize (B1), epilogue (B3) and decode (B2) on the card against
# the plain versions, in one process (a one-rank world, the schedule built
# by hand: compiled_schedule plans none at ws 1) and on two gloo ranks
# sharing the card.
# ---------------------------------------------------------------------------


def test_column_block_quantize_equals_contiguous(dev):
    """A column block of the (ws, chunk) rows, copied (``block_rows``) or
    handed over strided, quantizes to the same bytes as the same values
    made contiguous from scratch, and as the plain version."""
    from torch_cgx_tpu_torch.parallel import schedule

    ws, chunk, bucket = 4, 27 * 32 * 512, 512
    xs = torch.randn(ws, chunk, device=dev)
    for off, w in schedule.chunk_table(chunk, 4, bucket):
        fresh = torch.tensor(xs[:, off : off + w].cpu().numpy(), device=dev)
        want = codec_cuda.quantize_batch(fresh, 4, bucket)
        for got in (codec_cuda.quantize_batch(schedule.block_rows(xs, off, w), 4, bucket),
                    codec_cuda.quantize_batch(xs[:, off : off + w], 4, bucket)):
            assert _bits_equal(got.packed, want.packed) and _bits_equal(got.meta, want.meta), (off, w)
        plain = dispatch.quantize_batch(fresh.cpu(), CompressionConfig(bits=4, bucket_size=bucket))
        assert _bits_equal(want.packed, plain.packed) and _bits_equal(want.meta, plain.meta), (off, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bucket,chunks,n", [(512, 4, 16 * 32 * 512), (128, 7, 8 * 32 * 512 - 37)],
                         ids=["whole_chunks", "tails"])
def test_pipelined_sra_ws1_matches_plain(dev, monkeypatch, bucket, chunks, n, dtype):
    """The pipeline at world size 1 (the own row alone, raw): output and
    round trip on the card bit-identical to the plain versions on the CPU
    and to the monolithic SRA on the card. Blocks of whole chunks launch
    one B1, B3 and B2 each and one more B2 for the round trip; blocks with
    tails fold staged (B2, then B1). Under ``CGX_DEBUG_FORCE_CODEC`` the
    sync of one rank runs its proxy, never the pipeline, under ``on``."""
    from torch_cgx_tpu_torch.parallel import reducers, schedule

    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    cc = CompressionConfig(bits=4, bucket_size=bucket)
    chunk = reducers.chunk_layout(n, 1)[0]
    sched = schedule.CompiledSchedule(table=schedule.chunk_table(chunk, chunks, bucket), n=n, ws=1,
                                      chunk=chunk, cc=cc)
    assert sched.depth == chunks
    x = torch.randn(n, generator=torch.Generator().manual_seed(3)).to(dtype)
    codec_cuda.reset_launch_counts()
    card, card_rt = schedule.pipelined_quantized_allreduce(x.to(dev), None, 1, cc, "SRA", None, sched,
                                                           with_wire=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in codec_cuda.LAUNCHES.items() if v}
    plain, plain_rt = schedule.pipelined_quantized_allreduce(x, None, 1, cc, "SRA", None, sched,
                                                             with_wire=True)
    assert _bits_equal(card, plain) and _bits_equal(card_rt, plain_rt)
    assert _bits_equal(card, reducers.sra_allreduce(x.to(dev), None, 1, cc))
    if n % (32 * bucket) == 0:
        assert launches == {"codec_quantize": chunks, "codec_sra_epilogue": chunks,
                            "codec_dequantize": 2 * chunks}, launches
    else:
        assert launches == {"codec_quantize": 2 * chunks, "codec_dequantize": 3 * chunks}, launches
    monkeypatch.setenv("CGX_SCHEDULE", "on")
    monkeypatch.setenv("CGX_DEBUG_FORCE_CODEC", "1")
    schedule.reset_counts()
    got = gradient_sync({"w.kernel": x.to(dev).view(-1, 1)}, average=False)["w.kernel"]
    assert schedule.COUNTS["pipelined_slices"] == 0
    want = gradient_sync({"w.kernel": x.view(-1, 1)}, average=False)["w.kernel"]
    assert _bits_equal(got, want)


# The step planner's block shapes on GPT-2 124M at ws 4 (CGX_PLANNER=on,
# the default model, and CGX_PLANNER_AVG_BITS=3.5): (ws, block width, bits).
PLANNED_BLOCKS = {
    # A depth-16 block of a 64 MB wte slice: ws x w is exactly the fused
    # epilogue's 2^20-value gate, so B3 runs.
    "wte_depth16": (4, 262_144, 4),
    # The tail slice's last depth-8 block, which takes the remainder, and
    # the attention projection group's at 3 bits.
    "wte_tail_depth8": (4, 160_448, 4),
    "proj_3bit_depth8": (4, 245_760, 3),
    # The MLP slices' depth-4 blocks at 3 bits, the first QKV slice's at 5.
    "mlp_3bit": (4, 147_456, 3),
    "qkv_5bit": (4, 110_592, 5),
}


@pytest.mark.parametrize("name", list(PLANNED_BLOCKS))
def test_planned_block_shapes_match_plain(dev, monkeypatch, name):
    """One planned block's stage-1 quantize (B1), fold and requantize (B3
    at and above the 2^20-value gate, the staged B2 + B1 below it) and
    decode (B2) on the card against the plain versions on the CPU, bit for
    bit; the fused epilogue runs exactly where ws x w >= 2^20."""
    from torch_cgx_tpu_torch.parallel import reducers

    ws, w, bits = PLANNED_BLOCKS[name]
    cc = CompressionConfig(bits=bits, bucket_size=512)
    g = torch.Generator().manual_seed(w + bits)
    xs = torch.randn(ws, w, generator=g)
    peers = torch.randn(ws, w, generator=g) * 3.0
    codec_cuda.reset_launch_counts()
    q = reducers._quantize_rows(peers.to(dev), cc)
    fused = dispatch.fused_epilogue_would_run(q)
    assert fused == (ws * w >= 2**20), (name, fused)
    own = q_own = None
    for own in range(ws):
        q_own = reducers._sra_epilogue_q(q, xs.to(dev), own, cc, torch.float32)
    out = reducers._dequantize_rows(q)
    torch.cuda.synchronize()
    launches = {k: v for k, v in codec_cuda.LAUNCHES.items() if v}
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused" if fused else "staged")
    q_p = reducers._quantize_rows(peers, cc)
    assert _bits_equal(q.packed, q_p.packed) and _bits_equal(q.meta, q_p.meta), name
    want = reducers._sra_epilogue_q(q_p, xs, own, cc, torch.float32)
    assert _bits_equal(q_own.packed, want.packed) and _bits_equal(q_own.meta, want.meta), name
    assert _bits_equal(out, reducers._dequantize_rows(q_p)), name
    assert launches.get("codec_sra_epilogue", 0) == (ws if fused else 0), launches
    assert launches["codec_quantize"] >= 1 and launches["codec_dequantize"] >= 1, launches


SCHED_WS = 2


def _sched_rank(rank, store, result_q):
    import hashlib
    import os
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    from torch_cgx_tpu_torch import config as tcfg
    from torch_cgx_tpu_torch.parallel import allreduce_flat, schedule
    from torch_cgx_tpu_torch.torch_backend import backend
    from torch_cgx_tpu_torch.utils import prng

    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=SCHED_WS, timeout=timedelta(seconds=120))
        dev = torch.device("cuda", 0)
        n = SCHED_WS * (27 * 32 + 5) * 512 - 77  # blocks of chunks and tails, a partial bucket
        x32 = torch.from_numpy(np.random.default_rng(rank).standard_normal(n).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            for stochastic in (False, True):
                os.environ.update({"CGX_SRA_EPILOGUE": "fused", "CGX_SCHEDULE": "on"})
                if stochastic:
                    os.environ["CGX_STOCHASTIC_ROUNDING"] = "1"
                cc = CompressionConfig(bits=4, bucket_size=512, stochastic=stochastic)
                key = prng.key(5) if stochastic else None
                x = x32.to(dtype)
                codec_cuda.reset_launch_counts()
                schedule.reset_counts()
                card, card_rt = allreduce_flat(x.to(dev), cc, key=key, return_roundtrip=True)
                torch.cuda.synchronize()
                launches = dict(codec_cuda.LAUNCHES)
                blocks = schedule.COUNTS["blocks"]
                plain, plain_rt = allreduce_flat(x, cc, key=key, return_roundtrip=True)
                os.environ["CGX_SCHEDULE"] = "off"
                mono = allreduce_flat(x.to(dev), cc, key=key)
                out[(str(dtype), stochastic)] = (
                    _bits_equal(card, plain), _bits_equal(card_rt, plain_rt), launches, blocks,
                    _bits_equal(card, mono),
                )
                for k in ("CGX_SRA_EPILOGUE", "CGX_STOCHASTIC_ROUNDING", "CGX_SCHEDULE"):
                    os.environ.pop(k, None)
        # The DDP hook's pipelined bucket SRA: a bucket of three layers, on
        # the card against the plain versions, under both schedules.
        os.environ.update({"CGX_SRA_EPILOGUE": "fused", "CGX_COMPRESSION_QUANTIZATION_BITS": "4"})
        sizes = [33 * 32 * 512 + 100, 7 * 512, 40 * 32 * 512]
        for i, size in enumerate(sizes):
            tcfg.register_layer(("b", 0), i, size, 4, 512)
        bucket = torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(sum(sizes))
                                  .astype(np.float32))
        for mode in ("off", "on"):
            os.environ["CGX_SCHEDULE"] = mode
            codec_cuda.reset_launch_counts()
            card = backend.allreduce(bucket.to(dev), bucket_key=("b", 0))
            torch.cuda.synchronize()
            launches = dict(codec_cuda.LAUNCHES)
            plain = backend.allreduce(bucket.clone(), bucket_key=("b", 0))
            digest = hashlib.sha256(card.cpu().numpy().tobytes()).hexdigest()
            out[("hook", mode)] = (_bits_equal(card, plain), launches, digest)
        backend.release(None)
        dist.barrier()
    except Exception:  # reported to the parent, which fails the test
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


@pytest.fixture(scope="module")
def sched_world(tmp_path_factory):
    import multiprocessing as mp
    import queue
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    codec_cuda._lib()  # built once here, before the ranks load it
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    store = str(tmp_path_factory.mktemp("sched_world") / "store")
    procs = [ctx.Process(target=_sched_rank, args=(r, store, result_q)) for r in range(SCHED_WS)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + 300
    try:
        while len(results) < SCHED_WS and time.monotonic() < deadline:
            try:
                r, out = result_q.get(timeout=2.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            results[r] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert len(results) == SCHED_WS, f"only ranks {sorted(results)} reported"
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    assert not errors, "\n".join(f"rank {r}:\n{e}" for r, e in errors.items())
    return [results[r] for r in range(SCHED_WS)]


@pytest.mark.parametrize("stochastic", [False, True], ids=["nearest", "stochastic"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_pipelined_sra_ws2_matches_plain(sched_world, dtype, stochastic):
    """Two gloo ranks on the card (the asynchronous all-to-all and
    all-gather through host memory): ``(reduced, rt)`` of the pipelined SRA
    bit for bit against the plain versions (blocks of 217 buckets a row, six
    chunks and a tail of 25 each, so their epilogues are staged: B2, then
    B1), and equal to the monolithic SRA when it rounds to nearest."""
    for r, o in enumerate(sched_world):
        same, same_rt, launches, blocks, mono = o[(dtype, stochastic)]
        assert same and same_rt, (r, same, same_rt)
        assert blocks == 4, blocks
        assert launches["codec_quantize"] > 0 and launches["codec_dequantize"] > 0, launches
        assert mono or stochastic, r


def test_pipelined_hook_matches_plain(sched_world):
    """The DDP hook's bucket SRA under ``CGX_SCHEDULE=on`` on the card,
    bit for bit against the plain versions, and the same replicas on both
    ranks under both schedules (digests: the result queue carries no
    tensor, whose shared storage dies with its rank)."""
    for r, o in enumerate(sched_world):
        for mode in ("off", "on"):
            same, launches, _ = o[("hook", mode)]
            assert same and launches["codec_quantize"] > 0, (r, mode, launches)
    for mode in ("off", "on"):
        assert sched_world[0][("hook", mode)][2] == sched_world[1][("hook", mode)][2], mode
