"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports only torch, numpy and the port, so it runs on a machine without
JAX; there, skip the suite's JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

``chip_smoke.py`` makes the same comparisons at the GPT-2 slice's shapes.
The tolerance is 0 throughout: words, meta and decoded values are compared
bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
from torch_cgx_tpu_torch.ops import codec, codec_cuda
from torch_cgx_tpu_torch.parallel import gradient_sync, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
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
    assert codec_cuda.LAUNCHES == {
        "codec_quantize": 1, "codec_dequantize": 1, "codec_sra_epilogue": 0,
    }


def test_cuda_operands_refuse_unported_modes(dev, monkeypatch):
    x = torch.randn(32 * 512, device=dev)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        codec_cuda.quantize_batch(x.to(torch.bfloat16)[None], 4, 512)
    monkeypatch.setenv("CGX_CODEC_ENCODE", "mul")
    with pytest.raises(NotImplementedError, match="CGX_CODEC_ENCODE"):
        codec_cuda.quantize_batch(x[None], 4, 512)


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
    assert all(v > 0 for v in codec_cuda.LAUNCHES.values()), codec_cuda.LAUNCHES
