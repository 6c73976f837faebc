"""The matmul-quantize's (B8) route to its tensor-core kernels, on the CPU.

On the card, bf16 and f16 operands whose shape TMA can describe go to
``cgx_matmul_quantize_tc_kernel`` (``wgmma`` fed by a TMA ring), every
float32 pair to the split-TF32 kernel (``cgx_matmul_quantize_tf32_kernel``
after the split pass; ``tests/test_torch_mm_tf32.py``), and every other
launch to the FFMA kernel; the wrapper decides before the launch with one
pure function, ``codec_cuda.mm_tc_eligible``, and a private ``_route``
keyword forces the FFMA kernel. Here:

* ``mm_tc_eligible`` over the dtypes (float32 always), ``din`` and ``o``
  residues mod 8, and operand views off their 16-byte alignment;
* the tile geometry (``mm_tc_tiles``) at GPT-2 124M's three produced
  layers and at the card checks' edge shapes;
* the route each launch takes, ``_route="ffma"`` and the refusal of any
  other value;
* on CPU tensors every route runs the plain version: bit-identical to it,
  and, on small-integer bf16 operands, to the JAX kernel in interpret mode.

The kernels themselves run in ``tests/test_torch_kernels.py`` and
``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.ops import codec_cuda

# GPT-2 124M's produced dense layers (din, o) and the tiles of each:
# 128 x 192 tiles, one wave of the persistent grid on 132 SMs.
GPT2_TILES = {(768, 3072): (6, 16), (768, 2304): (6, 12), (3072, 768): (24, 4)}
# The card checks' edge shapes (din, o) -> (tiles, eligible in bf16 when
# aligned): o not a multiple of the tile, din below one tile, din not a
# multiple of 8 (100, 13) or o = 4 mod 8 (1036).
EDGE_TILES = {
    (64, 448): ((1, 3), True), (256, 1344): ((2, 7), True), (128, 672): ((1, 4), True),
    (128, 896): ((1, 5), True), (100, 4096): ((1, 22), False), (13, 4096): ((1, 22), False),
    (1024, 1036): ((8, 6), False),
}


def _view(rows, cols, dtype, offset):
    """A (rows, cols) contiguous view ``offset`` elements into a buffer."""
    buf = torch.zeros(rows * cols + offset + 16, dtype=dtype)
    base = (-buf.data_ptr() % 16) // buf.element_size()  # the buffer's first 16-byte boundary
    return buf[base + offset : base + offset + rows * cols].view(rows, cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("din,o", [(64, 512), (768, 3072), (100, 512), (64, 1036), (13, 4),
                                   (72, 8), (4, 16)])
def test_eligible_by_dtype_and_width(dtype, din, o):
    """16-bit operands with din and o multiples of 8, aligned: eligible, a
    16-bit width that is not a multiple of 8 never; float32 at every width
    (the split pass writes TMA-describable planes)."""
    x2, g2 = _view(32, din, dtype, 0), _view(32, o, dtype, 0)
    want = dtype == torch.float32 or (din % 8 == 0 and o % 8 == 0)
    assert codec_cuda.mm_tc_eligible(x2, g2) is want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("x_off,g_off", [(0, 0), (1, 0), (0, 1), (4, 0), (0, 4), (8, 8), (3, 5)])
def test_eligible_by_alignment(dtype, x_off, g_off):
    """A view off its 16-byte alignment (offsets in 2-byte elements; 8 is
    one whole 16 bytes) goes to the FFMA kernel."""
    x2, g2 = _view(16, 64, dtype, x_off), _view(16, 128, dtype, g_off)
    assert codec_cuda.mm_tc_eligible(x2, g2) is (x_off % 8 == 0 and g_off % 8 == 0)


def test_eligible_needs_one_dtype():
    x2 = _view(16, 64, torch.bfloat16, 0)
    assert not codec_cuda.mm_tc_eligible(x2, _view(16, 64, torch.float16, 0))
    assert not codec_cuda.mm_tc_eligible(x2, _view(16, 64, torch.float32, 0))
    assert codec_cuda.mm_tc_eligible(x2, _view(16, 64, torch.bfloat16, 0))


@pytest.mark.parametrize("shape", list(GPT2_TILES))
def test_tiles_at_gpt2_shapes(shape):
    """96, 72 and 96 tiles: one wave on 132 SMs, every GPT-2 124M layer
    eligible."""
    din, o = shape
    tiles = codec_cuda.mm_tc_tiles(din, o)
    assert tiles == GPT2_TILES[shape]
    assert tiles[0] * tiles[1] <= codec_cuda.CLUSTER_SMS
    x2, g2 = _view(4, din, torch.bfloat16, 0), _view(4, o, torch.bfloat16, 0)
    assert codec_cuda.mm_tc_eligible(x2, g2)


@pytest.mark.parametrize("shape", list(EDGE_TILES))
def test_tiles_at_edge_shapes(shape):
    din, o = shape
    tiles, eligible = EDGE_TILES[shape]
    assert codec_cuda.mm_tc_tiles(din, o) == tiles
    bm, bn = codec_cuda.MM_TC_TILE
    assert (tiles[0] - 1) * bm < din <= tiles[0] * bm and (tiles[1] - 1) * bn < o <= tiles[1] * bn
    x2, g2 = _view(4, din, torch.bfloat16, 0), _view(4, o, torch.bfloat16, 0)
    assert codec_cuda.mm_tc_eligible(x2, g2) is eligible


@pytest.mark.parametrize("x_off", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", [None, "ffma"])
def test_route_resolution(route, dtype, x_off):
    """None picks the tensor cores where the operands are eligible (float32
    at any alignment) and the FFMA kernel elsewhere; "ffma" takes any
    operands."""
    x2, g2 = _view(16, 64, dtype, x_off), _view(16, 128, dtype, 0)
    eligible = dtype == torch.float32 or x_off == 0
    assert codec_cuda._mm_route(x2, g2, route) == (route or ("tc" if eligible else "ffma"))


@pytest.mark.parametrize("route", ["tc", "wgmma", "", "auto"])
def test_unknown_route_raises(route):
    """Only the FFMA kernel can be forced; the tensor cores take what their
    shape admits."""
    x2, g2 = _view(16, 64, torch.bfloat16, 0), _view(16, 128, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="_route"):
        codec_cuda.matmul_quantize_chunks(x2, g2, 2, 4, 128, _route=route)


def _operands(seed, k, din, o, dtype, integer, x_off=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (k, din)) if integer else rng.standard_normal((k, din))
    g = rng.integers(-3, 4, (k, o)) if integer else rng.standard_normal((k, o))
    x2 = _view(k, din, dtype, x_off)
    x2.copy_(torch.from_numpy(x.astype(np.float32)).to(dtype))
    return x2, torch.from_numpy(g.astype(np.float32)).to(dtype).contiguous()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("route", [None, "ffma"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_every_route_runs_the_plain_version_on_cpu(dtype, route, integer):
    """On CPU tensors the route changes nothing: words, meta and the own
    raw row equal the plain version's bit for bit."""
    x2, g2 = _operands(7, 40, 64, 512, dtype, integer)
    for own in (0, 3):
        got = codec_cuda.matmul_quantize_chunks(x2, g2, 4, 4, 128, own_row=(own, 4), _route=route)
        want = codec_cuda.matmul_quantize_chunks_plain(x2, g2, 4, 4, 128, own_row=(own, 4))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("x_off", [0, 1])
@pytest.mark.parametrize("din,o", [(64, 448), (100, 4096)])
def test_ffma_shapes_run_the_plain_version_on_cpu(din, o, x_off):
    """The shapes the FFMA kernel takes on the card (din not a multiple of
    8, a misaligned view) give the plain version's bytes on the CPU too,
    forced or not."""
    x2, g2 = _operands(din + o + x_off, 24, din, o, torch.bfloat16, True, x_off)
    want = codec_cuda.matmul_quantize_chunks_plain(x2, g2, 2, 3, 128)
    for route in (None, "ffma"):
        got = codec_cuda.matmul_quantize_chunks(x2, g2, 2, 3, 128, _route=route)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("route", [None, "ffma"])
@pytest.mark.parametrize("bits,bucket", [(2, 128), (8, 128)])
def test_routes_match_jax_kernel_on_integers(route, bits, bucket):
    """Small-integer bf16 operands (every partial sum exact, so any order
    gives the same sums, as the tensor cores' does on the card): each
    route's words and meta equal the JAX kernel's in interpret mode."""
    import jax.numpy as jnp

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.ops import fused_producer as jfp

    x2, g2 = _operands(bits * bucket, 64, 256, 512, torch.bfloat16, True)
    jx = jnp.asarray(x2.float().numpy(), jnp.bfloat16)
    jg = jnp.asarray(g2.float().numpy(), jnp.bfloat16)
    ws, div = 2, 2
    cc = JCC(bits=bits, bucket_size=bucket)
    chunk = 256 * 512 // ws
    tm, tk = jfp._kernel_geometry(64, 256, 512, ws, chunk, cc)
    q = jfp._matmul_quantize_q(jx, jg, cc, ws=ws, chunk=chunk, div=div, tm=tm, tk=tk, interpret=True)
    w, m = codec_cuda.matmul_quantize_chunks(x2, g2, div, bits, bucket, _route=route)
    np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                  np.asarray(q.packed).reshape(-1).view(np.uint32))
    np.testing.assert_array_equal(m.numpy().view(np.uint32),
                                  np.asarray(q.meta).reshape(-1, 2).view(np.uint32))
