"""The GPT-2 slice of the port against the JAX package, on the CPU.

Part 1: a GPT-2 tiny gradient tree through the port's ``allreduce_tree``
and through the JAX ``gradient_sync`` on a 1-device mesh, with
``CGX_DEBUG_FORCE_CODEC=1`` (the per-rank codec work of a real SRA step)
and knobs small enough that standalone, fused, multi-slice and
chunk-plus-tail pieces all occur, in both epilogue eras: the same groups
and slices, bit-identical output on decode-exact gradients and agreement
within the envelope on real ones.

Part 2: the JAX model's parameters carried across with
``gpt2_params_from_jax``, then three compressed train steps on the same
tokens: float32 losses to a relative 1e-4 and parameters to 3 x lr, bf16
losses to a relative 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from torch_cgx_tpu.models import GPT2 as JGPT2
from torch_cgx_tpu.models import GPT2Config as JGPT2Config
from torch_cgx_tpu.models import lm_loss as jlm_loss
from torch_cgx_tpu.parallel import allreduce as jallreduce
from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
from torch_cgx_tpu.parallel import make_train_step as jmake_train_step
from torch_cgx_tpu.parallel import replicate, shard_batch
from torch_cgx_tpu.utils.compat import shard_map
from torch_cgx_tpu.utils.tree import leaf_paths
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.models import (
    GPT2,
    GPT2Config,
    gpt2_params_from_jax,
    gpt2_params_to_numpy,
    lm_loss,
)
from torch_cgx_tpu_torch.ops import codec
from torch_cgx_tpu_torch.parallel import allreduce, make_train_step
from torch_cgx_tpu_torch.utils.tree import sorted_items

BITS, BUCKET = 4, 384
VOCAB = 4099  # wte (524,672 values) spans two 1 MB fusion slices
LR = 1e-4
SLICE_ENV = {
    "CGX_DEBUG_FORCE_CODEC": "1",
    "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS),
    "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
    "CGX_FUSION_BUFFER_SIZE_MB": "1",
    "CGX_STANDALONE_LAYER_ELEMS": "40000",
}


@pytest.fixture
def slice_env(monkeypatch):
    for k, v in SLICE_ENV.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("dp",))


@functools.lru_cache(maxsize=None)
def _jax_model(dtype_name: str):
    cfg = JGPT2Config.tiny(vocab_size=VOCAB, dtype=getattr(jnp, dtype_name))
    model = JGPT2(cfg)
    tokens = np.random.default_rng(1).integers(0, VOCAB, size=(2, 64)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"]
    return model, jax.tree.map(np.asarray, params), tokens


@functools.lru_cache(maxsize=None)
def _jax_grads(dtype_name: str):
    model, params, tokens = _jax_model(dtype_name)
    grads = jax.grad(lambda p: jlm_loss(model.apply({"params": p}, tokens), tokens))(params)
    return jax.tree.map(np.asarray, grads)


def _jax_sync(tree):
    mesh = _mesh1()
    fn = shard_map(
        lambda g: jgradient_sync(g, mesh=mesh, average=False),
        mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False,
    )
    return {p: np.asarray(v) for p, v in leaf_paths(jax.jit(fn)(tree))}


def _port_sync(flat_np):
    tree = {p: torch.from_numpy(v.copy()) for p, v in flat_np.items()}
    return {p: v.numpy() for p, v in allreduce.allreduce_tree(tree).items()}


def _grid_tree(grads):
    """Decode-exact gradients of the same shapes: integer grids whose
    buckets hold 0 and 15, so at 2 bits every level decodes exactly."""
    out = {}
    for i, (p, v) in enumerate(leaf_paths(grads)):
        g = np.float32((np.arange(v.size) * (2 * i + 3)) % 16).reshape(v.shape)
        out[p] = g
    return out


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# Part 1: the gradient sync.
# ---------------------------------------------------------------------------


def test_groups_and_slices_match_jax(slice_env):
    grads = _jax_grads("float32")
    flat = dict(leaf_paths(grads))
    jpl = leaf_paths(grads)
    tpl = sorted_items({p: torch.from_numpy(v.copy()) for p, v in flat.items()})
    assert [p for p, _ in jpl] == [p for p, _ in tpl]
    jg = jallreduce._group_leaves(jpl, False)
    tg = allreduce._group_leaves(tpl, False)
    assert [(g.indices, g.cc.bits, g.cc.bucket_size) for g in jg] == [
        (g.indices, g.cc.bits, g.cc.bucket_size) for g in tg
    ]
    kinds = set()
    for g in tg:
        n = sum(tpl[i][1].numel() for i in g.indices)
        js = jallreduce._fusion_slices(n, 4)
        assert js == allreduce._fusion_slices(n, 4)
        if not g.cc.enabled:
            continue
        kinds.add("fused" if len(g.indices) > 1 else "standalone")
        if len(js) > 1:
            kinds.add("multi-slice")
        for _, ln in js:
            nb = codec.num_buckets(ln, BUCKET)
            if nb % codec.CHUNK_BUCKETS and nb > codec.CHUNK_BUCKETS:
                kinds.add("chunks+tail")
            elif nb % codec.CHUNK_BUCKETS == 0:
                kinds.add("whole chunks")
    assert kinds == {"fused", "standalone", "multi-slice", "chunks+tail", "whole chunks"}


@pytest.mark.parametrize("era", ["staged", "fused"])
def test_sync_bit_identical_on_decode_exact_grads(slice_env, era):
    slice_env.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "2")
    if era == "fused":
        slice_env.setenv("CGX_SRA_EPILOGUE", "fused")
    flat = _grid_tree(_jax_grads("float32"))
    want = _jax_sync(_nest(flat))
    got = _port_sync(flat)
    assert want.keys() == got.keys()
    lossy = 0
    for p in want:
        np.testing.assert_array_equal(got[p].view(np.uint32), want[p].view(np.uint32), err_msg=p)
        lossy += int((got[p] != flat[p]).sum())
    assert lossy > 0  # 2 bits cannot carry 16 levels: the codec really ran


@pytest.mark.parametrize("era", ["staged", "fused"])
def test_sync_within_envelope_on_real_grads(slice_env, era):
    if era == "fused":
        slice_env.setenv("CGX_SRA_EPILOGUE", "fused")
    grads = _jax_grads("float32")
    flat = dict(leaf_paths(grads))
    want = _jax_sync(grads)
    got = _port_sync(flat)
    for p, g in flat.items():
        if g.ndim <= 1:  # raw group: passes through unchanged at world size 1
            np.testing.assert_array_equal(got[p], g)
            continue
        step = float((g.max() - g.min()) / BUCKET)
        bound = 2 * codec.allreduce_error_bound(g.size, BITS, BUCKET, 1, step)
        assert np.abs(got[p] - want[p]).max() <= bound, p
        assert np.abs(got[p] - g).max() <= bound, p


# ---------------------------------------------------------------------------
# Part 2: the train step.
# ---------------------------------------------------------------------------


def _jax_train(dtype_name: str, steps: int):
    model, params, tokens = _jax_model(dtype_name)
    mesh = _mesh1()
    opt = optax.adam(LR)
    p = replicate(jax.tree.map(jnp.asarray, params), mesh)
    s = replicate(opt.init(p), mesh)
    step = jmake_train_step(
        lambda pp, t: jlm_loss(model.apply({"params": pp}, t), t), opt, mesh, donate=False
    )
    losses = []
    for i in range(steps):
        p, s, loss = step(p, s, shard_batch(jnp.asarray(tokens), mesh), jnp.int32(i))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


def _port_train(dtype: torch.dtype, dtype_name: str, steps: int):
    _, params, tokens = _jax_model(dtype_name)
    cfg = GPT2Config.tiny(vocab_size=VOCAB, dtype=dtype)
    model = GPT2(cfg, device="cpu")
    model.load_state_dict(gpt2_params_from_jax(params))
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device="cpu")
    t = torch.from_numpy(tokens)
    losses = [float(step(t)) for _ in range(steps)]
    return losses, gpt2_params_to_numpy(model)


def test_params_round_trip_and_paths():
    _, params, _ = _jax_model("float32")
    sd = gpt2_params_from_jax(params)
    model = GPT2(GPT2Config.tiny(vocab_size=VOCAB), device="cpu")
    assert [n for n, _ in model.named_parameters()] == list(model.state_dict())
    assert set(sd) == {p for p, _ in leaf_paths(params)} == set(model.state_dict())
    model.load_state_dict(sd)
    back = gpt2_params_to_numpy(model)
    for p, v in leaf_paths(params):
        np.testing.assert_array_equal(dict(leaf_paths(back))[p], v)


def test_train_steps_match_jax_float32(slice_env):
    jl, jp = _jax_train("float32", 3)
    tl, tp = _port_train(torch.float32, "float32", 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    flat_t = dict(leaf_paths(tp))
    for p, v in leaf_paths(jp):
        np.testing.assert_allclose(flat_t[p], v, rtol=0, atol=3 * LR, err_msg=p)


def test_train_steps_match_jax_bf16(slice_env):
    jl, _ = _jax_train("bfloat16", 3)
    tl, _ = _port_train(torch.bfloat16, "bfloat16", 3)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[-1] < tl[0]


def test_forward_logits_match_jax_float32():
    model, params, tokens = _jax_model("float32")
    want = np.asarray(model.apply({"params": params}, tokens))
    port = GPT2(GPT2Config.tiny(vocab_size=VOCAB, dtype=torch.float32), device="cpu")
    port.load_state_dict(gpt2_params_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_no_gpu_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPT2(GPT2Config.tiny())
    model = GPT2(GPT2Config.tiny(), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_train_step(model, lambda m, t: lm_loss(m(t), t), opt)


def test_compression_config_merges_env_default(monkeypatch):
    import torch_cgx_tpu_torch as port

    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "4")
    port.set_layer_pattern_config(r"attn_qkv\.kernel$", CompressionConfig(bits=2))
    try:
        from torch_cgx_tpu_torch import config as tcfg

        cc = tcfg.resolve_pattern_config("h_0.attn.attn_qkv.kernel")
        assert (cc.bits, cc.bucket_size) == (2, 512)
        assert tcfg.resolve_pattern_config("h_0.mlp.mlp_in.kernel") is None
    finally:
        port.clear_registry()
    monkeypatch.setenv("CGX_COMPRESSION_BUCKET_SIZE", "lots")
    with pytest.raises(ValueError, match="CGX_COMPRESSION_BUCKET_SIZE"):
        tcfg.default_compression_config()


@pytest.mark.parametrize("bits,bucket", [(0, 0), (2, 0), (0, 1024), (8, 128)])
def test_layer_registry_matches_jax(monkeypatch, bits, bucket):
    """Numeric (bucket, layer) registry: zeros back-fill from the env
    default at lookup, as in the JAX package; the two registries share no
    state."""
    from torch_cgx_tpu import config as jcfg
    from torch_cgx_tpu_torch import config as tcfg

    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "4")
    monkeypatch.setenv("CGX_COMPRESSION_BUCKET_SIZE", "256")
    jcfg.clear_registry()
    try:
        tcfg.register_layer(0, 0, 1000, bits=bits, bucket_size=bucket)
        assert jcfg.get_layer_config((0, 0)) == jcfg.default_compression_config()
        jcfg.register_layer(0, 0, 1000, bits=bits, bucket_size=bucket)
        got, want = tcfg.get_layer_config((0, 0)), jcfg.get_layer_config((0, 0))
        assert (got.bits, got.bucket_size) == (want.bits, want.bucket_size)
        assert tcfg.get_layer_config((0, 1)) == tcfg.default_compression_config()
        with pytest.raises(ValueError, match="out of order"):
            tcfg.register_layer(0, 2, 10)
    finally:
        tcfg.clear_registry()
        jcfg.clear_registry()
