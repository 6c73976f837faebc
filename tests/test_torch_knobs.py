"""Reference knobs: applied as the JAX package applies them, or refused,
never ignored.

``CGX_COMPRESSION_FAKE_RATIO`` (the reference's debug traffic shaping)
reduces only the leading ``ceil(ratio * n)`` values of each compressed
buffer in ``allreduce_flat`` (so also ``allreduce_tree`` and
``gradient_sync``) and leaves the tail un-reduced: held bit for bit against
the JAX package's ``allreduce_flat`` / ``allreduce_tree`` on a one-device
mesh under ``CGX_DEBUG_FORCE_CODEC=1`` (the prefix quantized and decoded,
the tail as it was), on decode-exact data. ``CGX_NONFINITE_GUARD`` (the
NaN/Inf gradient guard) runs under "skip" and "exact": on a clean tree
``gradient_sync`` equals the JAX package's ``gradient_sync`` under the same
knob bit for bit and the step trains; ``make_train_step`` resolves the
policy when it is built, so a guard set afterwards does not change that
step (a poisoned batch then poisons the parameters, as in the JAX
package). At their defaults (the ratio unset, 0 or 1; the guard "off")
everything runs as before. Both accessors parse as the JAX package's do,
which the tests check value by value. The guard's own behaviour on
poisoned steps is in ``tests/test_torch_nonfinite_guard.py``.
"""

import numpy as np
import pytest
import torch

from torch_cgx_tpu import config as jcfg
from torch_cgx_tpu_torch import config as tcfg
from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.parallel import allreduce_flat, allreduce_tree, gradient_sync, make_train_step

ENV = {"CGX_COMPRESSION_QUANTIZATION_BITS": "4", "CGX_COMPRESSION_BUCKET_SIZE": "128"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("CGX_COMPRESSION_FAKE_RATIO", raising=False)
    monkeypatch.delenv("CGX_NONFINITE_GUARD", raising=False)
    return monkeypatch


def _grads():
    rng = np.random.default_rng(0)
    return {"a.kernel": torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)),
            "a.bias": torch.from_numpy(rng.standard_normal(128).astype(np.float32))}


def _model_and_step():
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_train_step(model, lambda m, b: lm_loss(m(b), b), opt, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, size=(2, 16)))
    return model, step, tokens


def _grid(shape, k=3):
    """Tenths of an integer grid whose every bucket of 128 holds 0 and 15:
    the codec moves most values (a tenth is no multiple of the level step),
    and the JAX package's decode gives the same bits as the port's."""
    n = int(np.prod(shape))
    return (np.float32((np.arange(n) * k) % 16) * np.float32(0.1)).reshape(shape)


def _jax_on_one_device(fn, *args):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.utils.compat import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    body = shard_map(lambda *a: fn(mesh, *a), mesh=mesh, in_specs=P(), out_specs=P(),
                     check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(body)(*args))


@pytest.mark.parametrize("raw", ["0.5", "0.01", "0.99"])
def test_fake_ratio_is_refused_by_allreduce_tree(_env, raw):
    """Not refused: under the ratio ``allreduce_tree`` and
    ``gradient_sync`` of one rank with the codec forced equal the JAX
    package's ``allreduce_tree`` bit for bit, and differ from the run
    without the ratio only where the tail skipped the codec."""
    from torch_cgx_tpu.parallel import allreduce as jallreduce

    _env.setenv("CGX_DEBUG_FORCE_CODEC", "1")
    _env.setenv("CGX_COMPRESSION_FAKE_RATIO", raw)
    assert tcfg.fake_ratio() == jcfg.fake_ratio() == float(raw)
    grads = {"a.kernel": _grid((64, 128)), "b.kernel": _grid((40, 128), k=5)}
    want = _jax_on_one_device(
        lambda mesh, t: jallreduce.allreduce_tree(t, mesh=mesh), {"a": {"kernel": grads["a.kernel"]},
                                                                   "b": {"kernel": grads["b.kernel"]}})
    for fn in (allreduce_tree, gradient_sync):
        got = fn({k: torch.from_numpy(v.copy()) for k, v in grads.items()})
        for k in grads:
            a, b = k.split(".")
            np.testing.assert_array_equal(got[k].numpy().view(np.int32), want[a][b].view(np.int32))
    # The shaped tail is the input as it was; the prefix went through the
    # codec.
    n = sum(v.size for v in grads.values())
    m = max(1, int(np.ceil(float(raw) * n)))
    flat = np.concatenate([grads[k].reshape(-1) for k in sorted(grads)])
    out = np.concatenate([want[k.split(".")[0]]["kernel"].reshape(-1) for k in sorted(grads)])
    np.testing.assert_array_equal(out[m:], flat[m:])
    assert not np.array_equal(out[:m], flat[:m])


@pytest.mark.parametrize("raw", ["0.5", "0.25"])
def test_fake_ratio_is_refused_by_allreduce_flat(_env, raw):
    """Not refused: ``allreduce_flat`` sends the shaped prefix and
    leaves the tail un-reduced, bit for bit as the JAX package's."""
    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.parallel import allreduce as jallreduce

    _env.setenv("CGX_DEBUG_FORCE_CODEC", "1")
    _env.setenv("CGX_COMPRESSION_FAKE_RATIO", raw)
    flat = _grid(8192 + 77, k=7)
    want = _jax_on_one_device(
        lambda mesh, x: jallreduce.allreduce_flat(x, JCC(bits=4, bucket_size=128), mesh=mesh,
                                                  axes=("dp",)), flat)
    got = allreduce_flat(torch.from_numpy(flat.copy()), CompressionConfig(bits=4, bucket_size=128))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    m = int(np.ceil(float(raw) * flat.size))
    np.testing.assert_array_equal(got.numpy()[m:], flat[m:])
    assert not np.array_equal(got.numpy()[:m], flat[:m])


@pytest.mark.parametrize("raw", [None, "0", "1"])
def test_fake_ratio_off_allreduce_flat_runs_as_before(_env, raw):
    if raw is not None:
        _env.setenv("CGX_COMPRESSION_FAKE_RATIO", raw)
    flat = _grads()["a.kernel"].reshape(-1)
    out = allreduce_flat(flat, CompressionConfig(bits=4, bucket_size=128))
    assert torch.equal(out, flat)  # one rank: the sum is the buffer


@pytest.mark.parametrize("raw", [None, "0", "1", "-0.5", "1.5"])
def test_fake_ratio_off_runs_as_before(_env, raw):
    if raw is not None:
        _env.setenv("CGX_COMPRESSION_FAKE_RATIO", raw)
    assert tcfg.fake_ratio() is None and jcfg.fake_ratio() is None
    grads = _grads()
    out = allreduce_tree(grads)  # one rank: the sum is the gradient
    for k, v in grads.items():
        assert torch.equal(out[k], v)


def test_fake_ratio_garbage_names_the_knob(_env):
    _env.setenv("CGX_COMPRESSION_FAKE_RATIO", "half")
    with pytest.raises(ValueError, match="CGX_COMPRESSION_FAKE_RATIO"):
        tcfg.fake_ratio()
    with pytest.raises(ValueError, match="CGX_COMPRESSION_FAKE_RATIO"):
        jcfg.fake_ratio()


@pytest.mark.parametrize("guard", ["skip", "exact", "SKIP"])
def test_nonfinite_guard_runs_and_matches_jax(_env, guard):
    """The knob is read by ``gradient_sync`` and ``make_train_step`` as by
    the JAX package's: on a clean tree the sync equals JAX
    ``gradient_sync`` (one-device mesh, the knob read there too) bit for
    bit, counts no bad step, and the step trains."""
    from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
    from torch_cgx_tpu_torch.parallel import grad_sync

    _env.setenv("CGX_NONFINITE_GUARD", guard)
    assert tcfg.nonfinite_guard() == jcfg.nonfinite_guard() == guard.lower()
    grads = _grads()
    grad_sync.reset_counts()
    got = gradient_sync(grads)
    want = _jax_on_one_device(lambda mesh, g: jgradient_sync(g, mesh=mesh),
                              {"a": {k.split(".")[1]: v.numpy() for k, v in grads.items()}})
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy().view(np.uint32), want["a"][k.split(".")[1]].view(np.uint32))
    model, step, tokens = _model_and_step()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert np.isfinite(float(step(tokens)))
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    assert grad_sync.COUNTS["nonfinite_steps"] == 0


@pytest.mark.parametrize("guard", ["skip", "exact"])
def test_nonfinite_guard_set_after_the_step_is_built(_env, guard):
    """The step resolves the policy when it is built, as the JAX step does:
    a step built under "off" stays unguarded once the knob is set, so a
    poisoned batch (the loss scaled by NaN) poisons the parameters and no
    bad step is counted; a step built afterwards guards."""
    from torch_cgx_tpu_torch.parallel import grad_sync

    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def scaled(m, b):
        return lm_loss(m(b[0]), b[0]) * b[1]

    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, size=(2, 16)))
    step = make_train_step(model, scaled, opt, device="cpu")
    assert np.isfinite(float(step((tokens, torch.tensor(1.0)))))
    _env.setenv("CGX_NONFINITE_GUARD", guard)
    grad_sync.reset_counts()
    guarded = make_train_step(model, scaled, opt, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    guarded((tokens, torch.tensor(float("nan"))))
    assert grad_sync.COUNTS["nonfinite_steps"] == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())
    if guard == "skip":
        assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    step((tokens, torch.tensor(float("nan"))))
    assert grad_sync.COUNTS["nonfinite_steps"] == 1
    assert not all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("guard", [None, "off", "OFF"])
def test_nonfinite_guard_off_runs_as_before(_env, guard):
    if guard is not None:
        _env.setenv("CGX_NONFINITE_GUARD", guard)
    assert tcfg.nonfinite_guard() == jcfg.nonfinite_guard() == "off"
    grads = _grads()
    out = gradient_sync(grads)
    for k, v in grads.items():
        assert torch.equal(out[k], v)
    model, step, tokens = _model_and_step()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert np.isfinite(float(step(tokens)))
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())


@pytest.mark.parametrize("guard", ["bogus", "on", "1"])
def test_invalid_nonfinite_guard_is_a_value_error_as_in_jax(_env, guard):
    _env.setenv("CGX_NONFINITE_GUARD", guard)
    with pytest.raises(ValueError) as port:
        tcfg.nonfinite_guard()
    with pytest.raises(ValueError) as ref:
        jcfg.nonfinite_guard()
    assert str(port.value) == str(ref.value)
    assert "CGX_NONFINITE_GUARD" in str(port.value)
    with pytest.raises(ValueError, match="CGX_NONFINITE_GUARD"):
        gradient_sync(_grads())
    with pytest.raises(ValueError, match="CGX_NONFINITE_GUARD"):
        _model_and_step()
