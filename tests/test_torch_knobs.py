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

``CGX_SCHEDULE=on`` (the pipelined SRA) and ``CGX_PLANNER=on`` (the step
planner, which pipelines each slice at its planned depth) run on every
entry point and equal the knobs unset; ``CGX_MEMLEDGER`` under the planner
is refused before any collective wherever the planner would plan; "auto"
and "off" change nothing, and ``CGX_XLA_ALLREDUCE`` changes no group the
port can form (ROADMAP C21).
"""

import multiprocessing as mp
import os
import queue
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from torch_cgx_tpu import config as jcfg
from torch_cgx_tpu_torch import config as tcfg
from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.parallel import allreduce_flat, allreduce_tree, gradient_sync, make_train_step
from torch_cgx_tpu_torch.parallel import group as group_mod
from torch_cgx_tpu_torch.parallel.mesh import TwoLevelGroup

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


# ---------------------------------------------------------------------------
# CGX_SCHEDULE and CGX_PLANNER on the train-step path (C21): CGX_SCHEDULE=on
# runs the pipelined SRA (parallel/schedule.py) and CGX_PLANNER=on the step
# planner (parallel/planner.py), each going on to the wire as the unset run
# does; the planner under CGX_MEMLEDGER (whose staging budget the port does
# not have) is refused before any collective. "auto" and "off" run the
# monolithic SRA unchanged.
# CGX_XLA_ALLREDUCE is not read by the port: under "on" the JAX router
# changes the result only for a MIXED group (a process holding several of
# its devices), and a rank of the port holds one device.
# ---------------------------------------------------------------------------

COLLECTIVES = ("all_to_all_rows", "all_gather_rows", "shift_right", "all_reduce_sum",
               "reduce_scatter_sum", "all_to_all_rows_async", "all_gather_rows_async")


class _Collective(Exception):
    """Raised by a stand-in collective: the call got as far as the wire."""


@pytest.fixture
def two_ranks(_env):
    """This process stands in for a rank of a 2-rank flat group whose every
    collective raises ``_Collective`` (recorded by name)."""
    called = []

    def stand_in(name):
        def fn(*a, **kw):
            called.append(name)
            raise _Collective(name)
        return fn

    _env.setattr(group_mod, "world_size", lambda group=None: 2)
    _env.setattr(group_mod, "rank", lambda group=None: 0)
    for name in COLLECTIVES:
        _env.setattr(group_mod, name, stand_in(name))
    return called


def _entry_points(model, step, tokens):
    grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    cc = CompressionConfig(bits=4, bucket_size=128)
    return {
        "allreduce_tree": lambda: allreduce_tree(grads, average=True),
        "allreduce_flat": lambda: allreduce_flat(torch.zeros(32 * 128 * 2), cc),
        "gradient_sync": lambda: gradient_sync(grads),
        "make_train_step": lambda: step(tokens),
    }


@pytest.mark.parametrize("entry", ["allreduce_tree", "allreduce_flat", "gradient_sync",
                                   "make_train_step"])
@pytest.mark.parametrize("knob", ["CGX_SCHEDULE", "CGX_PLANNER"])
def test_pipelined_sra_knobs_refused_before_any_collective(two_ranks, knob, entry):
    """Under CGX_SCHEDULE=on and under CGX_PLANNER=on every entry point goes
    on to the wire as the unset run does (a tree's groups in reverse
    order); under CGX_SCHEDULE=on a flat buffer through the pipelined SRA's
    asynchronous all-to-all in place of the monolithic one's, under the
    planner (which plans only a tree's slices) through the monolithic one.
    With CGX_MEMLEDGER set beside the knob, the tree, the sync and the
    train step raise NotImplementedError naming it before any collective,
    the step before its forward (the parameters untouched), where the
    planner would plan; a flat buffer and the schedule alone run."""
    called = two_ranks
    forwards = []
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_train_step(model, lambda m, b: forwards.append(1) or lm_loss(m(b), b), opt, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, size=(2, 16)))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = []
    for mode in (None, "on"):
        with pytest.MonkeyPatch.context() as mp_:
            if mode:
                mp_.setenv(knob, mode)
            with pytest.raises(_Collective):
                _entry_points(model, step, tokens)[entry]()
        runs.append((list(called), len(forwards)))
        called.clear()
        forwards.clear()
    assert runs[0][1] == runs[1][1]  # the same forwards: none, or one before the sync
    assert runs[0][0] and runs[1][0], runs  # both reached the wire
    if entry == "allreduce_flat":  # one buffer: the pipeline's all-to-all first
        first = "all_to_all_rows_async" if knob == "CGX_SCHEDULE" else "all_to_all_rows"
        assert runs == [(["all_to_all_rows"], 0), ([first], 0)], runs
    refused = knob == "CGX_PLANNER" and entry != "allreduce_flat"
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv(knob, "on")
        mp_.setenv("CGX_MEMLEDGER", "1")
        if refused:
            with pytest.raises(NotImplementedError, match="CGX_PLANNER=on with CGX_MEMLEDGER"):
                _entry_points(model, step, tokens)[entry]()
        else:
            with pytest.raises(_Collective):
                _entry_points(model, step, tokens)[entry]()
    if refused:
        assert called == [] and forwards == []
        assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    else:
        assert called


@pytest.mark.parametrize("case", ["ring", "alltoall", "two_level", "uncompressed", "auto", "off"])
def test_pipelined_sra_knobs_leave_other_paths_running(two_ranks, case):
    """Where no flat-group SRA of compressed values runs (the Ring, the
    all-to-all, a TwoLevelGroup, an all-uncompressed tree) the planner under
    CGX_MEMLEDGER is not refused, and "auto" / "off" never are: the sync
    goes on to the wire."""
    knobs = {"CGX_SCHEDULE": "on", "CGX_PLANNER": "on", "CGX_MEMLEDGER": "1"}
    group = None
    if case == "ring":
        knobs["CGX_INNER_REDUCTION_TYPE"] = "RING"
    elif case == "alltoall":
        knobs["CGX_DEBUG_ALL_TO_ALL_REDUCTION"] = "1"
    elif case == "two_level":
        group = TwoLevelGroup(intra=None, intra_size=2, cross=None, cross_size=1)
    elif case == "uncompressed":
        knobs["CGX_COMPRESSION_QUANTIZATION_BITS"] = "32"
    else:
        knobs = {"CGX_SCHEDULE": case, "CGX_PLANNER": case, "CGX_MEMLEDGER": "1"}
    grads = {"a.kernel": torch.ones(64, 128)}
    with pytest.MonkeyPatch.context() as mp_:
        for k, v in knobs.items():
            mp_.setenv(k, v)
        for fn in (lambda: allreduce_tree(grads, group=group), lambda: gradient_sync(grads, group=group)):
            with pytest.raises(_Collective):
                fn()
    assert two_ranks


def test_xla_allreduce_on_changes_no_port_group():
    """The JAX router under CGX_XLA_ALLREDUCE=on (``topology.route``, slice
    ids from each device's process): it sends a group to its two-level
    override (uncompressed intra) only when the group is MIXED, some
    process holding several of its devices. Every group the port forms has
    one device a process (one rank, one card): the flat world and the
    (cross, intra) grid of a TwoLevelGroup classify as cross-slice and keep
    their path, whatever the world size; only a layout the port cannot
    form, two processes of two devices, is rerouted."""
    from torch_cgx_tpu.parallel import topology as jtopo

    class Dev:
        def __init__(self, process):
            self.process_index = process
            self.slice_index = None

    class Mesh:
        def __init__(self, procs, shape, names):
            self.devices = np.array([Dev(p) for p in procs], dtype=object).reshape(shape)
            self.axis_names = names
            self.shape = dict(zip(names, shape))

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv("CGX_XLA_ALLREDUCE", "on")
        for ws in (2, 4, 8):
            flat = Mesh(range(ws), (ws,), ("dp",))
            assert jtopo.route(flat, ("dp",), allow_remesh=True).route != jtopo.ROUTE_TWO_LEVEL
            if ws >= 4:
                grid = Mesh(range(ws), (2, ws // 2), ("cross", "intra"))
                d = jtopo.route(grid, ("cross", "intra"))
                assert d.topo.kind == jtopo.TOPO_CROSS and d.route != jtopo.ROUTE_TWO_LEVEL
        mixed = Mesh([0, 0, 1, 1], (2, 2), ("cross", "intra"))
        assert jtopo.route(mixed, ("cross", "intra")).route == jtopo.ROUTE_TWO_LEVEL
    assert "CGX_XLA_ALLREDUCE" not in open(tcfg.__file__).read()  # the port reads no such knob


# The same on two spawned gloo ranks: a tiny float32 GPT-2's make_train_step
# under each setting, the parameters after two steps against the knobs
# unset; CGX_SCHEDULE=on runs the pipelined SRA, CGX_PLANNER=on the planned
# one, and CGX_PLANNER=on with CGX_MEMLEDGER raises on both ranks (no rank
# is left in a collective).
KNOB_RUNS = [
    ("unset", {}), ("schedule_auto", {"CGX_SCHEDULE": "auto"}), ("schedule_off", {"CGX_SCHEDULE": "off"}),
    ("planner_auto", {"CGX_PLANNER": "auto"}), ("planner_off", {"CGX_PLANNER": "off"}),
    ("xla_on", {"CGX_XLA_ALLREDUCE": "on"}), ("xla_off", {"CGX_XLA_ALLREDUCE": "off"}),
]
KNOB_WS = 2
MODEL = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"cgx_knob_model_{os.getpid()}.json")


def _knob_rank(rank, init_file, result_q):
    import torch.distributed as dist

    from torch_cgx_tpu_torch.parallel import hierarchical_groups, planner, schedule

    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ.update(ENV)
    torch.set_num_threads(1)
    out = {}
    # A model file whose fixed cost a block is negligible: the planner then
    # pipelines every compressed slice as deep as its row allows.
    planner.CostModel(chunk_overhead_s=1e-12).save(MODEL)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=KNOB_WS, timeout=timedelta(seconds=120))
        tokens = torch.from_numpy(np.random.default_rng(rank).integers(0, 512, size=(2, 16)))
        for name, knobs in KNOB_RUNS + [("schedule_on", {"CGX_SCHEDULE": "on"}),
                                        ("planner_on", {"CGX_PLANNER": "on", "CGX_PLANNER_MODEL": MODEL}),
                                        ("memledger", {"CGX_PLANNER": "on", "CGX_MEMLEDGER": "1"})]:
            os.environ.update(knobs)
            model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                         generator=torch.Generator().manual_seed(0))
            step = make_train_step(model, lambda m, b: lm_loss(m(b), b),
                                   torch.optim.Adam(model.parameters(), lr=1e-4), device="cpu")
            schedule.reset_counts()
            planner.reset_counts()
            try:
                losses = [float(step(tokens)) for _ in range(2)]
                out[name] = {"losses": losses, "pipelined_slices": schedule.COUNTS["pipelined_slices"],
                             "plans": planner.COUNTS["compiled"],
                             "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}
            except NotImplementedError as e:
                out[name] = {"refused": str(e)}
            for k in knobs:
                del os.environ[k]
        # A TwoLevelGroup (intra 2 x cross 1) is not refused: its sync under
        # CGX_SCHEDULE=on equals the sync unset.
        tl = hierarchical_groups(intra_size=KNOB_WS)
        g = {"a.kernel": torch.from_numpy(np.random.default_rng(10 + rank).standard_normal((64, 128))
                                          .astype(np.float32))}
        base = gradient_sync(g, group=tl)["a.kernel"]
        os.environ["CGX_SCHEDULE"] = "on"
        out["two_level_on_same"] = bool(torch.equal(gradient_sync(g, group=tl)["a.kernel"], base))
        os.environ.update({"CGX_PLANNER": "on", "CGX_MEMLEDGER": "1"})
        out["two_level_planner_same"] = bool(torch.equal(gradient_sync(g, group=tl)["a.kernel"], base))
        del os.environ["CGX_SCHEDULE"], os.environ["CGX_PLANNER"], os.environ["CGX_MEMLEDGER"]
        dist.barrier()
    except Exception:
        import traceback

        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        os.remove(MODEL)
    result_q.put((rank, out))


@pytest.fixture(scope="module")
def knob_world(tmp_path_factory):
    init_file = str(tmp_path_factory.mktemp("gloo_knobs") / "store")
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = [ctx.Process(target=_knob_rank, args=(r, init_file, result_q), daemon=True)
             for r in range(KNOB_WS)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + 300.0
    try:
        while len(results) < KNOB_WS and time.monotonic() < deadline:
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
    assert len(results) == KNOB_WS, f"only ranks {sorted(results)} reported"
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    assert not errors, errors
    return [results[r] for r in range(KNOB_WS)]


@pytest.mark.parametrize("name", [n for n, _ in KNOB_RUNS[1:]])
def test_knob_settings_leave_the_step_bit_identical(knob_world, name):
    """"auto" and "off" of CGX_SCHEDULE and CGX_PLANNER, and either setting
    of CGX_XLA_ALLREDUCE: two train steps on two gloo ranks bit-identical
    to the knobs unset, on every rank."""
    for r, res in enumerate(knob_world):
        assert res[name]["losses"] == res["unset"]["losses"], (name, r)
        for p, v in res["unset"]["params"].items():
            np.testing.assert_array_equal(res[name]["params"][p].view(np.uint32), v.view(np.uint32),
                                          err_msg=f"{name} rank {r} {p}")


def test_knobs_on_refused_on_every_rank(knob_world):
    """Under CGX_SCHEDULE=on and under CGX_PLANNER=on (a model file that
    pipelines every compressed slice) the two steps run the pipelined SRA
    and equal the unset run bit for bit on both ranks; the planner under
    CGX_MEMLEDGER raises on both ranks (no rank waits in a collective); a
    TwoLevelGroup's sync under either knob runs unchanged."""
    for r, res in enumerate(knob_world):
        for name in ("schedule_on", "planner_on"):
            assert "refused" not in res[name], res[name]
            assert res[name]["pipelined_slices"] > 0, (name, res[name]["pipelined_slices"])
            assert res[name]["losses"] == res["unset"]["losses"]
            for p, v in res["unset"]["params"].items():
                np.testing.assert_array_equal(res[name]["params"][p].view(np.uint32),
                                              v.view(np.uint32), err_msg=f"{name} rank {r} {p}")
        assert res["planner_on"]["plans"] > 0 and res["schedule_on"]["plans"] == 0
        assert "CGX_MEMLEDGER" in res["memledger"]["refused"]
        assert res["two_level_on_same"] and res["two_level_planner_same"]
