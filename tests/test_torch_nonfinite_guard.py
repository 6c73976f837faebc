"""The nonfinite gradient guard (``CGX_NONFINITE_GUARD``) in the port, on
the CPU, against the JAX package.

Spawned gloo worlds of 2 and 4 ranks (spawned once for the module; the
world of 4 also forms the cross 2 x intra 2 subgroups). A rank's gradients
are poisoned through its inputs, the same way in both packages: rank 1's
tree holds a NaN, a +Inf and a -Inf (the sync cases), or rank 1's batch
carries a loss scale of NaN at step 1 (the train steps). The fault
injector (``CGX_FAULTS``) is not ported.

* ``gradient_sync(nonfinite_guard=)`` on a poisoned tree equals JAX
  ``gradient_sync`` under the same policy on a mesh of the same shape
  (flat at ws 2 and 4, two-level 2 x 2) bit for bit: "skip" zeros, "exact"
  the sanitized exact mean (integer grids, so any summation order is
  exact); on a clean tree every policy equals "off" and JAX's;
* the counter: one bad step, counted once, on the world's rank 0;
* "skip" resumes bit-identically to a run that never saw the poisoned
  batch (parameters, Adam state, error-feedback residuals), with and
  without error feedback, flat and two-level (the JAX
  ``test_nan_grad_skip_resumes_bit_identically``);
* "exact" applies a finite update from the exact mean of the sanitized
  gradients (held bit for bit against the ranks' raw gradients summed in
  rank order) and keeps the residuals;
* clean "skip" and "exact" runs are bit-identical to "off", with and
  without error feedback; with the guard off the poisoned step poisons the
  parameters;
* the producer plane stays inactive under the guard and under error
  feedback (``CGX_PRODUCER_FUSE=on``), and the parameters equal the
  unguarded, producer-fused run's.

The rank bodies import only torch and the port; JAX runs in the parent.
"""

import multiprocessing as mp
import os
import queue
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

SPAWN_TIMEOUT_S = 300.0
POISON_RANK, POISON_STEP, STEPS = 1, 1, 4
ENV = {"CGX_COMPRESSION_QUANTIZATION_BITS": "4", "CGX_COMPRESSION_BUCKET_SIZE": "64"}
SHAPES = {"a.kernel": (32, 96), "a.bias": (96,), "b.kernel": (48, 64)}
POLICIES = ("off", "skip", "exact")


def _sync_tree(ws, rank, poisoned):
    """Integer grids (every bucket holds 0 and 15), rank 1's poisoned with
    a NaN, a +Inf and a -Inf."""
    t = {}
    for i, (p, s) in enumerate(SHAPES.items()):
        n = int(np.prod(s))
        t[p] = np.float32((np.arange(n) * (2 * i + 3 + rank)) % 16).reshape(s)
    if poisoned and rank == POISON_RANK:
        t["a.kernel"][3, 5] = np.nan
        t["a.bias"][7] = np.inf
        t["b.kernel"][0, 0] = -np.inf
    return t


class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w1 = torch.nn.Parameter(torch.randn(16, 64, generator=g) * 0.3)
        self.b1 = torch.nn.Parameter(torch.zeros(64))
        self.w2 = torch.nn.Parameter(torch.randn(64, 4, generator=g) * 0.3)

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2


def _loss(m, b):
    return ((m(b[0]) - b[1]) ** 2).mean() * b[2]


def _batches(rank, poisoned):
    rng = np.random.default_rng(100 + rank)
    out = []
    for s in range(STEPS):
        x = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float32))
        bad = poisoned and rank == POISON_RANK and s == POISON_STEP
        out.append((x, y, torch.tensor(float("nan") if bad else 1.0)))
    return out


def _np(t):
    return t.detach().numpy().copy()


# ---------------------------------------------------------------------------
# The ranks.
# ---------------------------------------------------------------------------


def _sync_cases(rank, ws, tl, out):
    from torch_cgx_tpu_torch.parallel import grad_sync, gradient_sync

    os.environ.update(ENV)
    groups = {"flat": None, "two_level": tl} if tl is not None else {"flat": None}
    for gname, group in groups.items():
        for poisoned in (False, True):
            g = {p: torch.from_numpy(v) for p, v in _sync_tree(ws, rank, poisoned).items()}
            for policy in POLICIES:
                grad_sync.reset_counts()
                red = gradient_sync(g, group=group, nonfinite_guard=policy)
                out[("sync", gname, poisoned, policy)] = (
                    {p: _np(v) for p, v in red.items()}, grad_sync.COUNTS["nonfinite_steps"])


def _run(rank, policy, *, poisoned, ef, group=None, drop=None, record_exact=False):
    """A fresh MLP and Adam, STEPS steps (less the step ``drop``) under
    ``policy``; the final parameters, Adam state, residuals and counter."""
    from torch_cgx_tpu_torch.parallel import grad_sync, make_train_step

    model = MLP()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, _loss, opt, group=group, device="cpu", error_feedback=ef,
                           nonfinite_guard=policy)
    grad_sync.reset_counts()
    res = {"losses": []}
    for i, b in enumerate(_batches(rank, poisoned)):
        if i == drop:
            continue
        if record_exact and i == POISON_STEP:
            model.zero_grad(set_to_none=True)
            _loss(model, b).backward()
            res["raw"] = {n: _np(p.grad) for n, p in model.named_parameters()}
            res["e_before"] = {n: _np(v) for n, v in step.ef_state.e.items()} if ef else None
        res["losses"].append(float(step(b)))
        if record_exact and i == POISON_STEP:
            res["synced"] = {n: _np(p.grad) for n, p in model.named_parameters()}
            res["e_after"] = {n: _np(v) for n, v in step.ef_state.e.items()} if ef else None
    res["params"] = {n: _np(p) for n, p in model.named_parameters()}
    res["adam"] = {n: {k: _np(v) if torch.is_tensor(v) else v for k, v in opt.state[p].items()}
                   for n, p in model.named_parameters()}
    res["e"] = {n: _np(v) for n, v in step.ef_state.e.items()} if ef else None
    res["count"] = grad_sync.COUNTS["nonfinite_steps"]
    return res


def _train_cases(rank, ws, tl, out):
    os.environ.update(ENV)
    for ef in (False, True):
        out[("skip_faulted", ef)] = _run(rank, "skip", poisoned=True, ef=ef)
        out[("skip_control", ef)] = _run(rank, "skip", poisoned=False, ef=ef, drop=POISON_STEP)
        out[("exact_faulted", ef)] = _run(rank, "exact", poisoned=True, ef=ef, record_exact=True)
        for policy in POLICIES:
            out[(f"{policy}_clean", ef)] = _run(rank, policy, poisoned=False, ef=ef)
        out[("off_faulted", ef)] = _run(rank, "off", poisoned=True, ef=ef)
    if tl is not None:
        for ef in (False, True):
            out[("tl_skip_faulted", ef)] = _run(rank, "skip", poisoned=True, ef=ef, group=tl)
            out[("tl_skip_control", ef)] = _run(rank, "skip", poisoned=False, ef=ef, group=tl,
                                                drop=POISON_STEP)
        out[("tl_exact_faulted", False)] = _run(rank, "exact", poisoned=True, ef=False, group=tl)


def _producer_cases(rank, ws, out):
    """A float32 tiny GPT-2 step with the producer plane on: staged
    payloads under "off" only."""
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.ops import fused_producer
    from torch_cgx_tpu_torch.parallel import make_train_step

    os.environ.update({"CGX_COMPRESSION_QUANTIZATION_BITS": "4", "CGX_COMPRESSION_BUCKET_SIZE": "128",
                       "CGX_STANDALONE_LAYER_ELEMS": "32768", "CGX_PRODUCER_FUSE": "on"})
    cfg = GPT2Config.tiny(dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(rank).integers(0, cfg.vocab_size, (2, 32)))
    for label, kw in (("off", {}), ("skip", {"nonfinite_guard": "skip"}),
                      ("exact", {"nonfinite_guard": "exact"}), ("ef", {"error_feedback": True})):
        model = GPT2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device="cpu", **kw)
        fused_producer.reset_counts()
        step(tokens)
        out[("producer", label)] = {
            "staged": fused_producer.COUNTS["producer_staged"],
            "consumed": fused_producer.COUNTS["producer_consumed_slices"],
            "active": fused_producer.active(),
            "params": {n: _np(p) for n, p in model.named_parameters()},
        }
    del os.environ["CGX_PRODUCER_FUSE"]


def _rank_main(rank, ws, init_file, result_q):
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    import torch.distributed as dist

    from torch_cgx_tpu_torch.parallel import hierarchical_groups

    torch.set_num_threads(1)  # the worlds' ranks share the test machine's cores
    out = {}
    try:
        timeout = timedelta(seconds=120)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=ws, timeout=timeout)
        tl = hierarchical_groups(intra_size=2, timeout=timeout) if ws == 4 else None
        _sync_cases(rank, ws, tl, out)
        _train_cases(rank, ws, tl, out)
        if ws == 2:
            _producer_cases(rank, ws, out)
        dist.barrier()
    except Exception:  # reported to the parent, which fails the test
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((ws, rank, out))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 ranks, spawned at once; results by ws -> list
    by rank."""
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = []
    for ws in (2, 4):
        store = str(tmp_path_factory.mktemp(f"guard_ws{ws}") / "store")
        procs += [ctx.Process(target=_rank_main, args=(r, ws, store, result_q), daemon=True)
                  for r in range(ws)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < 6 and time.monotonic() < deadline:
            try:
                ws, rank, out = result_q.get(timeout=2.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            results[(ws, rank)] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert len(results) == 6, f"only {sorted(results)} reported"
    errors = {k: o["error"] for k, o in results.items() if "error" in o}
    assert not errors, "\n".join(f"{k}:\n{e}" for k, e in errors.items())
    return {ws: [results[(ws, r)] for r in range(ws)] for ws in (2, 4)}


def _jax_sync(ws, two_level, poisoned, policy):
    """JAX ``gradient_sync(nonfinite_guard=policy)`` of the same per-rank
    trees on a mesh of ws CPU devices, or (cross 2, intra 2): per rank, a
    dict by path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu.utils.tree import leaf_paths

    devs = np.asarray(jax.devices()[:ws])
    if two_level:
        mesh, axes, lead = Mesh(devs.reshape(2, 2), ("cross", "intra")), ("cross", "intra"), (2, 2)
    else:
        mesh, axes, lead = Mesh(devs, ("dp",)), ("dp",), (ws,)
    per = [_sync_tree(ws, r, poisoned) for r in range(ws)]
    stacked = {"a": {}, "b": {}}
    for p in SHAPES:
        mod, leaf = p.split(".")
        stacked[mod][leaf] = jnp.asarray(np.stack([t[p] for t in per]).reshape(lead + SHAPES[p]))
    spec = jax.tree.map(lambda _: P(*axes), stacked)
    body = shard_map(
        lambda t: jax.tree.map(
            lambda a: a.reshape((1,) * len(lead) + a.shape),
            jgradient_sync(jax.tree.map(lambda a: a.reshape(a.shape[len(lead):]), t), mesh=mesh,
                           axes=axes, nonfinite_guard=policy),
        ),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False,
    )
    res = jax.jit(body)(stacked)
    return [{p: np.asarray(v).reshape((ws,) + SHAPES[p])[r] for p, v in leaf_paths(res)}
            for r in range(ws)]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _equal_runs(a, b, ef):
    for n in a["params"]:
        np.testing.assert_array_equal(_bits(a["params"][n]), _bits(b["params"][n]), err_msg=n)
        for k, v in a["adam"][n].items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b["adam"][n][k]), err_msg=(n, k))
        if ef:
            np.testing.assert_array_equal(_bits(a["e"][n]), _bits(b["e"][n]), err_msg=n)


def _sync_params():
    return [(ws, g) for ws in (2, 4) for g in (("flat", "two_level") if ws == 4 else ("flat",))]


# ---------------------------------------------------------------------------
# The tests.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws,gname", _sync_params())
@pytest.mark.parametrize("policy", ["skip", "exact"])
def test_poisoned_sync_matches_jax(monkeypatch, worlds, ws, gname, policy):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    want = _jax_sync(ws, gname == "two_level", True, policy)
    for r in range(ws):
        got, count = worlds[ws][r][("sync", gname, True, policy)]
        assert count == (1 if r == 0 else 0), (r, count)
        for p in SHAPES:
            assert np.isfinite(got[p]).all(), (r, p)
            np.testing.assert_array_equal(_bits(got[p]), _bits(want[r][p]), err_msg=f"rank {r} {p}")
            if policy == "skip":
                assert not got[p].any()
    if policy == "exact":  # the sanitized mean: rank 1's NaN/Inf entries count as 0
        per = [_sync_tree(ws, r, True) for r in range(ws)]
        for p in SHAPES:
            want_p = sum(np.where(np.isfinite(t[p]), t[p], 0).astype(np.float64) for t in per) / ws
            np.testing.assert_array_equal(worlds[ws][0][("sync", gname, True, "exact")][0][p],
                                          want_p.astype(np.float32))


@pytest.mark.parametrize("ws,gname", _sync_params())
def test_clean_sync_equals_off_and_jax(monkeypatch, worlds, ws, gname):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    want = _jax_sync(ws, gname == "two_level", False, "skip")
    for r in range(ws):
        off, _ = worlds[ws][r][("sync", gname, False, "off")]
        for policy in ("skip", "exact"):
            got, count = worlds[ws][r][("sync", gname, False, policy)]
            assert count == 0
            for p in SHAPES:
                np.testing.assert_array_equal(_bits(got[p]), _bits(off[p]), err_msg=(policy, p))
                np.testing.assert_array_equal(_bits(got[p]), _bits(want[r][p]), err_msg=(policy, p))


@pytest.mark.parametrize("ws,gname", _sync_params())
def test_unguarded_sync_is_poisoned(worlds, ws, gname):
    """With the guard off, rank 1's three bad values poison the buckets
    they share with other values, on every rank."""
    for r in range(ws):
        got, count = worlds[ws][r][("sync", gname, True, "off")]
        assert count == 0
        assert not np.isfinite(got["a.kernel"]).all() and not np.isfinite(got["b.kernel"]).all()


@pytest.mark.parametrize("ws", [2, 4])
@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_skip_resumes_bit_identically(worlds, ws, ef):
    for r, o in enumerate(worlds[ws]):
        f, c = o[("skip_faulted", ef)], o[("skip_control", ef)]
        assert f["count"] == (1 if r == 0 else 0)
        assert all(np.isfinite(v).all() for v in f["params"].values())
        assert np.isnan(f["losses"][POISON_STEP])
        _equal_runs(f, c, ef)


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_two_level_skip_resumes_and_counts(worlds, ef):
    for r, o in enumerate(worlds[4]):
        f, c = o[("tl_skip_faulted", ef)], o[("tl_skip_control", ef)]
        assert f["count"] == (1 if r == 0 else 0)
        _equal_runs(f, c, ef)
    for r, o in enumerate(worlds[4]):
        x = o[("tl_exact_faulted", False)]
        assert x["count"] == (1 if r == 0 else 0)
        assert all(np.isfinite(v).all() for v in x["params"].values())
        for n, v in x["params"].items():
            np.testing.assert_array_equal(_bits(v), _bits(worlds[4][0][("tl_exact_faulted", False)]["params"][n]))


@pytest.mark.parametrize("ws", [2, 4])
@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_exact_applies_the_sanitized_exact_mean(worlds, ws, ef):
    res = [o[("exact_faulted", ef)] for o in worlds[ws]]
    for n in res[0]["raw"]:
        total = np.zeros_like(res[0]["raw"][n])
        for o in res:  # rank order, in float32, as the exact sum folds
            total = total + np.where(np.isfinite(o["raw"][n]), o["raw"][n], np.float32(0))
        want = total / np.float32(ws)
        for r, o in enumerate(res):
            np.testing.assert_array_equal(_bits(o["synced"][n]), _bits(want), err_msg=f"rank {r} {n}")
    for r, o in enumerate(res):
        assert o["count"] == (1 if r == 0 else 0)
        assert all(np.isfinite(v).all() for v in o["params"].values())
        # The step was applied: the parameters differ from the skipped run's.
        skipped = worlds[ws][r][("skip_faulted", ef)]["params"]
        assert any(not np.array_equal(v, skipped[n]) for n, v in o["params"].items())
        if ef:  # the residuals stay as they were
            for n, v in o["e_before"].items():
                np.testing.assert_array_equal(_bits(o["e_after"][n]), _bits(v))
        for n, v in o["params"].items():
            np.testing.assert_array_equal(_bits(v), _bits(res[0]["params"][n]))


@pytest.mark.parametrize("ws", [2, 4])
@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_clean_guarded_runs_are_bit_identical_to_off(worlds, ws, ef):
    for o in worlds[ws]:
        for policy in ("skip", "exact"):
            assert o[(f"{policy}_clean", ef)]["count"] == 0
            _equal_runs(o[(f"{policy}_clean", ef)], o[("off_clean", ef)], ef)


@pytest.mark.parametrize("ws", [2, 4])
@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_unguarded_step_poisons_the_parameters(worlds, ws, ef):
    for o in worlds[ws]:
        run = o[("off_faulted", ef)]
        assert run["count"] == 0
        assert not all(np.isfinite(v).all() for v in run["params"].values())


def test_producer_plane_inactive_under_guard_and_error_feedback(worlds):
    for o in worlds[2]:
        off = o[("producer", "off")]
        assert off["active"] and off["staged"] > 0 and off["consumed"] > 0
        for label in ("skip", "exact", "ef"):
            c = o[("producer", label)]
            assert not c["active"] and c["staged"] == 0 and c["consumed"] == 0, label
        for label in ("skip", "exact"):  # a clean step: the unguarded (producer-fused) one
            for n, v in off["params"].items():
                np.testing.assert_array_equal(_bits(o[("producer", label)]["params"][n]), _bits(v))
