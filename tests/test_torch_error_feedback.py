"""Error feedback in the port against the JAX package, on the CPU.

Spawned gloo worlds of 2 and 4 ranks (spawned once for the module; the
world of 4 also forms the cross 2 x intra 2 subgroups) run one
error-feedback sync (``grad_sync._ef_sync``: ``g / ws + e``, the quantized
sum, the residual against the round trip) and one
``allreduce_tree(..., return_roundtrip=True)`` of a small gradient tree (a
standalone layer of whole 32-bucket chunks and a tail, a fused group, an
uncompressed bias) under each scheme, at 2 bits: the flat SRA (both
epilogue lowerings), the all-to-all, the Ring, the exact wires (PSUM,
compression off, the dummy codec) and the fake ratio, and the two-level
scheme with the leader scheme, without it and with the intra level
uncompressed. The JAX package's ``_ef_sync`` and ``allreduce_tree`` run on
``shard_map`` meshes of the same shapes.

* the reduced gradients, ``rt`` and the residual equal JAX's bit for bit on
  decode-exact data (integer grids whose buckets hold 0 and 15: ROADMAP C1
  limits bit equality to such data) and stay within the
  ``allreduce_error_bound`` envelope of JAX's and of the exact sum on
  random data (twice the envelope over two levels);
* the residual is exactly 0 on the exact wires, on uncompressed leaves and
  on the fake ratio's tail, and, after one sync of a known gradient, within
  half a unit of its bucket of the wire layout and 0 on the own chunk (the
  JAX ``test_error_feedback_residual_mechanics``);
* under stochastic rounding ``rt`` is the decode of the payload the wire
  sent (captured from the transport: SRA's and the two levels' stage 1,
  the all-to-all's row, the Ring's hop 0), so the mirrors draw the wire's
  own keys;
* every rank holds the same reduced bytes;
* the JAX outlier toy: with error feedback the final loss is below 0.9 x
  the loss without it at 2 bits (ws 4);
* ``make_train_step(error_feedback=True)`` trains a bf16 tiny GPT-2 (ws 2)
  and a float32 one over the two-level group (ws 4), replicas identical;
  at world size 1 under ``CGX_DEBUG_FORCE_CODEC`` its three steps match the
  JAX ``_step_ef`` within ``tests/test_torch_gpt2_step.py``'s tolerance
  (losses to a relative 1e-4, parameters to 3 x lr).

The rank bodies import only torch and the port; JAX runs in the parent.
"""

import contextlib
import functools
import multiprocessing as mp
import os
import queue
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.ops import codec

SPAWN_TIMEOUT_S = 300.0
BITS, BUCKET = 2, 128
BASE_ENV = {
    "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS),
    "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
    "CGX_STANDALONE_LAYER_ELEMS": "16384",
}
# a.kernel: standalone, at ws 4 a chunk of 2 x 32 buckets and 8 more, at
# ws 2 4 x 32 and 16; b.kernel and c.kernel: one fused group; b.bias: raw.
SHAPES = {"a.kernel": (128, 288), "b.bias": (96,), "b.kernel": (32, 96), "c.kernel": (48, 64)}
FLAT = {
    "sra": {},
    "sra_fused": {"CGX_SRA_EPILOGUE": "fused"},
    "alltoall": {"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1"},
    "ring": {"CGX_INNER_REDUCTION_TYPE": "RING"},
}
EXACT = {
    "psum": {"CGX_INNER_REDUCTION_TYPE": "PSUM"},
    "off": {"CGX_COMPRESSION_QUANTIZATION_BITS": "32"},
    "dummy": {"CGX_DEBUG_DUMMY_COMPRESSION": "1"},
    "fake_ratio": {"CGX_COMPRESSION_FAKE_RATIO": "0.4"},
}
TWO_LEVEL = {
    "leader": {},
    "leader_fused": {"CGX_SRA_EPILOGUE": "fused"},
    "two_pass": {"CGX_INTRA_BROADCAST": "0"},
    "uncompressed_intra": {"CGX_INTRA_COMPRESS": "0"},
}
FAKE_RATIO = 0.4
DATA = ("grid", "random")


def _schemes(ws):
    out = {**FLAT, **EXACT}
    if ws == 4:
        out.update({f"tl_{k}": v for k, v in TWO_LEVEL.items()})
    return out


def _tree(ws, data):
    """Per-rank gradients: integer grids (decode-exact) or normal draws."""
    rng = np.random.default_rng(ws)
    out = []
    for r in range(ws):
        t = {}
        for i, (p, s) in enumerate(SHAPES.items()):
            n = int(np.prod(s))
            if data == "grid":
                t[p] = np.float32((np.arange(n) * (2 * i + 3 + r)) % 16).reshape(s)
            else:
                t[p] = rng.standard_normal(s).astype(np.float32)
        out.append(t)
    return out


@contextlib.contextmanager
def _env(knobs):
    saved = {k: os.environ.get(k) for k in list(BASE_ENV) + list(knobs)}
    os.environ.update({**BASE_ENV, **knobs})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# The ranks.
# ---------------------------------------------------------------------------


def _ef_cases(rank, ws, tl, out):
    from torch_cgx_tpu_torch.parallel import allreduce_tree, grad_sync

    for scheme, knobs in _schemes(ws).items():
        group = tl if scheme.startswith("tl_") else None
        for data in DATA:
            g = {p: torch.from_numpy(v) for p, v in _tree(ws, data)[rank].items()}
            with _env(knobs):
                e0 = {p: torch.zeros(v.shape) for p, v in g.items()}
                reduced, e = grad_sync._ef_sync(g, e0, group=group, key=None, divisor=ws)
                _, rt = allreduce_tree({p: v / ws for p, v in g.items()}, group=group,
                                       return_roundtrip=True)
            out[(scheme, data)] = {
                "reduced": {p: v.numpy() for p, v in reduced.items()},
                "e": {p: v.numpy() for p, v in e.items()},
                "rt": {p: v.numpy() for p, v in rt.items()},
            }


def _mechanics_case(rank, ws, out):
    """One EF sync of the same known gradient on every rank (the JAX
    residual-mechanics test), 2 bits, bucket 64."""
    from torch_cgx_tpu_torch.parallel import grad_sync

    g = torch.from_numpy(np.random.default_rng(3).normal(size=(16, 32)).astype(np.float32))
    with _env({"CGX_COMPRESSION_BUCKET_SIZE": "64"}):
        _, e = grad_sync._ef_sync({"w": g}, {"w": torch.zeros(16, 32)}, group=None, key=None,
                                  divisor=ws)
    out["mechanics"] = e["w"].numpy()


def _stochastic_cases(rank, ws, tl, out):
    """``rt`` against the decode of the payload the transport sent, captured
    by wrapping the reducers' stage-1 exchange, the all-to-all's quantize
    and the Ring's hop."""
    from torch_cgx_tpu_torch.config import CompressionConfig
    from torch_cgx_tpu_torch.ops import dispatch
    from torch_cgx_tpu_torch.parallel import allreduce_flat, group as group_mod, reducers
    from torch_cgx_tpu_torch.utils import prng

    n = ws * (2 * 32 + 3) * BUCKET - 5
    x = torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(n).astype(np.float32))
    key = prng.key(7)
    sent = []
    inner = {k: getattr(reducers, k) for k in ("_sra_exchange", "_alltoall_q", "_shift_right")}

    def exchange(x_, group, ws_, cc, pre=None, key=None):
        res = inner["_sra_exchange"](x_, group, ws_, cc, pre, key)
        sent.append(("sra", group, ws_, res[0]))
        return res

    def a2a(x_, group, cc, key=None):
        q = inner["_alltoall_q"](x_, group, cc, key)
        sent.append(("a2a", group, 1, q))
        return q

    def shift(q, group):
        sent.append(("ring", group, 1, q))
        return inner["_shift_right"](q, group)

    reducers._sra_exchange, reducers._alltoall_q, reducers._shift_right = exchange, a2a, shift
    cases = {"sra": ({}, None), "alltoall": ({"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1"}, None),
             "ring": ({"CGX_INNER_REDUCTION_TYPE": "RING"}, None)}
    if ws == 4:
        cases.update({"tl_leader": ({}, tl), "tl_two_pass": ({"CGX_INTRA_BROADCAST": "0"}, tl)})
    try:
        for name, (knobs, group) in cases.items():
            with _env({"CGX_STOCHASTIC_ROUNDING": "1", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
                       **knobs}):
                cc = CompressionConfig(bits=4, bucket_size=BUCKET, stochastic=True)
                sent.clear()
                y, rt = allreduce_flat(x, cc, group=group, key=key, return_roundtrip=True)
                wire = sent[0]
                _, rt_det = allreduce_flat(x, CompressionConfig(bits=4, bucket_size=BUCKET),
                                           group=group, return_roundtrip=True)
            kind, g_, rows, q = wire
            vals = dispatch.dequantize_batch(q, out_dtype=torch.float32)
            if kind == "sra":
                me = group_mod.rank(g_)
                want = x.clone()
                chunk = vals.shape[1]
                flat = vals.reshape(-1)[:n]
                mask = torch.ones(n, dtype=torch.bool)
                mask[me * chunk : (me + 1) * chunk] = False
                want[mask] = flat[mask]
            elif kind == "a2a":
                want = vals[0][:n]
            else:  # the Ring's hop 0: this rank's own segment decoded
                me = group_mod.rank(g_)
                seg = vals.shape[1]
                want = x.clone()
                hi = min((me + 1) * seg, n)
                want[me * seg : hi] = vals[0][: hi - me * seg]
            out[("stochastic", name)] = {
                "rt_is_wire": bool(torch.equal(rt.view(torch.int32), want.view(torch.int32))),
                "moved": not torch.equal(rt, rt_det),
                "reduced": y.numpy(),
            }
    finally:
        for k, v in inner.items():
            setattr(reducers, k, v)


def _outlier_toy(rank, ws, out):
    """The JAX package's outlier-bucket toy: a linear model on inputs whose
    every eighth feature is 100x the rest, 80 Adam steps at 2 bits, with
    and without error feedback. Each rank trains on its shard of the batch."""
    from torch_cgx_tpu_torch.parallel import make_train_step

    d = 512
    rng = np.random.default_rng(0)
    scale = np.where(np.arange(d) % 8 == 0, 100.0, 1.0)
    xs = (rng.normal(size=(256, d)) * scale).astype(np.float32)
    w_true = (rng.normal(size=(d, 1)) / np.sqrt(d) / scale[:, None]).astype(np.float32)
    ys = xs @ w_true
    shard = 256 // ws
    batch = (torch.from_numpy(xs[rank * shard : (rank + 1) * shard]),
             torch.from_numpy(ys[rank * shard : (rank + 1) * shard]))

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(d, 1))

    def loss_fn(m, b):
        return torch.mean((b[0] @ m.w - b[1]) ** 2)

    with _env({"CGX_COMPRESSION_BUCKET_SIZE": "64"}):
        for ef in (True, False):
            m = Linear()
            opt = torch.optim.Adam(m.parameters(), lr=3e-3)
            step = make_train_step(m, loss_fn, opt, device="cpu", error_feedback=ef)
            for _ in range(80):
                loss = float(step(batch))
            out[("outlier", ef)] = loss


def _gpt2_cases(rank, ws, tl, out):
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.parallel import make_train_step

    cfg = GPT2Config.tiny()
    tokens = torch.from_numpy(np.random.default_rng(rank).integers(0, cfg.vocab_size, (2, 32)))
    runs = {"bf16": (torch.bfloat16, None)} if ws == 2 else {"two_level": (torch.float32, tl)}
    with _env({"CGX_STANDALONE_LAYER_ELEMS": "40000"}):
        for label, (dtype, group) in runs.items():
            model = GPT2(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).to(dtype)
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, group=group,
                                   device="cpu", error_feedback=True)
            losses = [float(step(tokens)) for _ in range(3)]
            e = step.ef_state.e
            out[("gpt2", label)] = {
                "losses": losses,
                "params": {n: p.detach().float().numpy().copy() for n, p in model.named_parameters()},
                "dtypes": {str(p.dtype) for p in model.parameters()},
                "e_dtypes": {str(v.dtype) for v in e.values()},
                "e_nonzero": sum(int((v != 0).sum()) for v in e.values()),
                "e_keys": sorted(e) == sorted(n for n, _ in model.named_parameters()),
            }


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
        _ef_cases(rank, ws, tl, out)
        _mechanics_case(rank, ws, out)
        _stochastic_cases(rank, ws, tl, out)
        if ws == 4:
            _outlier_toy(rank, ws, out)
        _gpt2_cases(rank, ws, tl, out)
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
        store = str(tmp_path_factory.mktemp(f"ef_ws{ws}") / "store")
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


# ---------------------------------------------------------------------------
# The JAX package's side.
# ---------------------------------------------------------------------------


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


@functools.lru_cache(maxsize=None)
def _jax_ef(ws: int, scheme: str, data: str):
    """JAX ``_ef_sync`` (zero residuals, divisor ws) and ``allreduce_tree(
    return_roundtrip=True)`` of ``g / ws`` on a mesh of ws CPU devices, or
    (cross 2, intra 2) for the two-level schemes: per rank, dicts by path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.parallel import allreduce as jallreduce
    from torch_cgx_tpu.parallel import grad_sync as jgs
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu.utils.tree import leaf_paths

    two = scheme.startswith("tl_")
    devs = np.asarray(jax.devices()[:ws])
    if two:
        mesh, axes, lead = Mesh(devs.reshape(2, 2), ("cross", "intra")), ("cross", "intra"), (2, 2)
    else:
        mesh, axes, lead = Mesh(devs, ("dp",)), ("dp",), (ws,)
    per = _tree(ws, data)
    stacked = _nest({p: jnp.asarray(np.stack([t[p] for t in per]).reshape(lead + per[0][p].shape))
                     for p in SHAPES})
    spec = jax.tree.map(lambda _: P(*axes), stacked)

    def body(t):
        g = jax.tree.map(lambda a: a.reshape(a.shape[len(lead):]), t)
        e0 = jax.tree.map(jnp.zeros_like, g)
        red, e = jgs._ef_sync(g, e0, mesh=mesh, axes=axes, topology=None, key=None, divisor=ws)
        _, rt = jallreduce.allreduce_tree(jax.tree.map(lambda a: a / ws, g), mesh=mesh, axes=axes,
                                          return_roundtrip=True)
        back = functools.partial(jax.tree.map, lambda a: a.reshape((1,) * len(lead) + a.shape))
        return back(red), back(e), back(rt)

    knobs = _schemes(ws)[scheme]
    with _env(knobs):
        fn = shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec, spec),
                       check_vma=False)
        res = jax.jit(fn)(stacked)
    out = []
    for r in range(ws):
        one = {}
        for label, tree in zip(("reduced", "e", "rt"), res):
            one[label] = {p: np.asarray(v).reshape((ws,) + SHAPES[p])[r] for p, v in leaf_paths(tree)}
        out.append(one)
    return out


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# The tests.
# ---------------------------------------------------------------------------


def _all_schemes():
    return [(ws, s) for ws in (2, 4) for s in _schemes(ws)]


@pytest.mark.parametrize("ws,scheme", _all_schemes())
def test_matches_jax_bit_for_bit_on_decode_exact_data(worlds, ws, scheme):
    want = _jax_ef(ws, scheme, "grid")
    lossy = 0
    for r in range(ws):
        got = worlds[ws][r][(scheme, "grid")]
        for label in ("reduced", "e", "rt"):
            for p in SHAPES:
                np.testing.assert_array_equal(_bits(got[label][p]), _bits(want[r][label][p]),
                                              err_msg=f"{label} rank {r} {p}")
        lossy += sum(int((got["e"][p] != 0).sum()) for p in SHAPES)
    if scheme in FLAT or scheme in ("tl_leader", "tl_leader_fused", "tl_two_pass"):
        assert lossy > 0  # 2 bits cannot carry 16 levels: the residual is real


@pytest.mark.parametrize("ws,scheme", _all_schemes())
def test_within_the_envelope_on_random_data(worlds, ws, scheme):
    want = _jax_ef(ws, scheme, "random")
    per = _tree(ws, "random")
    k = 2 if scheme.startswith("tl_") else 1
    for p in SHAPES:
        x = np.stack([t[p] for t in per]).reshape(ws, -1) / ws
        exact = x.astype(np.float64).sum(axis=0)
        step = float((x.max() - x.min()) / BUCKET)
        bound = k * codec.allreduce_error_bound(x.shape[1], BITS, BUCKET, ws, step)
        for r in range(ws):
            got = worlds[ws][r][(scheme, "random")]
            red = got["reduced"][p].reshape(-1)
            if scheme != "fake_ratio":
                assert np.abs(red - exact).max() <= bound, (p, r)
            assert np.abs(red - want[r]["reduced"][p].reshape(-1)).max() <= bound, (p, r)
            assert np.abs(got["e"][p] - want[r]["e"][p]).max() <= bound, (p, r)
            assert np.abs(got["rt"][p] - want[r]["rt"][p]).max() <= bound, (p, r)
            # The residual is what the wire lost of this rank's contribution.
            np.testing.assert_array_equal(got["e"][p], x[r].reshape(SHAPES[p]) - got["rt"][p])


@pytest.mark.parametrize("ws", [2, 4])
@pytest.mark.parametrize("scheme", ["psum", "off", "dummy"])
def test_zero_residual_on_exact_wires(worlds, ws, scheme):
    for data in DATA:
        per = _tree(ws, data)
        for r in range(ws):
            got = worlds[ws][r][(scheme, data)]
            for p in SHAPES:
                assert not got["e"][p].any(), (data, r, p)
                np.testing.assert_array_equal(got["rt"][p], per[r][p] / ws)


@pytest.mark.parametrize("ws", [2, 4])
def test_zero_residual_on_raw_leaves_and_the_fake_ratio_tail(worlds, ws):
    """Uncompressed leaves (the bias) carry no residual under any scheme;
    under the fake ratio the tail of each compressed buffer carries none,
    while its travelling head does."""
    for scheme in _schemes(ws):
        for data in DATA:
            for r in range(ws):
                assert not worlds[ws][r][(scheme, data)]["e"]["b.bias"].any(), (scheme, r)
    for r in range(ws):
        e = worlds[ws][r][("fake_ratio", "random")]["e"]
        a = e["a.kernel"].reshape(-1)
        m = int(np.ceil(FAKE_RATIO * a.size))
        assert a[:m].any() and not a[m:].any()
        fused = np.concatenate([e["b.kernel"].reshape(-1), e["c.kernel"].reshape(-1)])
        m = int(np.ceil(FAKE_RATIO * fused.size))
        assert fused[:m].any() and not fused[m:].any()


@pytest.mark.parametrize("ws", [2, 4])
def test_residual_within_half_a_unit_of_the_wire_layout(worlds, ws):
    """JAX ``test_error_feedback_residual_mechanics``: g / ws in (ws, chunk)
    rows, buckets of 64 restarting at each row, deterministic rounding
    error at most half a unit; the own row (folded raw) exactly 0."""
    g = np.random.default_rng(3).normal(size=(16, 32)).astype(np.float32)
    chunk = 512 // ws
    rows = (g.astype(np.float64).reshape(-1) / ws).reshape(ws, chunk // 64, 64)
    unit = (rows.max(axis=2) - rows.min(axis=2)) / (2**BITS - 1)
    bound = unit[:, :, None] / 2 + 1e-6
    for r in range(ws):
        e = worlds[ws][r]["mechanics"].reshape(ws, chunk // 64, 64)
        assert np.abs(e).max() > 0, "2-bit quantization left a zero residual"
        assert (np.abs(e) <= bound).all(), r
        assert not e[r].any(), r


@pytest.mark.parametrize("ws,name", [(2, "sra"), (2, "alltoall"), (2, "ring"), (4, "sra"),
                                     (4, "alltoall"), (4, "ring"), (4, "tl_leader"),
                                     (4, "tl_two_pass")])
def test_stochastic_roundtrip_is_the_wires_own_decode(worlds, ws, name):
    for r, o in enumerate(worlds[ws]):
        c = o[("stochastic", name)]
        assert c["rt_is_wire"], r
        assert c["moved"], r  # the draw moved the round trip off round-to-nearest
        np.testing.assert_array_equal(c["reduced"], worlds[ws][0][("stochastic", name)]["reduced"])


@pytest.mark.parametrize("ws", [2, 4])
def test_replicas_identical(worlds, ws):
    res = worlds[ws]
    for scheme in _schemes(ws):
        if scheme == "fake_ratio":
            continue  # the un-reduced tail differs by design
        for data in DATA:
            for r in range(1, ws):
                for p in SHAPES:
                    np.testing.assert_array_equal(_bits(res[r][(scheme, data)]["reduced"][p]),
                                                  _bits(res[0][(scheme, data)]["reduced"][p]))


def test_error_feedback_improves_outlier_bucket_training(worlds):
    losses = {ef: [o[("outlier", ef)] for o in worlds[4]] for ef in (True, False)}
    for ef, ls in losses.items():
        assert len(set(ls)) == 1, (ef, ls)  # the averaged loss, the same on every rank
    assert losses[True][0] < 0.9 * losses[False][0], losses


@pytest.mark.parametrize("ws,label", [(2, "bf16"), (4, "two_level")])
def test_tiny_gpt2_trains_with_error_feedback(worlds, ws, label):
    res = [o[("gpt2", label)] for o in worlds[ws]]
    r0 = res[0]
    assert np.all(np.isfinite(r0["losses"])) and r0["losses"][-1] < r0["losses"][0]
    assert r0["dtypes"] == ({"torch.bfloat16"} if label == "bf16" else {"torch.float32"})
    for o in res:
        assert o["losses"] == r0["losses"]
        assert o["e_dtypes"] == {"torch.float32"} and o["e_keys"] and o["e_nonzero"] > 0
        for p, v in r0["params"].items():
            np.testing.assert_array_equal(_bits(o["params"][p]), _bits(v), err_msg=p)


# ---------------------------------------------------------------------------
# The train step against the JAX one, at world size 1.
# ---------------------------------------------------------------------------

STEP_ENV = {
    "CGX_DEBUG_FORCE_CODEC": "1",
    "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
    "CGX_COMPRESSION_BUCKET_SIZE": "384",
    "CGX_FUSION_BUFFER_SIZE_MB": "1",
    "CGX_STANDALONE_LAYER_ELEMS": "40000",
}
VOCAB, LR = 4099, 1e-4


def test_train_steps_match_jax_step_ef(monkeypatch):
    """Three steps of ``make_train_step(error_feedback=True)`` against the
    JAX ``make_train_step(error_feedback=True)`` (``_step_ef``) on a
    one-device mesh, from the same parameters (``gpt2_params_from_jax``)
    and tokens; the world-size-1 codec proxy is the wire, so its output is
    the round trip and the residual is real."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from torch_cgx_tpu.models import GPT2 as JGPT2
    from torch_cgx_tpu.models import GPT2Config as JGPT2Config
    from torch_cgx_tpu.models import lm_loss as jlm_loss
    from torch_cgx_tpu.parallel import init_error_feedback as jinit_ef
    from torch_cgx_tpu.parallel import make_train_step as jmake_train_step
    from torch_cgx_tpu.parallel import replicate, shard_batch
    from torch_cgx_tpu.utils.tree import leaf_paths
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_jax, gpt2_params_to_numpy
    from torch_cgx_tpu_torch.models import lm_loss
    from torch_cgx_tpu_torch.parallel import make_train_step

    for k, v in STEP_ENV.items():
        monkeypatch.setenv(k, v)
    jm = JGPT2(JGPT2Config.tiny(vocab_size=VOCAB, dtype=jnp.float32))
    tokens = np.random.default_rng(1).integers(0, VOCAB, size=(2, 64)).astype(np.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"])
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    opt = optax.adam(LR)
    p = replicate(jax.tree.map(jnp.asarray, params), mesh)
    s = replicate(opt.init(p), mesh)
    ef = jinit_ef(params, mesh)
    jstep = jmake_train_step(lambda pp, t: jlm_loss(jm.apply({"params": pp}, t), t), opt, mesh,
                             donate=False, error_feedback=True)
    jl = []
    for i in range(3):
        p, s, ef, loss = jstep(p, s, ef, shard_batch(jnp.asarray(tokens), mesh), jnp.int32(i))
        jl.append(float(loss))

    model = GPT2(GPT2Config.tiny(vocab_size=VOCAB, dtype=torch.float32), device="cpu")
    model.load_state_dict(gpt2_params_from_jax(params))
    topt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), topt, device="cpu",
                           error_feedback=True)
    t = torch.from_numpy(tokens)
    tl = [float(step(t)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    flat_t = dict(leaf_paths(gpt2_params_to_numpy(model)))
    for path, v in leaf_paths(jax.tree.map(np.asarray, p)):
        np.testing.assert_allclose(flat_t[path], v, rtol=0, atol=3 * LR, err_msg=path)
    # The residuals: per parameter, float32, the JAX ones' within the codec's
    # step at this width (a residual is at most half a unit of its bucket).
    je = {path: np.asarray(v)[0] for path, v in leaf_paths(ef)}
    assert sorted(je) == sorted(step.ef_state.e)
    moved = 0
    for path, v in step.ef_state.e.items():
        assert v.dtype == torch.float32 and v.shape == je[path].shape
        moved += int((v != 0).sum())
    assert moved > 0


def test_init_error_feedback_and_the_state_the_step_keeps():
    """``init_error_feedback`` gives float32 zeros shaped like the trainable
    parameters (of a module or a mapping); the step keeps the state it is
    given and updates it in place; a state without ``error_feedback`` is a
    ``ValueError``."""
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.parallel import ErrorFeedbackState, init_error_feedback, make_train_step

    model = GPT2(GPT2Config.tiny(), device="cpu", generator=torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16)
    state = init_error_feedback(model)
    assert isinstance(state, ErrorFeedbackState)
    assert list(state.e) == [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        assert state.e[n].dtype == torch.float32 and state.e[n].shape == p.shape and not state.e[n].any()
    assert init_error_feedback({"w": torch.ones(3, 4)}).e["w"].shape == (3, 4)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with _env({"CGX_DEBUG_FORCE_CODEC": "1"}):
        with pytest.raises(ValueError, match="error_feedback"):
            make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device="cpu", ef_state=state)
        step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device="cpu",
                               error_feedback=True, ef_state=state)
        assert step.ef_state is state
        step(torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 16))))
    assert any(v.any() for v in state.e.values())
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
