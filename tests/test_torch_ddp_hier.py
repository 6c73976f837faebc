"""The DDP hook's two-level scheme, host key and asynchronous bucket
allreduce (``torch_cgx_tpu_torch/torch_backend/``) against the JAX
package's hook over its ``"cgx"`` backend.

Function level: the host key against ``torch_cgx_tpu.torch_backend.shm.
host_fingerprint`` (with ``CGX_SHM_HOST_ID``, from the boot id, with the
boot id unreadable), two ranks of one hostname and two boot ids as two
hosts, and the host classification and leaders against the JAX backend's.

DDP level, in spawned ranks (the worlds run one after another when the
module's first DDP test asks for them; tolerance 0, parameters compared bit for
bit): the bias-free MLP of ``test_torch_ddp_hook.py`` under DDP at world
size 4 on two faked hosts (``CGX_SHM_HOST_ID=testhost{rank // 2}``), 8 SGD
steps, in the port's gloo ranks and the JAX package's ``"cgx"`` ranks,
under the default scheme (intra SRA, cross Ring, leader scheme), cross SRA,
cross all-to-all, ``CGX_INTRA_COMPRESS=0``, a bf16 bucket, and
``CGX_COMPRESSION_FAKE_RATIO=0.5`` over the two-level and the flat
reduction; a three-rank hook group on hosts ``[a, a, b]`` (the port's a
subgroup of global ranks 1-3 of its four, so group ranks are not global
ranks) against a JAX world of three; ``allreduce_flat`` at ratio 0.5
against the JAX one on the four-device CPU mesh. In the port's ranks also:
``chip_smoke.LaunchModel.hook`` on a leader and a non-leader against the
codec wrappers' calls counted on the CPU, a two-level allreduce again
after ``release`` and a map on one host, every bucket reduced on the
group's worker thread, ``cgx_hook``'s future
still pending while the worker is held, and a bucket that raises (a stale
registry) raising through ``loss.backward()`` within a bound.
"""

import multiprocessing as mp
import os
import queue
import threading
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_cgx_tpu_torch.torch_backend import backend as pb

SPAWN_TIMEOUT_S = 240.0
STEPS = 8
RAISE_BOUND_S = 60.0


# ---------------------------------------------------------------------------
# Function level: the host key and the host classification.
# ---------------------------------------------------------------------------


@pytest.fixture
def shm():
    from torch_cgx_tpu.torch_backend import shm

    return shm


def _boot_id_reads(boot):
    """An ``open`` that serves ``boot`` as the boot id (OSError for None)."""
    real = open

    def fake(path, *a, **k):
        if str(path).endswith("boot_id"):
            if boot is None:
                raise OSError("unreadable")
            path = _boot_file(boot)
        return real(path, *a, **k)

    return fake


_BOOT_DIR = {}


def _boot_file(boot):
    return _BOOT_DIR["dir"] / f"{boot}.txt"


@pytest.mark.parametrize("case", ["override", "boot_id", "no_boot_id"])
def test_host_key_matches_jax(shm, monkeypatch, tmp_path, case):
    _BOOT_DIR["dir"] = tmp_path
    (tmp_path / "boot-1.txt").write_text("boot-1\n")
    monkeypatch.delenv("CGX_SHM_HOST_ID", raising=False)
    if case == "override":
        monkeypatch.setenv("CGX_SHM_HOST_ID", "testhost7")
    boot = None if case == "no_boot_id" else "boot-1"
    monkeypatch.setattr(pb, "open", _boot_id_reads(boot), raising=False)
    monkeypatch.setattr(shm, "open", _boot_id_reads(boot), raising=False)
    key = pb.host_fingerprint()
    assert key == shm.host_fingerprint()
    want = {"override": "testhost7", "boot_id": ":boot-1", "no_boot_id": ":noboot"}[case]
    assert key.endswith(want), key


def test_one_hostname_two_boot_ids_are_two_hosts(monkeypatch, tmp_path):
    _BOOT_DIR["dir"] = tmp_path
    monkeypatch.delenv("CGX_SHM_HOST_ID", raising=False)
    monkeypatch.setattr(pb.socket, "gethostname", lambda: "samehost")
    keys = []
    for boot in ("boot-a", "boot-b"):
        (tmp_path / f"{boot}.txt").write_text(boot)
        monkeypatch.setattr(pb, "open", _boot_id_reads(boot), raising=False)
        keys.append(pb.host_fingerprint())
    assert keys == ["samehost:boot-a", "samehost:boot-b"]
    assert pb._host_topology(keys) == pb.TOPO_CROSS
    assert pb._host_topology(keys + keys[:1]) == pb.TOPO_MIXED


HOST_MAPS = [
    [], ["a"], ["a", "a"], ["a", "b"], ["a", "a", "b"], ["a", "b", "b"], ["a", "b", "a", "b"],
    ["a", "a", "b", "b"], ["b", "a", "a", "c", "c", "c"], ["x", "y", "z"],
]


@pytest.mark.parametrize("hosts", HOST_MAPS, ids=lambda h: "".join(h) or "empty")
def test_host_classification_matches_jax(hosts):
    from torch_cgx_tpu.torch_backend import backend as jb

    assert pb._host_topology(hosts) == jb._host_topology(hosts)
    assert pb._slice_leaders(hosts) == jb._slice_leaders(hosts)


@pytest.mark.parametrize("raw", ["on", "ON", "off", "auto", "bogus"])
def test_async_knob_parses_as_jax_and_is_refused_on_two_levels(monkeypatch, raw):
    """``CGX_ASYNC=on`` makes the JAX backend skip the two-level scheme's
    cross stage; the port refuses it there (the flat reduction has no cross
    stage and runs)."""
    from torch_cgx_tpu import config as jcfg
    from torch_cgx_tpu_torch import config as tcfg

    monkeypatch.setenv("CGX_ASYNC", raw)
    topo = tcfg.topology_from_env()
    if raw == "bogus":
        for mode in (tcfg.async_mode, jcfg.async_mode):
            with pytest.raises(ValueError, match="CGX_ASYNC"):
                mode()
        return
    assert tcfg.async_mode() == jcfg.async_mode() == raw.lower()
    pb._refuse_unported(topo, hier=False)
    if raw.lower() == "on":
        with pytest.raises(NotImplementedError, match="CGX_ASYNC"):
            pb._refuse_unported(topo, hier=True)
    else:
        pb._refuse_unported(topo, hier=True)


def test_release_joins_the_worker_within_its_bound():
    """A worker stuck in a job makes ``release`` raise after its timeout
    instead of waiting; once the job ends the thread stops."""
    gate = threading.Event()
    worker = pb._worker(None)
    worker.submit(lambda: gate.wait(30))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not stop"):
        pb.release(None, timeout=0.2)
    assert time.monotonic() - t0 < 5
    gate.set()
    worker.thread.join(5)
    assert not worker.thread.is_alive()
    fut = pb.allreduce_async(torch.ones(3))  # a fresh worker serves the group
    assert fut.wait() is not None and pb._worker(None) is not worker
    pb.release(None)


@pytest.mark.parametrize("case", ["disjoint", "overlapping", "clipped", "empty"])
def test_hookprof_card_share_is_the_union_in_the_window(case):
    """``hookprof.card_share``: the union of every rank's device intervals
    inside the window, exact on these binary fractions."""
    from torch_cgx_tpu_torch.tools import hookprof

    ranks, busy = {
        "disjoint": ([[(1.0, 1.25)], [(1.5, 1.75)]], 500.0),
        "overlapping": ([[(1.0, 1.5)], [(1.25, 1.75)], [(1.5, 1.625)]], 750.0),
        "clipped": ([[(0.5, 1.25)], [(1.75, 3.0)]], 500.0),
        "empty": ([[], []], 0.0),
    }[case]
    got = hookprof.card_share((1.0, 2.0), ranks)
    assert got == {"card_busy_ms": busy, "card_idle_share": 1.0 - busy / 1000.0}


# ---------------------------------------------------------------------------
# DDP: spawned ranks of both packages.
# ---------------------------------------------------------------------------


def _bits_of(t):
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy().copy()


def _mlp():
    import torch.nn as nn

    torch.manual_seed(1234)
    return nn.Sequential(nn.Linear(32, 64, bias=False), nn.ReLU(), nn.Linear(64, 10, bias=False))


def _train(tb, rank, steps=STEPS, *, dtype=torch.float32, group=None, before=None, hook=None):
    """``test_torch_ddp_hook._train`` over ``group`` with the bias-free
    MLP: DDP, the hook at 4 bits, bucket 512, ``layer_min_size=64``,
    SGD(0.05), data from seed 100 + ``rank`` (the rank in ``group``).
    ``hook`` replaces ``tb.cgx_hook``; ``before(step, state)`` runs ahead of
    each step. Returns the parameters' bits."""
    import torch.nn as nn

    model = _mlp().to(dtype)
    ddp = nn.parallel.DistributedDataParallel(model, process_group=group)
    state = tb.CGXState(group, compression_params={"bits": 4, "bucket_size": 512},
                        layer_min_size=64)
    ddp.register_comm_hook(state, hook or tb.cgx_hook)
    opt = torch.optim.SGD(ddp.parameters(), lr=0.05)
    loss_fn = nn.CrossEntropyLoss()
    torch.manual_seed(100 + rank)
    for step in range(steps):
        if before is not None:
            before(step, state)
        x = torch.randn(16, 32).to(dtype)
        y = torch.randint(0, 10, (16,))
        opt.zero_grad()
        loss_fn(ddp(x).float(), y).backward()
        opt.step()
    return [_bits_of(p) for p in model.parameters()]


# Scenarios run in both packages' four-rank worlds: name -> (env, dtype).
COMMON = {
    "default": ({}, torch.float32),
    "cross_sra": ({"CGX_CROSS_REDUCTION_TYPE": "SRA"}, torch.float32),
    "cross_alltoall": ({"CGX_CROSS_REDUCTION_TYPE": "ALLTOALL"}, torch.float32),
    "intra_raw": ({"CGX_INTRA_COMPRESS": "0"}, torch.float32),
    "bf16": ({}, torch.bfloat16),
    "ratio_hier": ({"CGX_COMPRESSION_FAKE_RATIO": "0.5"}, torch.float32),
    "ratio_flat": ({"CGX_COMPRESSION_FAKE_RATIO": "0.5", "CGX_INTRA_BROADCAST": "0"}, torch.float32),
}
WORLDS = {
    ("port", 4): list(COMMON) + ["launches", "release", "ws3", "flat_ratio", "threads", "held",
                                 "raises"],
    ("jax", 4): list(COMMON),
    ("jax", 3): ["ws3"],
}
# The four ranks' values for allreduce_flat: decode-exact integer grids.
FLAT_N = 4 * 3 * 32 * 128 + 77


def _flat_input(rank):
    return np.float32((np.arange(FLAT_N) * (2 * rank + 3)) % 16)


_HIER_CALLS = [0]


def _count_hier():
    real = pb._qreduce_hier

    def counting(*a, **k):
        _HIER_CALLS[0] += 1
        return real(*a, **k)

    pb._qreduce_hier = counting


def _common(name, tb, rank):
    env, dtype = COMMON[name]
    os.environ.update(env)
    _HIER_CALLS[0] = 0
    return {"params": _train(tb, rank, dtype=dtype), "hier_calls": _HIER_CALLS[0]}


def _ws3_port(tb, rank):
    """Global ranks 1-3 of the four form the hook group, on hosts a, a, b:
    its host map is gathered with this scenario's host keys. Rank 0 only
    joins the group's creation."""
    sub = dist.new_group([1, 2, 3])
    if rank == 0:
        return None
    os.environ["CGX_SHM_HOST_ID"] = "a" if rank < 3 else "b"
    _HIER_CALLS[0] = 0
    params = _train(tb, dist.get_rank(sub), group=sub)
    hm = pb._hosts(sub)
    out = {"params": params, "hier_calls": _HIER_CALLS[0], "hosts": list(hm.hosts),
           "leaders": list(hm.leaders), "local": list(hm.local)}
    tb.destroy_process_group(sub)  # the worker's bounded join, then the group
    return out


def _flat_ratio(tb, rank):
    from torch_cgx_tpu_torch.config import CompressionConfig
    from torch_cgx_tpu_torch.parallel import allreduce_flat

    os.environ["CGX_COMPRESSION_FAKE_RATIO"] = "0.5"
    x = torch.from_numpy(_flat_input(rank))
    return allreduce_flat(x, CompressionConfig(bits=4, bucket_size=128)).numpy()


def _threads(tb, rank):
    """The thread each hook call and each bucket allreduce ran on."""
    hooks, reduces = set(), set()
    inner = pb.allreduce

    def hook(state, bucket: dist.GradBucket) -> torch.futures.Future[torch.Tensor]:
        hooks.add(threading.current_thread().name)
        return tb.cgx_hook(state, bucket)

    def recording(*a, **k):
        reduces.add(threading.current_thread().name)
        return inner(*a, **k)

    pb.allreduce = recording
    try:
        _train(tb, rank, steps=3, hook=hook)
    finally:
        pb.allreduce = inner
    return {"hooks": sorted(hooks), "reduces": sorted(reduces)}


def _held(tb, rank):
    """At step 0 the group's worker is held on an event that the hook sets
    only after it has looked at the future it got: that future is pending.
    The run is the default scenario's otherwise."""
    gate = threading.Event()
    pending = []

    def hook(state, bucket: dist.GradBucket) -> torch.futures.Future[torch.Tensor]:
        fut = tb.cgx_hook(state, bucket)
        pending.append(not fut.done())
        gate.set()
        return fut

    def before(step, state):
        if step == 0:
            pb._worker(None).submit(lambda: gate.wait(RAISE_BOUND_S))

    params = _train(tb, rank, before=before, hook=hook)
    return {"params": params, "pending": pending[:1]}


def _raises(tb, rank):
    """After registration (step 2) the bucket's first layer is registered
    one value too long: the bucket raises the stale-registry error on the
    worker, and ``loss.backward()`` raises it. Last scenario of the world."""
    from torch_cgx_tpu_torch import config as cfg

    def before(step, state):
        if step == 3:
            key = cfg.registered_buckets()[0]
            sizes = cfg.registered_layer_sizes(key)
            cfg.register_layer(key, 0, sizes[0] + 1, 4, 512)

    t0 = time.monotonic()
    try:
        _train(tb, rank, steps=4, before=before)
    except RuntimeError as e:
        return {"message": str(e), "seconds": time.monotonic() - t0}
    return {"message": None, "seconds": time.monotonic() - t0}


def _launches(tb, rank):
    """The codec wrappers' calls on the CPU (each one launch on the card)
    against ``chip_smoke.LaunchModel.hook`` with the world's host map, for
    two buckets (whole 32-bucket chunks; tails, short layers, a raw layer)
    under each two-level variant: a leader's and a non-leader's counts."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from torch_cgx_tpu_torch import config as cfg
    from torch_cgx_tpu_torch.ops import codec_cuda

    counts = {k: 0 for k in codec_cuda.LAUNCHES}
    for fn, key in (("quantize_chunks", "codec_quantize"), ("dequantize_chunks", "codec_dequantize"),
                    ("sra_epilogue_chunks", "codec_sra_epilogue"),
                    ("reduce_rows_chunks", "codec_reduce_rows")):
        def counting(*a, _orig=getattr(codec_cuda, fn), _key=key, **k):
            counts[_key] += 1
            return _orig(*a, **k)

        setattr(codec_cuda, fn, counting)
    os.environ.update({"CGX_SRA_EPILOGUE": "fused", "CGX_PALLAS_DB": "off"})
    buckets = {
        ("l", 0): [(8192, 4, 128)] * 4,
        ("l", 1): [(20, 8, 128), (4096 + 3 * 128 + 5, 2, 128), (100, 4, 512), (300, 32, 512),
                   (2 * 32 * 96, 3, 96), (5 * 32 * 128 + 40, 4, 128), (7, 4, 128)],
    }
    for key, layers in buckets.items():
        for i, (n, bits, b) in enumerate(layers):
            cfg.register_layer(key, i, n, bits, b)
    rng = np.random.default_rng(rank)
    out = {}
    for variant, env in (("default", {}), ("cross_sra", {"CGX_CROSS_REDUCTION_TYPE": "SRA"}),
                         ("cross_alltoall", {"CGX_CROSS_REDUCTION_TYPE": "ALLTOALL"}),
                         ("intra_raw", {"CGX_INTRA_COMPRESS": "0"})):
        os.environ.update(env)
        for key, layers in buckets.items():
            n = sum(x[0] for x in layers)
            model = chip_smoke.LaunchModel(torch.device("cpu"))
            model.hook(pb._extract_layers(n, key), 4, rank, cfg.intra_reduction(), pb._hosts(None).hosts)
            for k in counts:
                counts[k] = 0
            pb.allreduce(torch.from_numpy(rng.standard_normal(n).astype(np.float32)), bucket_key=key)
            out[(variant, key)] = (dict(counts), dict(model.counts))
        for k in env:
            del os.environ[k]
    return out


def _release(tb, rank):
    """A two-level bucket allreduce, ``release``, one on a single host (no
    subgroups), ``release``, and the two-level one again over the same
    hosts: it takes the subgroups set aside and gives the same bytes."""
    from torch_cgx_tpu_torch import config as cfg

    key, layers = ("r", 0), [(8192, 4, 128), (300, 4, 128)]
    for i, (n, bits, b) in enumerate(layers):
        cfg.register_layer(key, i, n, bits, b)
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(8492).astype(np.float32))

    def reduce():
        return pb.allreduce(x.clone(), bucket_key=key).numpy()

    _HIER_CALLS[0] = 0
    first = reduce()
    subs = (pb._hosts(None).intra, pb._hosts(None).cross)
    pb.release(None)
    os.environ["CGX_SHM_HOST_ID"] = "onehost"
    one_host = (reduce(), pb._hosts(None).topology)
    pb.release(None)
    os.environ["CGX_SHM_HOST_ID"] = f"testhost{rank // 2}"
    again = reduce()
    hm = pb._hosts(None)
    return {"first": first, "again": again, "one_host": one_host, "hier_calls": _HIER_CALLS[0],
            "reused": hm.intra is subs[0] and hm.cross is subs[1]}


SCENARIOS = {"launches": _launches, "release": _release, "ws3": _ws3_port, "flat_ratio": _flat_ratio, "threads": _threads, "held": _held,
             "raises": _raises}


def _rank_main(pkg, rank, ws, init_file, names, result_q):
    """One rank of one package's world on two faked hosts: every scenario
    of ``names`` in order over one process group, each with a clean
    registry and its own CGX_* knobs."""
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ.update({"CGX_BRIDGE_DEVICE_CODEC": "off", "CGX_COMPRESSION_QUANTIZATION_BITS": "4",
                       "CGX_SHM_HOST_ID": f"testhost{rank // 2}"})
    out = {}
    torch.set_num_threads(1)  # every world's ranks share the test machine's cores
    try:
        if pkg == "jax":
            os.environ["JAX_PLATFORMS"] = "cpu"
            import torch_cgx_tpu.torch_backend as tb  # registers the "cgx" backend
            from torch_cgx_tpu import config as cfg

            backend = "cgx"
        else:
            import torch_cgx_tpu_torch.torch_backend as tb
            from torch_cgx_tpu_torch import config as cfg

            backend = "gloo"
            _count_hier()
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=ws, timeout=timedelta(seconds=120))
        for name in names:
            cfg.clear_registry()
            keep = {k: v for k, v in os.environ.items() if k.startswith("CGX_")}
            if name == "ws3" and pkg == "jax":
                out[name] = _common("default", tb, rank)
            elif name in COMMON:
                out[name] = _common(name, tb, rank)
            else:
                out[name] = SCENARIOS[name](tb, rank)
            for k in [k for k in os.environ if k.startswith("CGX_")]:
                del os.environ[k]
            os.environ.update(keep)
            if name != "raises":
                dist.barrier()
    except Exception:  # reported to the parent, which fails the test
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            if pkg == "port":
                tb.destroy_process_group()
            else:
                dist.destroy_process_group()
    result_q.put(((pkg, ws), rank, out))


def _run_world(ctx, pkg, ws, names, store, deadline):
    """The ``ws`` ranks of one world, to their results by rank (every
    process joined or killed before it returns)."""
    result_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(pkg, r, ws, store, names, result_q), daemon=True)
             for r in range(ws)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < ws and time.monotonic() < deadline:
            try:
                _, rank, out = result_q.get(timeout=2.0)
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
    assert len(results) == ws, f"{pkg} ws {ws}: only ranks {sorted(results)} reported"
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    assert not errors, "\n".join(f"{pkg} ws {ws} rank {r}:\n{e}" for r, e in errors.items())
    return [results[r] for r in range(ws)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of :data:`WORLDS`, one after another (at most four ranks
    run at once, so the module does not crowd the machine's other tests);
    their results by (package, ws) -> list by rank."""
    ctx = mp.get_context("spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    return {(pkg, ws): _run_world(ctx, pkg, ws, names,
                                  str(tmp_path_factory.mktemp(f"{pkg}_ws{ws}") / "store"), deadline)
            for (pkg, ws), names in WORLDS.items()}


def _assert_params_equal(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: parameter {i}")


@pytest.mark.parametrize("name", list(COMMON))
def test_ddp_two_hosts_bit_identical_to_jax(worlds, name):
    """Every rank's parameters equal the JAX rank's, bit for bit, and the
    replicas each other's (but under the fake ratio, whose tail each rank
    keeps un-reduced); the port took the two-level scheme for each of the 8
    steps' buckets (none under CGX_INTRA_BROADCAST=0)."""
    port, jax_ = worlds[("port", 4)], worlds[("jax", 4)]
    for r in range(4):
        _assert_params_equal(port[r][name]["params"], jax_[r][name]["params"], f"{name} rank {r}")
        if not name.startswith("ratio"):
            _assert_params_equal(port[r][name]["params"], port[0][name]["params"], f"{name} replicas")
        assert port[r][name]["hier_calls"] == (0 if name == "ratio_flat" else STEPS), name


def test_fake_ratio_leaves_the_tail_unreduced(worlds):
    """Half the compressed values travel: the ratio's parameters differ from
    the default run's, and the flat and two-level runs differ too."""
    port = worlds[("port", 4)][0]
    for name in ("ratio_hier", "ratio_flat"):
        assert any(not np.array_equal(a, b) for a, b in
                   zip(port[name]["params"], port["default"]["params"])), name
    assert any(not np.array_equal(a, b) for a, b in
               zip(port["ratio_hier"]["params"], port["ratio_flat"]["params"]))


def test_ddp_three_rank_subgroup_bit_identical_to_jax(worlds):
    """Hosts [a, a, b]: the rank alone on b leads itself. The port's group
    is global ranks 1-3, the JAX world ranks 0-2."""
    port, jax_ = worlds[("port", 4)], worlds[("jax", 3)]
    assert port[0]["ws3"] is None
    for g in range(3):
        got = port[g + 1]["ws3"]
        assert got["hosts"] == ["a", "a", "b"] and got["leaders"] == [0, 2], got
        assert got["local"] == ([0, 1] if g < 2 else [2]), got
        assert got["hier_calls"] == STEPS
        _assert_params_equal(got["params"], jax_[g]["ws3"]["params"], f"group rank {g}")


def test_allreduce_flat_fake_ratio_matches_jax(worlds, monkeypatch):
    """``allreduce_flat`` at ratio 0.5 over four ranks: the leading half
    SRA-reduced, the tail each rank's own, bit for bit as the JAX package's
    on the four-device CPU mesh (decode-exact data)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.parallel import allreduce as jallreduce
    from torch_cgx_tpu.utils.compat import shard_map

    monkeypatch.setenv("CGX_COMPRESSION_FAKE_RATIO", "0.5")
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
    body = shard_map(
        lambda x: jallreduce.allreduce_flat(x[0], JCC(bits=4, bucket_size=128), mesh=mesh,
                                            axes=("dp",))[None],
        mesh=mesh, in_specs=P("dp"), out_specs=P("dp"), check_vma=False,
    )
    per_rank = np.stack([_flat_input(r) for r in range(4)])
    want = np.asarray(jax.jit(body)(jnp.asarray(per_rank)))
    m = int(np.ceil(0.5 * FLAT_N))
    for r, o in enumerate(worlds[("port", 4)]):
        got = o["flat_ratio"]
        np.testing.assert_array_equal(got.view(np.int32), want[r].view(np.int32), err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[m:], per_rank[r][m:])
        np.testing.assert_array_equal(got[:m], per_rank[:, :m].sum(axis=0))


def test_launch_model_matches_counted_calls_two_level(worlds):
    seen = set()
    for r, o in enumerate(worlds[("port", 4)]):
        for (variant, key), (counted, model) in o["launches"].items():
            assert counted == model, (r, variant, key, counted, model)
            seen |= {k for k, v in counted.items() if v}
    # The leaders' cross SRA folds with B3, the cross all-to-all with B4.
    assert seen == {"codec_quantize", "codec_dequantize", "codec_sra_epilogue",
                    "codec_reduce_rows"}, seen
    leader, local = worlds[("port", 4)][0]["launches"], worlds[("port", 4)][1]["launches"]
    assert leader[("default", ("l", 0))] != local[("default", ("l", 0))]


def test_release_then_two_level_allreduce_again(worlds):
    """After ``release`` and a map on one host, the two-level allreduce over
    the same hosts runs again on the subgroups set aside, bit for bit as
    before, the replicas equal."""
    r0 = worlds[("port", 4)][0]["release"]
    for r, o in enumerate(worlds[("port", 4)]):
        got = o["release"]
        assert got["one_host"][1] == pb.TOPO_INTRA, (r, got["one_host"][1])
        assert got["hier_calls"] == 2 and got["reused"], (r, got["hier_calls"], got["reused"])
        np.testing.assert_array_equal(got["again"].view(np.int32), got["first"].view(np.int32))
        np.testing.assert_array_equal(got["first"], r0["first"])
        np.testing.assert_array_equal(got["one_host"][0], r0["one_host"][0])


def test_bucket_allreduce_runs_on_the_worker_thread(worlds):
    for r, o in enumerate(worlds[("port", 4)]):
        t = o["threads"]
        assert t["reduces"] and all(n.startswith("cgx-bucket-worker") for n in t["reduces"]), (r, t)
        assert not set(t["reduces"]) & set(t["hooks"]), (r, t)


def test_hook_future_pending_while_worker_held(worlds):
    for r, o in enumerate(worlds[("port", 4)]):
        assert o["held"]["pending"] == [True], (r, o["held"])
        _assert_params_equal(o["held"]["params"], o["default"]["params"], f"rank {r}")


def test_failing_bucket_raises_through_ddp(worlds):
    for r, o in enumerate(worlds[("port", 4)]):
        got = o["raises"]
        assert got["message"] and "stale registry" in got["message"], (r, got)
        assert got["seconds"] < RAISE_BOUND_S, (r, got)
