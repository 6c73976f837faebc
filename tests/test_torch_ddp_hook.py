"""The port's DDP comm hook (``torch_cgx_tpu_torch/torch_backend/``) against
the JAX package's ``cgx_hook`` over its ``"cgx"`` backend.

Function level: the bucket-side functions of the port against the JAX
backend's module-level ones, with ``CGX_BRIDGE_DEVICE_CODEC=off`` so the JAX
side uses its host codec (whose bytes the port's codec matches): the chunk
split in both modes, the segments, the frame sizes, the stage-1 frames byte
for byte on random data, the SRA fold with its requantize (bytes and
written-back values bit for bit), and the frame decode.

DDP level: the same model, seeds, data and SGD steps under
``DistributedDataParallel`` in spawned gloo ranks for the port and spawned
``"cgx"`` ranks for the JAX package, every world started at once when the
module's first DDP test asks for them. The final parameters are compared
bit for bit:

* world size 2, 8 steps, under SRA, Ring and all-to-all; under the SRA
  pipelined by ``CGX_SCHEDULE=on``, and by ``CGX_PLANNER=on`` at the step
  planner's depth from a ``CGX_PLANNER_MODEL`` file; under the dummy codec; with per-layer
  bits and buckets changed after registration; with f16 and bf16 buckets;
* world size 4, 8 steps, a bias-free model whose layers are all compressed;
* world size 4, one step with raw (bias) layers: every port rank equals
  JAX ranks 0 and 1, and the port's replicas equal each other (the JAX
  backend folds its own row first in the uncompressed sum, so its ranks 2
  and 3 may differ: ROADMAP C12).

Also in the port's ranks: registration at step 2 and its compressed/raw
split, the stale-registry and ambiguous-bucket errors, each refused knob
(``NotImplementedError`` naming it), ``CGX_SCHEDULE=on`` and
``CGX_PLANNER=on`` (with and without ``CGX_MEMLEDGER``, whose staging
budget the hook's depth never reads) running through and equal to the
monolithic SRA on one layer, the two-level path of a group on two
faked hosts, and ``chip_smoke.LaunchModel.hook`` against the codec
wrappers' calls counted on the CPU. The hook runs every bucket on the
group's worker thread (``backend.allreduce_async``); the two-level scheme
against the JAX hook, the host key and the worker are
``tests/test_torch_ddp_hier.py``'s. The rank bodies import torch and one package each; JAX is
imported in the test functions and the JAX ranks only.
"""

import multiprocessing as mp
import os
import queue
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.torch_backend import backend as pb

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240.0
STEPS = 8


# ---------------------------------------------------------------------------
# Function level.
# ---------------------------------------------------------------------------


@pytest.fixture
def jb(monkeypatch):
    monkeypatch.setenv("CGX_BRIDGE_DEVICE_CODEC", "off")
    from torch_cgx_tpu.torch_backend import backend

    return backend


def _jax_wdt(name):
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16) if name == "bf16" else np.dtype(np.float32)


def _port_wdt(name):
    return torch.bfloat16 if name == "bf16" else torch.float32


# Layer sizes with tails: below 32 values, below one bucket, whole 32-bucket
# chunks at bucket 128, and a chunk plus a partial bucket.
LAYOUTS = [
    [5000],
    [20, 300, 4096, 7, 4096 + 3 * 128 + 5, 1],
    [64, 64, 64],
    [1000, 31, 8192, 513],
]


def _layers(sizes, bits=4, bucket=128):
    from torch_cgx_tpu_torch.config import CompressionConfig

    out, off = [], 0
    for n in sizes:
        out.append((off, n, CompressionConfig(bits=bits, bucket_size=bucket)))
        off += n
    return out


@pytest.mark.parametrize("aligned", [False, True], ids=["equal", "layer_aligned"])
@pytest.mark.parametrize("li", range(len(LAYOUTS)))
def test_chunk_split_and_segments_match_jax(jb, monkeypatch, aligned, li):
    if aligned:
        monkeypatch.setenv("CGX_LAYER_ALIGNED_SPLIT", "1")
    sizes = LAYOUTS[li]
    layers = _layers(sizes)
    n = sum(sizes)
    for ws in range(1, 9):
        got = pb._chunk_split(n, ws, layers)
        assert got == jb._chunk_split(n, ws, layers), ws
        assert sum(got[0]) == n
        for lo, size in zip(got[1], got[0]):
            want = jb._segments_in(layers, lo, lo + size)
            assert pb._segments_in(layers, lo, lo + size) == [
                pb._Segment(s.start, s.numel, s.bits, s.bucket_size) for s in want
            ]


@pytest.mark.parametrize("wd", ["f32", "bf16"])
def test_wire_layout_matches_jax(wd):
    from torch_cgx_tpu.ops import codec_host as hcodec
    from torch_cgx_tpu_torch.ops import codec

    for n in (1, 7, 31, 32, 100, 511, 512, 513, 32 * 512, 32 * 512 + 7, 33 * 96 + 5):
        for bits in (1, 3, 4, 8):
            for bucket in (32, 64, 96, 512):
                assert codec.wire_layout(n, bits, bucket, _port_wdt(wd)) == hcodec.wire_layout(
                    n, bits, bucket, _jax_wdt(wd)
                ), (n, bits, bucket)


def test_wire_dtype_matches_jax(jb):
    """bf16 buckets frame with bf16 meta, f16 and f32 buckets with f32."""
    for dt, want in ((torch.float32, torch.float32), (torch.float16, torch.float32),
                     (torch.bfloat16, torch.bfloat16)):
        assert pb._wire_dtype(dt) == want
        assert np.dtype(jb._wire_dtype(dt)).itemsize == want.itemsize


def _segs_of(jb, layers, ws, r):
    sizes, offs = jb._chunk_split(sum(n for _, n, _ in layers), ws, layers)
    js = jb._segments_in(layers, offs[r], offs[r] + sizes[r])
    return js, [pb._Segment(s.start, s.numel, s.bits, s.bucket_size) for s in js]


@pytest.mark.parametrize("aligned", [False, True], ids=["equal", "layer_aligned"])
@pytest.mark.parametrize("wd", ["f32", "bf16"])
@pytest.mark.parametrize("bucket", [64, 512, 96])
@pytest.mark.parametrize("bits", range(1, 9))
def test_stage1_frames_match_jax(jb, monkeypatch, bits, bucket, wd, aligned):
    """Every rank chunk's frames at ws 3, byte for byte on random data."""
    if aligned:
        monkeypatch.setenv("CGX_LAYER_ALIGNED_SPLIT", "1")
    sizes = [20, 3 * bucket + 5, 32 * bucket, 7, 32 * bucket + bucket + 9, bucket - 1]
    layers = _layers(sizes, bits, bucket)
    n = sum(sizes)
    fused = np.random.default_rng(bits * 1000 + bucket).standard_normal(n).astype(np.float32)
    for r in range(3):
        js, ps = _segs_of(jb, layers, 3, r)
        want = jb._compress_frames(fused, js, False, None, _jax_wdt(wd))
        got = pb._compress_frames(torch.from_numpy(fused), ps, False, _port_wdt(wd))
        assert got.numpy().tobytes() == want, r
        assert got.numel() == pb.frames_bytes(ps, _port_wdt(wd), False)


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("wd", ["f32", "bf16"])
def test_decompress_frames_match_jax(jb, wd, add):
    sizes = [20, 3 * 128 + 5, 32 * 128, 7, 100]
    layers = _layers(sizes, 3, 128)
    n = sum(sizes)
    rng = np.random.default_rng(7)
    src = rng.standard_normal(n).astype(np.float32)
    js, ps = _segs_of(jb, layers, 1, 0)
    wire = jb._compress_frames(src, js, False, None, _jax_wdt(wd))
    base = rng.standard_normal(n).astype(np.float32)
    want = base.copy()
    jb._decompress_frames(np.frombuffer(wire, np.uint8), js, want, False, add, _jax_wdt(wd))
    got = torch.from_numpy(base.copy())
    pb._decompress_frames(torch.frombuffer(bytearray(wire), dtype=torch.uint8), ps, got, False,
                          add, _port_wdt(wd))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("epilogue", ["staged", "fused"])
@pytest.mark.parametrize("wd", ["f32", "bf16"])
@pytest.mark.parametrize("ws,me", [(2, 0), (2, 1), (3, 2), (4, 1), (4, 3)])
def test_sra_fold_and_requantize_match_jax(jb, monkeypatch, ws, me, wd, epilogue):
    """The port's fold + requantize of one rank's chunk against the JAX
    ``_sra_fold_chunk`` followed by ``_requantize_frames``: the stage-2
    frames byte for byte and the written-back values bit for bit. Layers of
    whole 32-bucket chunks (the fused epilogue's geometry under
    ``CGX_SRA_EPILOGUE=fused``), with tails, and below one bucket."""
    monkeypatch.setenv("CGX_SRA_EPILOGUE", epilogue)
    monkeypatch.setenv("CGX_LAYER_ALIGNED_SPLIT", "1")
    bucket = 128
    sizes = [8192] * ws + [5, 3 * bucket + 11, 4096 + 7]
    layers = _layers(sizes, 4, bucket)
    n = sum(sizes)
    rng = np.random.default_rng(ws * 10 + me)
    ranks = rng.standard_normal((ws, n)).astype(np.float32)
    sizes_r, offs = jb._chunk_split(n, ws, layers)
    lo, hi = offs[me], offs[me] + sizes_r[me]
    js, ps = _segs_of(jb, layers, ws, me)
    frames_j = {j: np.frombuffer(jb._compress_frames(ranks[j], js, False, None, _jax_wdt(wd)),
                                 np.uint8) for j in range(ws) if j != me}
    want = ranks[me].copy()
    jb._sra_fold_chunk(want, lo, hi, js, frames_j, me, ws, False, _jax_wdt(wd))
    want_wire = jb._requantize_frames(want, js, False, None, _jax_wdt(wd))
    got = torch.from_numpy(ranks[me].copy())
    frames_p = [None if j == me else torch.from_numpy(frames_j[j].copy()) for j in range(ws)]
    got_wire = pb._sra_fold_chunk(got, ps, frames_p, me, ws, False, _port_wdt(wd))
    assert got_wire.numpy().tobytes() == want_wire
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_world_size_one_returns_bucket_untouched(monkeypatch):
    """With no process group the world is one rank: the bucket comes back
    as it was, even under CGX_DEBUG_FORCE_CODEC."""
    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "4")
    monkeypatch.setenv("CGX_DEBUG_FORCE_CODEC", "1")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    want = x.clone()
    out = pb.allreduce(x, bucket_key=("ws1", 0))
    assert out is x and torch.equal(x, want)


# ---------------------------------------------------------------------------
# DDP: spawned ranks of both packages.
# ---------------------------------------------------------------------------


def _bits_of(t):
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy().copy()


def _mlp(bias=True):
    import torch.nn as nn

    torch.manual_seed(1234)
    return nn.Sequential(nn.Linear(32, 64, bias=bias), nn.ReLU(), nn.Linear(64, 10, bias=bias))


def _train(tb, rank, steps, *, bias=True, dtype=torch.float32, before=None):
    """``_worker_ddp`` of the JAX package's tests: DDP, the hook at 4 bits,
    bucket 512, ``layer_min_size=64``, SGD(0.05), rank-local data from seed
    100 + rank. ``before(step, state)`` runs ahead of each step. Returns
    the parameters' bits and the hook's state."""
    import torch.nn as nn

    model = _mlp(bias).to(dtype)
    ddp = nn.parallel.DistributedDataParallel(model)
    state = tb.CGXState(None, compression_params={"bits": 4, "bucket_size": 512}, layer_min_size=64)
    ddp.register_comm_hook(state, tb.cgx_hook)
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
    return [_bits_of(p) for p in model.parameters()], state


def _layer_bits(cfg):
    return sorted(
        cfg.get_layer_config((b, i)).bits
        for b in cfg.registered_buckets()
        for i in range(len(cfg.registered_layer_sizes(b)))
    )


def _per_layer(cfg):
    """After registration: the first compressed layer to 2 bits, the second
    to bucket 128."""

    def before(step, state):
        if step != 3:
            return
        comp = [(b, i) for b in cfg.registered_buckets()
                for i in range(len(cfg.registered_layer_sizes(b)))
                if cfg.get_layer_config((b, i)).bits == 4]
        assert len(comp) == 2, comp
        cfg.set_quantization_bits(comp[0], 2)
        cfg.set_quantization_bucket_size(comp[1], 128)

    return before


def _registration(cfg):
    seen = {}

    def before(step, state):
        seen[step] = (state.step, len(cfg.registered_buckets()))

    return before, seen


# Scenarios run in both packages' ranks: name -> (env, train kwargs).
COMMON = {
    "sra": ({"CGX_INNER_REDUCTION_TYPE": "SRA"}, {}),
    "sra_sched": ({"CGX_INNER_REDUCTION_TYPE": "SRA", "CGX_SCHEDULE": "on"}, {}),
    # CGX_PLANNER_MODEL: a file (PLANNED_MODEL) written by each rank before
    # it trains, whose negligible cost a block makes the planner pipeline as
    # deep as the rank chunks allow.
    "sra_planned": ({"CGX_INNER_REDUCTION_TYPE": "SRA", "CGX_PLANNER": "on"}, {}),
    "ring": ({"CGX_INNER_REDUCTION_TYPE": "RING"}, {}),
    "alltoall": ({"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1"}, {}),
    "dummy": ({"CGX_DEBUG_DUMMY_COMPRESSION": "1"}, {}),
    "per_layer": ({}, {"per_layer": True}),
    "f16": ({}, {"dtype": torch.float16}),
    "bf16": ({}, {"dtype": torch.bfloat16}),
    # The env default compresses the two steps before registration too: an
    # uncompressed sum at ws 4 would take the JAX backend's own-row-first
    # order (C12).
    "nobias": ({"CGX_COMPRESSION_QUANTIZATION_BITS": "4"}, {"bias": False}),
    "raw1": ({}, {"steps": 1, "register_first": True}),
}
PLANNED_MODEL = {"quantize_gbps": 8.0, "dequantize_gbps": 16.0, "wire_gbps": 1.0, "overlap_frac": 0.0,
                 "chunk_overhead_s": 1e-12, "compute_s": 0.0, "dcn_gbps": 0.25, "source": "test"}
WORLDS = {
    ("port", 2): ["sra", "sra_sched", "sra_planned", "ring", "alltoall", "dummy", "per_layer", "f16", "bf16",
                  "registration", "errors", "refusals"],
    ("jax", 2): ["sra", "sra_sched", "sra_planned", "ring", "alltoall", "dummy", "per_layer", "f16", "bf16",
                 "registration"],
    ("port", 4): ["nobias", "raw1", "launches", "hierarchy"],
    ("jax", 4): ["nobias", "raw1"],
}


def _common(name, tb, cfg, rank):
    env, kw = COMMON[name]
    os.environ.update(env)
    if env.get("CGX_PLANNER") == "on":
        import json
        import tempfile

        path = os.path.join(tempfile.gettempdir(), f"cgx_hook_model_{tb.__name__}_{rank}.json")
        with open(path, "w") as f:
            json.dump(PLANNED_MODEL, f)
        os.environ["CGX_PLANNER_MODEL"] = path
    before = _per_layer(cfg) if kw.get("per_layer") else None
    if kw.get("register_first"):
        # Register at the first step, so that the one step compared sums the
        # raw layers beside the compressed ones.
        def before(step, state):  # noqa: F811
            state.step = 2

    depths = []
    patched = tb.__name__.startswith("torch_cgx_tpu_torch") and (
        "CGX_SCHEDULE" in env or "CGX_PLANNER" in env)
    if patched:  # record the depth of every SRA that pipelined
        real = pb._sched_tables

        def tables(*a):
            t = real(*a)
            if t is not None:
                depths.append(len(t[0]))
            return t

        pb._sched_tables = tables
    try:
        params, _ = _train(tb, rank, kw.get("steps", STEPS), bias=kw.get("bias", True),
                           dtype=kw.get("dtype", torch.float32), before=before)
    finally:
        if patched:
            pb._sched_tables = real
        if "CGX_PLANNER_MODEL" in os.environ:
            os.remove(os.environ["CGX_PLANNER_MODEL"])
    return {"params": params, "bits": _layer_bits(cfg), "depths": depths}


def _registration_scenario(tb, cfg, rank):
    before, seen = _registration(cfg)
    _train(tb, rank, 4, before=before)
    sizes = [n for b in cfg.registered_buckets() for n in cfg.registered_layer_sizes(b)]
    return {"seen": seen, "sizes": sorted(sizes), "bits": _layer_bits(cfg)}


def _raises(fn, exc):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _errors_scenario(rank, ws):
    """The stale-registry and the ambiguous-bucket errors (raised before
    any collective, on every rank alike)."""
    from torch_cgx_tpu_torch import config as cfg

    os.environ["CGX_COMPRESSION_QUANTIZATION_BITS"] = "4"
    cfg.register_layer(("t", 0), 0, 10, 4, 512)
    cfg.register_layer(("t", 0), 1, 20, 4, 512)
    stale = _raises(lambda: pb.allreduce(torch.ones(31), bucket_key=("t", 0)), RuntimeError)
    cfg.register_layer(("t", 1), 0, 30, 4, 512)
    ambiguous = _raises(lambda: pb.allreduce(torch.ones(30)), RuntimeError)
    # A plain (non-float) tensor sums exactly; a tagged unregistered bucket
    # is one default layer.
    ints = pb.allreduce(torch.full((5,), rank + 1, dtype=torch.int64))
    x = torch.full((4096,), float(rank + 1))
    out = pb.allreduce(x, bucket_key=("t", 9))
    return {"stale": stale, "ambiguous": ambiguous, "ints": ints.tolist(),
            "default": out[:3].tolist(), "same_tensor": out is x}


REFUSED = [
    ({"CGX_SCHEDULE": "on"}, None, "CGX_SCHEDULE"),  # runs: the pipelined SRA
    # Runs: the planned SRA (at the default model's depth for one layer).
    ({"CGX_PLANNER": "on"}, None, "CGX_PLANNER"),
    # Runs too: the hook's depth reads no staging budget, in the JAX
    # backend either.
    ({"CGX_PLANNER": "on", "CGX_MEMLEDGER": "1"}, None, "CGX_MEMLEDGER"),
    ({"CGX_SCHEDULE": "bogus"}, ValueError, "CGX_SCHEDULE"),
]


def _refusals_scenario(rank, ws):
    out = []
    x = np.random.default_rng(rank).standard_normal(4096).astype(np.float32)
    os.environ["CGX_COMPRESSION_QUANTIZATION_BITS"] = "4"
    unset = pb.allreduce(torch.from_numpy(x.copy())).numpy()
    for env, exc, _ in REFUSED:
        os.environ.update(env)
        if exc is None:  # runs and equals the monolithic SRA of one layer bit for bit
            got = pb.allreduce(torch.from_numpy(x.copy())).numpy()
            out.append(bool(np.array_equal(got.view(np.int32), unset.view(np.int32))))
        else:
            out.append(_raises(lambda: pb.allreduce(torch.ones(4096)), exc))
        for k in env:
            del os.environ[k]
    # The Ring has no pipelined variant: CGX_SCHEDULE=on runs it unchanged.
    os.environ.update({"CGX_INNER_REDUCTION_TYPE": "RING", "CGX_SCHEDULE": "on"})
    ring = pb.allreduce(torch.full((4096,), float(rank))).tolist()[:2]
    # Stochastic rounding is ported: constant buckets still sum exactly.
    del os.environ["CGX_SCHEDULE"], os.environ["CGX_INNER_REDUCTION_TYPE"]
    os.environ["CGX_STOCHASTIC_ROUNDING"] = "1"
    stochastic = pb.allreduce(torch.full((4096,), float(rank + 1))).tolist()[:2]
    del os.environ["CGX_STOCHASTIC_ROUNDING"]
    return {"refused": out, "ring": ring, "stochastic": stochastic}


def _hierarchy_scenario(rank, ws):
    """Ranks 0, 1 on one host and 2, 3 on another (``CGX_SHM_HOST_ID``, the
    world's host map gathered anew): the two-level path runs, and
    CGX_INTRA_BROADCAST=0 runs the flat reduction."""
    os.environ["CGX_COMPRESSION_QUANTIZATION_BITS"] = "4"
    os.environ["CGX_SHM_HOST_ID"] = f"host{rank // 2}"
    ran = []
    real = pb._qreduce_hier

    def counting(*a, **k):
        ran.append(pb._hosts(None).topology)
        return real(*a, **k)

    pb._qreduce_hier = counting
    try:
        pb.release(None)
        hier = pb.allreduce(torch.ones(4096))[:2].tolist()
        os.environ["CGX_INTRA_BROADCAST"] = "0"
        flat = pb.allreduce(torch.ones(4096))[:2].tolist()
    finally:
        pb._qreduce_hier = real
        pb.release(None)
    return {"ran": ran, "hier": hier, "flat": flat}


def _launches_scenario(rank, ws):
    """The codec wrappers' calls on the CPU (each one launch on the card)
    against ``chip_smoke.LaunchModel.hook``, for two buckets under each
    reduction and the pipelined SRA: whole layers of whole 32-bucket chunks a rank (the fused
    epilogue and reduce), and a bucket of tails, short layers, a raw layer
    and a bucket that is not a multiple of 128."""
    sys.path.insert(0, _REPO)
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
    os.environ.update({"CGX_SRA_EPILOGUE": "fused", "CGX_PALLAS_DB": "off",
                       "CGX_LAYER_ALIGNED_SPLIT": "1"})
    buckets = {
        ("l", 0): [(8192, 4, 128)] * ws,
        ("l", 1): [(20, 8, 128), (4096 + 3 * 128 + 5, 2, 128), (100, 4, 512), (300, 32, 512),
                   (2 * 32 * 96, 3, 96), (5 * 32 * 128 + 40, 4, 128), (7, 4, 128)],
    }
    for key, layers in buckets.items():
        for i, (n, bits, b) in enumerate(layers):
            cfg.register_layer(key, i, n, bits, b)
    rng = np.random.default_rng(rank)
    out = {}
    for algo in ("SRA", "RING", "ALLTOALL", "SRA CGX_SCHEDULE=on"):
        os.environ["CGX_INNER_REDUCTION_TYPE"] = algo.split()[0]
        if algo.endswith("=on"):
            os.environ["CGX_SCHEDULE"] = "on"
        for key, layers in buckets.items():
            n = sum(x[0] for x in layers)
            model = chip_smoke.LaunchModel(torch.device("cpu"))
            model.hook(pb._extract_layers(n, key), ws, rank, cfg.intra_reduction())
            for k in counts:
                counts[k] = 0
            pb.allreduce(torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
                         bucket_key=key)
            out[(algo, key)] = (dict(counts), dict(model.counts))
    return out


SCENARIOS = {
    "registration": lambda tb, cfg, rank, ws: _registration_scenario(tb, cfg, rank),
    "errors": lambda tb, cfg, rank, ws: _errors_scenario(rank, ws),
    "refusals": lambda tb, cfg, rank, ws: _refusals_scenario(rank, ws),
    "hierarchy": lambda tb, cfg, rank, ws: _hierarchy_scenario(rank, ws),
    "launches": lambda tb, cfg, rank, ws: _launches_scenario(rank, ws),
}


def _rank_main(pkg, rank, ws, init_file, names, result_q):
    """One rank of one package's world: every scenario of ``names`` in
    order over one process group, each with a clean registry and its own
    CGX_* knobs."""
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    os.environ["CGX_BRIDGE_DEVICE_CODEC"] = "off"
    out = {}
    import torch.distributed as dist

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
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=ws, timeout=timedelta(seconds=120))
        for name in names:
            cfg.clear_registry()
            keep = {k: v for k, v in os.environ.items() if k.startswith("CGX_")}
            if name in COMMON:
                out[name] = _common(name, tb, cfg, rank)
            else:
                out[name] = SCENARIOS[name](tb, cfg, rank, ws)
            for k in [k for k in os.environ if k.startswith("CGX_")]:
                del os.environ[k]
            os.environ.update(keep)
            dist.barrier()
    except Exception:  # reported to the parent, which fails the test
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put(((pkg, ws), rank, out))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of :data:`WORLDS` spawned at once; their results by
    (package, ws) -> list by rank."""
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = []
    for (pkg, ws), names in WORLDS.items():
        store = str(tmp_path_factory.mktemp(f"{pkg}_ws{ws}") / "store")
        for r in range(ws):
            procs.append(ctx.Process(target=_rank_main, args=(pkg, r, ws, store, names, result_q),
                                     daemon=True))
    for p in procs:
        p.start()
    want = sum(ws for (_, ws) in WORLDS)
    results = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < want and time.monotonic() < deadline:
            try:
                world, rank, out = result_q.get(timeout=2.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            results[(world, rank)] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert len(results) == want, f"only {sorted(results)} reported"
    errors = {k: o["error"] for k, o in results.items() if "error" in o}
    assert not errors, "\n".join(f"{k}:\n{e}" for k, e in errors.items())
    return {w: [results[(w, r)] for r in range(w[1])] for w in WORLDS}


def _assert_params_equal(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: parameter {i}")


@pytest.mark.parametrize("name", ["sra", "sra_sched", "sra_planned", "ring", "alltoall", "dummy",
                                  "per_layer", "f16", "bf16"])
def test_ddp_ws2_bit_identical_to_jax(worlds, name):
    port, jax_ = worlds[("port", 2)], worlds[("jax", 2)]
    for r in range(2):
        _assert_params_equal(port[r][name]["params"], jax_[r][name]["params"], f"{name} rank {r}")
        assert port[r][name]["bits"] == jax_[r][name]["bits"]
    _assert_params_equal(port[0][name]["params"], port[1][name]["params"], f"{name} replicas")


def test_ddp_scheduled_sra_ran_pipelined(worlds):
    """Under CGX_SCHEDULE=on every compressed bucket of the registered
    steps took the pipelined SRA (two sub-chunks a rank: 1,344 values
    against the 512-value alignment), on both ranks."""
    for o in worlds[("port", 2)]:
        depths = o["sra_sched"]["depths"]
        assert depths and set(depths) == {2}, depths


def test_ddp_planned_sra_took_the_planners_depth(worlds, monkeypatch):
    """Under CGX_PLANNER=on with the model file every compressed bucket took
    the pipelined SRA at ``planner.bridge_chunks``' depth (two sub-chunks:
    the file's cost a block is negligible, and a 1,344-value rank chunk
    holds two 512-value units), on both ranks; the parameters equal the JAX
    "cgx" ranks' (``test_ddp_ws2_bit_identical_to_jax``)."""
    from torch_cgx_tpu_torch.parallel import planner

    monkeypatch.setenv("CGX_PLANNER", "on")
    planner.set_cost_model(planner.CostModel.from_dict(PLANNED_MODEL))
    try:
        want = planner.bridge_chunks(1344, 512, 2, 4, 4)
    finally:
        planner.set_cost_model(None)
    default = planner.bridge_chunks(1344, 512, 2, 4, 4)
    assert want == 2 and default == 1, (want, default)  # the default model keeps it monolithic
    for o in worlds[("port", 2)]:
        depths = o["sra_planned"]["depths"]
        assert depths and set(depths) == {want}, depths


def test_ddp_per_layer_setters_applied(worlds):
    bits = worlds[("port", 2)][0]["per_layer"]["bits"]
    assert bits == [2, 4, 32, 32], bits  # the 2-bit layer, the bucket-128 one, two biases
    a = worlds[("port", 2)][0]["per_layer"]["params"]
    b = worlds[("port", 2)][0]["sra"]["params"]
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))


def test_ddp_ws4_bias_free_bit_identical_to_jax(worlds):
    port, jax_ = worlds[("port", 4)], worlds[("jax", 4)]
    assert port[0]["nobias"]["bits"] == [4, 4]
    for r in range(4):
        _assert_params_equal(port[r]["nobias"]["params"], jax_[r]["nobias"]["params"], f"rank {r}")
        _assert_params_equal(port[r]["nobias"]["params"], port[0]["nobias"]["params"], "replicas")


def test_ddp_ws4_raw_layers_one_step(worlds):
    port, jax_ = worlds[("port", 4)], worlds[("jax", 4)]
    assert port[0]["raw1"]["bits"] == [4, 4, 32, 32]
    _assert_params_equal(jax_[0]["raw1"]["params"], jax_[1]["raw1"]["params"], "JAX ranks 0, 1")
    for r in range(4):
        _assert_params_equal(port[r]["raw1"]["params"], jax_[0]["raw1"]["params"], f"port rank {r}")


def test_registration_at_step_two(worlds):
    for pkg in ("port", "jax"):
        got = worlds[(pkg, 2)][0]["registration"]
        # (state.step, registered buckets) ahead of each step: nothing before
        # the hook's third call, one bucket of four layers after it.
        assert got["seen"] == {0: (0, 0), 1: (1, 0), 2: (2, 0), 3: (3, 1)}, (pkg, got)
        assert got["sizes"] == [10, 64, 640, 2048]
        assert got["bits"] == [4, 4, 32, 32]  # weights compressed, biases raw


def test_stale_and_ambiguous_registry_errors(worlds):
    for r, o in enumerate(worlds[("port", 2)]):
        e = o["errors"]
        assert e["stale"] and "stale registry" in e["stale"], e
        assert e["ambiguous"] and "matches 2 registered buckets" in e["ambiguous"], e
        assert e["ints"] == [3] * 5
        assert e["default"] == [3.0] * 3 and e["same_tensor"]


def test_unported_knobs_refused(worlds):
    for o in worlds[("port", 2)]:
        got = o["refusals"]
        for (env, exc, knob), msg in zip(REFUSED, got["refused"]):
            if exc is None:
                assert msg is True, (env, msg)
            else:
                assert msg is not None and knob in msg, (env, msg)
        assert got["ring"] == [1.0, 1.0]
        assert got["stochastic"] == [3.0, 3.0]


def test_two_level_group_refused(worlds):
    """Not refused: a group on two hosts of two ranks runs the
    two-level scheme once (the flat one under CGX_INTRA_BROADCAST=0), and
    both sum the constant buckets exactly."""
    for o in worlds[("port", 4)]:
        h = o["hierarchy"]
        assert h["ran"] == [pb.TOPO_MIXED], h
        assert h["hier"] == [4.0, 4.0] and h["flat"] == [4.0, 4.0], h


def test_launch_model_matches_counted_calls(worlds):
    seen = set()
    for r, o in enumerate(worlds[("port", 4)]):
        for (algo, key), (counted, model) in o["launches"].items():
            assert counted == model, (r, algo, key, counted, model)
            seen |= {k for k, v in counted.items() if v}
    # Every kernel of the hook's path ran somewhere.
    assert seen == {"codec_quantize", "codec_dequantize", "codec_sra_epilogue",
                    "codec_reduce_rows"}, seen
