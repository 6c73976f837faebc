"""The port's two-level (cross x intra) allreduce on four spawned gloo ranks
against the JAX package's ``hierarchical_allreduce`` on a ``(cross=2,
intra=2)`` mesh of the CPU devices.

The ranks form their subgroups with ``hierarchical_groups(intra_size=2)``
(intra {0,1} and {2,3}, cross {0,2} and {1,3}) once for the module and run
every case there: the leader scheme (the reference's default: intra SRA,
cross Ring), the two-pass scheme (``intra_broadcast=False``), the
uncompressed intra level (``two_level_config``) and the all-to-all at both
levels, each in both epilogue lowerings (the staged ops, and the fused
kernels' plain versions, the multi-row reduce B4 among them). Then a tiny
GPT-2 trains through ``make_train_step`` with the two-level group.

* the output is bit-identical to JAX's on decode-exact data (an integer
  grid) and within twice the allreduce envelope on random data (two
  quantized levels, the bound of the JAX package's own hierarchical test);
* every rank holds the same bytes, in both lowerings;
* the synced gradients of the GPT-2 train step equal JAX ``gradient_sync``
  through ``allreduce_tree`` over both axes, on decode-exact gradients.

The rank bodies import only torch and the port; JAX is imported in the
test functions.
"""

import multiprocessing as mp
import os
import queue
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.config import CompressionConfig, TopologyConfig
from torch_cgx_tpu_torch.ops import codec

WS, INTRA = 4, 2
BITS, BUCKET = 4, 128
SPAWN_TIMEOUT_S = 300.0
SCHEMES = {
    "leader": {},
    "two_pass": {"intra_broadcast": False},
    "uncompressed_intra": {"intra_compress": False},
    "alltoall": {"intra_reduction": "ALLTOALL", "cross_reduction": "ALLTOALL"},
}
GPT2_ENV = {
    "CGX_COMPRESSION_QUANTIZATION_BITS": "2",
    "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
    "CGX_STANDALONE_LAYER_ELEMS": "40000",
}


def _inputs():
    """Fused-slice lengths whose intra chunks are whole 32-bucket chunks
    (the fused reduce's geometry) or carry a 3-bucket tail (staged)."""
    rng = np.random.default_rng(7)
    out = {}
    for geom, n in {
        "chunks": WS * 2 * codec.CHUNK_BUCKETS * BUCKET - 5,
        "tail": WS * (codec.CHUNK_BUCKETS + 3) * BUCKET - 5,
    }.items():
        out[f"grid_{geom}"] = np.stack(
            [np.float32((np.arange(n) * (2 * r + 3)) % 16) for r in range(WS)]
        )
        out[f"random_{geom}"] = rng.standard_normal((WS, n)).astype(np.float32)
    return out


def _grid_grads(shapes):
    """Decode-exact per-rank gradients of the tiny GPT-2's shapes."""
    return [
        {
            p: np.float32((np.arange(int(np.prod(s))) * (2 * i + 3 + r)) % 16).reshape(s)
            for i, (p, s) in enumerate(shapes)
        }
        for r in range(WS)
    ]


def _gpt2_shapes():
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config

    model = GPT2(GPT2Config.tiny(), device="cpu")
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def _rank_main(rank, init_file, inputs, grads, result_q):
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    import torch.distributed as dist

    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.parallel import (
        gradient_sync, group, hierarchical_allreduce, hierarchical_groups,
        make_train_step, two_level_config,
    )

    torch.set_num_threads(1)  # four ranks share the test machine's cores
    out = {}
    try:
        timeout = timedelta(seconds=120)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=WS,
            timeout=timeout,
        )
        tl = hierarchical_groups(intra_size=INTRA, timeout=timeout)
        out["layout"] = (tl.intra_size, tl.cross_size, group.rank(tl.intra), group.rank(tl.cross))
        cc = CompressionConfig(bits=BITS, bucket_size=BUCKET)
        for scheme, kw in SCHEMES.items():
            topo = TopologyConfig(**kw)
            if scheme == "uncompressed_intra":
                topo = two_level_config(TopologyConfig())
            for mode in ("staged", "fused"):
                os.environ["CGX_SRA_EPILOGUE"] = mode
                for name, per_rank in inputs.items():
                    y = hierarchical_allreduce(torch.from_numpy(per_rank[rank]), tl, cc, topo)
                    out[(scheme, mode, name)] = y.numpy()
        del os.environ["CGX_SRA_EPILOGUE"]

        os.environ.update(GPT2_ENV)
        g = {n: torch.from_numpy(v) for n, v in grads[rank].items()}
        out["sync_staged"] = {k: v.numpy() for k, v in gradient_sync(g, group=tl).items()}
        os.environ["CGX_SRA_EPILOGUE"] = "fused"
        model = GPT2(GPT2Config.tiny(), device="cpu", generator=torch.Generator().manual_seed(0))
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)

        def grid_loss(m, _):
            return sum((p * g[n]).sum() for n, p in m.named_parameters())

        make_train_step(model, grid_loss, opt, group=tl, device="cpu")(None)
        out["sync_fused"] = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
        step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, group=tl, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(rank).integers(0, 512, size=(2, 32)))
        out["losses"] = [float(step(tokens)) for _ in range(2)]
        out["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        dist.barrier()
    except Exception as e:  # reported to the parent, which fails the test
        out = {"error": repr(e)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs()
    grads = _grid_grads(_gpt2_shapes())
    init_file = str(tmp_path_factory.mktemp("gloo_hier") / "store")
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(r, init_file, inputs, grads, result_q), daemon=True)
        for r in range(WS)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < WS and time.monotonic() < deadline:
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
    assert len(results) == WS, f"only ranks {sorted(results)} reported"
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    assert not errors, errors
    return inputs, grads, [results[r] for r in range(WS)]


def _mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:WS]).reshape(WS // INTRA, INTRA), ("cross", "intra"))


def _jax_hier(per_rank: np.ndarray, scheme: str) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.config import TopologyConfig as JTopo
    from torch_cgx_tpu.parallel import reducers as jreducers
    from torch_cgx_tpu.utils.compat import shard_map

    cc = JCC(bits=BITS, bucket_size=BUCKET)
    topo = JTopo(**SCHEMES[scheme])
    body = shard_map(
        lambda x: jreducers.hierarchical_allreduce(
            x[0, 0], intra_axis="intra", cross_axis="cross", ws_intra=INTRA,
            ws_cross=WS // INTRA, cc=cc, topology=topo,
        )[None, None],
        mesh=_mesh(), in_specs=P("cross", "intra"), out_specs=P("cross", "intra"),
        check_vma=False,
    )
    x = jnp.asarray(per_rank).reshape(WS // INTRA, INTRA, -1)
    return np.asarray(jax.jit(body)(x)).reshape(WS, -1)


def test_subgroup_layout(world):
    """Rank r sits at cross index r // intra and intra index r % intra."""
    _, _, results = world
    for r in range(WS):
        assert results[r]["layout"] == (INTRA, WS // INTRA, r % INTRA, r // INTRA)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("name", ["grid_chunks", "grid_tail"])
def test_matches_jax_on_decode_exact_data(world, scheme, name):
    inputs, _, results = world
    ref = _jax_hier(inputs[name], scheme)
    for r in range(WS):
        for mode in ("staged", "fused"):
            got = results[r][(scheme, mode, name)]
            np.testing.assert_array_equal(
                got.view(np.uint32), ref[r].view(np.uint32), err_msg=f"rank {r} {mode}"
            )


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("name", ["random_chunks", "random_tail"])
def test_within_envelope_on_random_data(world, scheme, name):
    inputs, _, results = world
    x = inputs[name]
    ref = _jax_hier(x, scheme)
    exact = x.astype(np.float64).sum(axis=0)
    step = float((x.max() - x.min()) / BUCKET)
    bound = 2 * codec.allreduce_error_bound(x.shape[1], BITS, BUCKET, WS, step)
    for r in range(WS):
        for mode in ("staged", "fused"):
            got = results[r][(scheme, mode, name)]
            assert np.abs(got - exact).max() <= bound
            assert np.abs(got - ref[r]).max() <= bound


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_replicas_and_lowerings_bit_identical(world, scheme):
    inputs, _, results = world
    for name in inputs:
        y0 = results[0][(scheme, "staged", name)].view(np.uint32)
        for r in range(WS):
            for mode in ("staged", "fused"):
                got = results[r][(scheme, mode, name)].view(np.uint32)
                np.testing.assert_array_equal(got, y0, err_msg=f"{name} rank {r} {mode}")


def test_gpt2_two_level_sync_matches_jax(world, monkeypatch):
    """``gradient_sync`` and the gradients ``make_train_step`` applies, over
    the two-level group, against JAX ``gradient_sync`` over the (cross,
    intra) axes on the same decode-exact per-rank gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from torch_cgx_tpu.parallel import gradient_sync as jgradient_sync
    from torch_cgx_tpu.utils.compat import shard_map
    from torch_cgx_tpu.utils.tree import leaf_paths

    _, grads, results = world
    for k, v in GPT2_ENV.items():
        monkeypatch.setenv(k, v)
    tree = {}
    for name in grads[0]:
        node = tree
        *parents, leaf = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(
            np.stack([g[name] for g in grads]).reshape((WS // INTRA, INTRA) + grads[0][name].shape)
        )
    mesh = _mesh()
    spec = jax.tree.map(lambda _: P("cross", "intra"), tree)
    body = shard_map(
        lambda t: jax.tree.map(
            lambda a: a[None, None],
            jgradient_sync(jax.tree.map(lambda a: a[0, 0], t), mesh=mesh, axes=("cross", "intra")),
        ),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False,
    )
    want = {p: np.asarray(v).reshape((WS,) + grads[0][p].shape) for p, v in leaf_paths(jax.jit(body)(tree))}
    assert want.keys() == grads[0].keys()
    lossy = 0
    for r in range(WS):
        for key in ("sync_staged", "sync_fused"):
            got = results[r][key]
            for p in want:
                np.testing.assert_array_equal(
                    got[p].view(np.uint32), want[p][r].view(np.uint32), err_msg=f"{key} rank {r} {p}"
                )
        lossy += sum(int((results[r]["sync_staged"][p] != sum(g[p] for g in grads) / WS).sum()) for p in want)
    assert lossy > 0  # 2 bits cannot carry 16 levels: the codec really ran


def test_gpt2_two_level_train_steps_keep_replicas_identical(world):
    _, _, results = world
    for r in range(WS):
        assert np.all(np.isfinite(results[r]["losses"]))
        assert results[r]["losses"] == results[0]["losses"]
        for p, v in results[0]["params"].items():
            np.testing.assert_array_equal(results[r]["params"][p].view(np.uint32), v.view(np.uint32))


@pytest.mark.parametrize("env", [
    {},
    {"CGX_INNER_REDUCTION_TYPE": "ring", "CGX_CROSS_REDUCTION_TYPE": "SRA"},
    {"CGX_INTRA_BROADCAST": "0", "CGX_INTRA_COMPRESS": "0"},
    {"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1", "CGX_CROSS_REDUCTION_TYPE": "PSUM"},
])
def test_topology_from_env_matches_jax(monkeypatch, env):
    """The knobs read as in the JAX package (re-read on every call), and
    ``two_level_config`` overrides the same fields."""
    import dataclasses

    from torch_cgx_tpu import config as jcfg
    from torch_cgx_tpu.parallel import topology as jtopology
    from torch_cgx_tpu_torch import config as tcfg
    from torch_cgx_tpu_torch.parallel import two_level_config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(tcfg.topology_from_env()) == dataclasses.asdict(jcfg.topology_from_env())
    assert dataclasses.asdict(two_level_config()) == dataclasses.asdict(jtopology.two_level_config())
    with pytest.raises(ValueError, match="unknown reduction"):
        TopologyConfig(cross_reduction="TREE")


def test_hierarchical_groups_without_a_process_group():
    from torch_cgx_tpu_torch.parallel import hierarchical_groups
    from torch_cgx_tpu_torch.parallel.mesh import _pow2_div

    tl = hierarchical_groups()
    assert (tl.intra_size, tl.cross_size, tl.size) == (1, 1, 1)
    assert [_pow2_div(n) for n in (1, 4, 6, 12, 16, 24)] == [1, 4, 2, 4, 8, 8]
