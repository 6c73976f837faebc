"""The port's quantized allreduce over spawned gloo ranks against the JAX
package's ``sra_allreduce`` under ``shard_map`` on the CPU mesh.

Each world size spawns its ranks once (a ``FileStore`` in a temporary
directory, every wait bounded) and runs every case there; the tests then
compare what the ranks returned:

* stage-1 frames (the quantized ``(ws, chunk)`` rows a rank sends) are
  byte-identical to the JAX stage-1 quantize on any data;
* the reduced output is bit-identical to JAX's on decode-exact data (an
  integer grid whose buckets all hold 0 and 15) and within the allreduce
  envelope on random data;
* every rank holds the same bytes (error symmetry), in both epilogue
  lowerings, which also agree with each other;
* the uncompressed (PSUM), dummy-codec and tree paths sum exactly.

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

from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.ops import codec

BITS, BUCKET = 4, 128
SPAWN_TIMEOUT_S = 240.0


def _sizes(ws: int):
    """Two fused-slice lengths: whole 32-bucket chunks per rank (the fused
    epilogue geometry) and chunks with a tail of 3 buckets (staged)."""
    return {
        "chunks": ws * 2 * codec.CHUNK_BUCKETS * BUCKET - 5,
        "tail": ws * (codec.CHUNK_BUCKETS + 3) * BUCKET - 5,
    }


def _inputs(ws: int):
    out = {}
    rng = np.random.default_rng(ws)
    for geom, n in _sizes(ws).items():
        out[f"grid_{geom}"] = np.stack(
            [np.float32((np.arange(n) * (2 * r + 3)) % 16) for r in range(ws)]
        )
        out[f"random_{geom}"] = rng.standard_normal((ws, n)).astype(np.float32)
    return out


def _rank_main(rank, ws, init_file, inputs, result_q):
    """One rank: the SRA wire frames of every input in both epilogue
    lowerings, then the exact paths."""
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    import torch.distributed as dist

    from torch_cgx_tpu_torch.parallel import allreduce, reducers

    out = {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=ws,
            timeout=timedelta(seconds=120),
        )
        cc = CompressionConfig(bits=BITS, bucket_size=BUCKET)
        for mode in ("staged", "fused"):
            os.environ["CGX_SRA_EPILOGUE"] = mode
            for name, per_rank in inputs.items():
                y, q_sent, q_own = reducers.sra_wire_frames(
                    torch.from_numpy(per_rank[rank]), None, ws, cc
                )
                out[(mode, name)] = (
                    y.numpy(), q_sent.packed.numpy(), q_sent.meta.numpy(),
                    q_own.packed.numpy(), q_own.meta.numpy(),
                )
        del os.environ["CGX_SRA_EPILOGUE"]
        x = torch.from_numpy(inputs["random_tail"][rank])
        out["psum"] = reducers.quantized_allreduce(x, None, ws, CompressionConfig(bits=32)).numpy()
        os.environ["CGX_DEBUG_DUMMY_COMPRESSION"] = "1"
        out["dummy"] = reducers.quantized_allreduce(x, None, ws, cc).numpy()
        del os.environ["CGX_DEBUG_DUMMY_COMPRESSION"]
        os.environ["CGX_COMPRESSION_QUANTIZATION_BITS"] = str(BITS)
        os.environ["CGX_COMPRESSION_BUCKET_SIZE"] = str(BUCKET)
        tree = {
            "w": torch.full((64, 32), float(rank + 1)),
            "b": torch.full((32,), float(rank + 1)),
        }
        out["tree"] = {
            k: v.numpy() for k, v in allreduce.allreduce_tree(tree, average=True).items()
        }
        dist.barrier()
    except Exception as e:  # reported to the parent, which fails the test
        out = {"error": repr(e)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


def _spawn(ws: int, inputs, init_file: str):
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(r, ws, init_file, inputs, result_q), daemon=True)
        for r in range(ws)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < ws and time.monotonic() < deadline:
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
    assert len(results) == ws, f"only ranks {sorted(results)} reported"
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    assert not errors, errors
    return [results[r] for r in range(ws)]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda ws: f"ws{ws}")
def world(request, tmp_path_factory):
    ws = request.param
    inputs = _inputs(ws)
    store = tmp_path_factory.mktemp(f"gloo_ws{ws}") / "store"
    return ws, inputs, _spawn(ws, inputs, str(store))


def _jax_stage1(x: np.ndarray, ws: int):
    import jax.numpy as jnp

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.ops import dispatch as jdispatch
    from torch_cgx_tpu.parallel import reducers as jreducers

    n = x.shape[0]
    xs = jreducers._pad_rows(jnp.asarray(x), ws, jreducers.chunk_layout(n, ws)[0])
    q = jdispatch.quantize_batch(xs, JCC(bits=BITS, bucket_size=BUCKET))
    return np.asarray(q.packed), np.asarray(q.meta)


def _jax_sra(per_rank: np.ndarray, ws: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torch_cgx_tpu.config import CompressionConfig as JCC
    from torch_cgx_tpu.parallel import reducers as jreducers
    from torch_cgx_tpu.utils.compat import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:ws]), ("dp",))
    cc = JCC(bits=BITS, bucket_size=BUCKET)
    fn = shard_map(
        lambda x: jreducers.sra_allreduce(x[0], "dp", ws, cc)[None],
        mesh=mesh, in_specs=P("dp"), out_specs=P("dp"), check_vma=False,
    )
    return np.asarray(jax.jit(fn)(jnp.asarray(per_rank)))


NAMES = ["grid_chunks", "grid_tail", "random_chunks", "random_tail"]


@pytest.mark.parametrize("name", NAMES)
def test_stage1_frames_match_jax(world, name):
    ws, inputs, results = world
    for r in range(ws):
        packed, meta = _jax_stage1(inputs[name][r], ws)
        for mode in ("staged", "fused"):
            _, sent_p, sent_m, _, _ = results[r][(mode, name)]
            np.testing.assert_array_equal(sent_p.view(np.uint32), packed, err_msg=f"rank {r}")
            np.testing.assert_array_equal(sent_m, meta, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", ["grid_chunks", "grid_tail"])
def test_output_matches_jax_on_decode_exact_data(world, name):
    ws, inputs, results = world
    ref = _jax_sra(inputs[name], ws)
    for r in range(ws):
        for mode in ("staged", "fused"):
            np.testing.assert_array_equal(results[r][(mode, name)][0], ref[r])


@pytest.mark.parametrize("name", ["random_chunks", "random_tail"])
def test_output_within_envelope_on_random_data(world, name):
    ws, inputs, results = world
    x = inputs[name]
    ref = _jax_sra(x, ws)
    exact = x.astype(np.float64).sum(axis=0)
    step = float((x.max() - x.min()) / BUCKET)
    bound = codec.allreduce_error_bound(x.shape[1], BITS, BUCKET, ws, step)
    got = results[0][("staged", name)][0]
    assert np.abs(got - exact).max() <= bound
    assert np.abs(got - ref[0]).max() <= bound


@pytest.mark.parametrize("name", NAMES)
def test_replicas_and_lowerings_bit_identical(world, name):
    """Every rank decodes the same stage-2 bytes, and the fused epilogue
    writes the same stage-2 payload as the staged ops."""
    ws, _, results = world
    y0 = results[0][("staged", name)][0]
    for r in range(ws):
        staged = results[r][("staged", name)]
        fused = results[r][("fused", name)]
        np.testing.assert_array_equal(staged[0].view(np.uint32), y0.view(np.uint32))
        np.testing.assert_array_equal(fused[0].view(np.uint32), y0.view(np.uint32))
        np.testing.assert_array_equal(staged[3], fused[3])
        np.testing.assert_array_equal(staged[4], fused[4])


def test_exact_paths_sum(world):
    ws, inputs, results = world
    x = inputs["random_tail"]
    ordered = x[0].copy()
    for r in range(1, ws):
        ordered = ordered + x[r]
    for r in range(ws):
        np.testing.assert_allclose(results[r]["psum"], x.sum(axis=0), rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(results[r]["dummy"], ordered)
        avg = (ws + 1) / 2.0
        np.testing.assert_array_equal(results[r]["tree"]["w"], np.full((64, 32), avg, np.float32))
        np.testing.assert_allclose(results[r]["tree"]["b"], np.full((32,), avg, np.float32), rtol=1e-6)
