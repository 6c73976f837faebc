"""Stochastic (QSGD) rounding in the port: the Philox4x32-10 stream of
``torch_cgx_tpu_torch/utils/prng.py``, the codec's stochastic encode against
the JAX package's on the same noise, and the key threading through the
reducers, ``make_train_step`` and the DDP hook.

Function level: Philox4x32-10 against Random123's known-answer vectors;
``encode_levels(rand=)`` + ``pack_levels_bucketed`` byte-identical to the
JAX codec's on the same numpy noise, meta equal; every level floor(q) or
floor(q) + 1; the mean decode over many seeds unbiased (as the JAX codec's
test); no key, deterministic bytes; stochastic bytes independent of the
tile, the pack, the single-stage or pipelined wrapper, the cluster geometry
(a model of the kernels' walk), and the fused or staged epilogue.

In spawned gloo ranks (a world of 2 and one of 4, spawned once for the
module): SRA (both epilogues), Ring, all-to-all and the two-level scheme
within the JAX package's stochastic envelope (``tests/test_reducers.py``
``test_stochastic_rounding_envelope``: ``2 * min(bucket, n) / (2^bits - 1)
* ws * (ws + 1)`` on its arange inputs), every rank holding the same bytes,
the same key giving the same bytes, equal inputs giving different stage-1
payloads on two ranks; ``make_train_step(stochastic_seed=)`` on a tiny
GPT-2 at ws 2; the DDP hook under ``CGX_STOCHASTIC_ROUNDING=1`` at ws 2
and on two faked hosts at ws 4, replicas identical after every step and the
leaders' stage-3 frames identical. Only the envelope has a tolerance;
everything else is bit for bit.
"""

import hashlib
import multiprocessing as mp
import os
import queue
import time
import traceback
from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cgx_tpu.ops import codec as jcodec
from torch_cgx_tpu_torch.config import CompressionConfig
from torch_cgx_tpu_torch.ops import codec, codec_cuda, dispatch
from torch_cgx_tpu_torch.utils import prng

SPAWN_TIMEOUT_S = 240.0
SEED = 0x0123456789ABCDEF  # both key words nonzero


# ---------------------------------------------------------------------------
# The generator.
# ---------------------------------------------------------------------------

# Random123's known-answer vectors of philox4x32_10: (counter, key, output).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert prng.philox4x32_10(*ctr, *key) == want
    # The vectorised form on int64 tensors, as the plain versions call it.
    got = prng.philox4x32_10(*(torch.tensor([c, 0], dtype=torch.int64) for c in ctr), *key)
    assert [int(w[0]) for w in got] == list(want)


def test_keys_are_pure_and_distinct():
    k = prng.key(SEED)
    assert prng.seed_from_key(k) == SEED and prng.seed_words(SEED) == (k.hi, k.lo)
    assert prng.fold_in(k, 3) == prng.fold_in(prng.key(SEED), 3)
    folds = {prng.fold_in(k, d) for d in (0, 1, 2, 3, 5, 2**32, 2**40 + 1)}
    assert len(folds) == 7 and k not in folds
    with pytest.raises(ValueError):
        prng.fold_in(k, -1)


def _chunk_draws(c, bucket):
    """Chunk ``c``'s offsets (32, bucket) straight from the Philox: bucket
    4g + j at position l is word j of the call on (l, c, 0, g)."""
    k0, k1 = prng.seed_words(SEED)
    l = torch.arange(bucket, dtype=torch.int64).view(1, -1)
    g = torch.arange(8, dtype=torch.int64).view(-1, 1)
    words = torch.broadcast_tensors(*prng.philox4x32_10(l, c, 0, g, k0, k1))  # 4 x (8, B)
    return prng.uniform24(torch.stack(words, dim=1).reshape(32, bucket))


def test_chunk_offsets_layout():
    """Bucket 4g + j of chunk c at position l is word j of Philox of (l, c,
    tag << 16, g); fewer chunks are the head of more."""
    full = prng.chunk_offsets(SEED, 9, 64)
    k0, k1 = prng.seed_words(SEED)
    for c, s, l in ((5, 0, 0), (6, 13, 37), (7, 31, 63)):
        w = prng.philox4x32_10(l, c, 0, s // 4, k0, k1)[s % 4]
        assert float(full[c * 32 + s, l]) == (w >> 8) * 2.0**-24
    assert torch.equal(full[5 * 32 : 6 * 32], _chunk_draws(5, 64))
    assert torch.equal(prng.chunk_offsets(SEED, 3, 64), full[: 3 * 32])
    tail = prng.chunk_offsets(SEED, 9, 64, tag=prng.TAG_TAIL)
    assert not torch.equal(tail, full)
    assert float(full.min()) >= 0.0 and float(full.max()) < 1.0


# ---------------------------------------------------------------------------
# The codec against the JAX package's on the same noise.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("nb", [32, 64, 45])
def test_stochastic_words_match_jax_on_the_same_noise(bits, nb):
    rng = np.random.default_rng(bits * 100 + nb)
    b = 128
    xb = rng.standard_normal((nb, b)).astype(np.float32)
    rand = rng.random((nb, b), dtype=np.float32)
    ju, jm = jcodec.compute_meta(jnp.asarray(xb), bits)
    jl = jcodec.encode_levels(jnp.asarray(xb), ju, jm, bits, jnp.asarray(rand))
    jw = np.asarray(jcodec.pack_levels_bucketed(jl, bits)).view(np.uint32)
    t = torch.from_numpy(xb)
    unit, bmin = codec.compute_meta(t, bits)
    lvl = codec.encode_levels(t, unit, bmin, bits, rand=torch.from_numpy(rand))
    for pack in ("sum", "butterfly"):
        pw = codec.pack_levels_bucketed(lvl, bits, pack).numpy().view(np.uint32)
        np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(unit.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(bmin.numpy(), np.asarray(jm))
    # And the levels differ from round-to-nearest somewhere: the noise moved them.
    assert not torch.equal(lvl, codec.encode_levels(t, unit, bmin, bits))


@pytest.mark.parametrize("encode", ["div", "mul"])
@pytest.mark.parametrize("bits", [1, 3, 8])
def test_levels_are_floor_or_floor_plus_one(encode, bits):
    rng = np.random.default_rng(bits)
    b = 256
    x = torch.from_numpy(rng.standard_normal(2 * 32 * b).astype(np.float32))
    w, m = codec_cuda.quantize_chunks(x, bits, b, encode=encode, seed=SEED)
    lvl = codec.unpack_levels_bucketed(w, bits, 64, b).to(torch.float64)
    xb = x.view(64, b)
    unit, bmin = m[:, 0], m[:, 1]
    safe = torch.where(unit > 0, unit, torch.ones_like(unit))
    if encode == "mul":
        q = (xb - bmin[:, None]) * (1.0 / safe)[:, None]
    else:
        q = (xb - bmin[:, None]) / safe[:, None]
    d = lvl - torch.floor(q.to(torch.float64))
    top = lvl == (1 << bits) - 1  # floor(q) + 1 past the top clamps to it
    assert bool(((d == 0) | (d == 1) | top).all())
    assert bool((d == 1).any()) and bool((d == 0).any())
    torch.testing.assert_close(m, codec_cuda.quantize_chunks(x, bits, b, encode=encode)[1],
                               rtol=0, atol=0)


def test_stochastic_rounding_unbiased():
    """The JAX codec's test (``tests/test_codec.py``): a bucket of 0.3 with
    one 0 and one 1 at 1 bit, 200 keys; the mean decode within 0.12 of 0.3
    (about 3 sigma / sqrt(reps))."""
    x = torch.full((512,), 0.3)
    x[0], x[1] = 0.0, 1.0
    ys = torch.stack([
        codec.dequantize(codec.quantize(x, 1, 512, key=prng.fold_in(prng.key(0), i)))
        for i in range(200)
    ])
    np.testing.assert_allclose(ys.mean(dim=0)[2:].numpy(), 0.3, atol=0.12)
    # The chunk kernels' plain version on a chunk of 32 such buckets, one
    # seed a draw: each position's mean over the 200 x 32 draws within
    # 4 sigma (sigma = sqrt(0.21 / 6400)).
    xc = x.repeat(32)
    yc = torch.stack([
        codec_cuda.dequantize_chunks(*codec_cuda.quantize_chunks(xc, 1, 512, seed=s), 1, 512)
        for s in range(200)
    ]).view(200 * 32, 512)
    np.testing.assert_allclose(yc.mean(dim=0)[2:].numpy(), 0.3, atol=4 * (0.21 / 6400) ** 0.5)


def test_no_key_rounds_to_nearest(monkeypatch):
    monkeypatch.setenv("CGX_STOCHASTIC_ROUNDING", "1")
    x = torch.randn(3, 40 * 128 + 7)
    det = dispatch.quantize_batch(x, CompressionConfig(bits=4, bucket_size=128))
    cc = CompressionConfig(bits=4, bucket_size=128, stochastic=True)
    nokey = dispatch.quantize_batch(x, cc)
    assert torch.equal(nokey.packed, det.packed) and torch.equal(nokey.meta, det.meta)
    # A key without the config rounds to nearest too.
    k = prng.key(1)
    off = dispatch.quantize_batch(x, CompressionConfig(bits=4, bucket_size=128), k)
    assert torch.equal(off.packed, det.packed)
    on = dispatch.quantize_batch(x, cc, k)
    assert torch.equal(on.meta, det.meta) and not torch.equal(on.packed, det.packed)
    assert torch.equal(on.packed, dispatch.quantize_batch(x, cc, prng.key(1)).packed)


def test_batch_layout_tail_stream_and_fallback():
    """quantize_batch's offsets: the rows' chunks row-major from the chunk
    stream, each row's tail from the tail stream at the row's index; one
    row equals codec.quantize with the same key; rows too short for the
    chunk kernels round with fold_in(key, row), as the JAX package's XLA
    path."""
    rng = np.random.default_rng(3)
    b, rows, nb = 128, 3, 32 + 5
    x = torch.from_numpy(rng.standard_normal((rows, nb * b)).astype(np.float32))
    q = codec_cuda.quantize_batch(x, 4, b, seed=SEED)
    rand = codec.rounding_offsets(SEED, rows, nb, b)
    xb = x.view(rows * nb, b)
    unit, bmin = codec.compute_meta(xb, 4)
    lvl = codec.encode_levels(xb, unit, bmin, 4, rand=rand.reshape(-1, b)).view(rows, nb, b)
    for r in range(rows):
        words = codec.pack_levels_bucketed(lvl[r], 4)
        assert torch.equal(q.packed[r], words), r
    one = codec_cuda.quantize_batch(x[:1], 4, b, seed=SEED)
    flat = codec.quantize(x[0], 4, b, key=prng.key(SEED))
    assert torch.equal(one.packed[0], flat.packed) and torch.equal(one.meta[0], flat.meta)
    cc = CompressionConfig(bits=4, bucket_size=b, stochastic=True)
    short = torch.from_numpy(rng.standard_normal((2, 100)).astype(np.float32))
    k = prng.key(9)
    got = dispatch.quantize_batch(short, cc, k)
    for r in range(2):
        want = codec.quantize(short[r], 4, b, key=prng.fold_in(k, r))
        assert torch.equal(got.packed[r], want.packed), r


def test_bytes_independent_of_tile_pack_and_wrapper(monkeypatch):
    """The plain versions of B1, B7a (every tile), B3 and B7c in both packs
    and both wrappers give the same stochastic bytes; the batch function's
    route (CGX_PALLAS_DB off or on) does not move them."""
    rng = np.random.default_rng(4)
    b, chunks = 128, 6
    x = torch.from_numpy(rng.standard_normal(chunks * 32 * b).astype(np.float32))
    want = codec_cuda.quantize_chunks(x, 4, b, pack="sum", seed=SEED)
    for pack in ("sum", "butterfly"):
        assert torch.equal(codec_cuda.quantize_chunks(x, 4, b, pack=pack, seed=SEED)[0], want[0])
        for tc in (1, 2, 3, 6):
            w, m = codec_cuda.quantize_chunks_db(x, 4, b, tc, pack=pack, seed=SEED)
            assert torch.equal(w, want[0]) and torch.equal(m, want[1])
    rows = torch.from_numpy(rng.standard_normal((4, chunks * 32 * b)).astype(np.float32))
    q = codec_cuda.quantize_batch(rows, 4, b)
    ew, em = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, rows[2], 2, 4, b, seed=SEED)
    for pack in ("sum", "butterfly"):
        for tc in (1, 3):
            w, m = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, rows[2], 2, 4, b, tc,
                                                     pack=pack, seed=SEED)
            assert torch.equal(w, ew) and torch.equal(m, em)
    outs = []
    for db in ("off", "on"):
        monkeypatch.setenv("CGX_PALLAS_DB", db)
        outs.append(codec_cuda.quantize_batch(rows, 4, b, seed=SEED).packed)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("bucket,chunks", [(512, 5), (1760, 3), (16384, 2)])
def test_kernel_walk_model_draws_the_same_offsets(bucket, chunks):
    """A model of the cluster kernels' walk: every geometry (cluster size k,
    positions in rounds past the register budget, B7a/B7c's equal rounds)
    and tiles of 1 and 2 chunks, each thread drawing its positions' offsets
    chunk by chunk from the Philox (:func:`_chunk_draws`) in the order the walk
    visits them, fills the same offsets as one call over every chunk: no
    offset depends on the cut."""
    full = prng.chunk_offsets(SEED, chunks, bucket)
    geoms = set(codec_cuda.cluster_geometries(bucket))
    geoms |= {codec_cuda.cluster_geometry(chunks, bucket, 4), codec_cuda.db_geometry(chunks, bucket, 4)}
    for g in geoms:
        pos = codec_cuda.cluster_positions(g, bucket)  # (k, positions, threads)
        for tc in (1, 2):
            if chunks % tc:
                continue
            got = torch.full_like(full, -1.0)
            for t in range(chunks // tc):
                for u in range(tc):
                    c = t * tc + u
                    one = _chunk_draws(c, bucket)
                    for ls in pos.reshape(-1):
                        if ls >= 0:
                            got[c * 32 : (c + 1) * 32, ls] = one[:, ls]
            assert torch.equal(got, full), (g, tc)


@pytest.mark.parametrize("own", [None, 0, 3])
def test_fused_epilogue_equals_staged(monkeypatch, own):
    monkeypatch.setenv("CGX_STOCHASTIC_ROUNDING", "1")
    rng = np.random.default_rng(5)
    cc = CompressionConfig(bits=4, bucket_size=128, stochastic=True)
    rows = torch.from_numpy(rng.standard_normal((4, 2 * 32 * 128)).astype(np.float32))
    q = dispatch.quantize_batch(rows, cc)
    k = prng.key(11)
    got = {}
    for mode in ("fused", "staged"):
        monkeypatch.setenv("CGX_SRA_EPILOGUE", mode)
        kw = {} if own is None else {"raw_rows": rows, "own_idx": own}
        got[mode] = dispatch.reduce_rows_requantize(q, cc, key=k, **kw)
        assert dispatch.fused_epilogue_would_run(q) == (mode == "fused")
    assert torch.equal(got["fused"].packed, got["staged"].packed)
    assert torch.equal(got["fused"].meta, got["staged"].meta)


# ---------------------------------------------------------------------------
# Spawned ranks: the reducers, the train step and the DDP hook.
# ---------------------------------------------------------------------------


def arange_inputs(n: int, ws: int) -> np.ndarray:
    """``tests/test_reducers.py``'s inputs: rank r holds (r + 1) * arange."""
    base = np.arange(-n / 2, n / 2, 1.0)
    return np.stack([(r + 1) * base for r in range(ws)]).astype(np.float32)


def _digest(t) -> str:
    return hashlib.sha256(np.ascontiguousarray(t).tobytes()).hexdigest()


def _reducer_cases(rank, ws, out):
    from torch_cgx_tpu_torch.parallel import hierarchical_groups, reducers

    key = prng.key(7)
    tl = hierarchical_groups(intra_size=2)
    for n, b in ((8192, 512), (ws * 2 * 32 * 128, 128)):
        cc = CompressionConfig(bits=4, bucket_size=b, stochastic=True)
        x = torch.from_numpy(arange_inputs(n, ws)[rank])
        for mode in ("staged", "fused"):
            os.environ["CGX_SRA_EPILOGUE"] = mode
            y, q_sent, q_own = reducers.sra_wire_frames(x, None, ws, cc, key=key)
            out[("sra", mode, n)] = y.numpy()
            out[("sra_wire", mode, n)] = (_digest(q_sent.packed), _digest(q_own.packed))
        del os.environ["CGX_SRA_EPILOGUE"]
        out[("sra_again", n)] = reducers.sra_allreduce(x, None, ws, cc, key=key).numpy()
        out[("sra_det", n)] = reducers.sra_allreduce(
            x, None, ws, CompressionConfig(bits=4, bucket_size=b)).numpy()
        out[("ring", n)] = reducers.ring_allreduce(x, None, ws, cc, key=key).numpy()
        out[("ring_again", n)] = reducers.ring_allreduce(x, None, ws, cc, key=key).numpy()
        out[("alltoall", n)] = reducers.alltoall_allreduce(x, None, ws, cc, key=key).numpy()
        out[("two_level", n)] = reducers.hierarchical_allreduce(x, tl, cc, key=key).numpy()
        out[("two_level_again", n)] = reducers.hierarchical_allreduce(x, tl, cc, key=key).numpy()
        # Equal inputs on every rank: each rank's stage-1 rows round with its own stream.
        same = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
        _, q_sent, _ = reducers.sra_wire_frames(same, None, ws, cc, key=key)
        out[("stage1_equal_inputs", n)] = _digest(q_sent.packed)


def _train_step_case(rank, ws, out):
    from torch_cgx_tpu_torch.models import GPT2, GPT2Config, lm_loss
    from torch_cgx_tpu_torch.parallel import make_train_step

    os.environ.update({"CGX_COMPRESSION_QUANTIZATION_BITS": "4",
                       "CGX_COMPRESSION_BUCKET_SIZE": "128", "CGX_STOCHASTIC_ROUNDING": "1"})
    cfg = GPT2Config.tiny()
    tokens = torch.from_numpy(np.random.default_rng(rank).integers(0, cfg.vocab_size, (2, 32)))
    for label, seed in (("seed5", 5), ("seed5_again", 5), ("seed6", 6), ("no_seed", None)):
        model = GPT2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device="cpu",
                               stochastic_seed=seed)
        losses = [float(step(tokens)) for _ in range(2)]
        out[("train", label)] = (losses, [p.detach().numpy().copy() for p in model.parameters()])
    for k in ("CGX_COMPRESSION_QUANTIZATION_BITS", "CGX_COMPRESSION_BUCKET_SIZE",
              "CGX_STOCHASTIC_ROUNDING"):
        del os.environ[k]


def _hook_case(rank, ws, out):
    """DDP + cgx_hook on a float32 tiny GPT-2 under stochastic rounding, 4
    steps; at ws 4 on two faked hosts (the two-level scheme), recording
    each leader's stage-3 frames."""
    import torch.distributed as dist

    from torch_cgx_tpu_torch import config as cfg
    from torch_cgx_tpu_torch.models import GPT2Config, lm_loss
    from torch_cgx_tpu_torch.tools.hookprof import ddp_setup
    from torch_cgx_tpu_torch.torch_backend import backend

    os.environ.update({"CGX_COMPRESSION_QUANTIZATION_BITS": "4", "CGX_STOCHASTIC_ROUNDING": "1",
                       "CGX_SEED": "3"})
    if ws == 4:
        os.environ["CGX_SHM_HOST_ID"] = f"testhost{rank // 2}"
    backend.release(None)
    cfg.clear_registry()
    stage3, last = [], [None]
    inner_req, inner_hier = backend._requantize_frames, backend._qreduce_hier

    def requantize(*a, **kw):
        last[0] = inner_req(*a, **kw)
        return last[0]

    def hier(fused, layers, wdt, topo, hm, *rest):
        last[0] = None
        inner_hier(fused, layers, wdt, topo, hm, *rest)
        if dist.get_rank(hm.intra) == 0:
            stage3.append(_digest(last[0].cpu().numpy()))

    backend._requantize_frames, backend._qreduce_hier = requantize, hier
    try:
        gcfg = GPT2Config.tiny()
        model, ddp, _, opt = ddp_setup(torch.device("cpu"), gcfg, 0)
        tokens = torch.from_numpy(np.random.default_rng(rank).integers(0, gcfg.vocab_size, (2, 32)))
        digests = []
        for _ in range(4):
            opt.zero_grad(set_to_none=True)
            lm_loss(ddp(tokens), tokens).backward()
            opt.step()
            digests.append([_digest(p.detach().numpy()) for p in model.parameters()])
        out["hook"] = {"digests": digests, "stage3": stage3,
                       "hier": backend._use_hierarchy(None, cfg.topology_from_env()),
                       "rng": bool(backend._RNGS)}
    finally:
        backend._requantize_frames, backend._qreduce_hier = inner_req, inner_hier
        backend.release(None)
        for k in ("CGX_COMPRESSION_QUANTIZATION_BITS", "CGX_STOCHASTIC_ROUNDING", "CGX_SEED",
                  "CGX_SHM_HOST_ID"):
            os.environ.pop(k, None)


def _rank_main(rank, ws, init_file, result_q):
    for k in [k for k in os.environ if k.startswith("CGX_")]:
        del os.environ[k]
    import torch.distributed as dist

    torch.set_num_threads(1)  # the worlds' ranks share the test machine's cores
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=ws, timeout=timedelta(seconds=120))
        _reducer_cases(rank, ws, out)
        if ws == 2:
            _train_step_case(rank, ws, out)
        _hook_case(rank, ws, out)
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
        store = str(tmp_path_factory.mktemp(f"stochastic_ws{ws}") / "store")
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


def _sizes(ws):
    return ((8192, 512), (ws * 2 * 32 * 128, 128))


@pytest.mark.parametrize("ws", [2, 4])
@pytest.mark.parametrize("name", ["sra", "ring", "alltoall", "two_level"])
def test_reducers_within_the_stochastic_envelope(worlds, ws, name):
    res = worlds[ws]
    for n, b in _sizes(ws):
        kind = ("sra", "fused", n) if name == "sra" else (name, n)
        expected = arange_inputs(n, ws).astype(np.float64).sum(axis=0)
        out = res[0][kind]
        bound = codec.allreduce_error_bound(n, 4, b, ws)
        assert np.max(np.abs(out - expected)) < bound, (name, n)
        for r in range(1, ws):
            np.testing.assert_array_equal(res[r][kind], out, err_msg=f"{name} n={n} rank {r}")


@pytest.mark.parametrize("ws", [2, 4])
def test_same_key_same_bytes_and_lowerings_agree(worlds, ws):
    for o in worlds[ws]:
        for n, _ in _sizes(ws):
            np.testing.assert_array_equal(o[("sra", "fused", n)], o[("sra", "staged", n)])
            assert o[("sra_wire", "fused", n)] == o[("sra_wire", "staged", n)]
            np.testing.assert_array_equal(o[("sra_again", n)], o[("sra", "fused", n)])
            np.testing.assert_array_equal(o[("ring_again", n)], o[("ring", n)])
            np.testing.assert_array_equal(o[("two_level_again", n)], o[("two_level", n)])
            # Stochastic rounding moved the result off the deterministic one.
            assert not np.array_equal(o[("sra_det", n)], o[("sra", "fused", n)])


@pytest.mark.parametrize("ws", [2, 4])
def test_equal_inputs_give_different_stage1_payloads(worlds, ws):
    for n, _ in _sizes(ws):
        payloads = {o[("stage1_equal_inputs", n)] for o in worlds[ws]}
        assert len(payloads) == ws, n


def test_make_train_step_stochastic_seed(worlds):
    r0, r1 = worlds[2]
    for label in ("seed5", "seed5_again", "seed6", "no_seed"):
        (l0, p0), (l1, p1) = r0[("train", label)], r1[("train", label)]
        assert np.all(np.isfinite(l0)) and l0 == l1, label
        for a, b in zip(p0, p1):
            np.testing.assert_array_equal(a, b, err_msg=f"{label} replicas")
    same = zip(r0[("train", "seed5")][1], r0[("train", "seed5_again")][1])
    assert all(np.array_equal(a, b) for a, b in same)
    for other in ("seed6", "no_seed"):
        diff = zip(r0[("train", "seed5")][1], r0[("train", other)][1])
        assert not all(np.array_equal(a, b) for a, b in diff), other


@pytest.mark.parametrize("ws", [2, 4])
def test_ddp_hook_stochastic_replicas_and_stage3_frames(worlds, ws):
    res = worlds[ws]
    h0 = res[0]["hook"]
    assert h0["hier"] == (ws == 4) and h0["rng"]
    for r, o in enumerate(res):
        h = o["hook"]
        for step, d in enumerate(h["digests"]):
            assert d == h0["digests"][step], (r, step)
    if ws == 4:
        leaders = [res[r]["hook"]["stage3"] for r in (0, 2)]
        assert leaders[0] and leaders[0] == leaders[1]
        assert not res[1]["hook"]["stage3"] and not res[3]["hook"]["stage3"]
