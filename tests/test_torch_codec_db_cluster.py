"""The geometry of the port's pipelined quantize (B7a) and SRA epilogue (B7c),
on the CPU.

Both run B1's and B3's cluster body on a persistent grid of clusters, each
CTA streaming its share of a chunk through a ring of share slots
(``csrc/codec.cu``, "The pipelined cluster kernels"). The kernels run only
on the card (``tests/test_torch_kernels.py``); here:

* the ring at the GPT-2 124M step's launch shapes (108, 144, 307, 480 and
  1,024 chunks, bucket 512, 4 bits) and at the shapes the old whole-chunk
  rings could not hold (ROADMAP C7): the cluster geometry is B1's and
  B3's, one CTA fits a block's shared memory in both packs, B7a keeps two
  512-thread CTAs an SM, a slot holds the widest round of a CTA's share
  and every segment a bulk copy moves starts 128-byte aligned;
* the tile cap: every cluster the card holds has a tile at the cap, and
  one chunk more a tile would leave one idle;
* the routing: ``db_would_run`` and the batch functions take the
  pipelined kernels at the step's shapes and at the old gates, the tile
  within the cap;
* the wrappers hand the tile, the geometry and the ring's depth to the
  library (a stand-in records the call);
* ``shapebench``'s B7a, B7c and B4 shapes are the step's.
"""

import re
from pathlib import Path

import pytest
import torch

from torch_cgx_tpu_torch.ops import autotune, codec, codec_cuda, dispatch
from torch_cgx_tpu_torch.tools import shapebench

SOURCE = Path(codec_cuda.SOURCE).read_text()
STEP_CHUNKS = (108, 144, 307, 480, 1024)
KERNELS = ("quantize", "epilogue")


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("CGX_AUTOTUNE_DIR", str(tmp_path))
    for k in ("CGX_PALLAS_DB", "CGX_AUTOTUNE", "CGX_PALLAS_TILE_CHUNKS", "CGX_PALLAS_PACK",
              "CGX_SRA_EPILOGUE", "CGX_SRA_EPILOGUE_MIN_ELEMS", "CGX_CODEC_ENCODE"):
        monkeypatch.delenv(k, raising=False)
    autotune.invalidate("test setup")
    codec_cuda.reset_launch_counts()
    yield
    autotune.invalidate("test teardown")


def _fits_one_block(kernel, chunks, bits, bucket):
    return all(codec_cuda.db_smem_bytes(kernel, 1, bits, bucket, chunks=chunks, pack=p)
               + codec_cuda.DB_CLUSTER_STATIC_BYTES <= 232448 for p in codec_cuda.PACKS)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("chunks", STEP_CHUNKS)
def test_ring_at_the_step_shapes(kernel, chunks):
    """B1's and B3's geometry; one CTA within 232,448 bytes in both packs;
    under the sum pack B7a keeps two 512-thread CTAs an SM (a 64 KB slot)
    and B7c a ring of four row items of 8.25 KB; the tile cap is one chunk
    below a chunk a resident cluster, three at 1,024 chunks."""
    ring = codec_cuda.db_ring(kernel, chunks, 4, 512)
    assert ring.geometry == codec_cuda.cluster_geometry(chunks, 512, 4)
    assert ring.geometry.positions == 1
    assert _fits_one_block(kernel, chunks, 4, 512)
    if kernel == "quantize":
        assert ring.slots == 1
        if ring.geometry.threads == 512:
            assert ring.slot_bytes == 65536
            per_cta = (codec_cuda.db_smem_bytes(kernel, 1, 4, 512, chunks=chunks)
                       + codec_cuda.DB_CLUSTER_STATIC_BYTES + codec_cuda.SMEM_BLOCK_RESERVED)
            assert 2 * per_cta <= codec_cuda.SMEM_SM_BYTES
    else:
        assert ring.slots == 4
        if ring.geometry.threads == 512:
            assert ring.slot_bytes == 8448  # 4 planes of 512 words and 256 bytes of meta
    want = {108: 1, 144: 1, 307: 1, 480: 1, 1024: 3}[chunks]
    assert codec_cuda.db_tc_cap(kernel, 4, 512, chunks=chunks) == want


@pytest.mark.parametrize("bucket", [32, 96, 128, 512, 1024, 1536, 1760, 1792, 2048, 4096, 6144,
                                    8192, 16384])
@pytest.mark.parametrize("chunks", [1, 18, 144, 1024])
def test_slot_holds_the_widest_round(bucket, chunks):
    """Each round of a CTA's share is a contiguous run of positions that
    starts at a multiple of 32 (a 128-byte aligned segment of every bucket
    or plane), no wider than the CTA's threads; a slot holds the widest
    round: B7a 32 buckets of it in f32, B7c a row's ``bits`` planes of it
    and the 256 bytes of meta."""
    for bits in (1, 4, 8):
        for kernel in KERNELS:
            ring = codec_cuda.db_ring(kernel, chunks, bits, bucket)
            g = ring.geometry
            pos = codec_cuda.cluster_positions(g, bucket)
            widest = 0
            for rank in range(g.k):
                for p in range(g.positions):
                    run = pos[rank, p][pos[rank, p] >= 0]
                    if run.numel() == 0:
                        continue
                    assert torch.equal(run, torch.arange(int(run[0]), int(run[0]) + run.numel()))
                    assert int(run[0]) % 32 == 0 and run.numel() % 32 == 0
                    widest = max(widest, run.numel())
            assert widest == g.threads
            # Rounds of equal width: every thread has a position in every
            # round, so every warp reads every item of the ring.
            assert bool((pos >= 0).all())
            base = codec_cuda.cluster_geometry(chunks, bucket, bits)
            assert g.k == base.k and g.positions >= base.positions
            assert (g == base) == (base.positions == 1 or (bucket // (32 * g.k)) % base.positions == 0)
            need = 32 * 4 * widest if kernel == "quantize" else bits * 4 * widest + 256
            assert ring.slot_bytes >= need and ring.slot_bytes % 128 == 0
            assert 1 <= ring.slots <= codec_cuda.DB_MAX_SLOTS
            assert _fits_one_block(kernel, chunks, bits, bucket)


@pytest.mark.parametrize("kernel,bits,bucket", [
    ("quantize", 4, 1024), ("quantize", 8, 2048), ("quantize", 4, 4096), ("quantize", 1, 8192),
    ("quantize", 8, 16384), ("epilogue", 4, 1280), ("epilogue", 4, 1536), ("epilogue", 4, 1792),
    ("epilogue", 8, 1024), ("epilogue", 8, 1792),
])
def test_old_gates_now_hold_a_ring(kernel, bits, bucket):
    """ROADMAP C7's gates of the whole-chunk rings (B7a at B >= 1024, B7c
    at 4 bits and B >= 1280): the share rings fit there at every chunk
    count, so the cap is at least one tile."""
    for chunks in (1, 64, 1024):
        assert _fits_one_block(kernel, chunks, bits, bucket)
        assert codec_cuda.db_tc_cap(kernel, bits, bucket, chunks=chunks) >= 1


@pytest.mark.parametrize("chunks", [1, 18, 108, 144, 307, 480, 1024, 4096, 65536])
@pytest.mark.parametrize("bucket", [128, 512, 1760, 8192])
def test_tile_cap_keeps_every_cluster_busy(chunks, bucket):
    """At the cap every cluster the card holds at once has a tile; a tile
    one chunk larger would leave one without. The card's SMs count: twice
    the SMs hold at least twice the clusters of the same geometry."""
    for kernel in KERNELS:
        clusters = codec_cuda.db_clusters(kernel, chunks, 4, bucket)
        cap = codec_cuda.db_tc_cap(kernel, 4, bucket, chunks=chunks)
        assert cap >= 1 and clusters >= 1
        if cap > 1:
            assert chunks // cap >= clusters > chunks // (cap + 1)
        else:
            assert chunks // 2 < clusters
        if codec_cuda.cluster_geometry(2 * chunks, bucket, 4, 264) == \
                codec_cuda.cluster_geometry(chunks, bucket, 4):
            assert codec_cuda.db_clusters(kernel, 2 * chunks, 4, bucket, sms=264) >= 2 * clusters


def _layout(rows: int, n: int, bits: int = 4, bucket: int = 512) -> codec.QTensor:
    nb = codec.num_buckets(n, bucket)
    return codec.QTensor(
        packed=torch.empty((rows, 0), dtype=torch.int32), meta=torch.empty((rows, nb, 2)),
        residual=torch.empty((rows, 0)), numel=n, bits=bits, bucket_size=bucket,
        dtype=torch.float32,
    )


@pytest.mark.parametrize("chunks", STEP_CHUNKS[:2] + STEP_CHUNKS[3:])
def test_route_takes_the_pipelined_kernels_at_the_step_shapes(chunks, monkeypatch):
    """Under CGX_PALLAS_DB=on the step's slices of whole chunks take B7a and
    B7c, the tile the override asks for snapped within the cap (4 at 1,024
    chunks: 2, the cap is 3 and the tile divides the chunks; 1 below)."""
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    q = _layout(1, chunks * 32 * 512)
    assert dispatch.db_would_run(q, "quantize") and dispatch.db_would_run(q, "epilogue")
    for kernel in KERNELS:
        assert codec_cuda._db_route(kernel, chunks, 4, 512, None) == 1
        monkeypatch.setenv("CGX_PALLAS_TILE_CHUNKS", "4")
        assert codec_cuda._db_route(kernel, chunks, 4, 512, None) == (2 if chunks == 1024 else 1)
        tuned = autotune.TunedConfig(tc=8, db=True)
        assert codec_cuda._db_route(kernel, chunks, 4, 512, tuned) == (2 if chunks == 1024 else 1)
        monkeypatch.delenv("CGX_PALLAS_TILE_CHUNKS")
    assert not any(codec_cuda.DB_GATED.values())


@pytest.mark.parametrize("bits,bucket", [(4, 1024), (8, 1792), (4, 1536)])
def test_batch_functions_take_the_pipelined_kernels_at_the_old_gates(bits, bucket, monkeypatch):
    """The batch quantize and fused epilogue call the pipelined wrappers at
    buckets the whole-chunk rings refused, at the tile the cap allows (one
    chunk, the override of 2 notwithstanding: two rows of one chunk fill
    no more than two of the card's clusters); nothing is gated."""
    monkeypatch.setenv("CGX_PALLAS_DB", "on")
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    monkeypatch.setenv("CGX_PALLAS_TILE_CHUNKS", "2")
    seen = []
    for name in ("quantize_chunks_db", "sra_epilogue_chunks_db"):
        real = getattr(codec_cuda, name)
        monkeypatch.setattr(codec_cuda, name,
                            lambda *a, _n=name, _r=real, **kw: seen.append((_n, a[6] if "epi" in _n
                                                                             else a[3]))
                            or _r(*a, **kw))
    x = torch.randn(2, 32 * bucket)
    from torch_cgx_tpu_torch.config import CompressionConfig

    cc = CompressionConfig(bits=bits, bucket_size=bucket)
    q = dispatch.quantize_batch(x, cc)
    assert dispatch.fused_epilogue_would_run(q)
    dispatch.reduce_rows_requantize(q, cc, raw_rows=x, own_idx=1)
    assert seen == [("quantize_chunks_db", 1), ("sra_epilogue_chunks_db", 1)]
    assert not any(codec_cuda.DB_GATED.values())


class _FakeLib:
    """Stands in for the built library: records each entry point's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(codec_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(codec_cuda, "_stream", lambda t: 0)
    monkeypatch.setattr(codec_cuda, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(codec_cuda, "_sm_count", lambda index: 132)
    yield lib


@pytest.mark.parametrize("chunks,bucket,tc,want", [
    (144, 512, 1, (4, 128, 1)), (1024, 512, 2, (1, 512, 1)), (108, 512, 54, (1, 512, 1)),
    (64, 8192, 1, (8, 512, 2)), (5, 16384, 5, (8, 512, 2)), (144, 1760, 1, (1, 352, 2)),
])
def test_quantize_db_hands_tile_geometry_and_ring_to_the_kernel(fake_card, chunks, bucket, tc, want):
    """(tc, k, threads, slots) reach cgx_quantize_db: B1's geometry (past
    the register budget in rounds of equal width: 1,760 in five rounds of
    352, not four of 448), one slot within the budget and two past it; any
    tile that divides the chunks; one launch."""
    codec_cuda.quantize_chunks_db(torch.zeros(chunks * 32 * bucket), 4, bucket, tc)
    (name, args), = fake_card.calls
    assert name == "cgx_quantize_db" and args[4] == tc and tuple(args[10:13]) == want
    assert tuple(args[13:16]) == (0, 0, 0)  # round to nearest: no seed
    assert codec_cuda.LAUNCHES["codec_quantize_db"] == 1
    with pytest.raises(ValueError, match="divide"):
        codec_cuda.quantize_chunks_db(torch.zeros(chunks * 32 * bucket), 4, bucket, chunks + 1)


@pytest.mark.parametrize("chunks,bucket,ws,own,want", [
    (256, 512, 4, 1, (1, 512, 4)), (18, 512, 8, 3, (4, 128, 4)), (144, 1760, 4, -1, (1, 352, 4)),
    (3, 8192, 1, 0, (8, 512, 4)),
])
def test_epilogue_db_hands_tile_geometry_and_ring_to_the_kernel(fake_card, chunks, bucket, ws,
                                                                 own, want):
    """(tc, k, threads, slots) reach cgx_sra_epilogue_db at every bucket,
    with and without the raw own row; one launch."""
    words = torch.zeros(ws, chunks * 4 * bucket, dtype=torch.int32)
    meta = torch.zeros(ws, chunks * 32, 2)
    raw = torch.zeros(chunks * 32 * bucket) if own >= 0 else None
    codec_cuda.sra_epilogue_chunks_db(words, meta, raw, own, 4, bucket, 1)
    (name, args), = fake_card.calls
    assert name == "cgx_sra_epilogue_db" and args[6] == 1 and tuple(args[12:15]) == want
    assert (args[3], args[4]) == (own, ws)
    assert codec_cuda.LAUNCHES["codec_sra_epilogue_db"] == 1


def test_python_constants_match_the_source():
    """The ring's barriers, depth and the body's static shared memory are
    the kernels'."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))

    assert const("kBarBytes") == codec_cuda.DB_BAR_BYTES
    assert const("kMaxSlots") == codec_cuda.DB_MAX_SLOTS
    assert 2 * codec_cuda.DB_MAX_SLOTS * 8 <= codec_cuda.DB_BAR_BYTES  # a full and an empty barrier each
    assert max(max(v) for v in codec_cuda.DB_SLOTS.values()) <= codec_cuda.DB_MAX_SLOTS
    warps = const("kClusterMaxThreads") // 32
    static = 0
    for decl, size in (("s_red[2][kClusterMaxWarps][kChunkBuckets]", 4 * 2 * warps * 32),
                       ("s_part[2][kChunkBuckets]", 4 * 2 * 32),
                       ("s_par[kChunkBuckets]", 16 * 32)):
        assert decl in SOURCE
        static += size
    assert "__shared__ float4 s_par[kChunkBuckets]" in SOURCE
    assert static == codec_cuda.CLUSTER_STATIC_BYTES
    cursor = re.search(r"struct Cursor \{\s*int ([a-z, ]+);\s*\};", SOURCE).group(1)
    assert len(cursor.split(",")) * 4 + static <= codec_cuda.DB_CLUSTER_STATIC_BYTES


def test_shapebench_db_and_reduce_shapes_are_the_steps(monkeypatch):
    """B7a's and B7c's rows are the step's slices of whole chunks (what
    ``CGX_PALLAS_DB=on`` sends them); B4's are the launch shapes of phase
    7's two-level and all-to-all steps, 39 launches a rank-step each, and
    their least device time at 3.35 TB/s."""
    monkeypatch.setenv("CGX_COMPRESSION_BUCKET_SIZE", "512")
    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "4")
    monkeypatch.setenv("CGX_SRA_EPILOGUE", "fused")
    for k in ("CGX_STANDALONE_LAYER_ELEMS", "CGX_FUSION_BUFFER_SIZE_MB"):
        monkeypatch.delenv(k, raising=False)
    whole = {c for c, tail in shapebench.step_slices() if not tail}
    b7a = {c for kind, _, c, _, _ in shapebench.SHAPES if kind == "quantize_db"}
    b7c = {c for kind, _, c, rows, _ in shapebench.SHAPES if kind == "epilogue_db" and rows == 1}
    assert b7a == b7c == whole == {108, 144, 480, 1024}
    counts = shapebench.reduce_step_shapes()
    assert {k: sum(v.values()) for k, v in counts.items()} == {"two_level": 39, "alltoall": 39}
    shapes = {(c, rows, own) for _, _, c, rows, own in shapebench.REDUCE_SHAPES}
    assert shapes == set(counts["two_level"]) | set(counts["alltoall"])
    bounds = shapebench.reduce_step_bounds(3.35e12)
    assert bounds["two_level"]["bytes"] == 507_852_800 and bounds["alltoall"]["bytes"] == 723_107_840
    assert 0.151 < bounds["two_level"]["bound_ms"] < 0.152
    assert 0.215 < bounds["alltoall"]["bound_ms"] < 0.216
    n = 54 * 32 * 512
    assert shapebench.shape_bytes("reduce", 54, 2, 0) == (n // 2 + n // 64) + 4 * n + 4 * n
    assert shapebench.shape_bytes("quantize_db", 144, 1, -1) == shapebench.shape_bytes(
        "quantize", 144, 1, -1)


@pytest.mark.parametrize("timed,want", [
    ("every shape", {"two_level": 12 * 0.005 + 24 * 0.006, "alltoall": 12 * 0.0075}),
    ("two-level only", {"two_level": 12 * 0.005 + 24 * 0.006, "alltoall": None}),
])
def test_shapebench_reduce_step_ms(timed, want):
    """B4's burst time a rank-step: each launch shape's burst times its
    launches in the scheme, None for a scheme with a shape left untimed;
    records of other kernels at the same chunk count are not B4's."""
    counts = {"two_level": {(54, 2, 0): 12, (72, 2, 0): 24}, "alltoall": {(108, 4, -1): 12}}
    shapes = [{"kernel": "reduce", "chunks": 54, "rows": 2, "own": 0, "ms": 0.005},
              {"kernel": "reduce", "chunks": 72, "rows": 2, "own": 0, "ms": 0.006},
              {"kernel": "epilogue", "chunks": 108, "rows": 4, "own": -1, "ms": 1.0}]
    if timed == "every shape":
        shapes.append({"kernel": "reduce", "chunks": 108, "rows": 4, "own": -1, "ms": 0.0075})
    got = shapebench.reduce_step_ms(shapes, counts)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (None if v is None else pytest.approx(v, rel=1e-12)), k
