"""The cluster geometry and the reciprocal quotient of the port's B1/B5 and
B3 kernels, on the CPU.

The kernels (``csrc/codec.cu``, "The cluster kernels") run only on the card
(``tests/test_torch_kernels.py``). What surrounds them is checked here:

* ``codec_cuda.cluster_geometry`` at the GPT-2 124M step's launch shapes
  and at buckets 32 ... 16384: every (chunk, position) owned by exactly one
  thread, k in {1, 2, 4, 8}, at most 512 threads a CTA (the CUDA limit is
  1024), a thread's values within the register budget (one position's 32)
  wherever a cluster holds the chunk so, positions in rounds (re-read)
  past it; the measured geometries at the step's shapes; the rule in
  units of the card's SMs;
* the wrappers hand that geometry to the library (a stand-in library
  records the call), the epilogue at every bucket too;
* the div encode's reciprocal quotient (``div_quotient``: q = a*r with r
  the correctly rounded reciprocal, then one FMA correction), modelled
  exactly with ``fractions.Fraction`` and rounded to float32 with ties to
  even, equals numpy's float32 division bit for bit over the level domain
  and at the edges of the ranges (divisor and numerator) the kernels guard
  it to;
* ``shapebench.SHAPES`` against the port's own grouping of the GPT-2 124M
  gradients, and ``qbench.adversarial_operand``'s bucket classes.
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_cgx_tpu_torch.models import GPT2, GPT2Config
from torch_cgx_tpu_torch.ops import codec, codec_cuda
from torch_cgx_tpu_torch.parallel import allreduce
from torch_cgx_tpu_torch.tools import qbench, shapebench

SOURCE = Path(codec_cuda.SOURCE).read_text()
STEP_CHUNKS = (18, 108, 144, 307, 480, 1024)
BUCKETS = (32, 96, 128, 256, 512, 544, 896, 1024, 1760, 1792, 2048, 4096, 6144, 8192, 16384)


def _fits(bucket):
    """Every k the register budget admits, by brute force: B/k positions a
    CTA, one a thread, in whole warps of at most 512 threads."""
    return [k for k in (1, 2, 4, 8) if bucket % (32 * k) == 0 and bucket // k <= 512]


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("chunks", STEP_CHUNKS + (1, 133, 212, 256, 4096))
def test_geometry_covers_each_position_once_within_the_budget(chunks, bucket):
    for bits in (1, 4, 8):
        g = codec_cuda.cluster_geometry(chunks, bucket, bits)
        fits = _fits(bucket)
        assert g.k in (1, 2, 4, 8) and bucket % (32 * g.k) == 0
        assert g.threads % 32 == 0 and 32 <= g.threads <= 512 <= 1024
        assert codec_cuda.CLUSTER_VALUES_PER_THREAD == 32  # one position's 32 buckets
        if fits:  # within the budget: one position a thread, in registers
            assert g.k in fits and g.threads * g.k == bucket and g.positions == 1
        else:  # past it (B > 4096, or warps no k splits): positions in rounds
            assert bucket > 4096 or bucket % 128
            span = bucket // g.k
            assert g.positions == -(-span // g.threads) > 1 and g.threads <= span
            # The largest k that splits the warps; the fewest rounds, evenly.
            assert g.k == max(k for k in (1, 2, 4, 8) if (bucket // 32) % k == 0)
            assert g.positions == -(-span // 512) and span > (g.positions - 1) * g.threads
        pos = codec_cuda.cluster_positions(g, bucket)
        assert pos.shape == (g.k, g.positions, g.threads)
        owned = pos[pos >= 0]
        assert torch.equal(owned.sort().values, torch.arange(bucket))
        # Each CTA a contiguous range of B/k positions, neighbouring threads
        # on neighbouring positions (coalesced loads and stores), round
        # after round; a warp's positions of a round all in range or all
        # out, and round 0 in range for every thread.
        assert torch.equal(owned, torch.arange(bucket))
        assert bool((pos[:, 0] >= 0).all())
        warps = (pos >= 0).view(g.k, g.positions, g.threads // 32, 32)
        assert bool((warps.all(-1) | ~warps.any(-1)).all())
        # The grid: CTA i is rank i % k of chunk i // k, every pair once.
        grid = [(i // g.k, i % g.k) for i in range(min(chunks, 3) * g.k)]
        assert grid == [(c, r) for c in range(min(chunks, 3)) for r in range(g.k)]


@pytest.mark.parametrize("chunks", STEP_CHUNKS + (1, 133, 212, 4096))
def test_geometry_rule_counts_in_the_cards_sms(chunks):
    """The rule is in units of the card's SMs: twice the chunks on twice the
    SMs take the same geometry, and a card's own SM count reaches it."""
    for bucket in (128, 512, 2048):
        g = codec_cuda.cluster_geometry(chunks, bucket, 4, sms=132)
        assert codec_cuda.cluster_geometry(2 * chunks, bucket, 4, sms=264) == g
        assert codec_cuda.cluster_geometry(chunks, bucket, 4) == g  # 132 where no card is named


@pytest.mark.parametrize("chunks,k,threads", [
    (18, 4, 128), (108, 1, 512), (144, 4, 128), (256, 1, 512), (307, 1, 512), (480, 1, 512),
    (1024, 1, 512),
])
def test_geometry_at_the_step_shapes(chunks, k, threads):
    """Bucket 512: one CTA an SM at 108 chunks (and at the 18 of an mlp
    layer's ws-8 share, four CTAs a chunk), four CTAs an SM at 144 (one CTA
    a chunk would give 12 SMs two), k = 1 from 256 chunks on."""
    g = codec_cuda.cluster_geometry(chunks, 512, 4)
    assert (g.k, g.threads) == (k, threads)


@pytest.mark.parametrize("bucket", range(128, 1793, 128))
def test_every_epilogue_bucket_has_a_geometry(bucket):
    """The buckets whose (32, B) f32 tile fits a block's shared memory (the
    fused epilogue's old gate, B <= 1,792) keep B3 inside the register
    budget: one position a thread, in registers (larger ones, which the
    gate now admits, take positions in rounds)."""
    assert 32 * bucket * 4 <= codec_cuda.MAX_EPILOGUE_TILE_BYTES
    for chunks in STEP_CHUNKS:
        assert codec_cuda.cluster_geometry(chunks, bucket, 4).positions == 1


def test_geometry_refuses_bad_arguments():
    with pytest.raises(ValueError):
        codec_cuda.cluster_geometry(0, 512, 4)
    with pytest.raises(ValueError):
        codec_cuda.cluster_geometry(4, 500, 4)
    with pytest.raises(ValueError):
        codec_cuda.cluster_geometry(4, 512, 9)


def test_python_constants_match_the_source():
    """The geometry's limits and the reciprocal's range are the kernels'."""
    def const(name):
        expr = re.search(rf"constexpr int {name} = ([0-9 +-]+);", SOURCE).group(1)
        return sum(int(t) for t in expr.replace("- ", "-").replace("+ ", "").split())

    assert const("kClusterMaxThreads") == codec_cuda.CLUSTER_MAX_THREADS
    assert const("kClusterMaxSize") == max(codec_cuda.CLUSTER_SIZES)
    assert const("kChunkBuckets") == codec_cuda.CLUSTER_VALUES_PER_THREAD
    assert (const("kRcpExpLo") - 127, const("kRcpExpHi") - 127) == codec_cuda.RCP_EXP_RANGE
    lo = re.search(r"kRcpMinNumeratorBits = \(uint32_t\)\(127 - (\d+)\) << 23;", SOURCE).group(1)
    assert 2.0 ** -int(lo) == codec_cuda.RCP_MIN_NUMERATOR


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
    codec_cuda.reset_launch_counts()
    yield lib
    codec_cuda.reset_launch_counts()


@pytest.mark.parametrize("chunks,bucket,want", [
    (144, 512, (4, 128)), (1024, 512, (1, 512)), (2, 4096, (8, 512)), (1, 8192, (8, 512)),
    (1, 16384, (8, 512)),
])
def test_quantize_hands_its_geometry_to_the_kernel(fake_card, chunks, bucket, want):
    """(k, threads) reach cgx_quantize; past the budget fewer threads than
    B/k (2 and 4 positions a thread at 8192 and 16384); one launch."""
    codec_cuda.quantize_chunks(torch.zeros(chunks * 32 * bucket), 4, bucket)
    (name, args), = fake_card.calls
    assert name == "cgx_quantize" and tuple(args[9:11]) == want
    assert tuple(args[11:14]) == (0, 0, 0)  # round to nearest: no seed
    assert codec_cuda.LAUNCHES["codec_quantize"] == 1


@pytest.mark.parametrize("variant", codec_cuda.VARIANTS)
@pytest.mark.parametrize("chunks,bucket,want", [
    (144, 512, (4, 128)), (1024, 512, (1, 512)), (1, 8192, (8, 512)),
])
def test_quantize_variant_hands_b1s_geometry_to_the_kernel(fake_card, chunks, bucket, want, variant):
    """B9 runs at B1's geometry: the (k, threads) cgx_quantize gets reach
    cgx_quantize_variant after the variant's index and the unit scale, at
    the step's mlp_in launch (a cluster of 4), at 1,024 chunks (one CTA a
    chunk) and past the register budget (positions in rounds); one counted
    launch."""
    x = torch.zeros(chunks * 32 * bucket)
    codec_cuda.quantize_chunks(x, 4, bucket)
    codec_cuda.reset_launch_counts()
    codec_cuda.quantize_variant_chunks(x, variant, 4, bucket)
    (_, qa), (name, args) = fake_card.calls
    assert name == "cgx_quantize_variant" and tuple(args[8:10]) == tuple(qa[9:11]) == want
    assert args[3:8] == (chunks, bucket, 4, codec_cuda.VARIANTS.index(variant),
                         codec.unit_scale(4))
    assert codec_cuda.LAUNCHES["codec_quantize_variant"] == 1
    assert sum(codec_cuda.LAUNCHES.values()) == 1


@pytest.mark.parametrize("variant", codec_cuda.VARIANTS)
def test_quantize_variant_takes_a_forced_geometry(fake_card, variant):
    """A geometry given as ``g`` reaches the kernel as given, in rounds too
    (256 threads for 512 positions); one counted launch a call."""
    x = torch.zeros(6 * 32 * 512)
    for i, g in enumerate((codec_cuda.ClusterGeometry(2, 256), codec_cuda.ClusterGeometry(1, 256, 2))):
        codec_cuda.quantize_variant_chunks(x, variant, 4, 512, g)
        name, args = fake_card.calls[-1]
        assert name == "cgx_quantize_variant" and tuple(args[8:10]) == (g.k, g.threads)
        assert codec_cuda.LAUNCHES["codec_quantize_variant"] == i + 1 == len(fake_card.calls)


class _FakeFunction:
    """An entry point of the stand-in library: takes its argtypes."""


class _FakeCDLL:
    """Stands in for ``ctypes.CDLL`` of the built library."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = _FakeFunction()
        setattr(self, name, fn)
        return fn


# The default library's entry points, each bound with its argtypes.
ENTRY_POINTS = (
    "cgx_quantize", "cgx_dequantize", "cgx_sra_epilogue", "cgx_reduce_rows", "cgx_matmul_quantize",
    "cgx_matmul_quantize_tc", "cgx_matmul_quantize_tf32", "cgx_tf32_split", "cgx_quantize_db",
    "cgx_dequantize_db", "cgx_sra_epilogue_db", "cgx_quantize_variant", "cgx_div_sweep",
    "cgx_div_pairs", "cgx_error_name",
)
C_TYPES = {"int": "c_int", "long long": "c_longlong", "float": "c_float", "unsigned": "c_uint"}


@pytest.fixture
def bound_argtypes(monkeypatch):
    """Each entry point's argtypes as ``codec_cuda._lib`` binds them, on a
    stand-in library (nothing is built or loaded)."""
    import ctypes

    monkeypatch.setattr(codec_cuda, "build", lambda force=False: Path("libcgx_codec.so"))
    monkeypatch.setattr(ctypes, "CDLL", _FakeCDLL)
    monkeypatch.setattr(codec_cuda, "_LIB", None)
    lib = codec_cuda._lib()
    return {name: fn.argtypes for name, fn in vars(lib).items() if hasattr(fn, "argtypes")}


def test_every_entry_point_is_bound(bound_argtypes):
    assert sorted(bound_argtypes) == sorted(ENTRY_POINTS)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_argtypes_match_the_c_signature(bound_argtypes, name):
    """ctypes passes each argument as the entry point's C definition in
    ``csrc/codec.cu`` takes it: a pointer as ``c_void_p``, ``long long`` as
    ``c_longlong`` and so on, in order (a mismatch shifts every argument
    after it)."""
    import ctypes

    found = re.findall(rf"\n(?:int|const char\*) {name}\(([^)]*)\)\s*\{{", SOURCE)
    assert len(found) == 1, found
    want = []
    for param in found[0].split(","):
        decl = " ".join(param.split())
        if "*" in decl:
            want.append(ctypes.c_void_p)
        else:
            want.append(getattr(ctypes, C_TYPES[decl.rsplit(" ", 1)[0]]))
    assert list(bound_argtypes[name]) == want


def test_build_parts_are_timed_each_in_order():
    """The build waits on its parts' compilers together and records each
    one's seconds in the order of the parts, not of their ends; their
    diagnostics come back in that order too."""
    import subprocess
    import sys

    procs = [subprocess.Popen([sys.executable, "-c", f"import sys, time; time.sleep({t}); "
                               f"sys.stderr.write('{k}')"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, t in enumerate((1.2, 0.0, 0.6))]
    seconds = []
    assert codec_cuda._run_nvcc(procs, seconds) == "012"
    assert len(seconds) == 3 and seconds[1] < seconds[2] < seconds[0]


def test_build_stops_every_part_at_the_first_failure():
    import subprocess
    import sys
    import time

    slow = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    bad = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        codec_cuda._run_nvcc([slow, bad])
    assert time.perf_counter() - t0 < 30 and slow.poll() is not None


def test_seed_reaches_the_kernels_as_its_key_words(fake_card):
    """A seed reaches cgx_quantize and cgx_sra_epilogue as (1, its high
    word, its low word), after the geometry; one launch each."""
    seed = 0x0123456789ABCDEF
    codec_cuda.quantize_chunks(torch.zeros(32 * 512), 4, 512, seed=seed)
    words = torch.zeros(2, 4 * 512, dtype=torch.int32)
    codec_cuda.sra_epilogue_chunks(words, torch.zeros(2, 32, 2), None, -1, 4, 512, seed=seed)
    (q, qa), (e, ea) = fake_card.calls
    assert (q, e) == ("cgx_quantize", "cgx_sra_epilogue")
    assert tuple(qa[11:14]) == tuple(ea[13:16]) == (1, 0x01234567, 0x89ABCDEF)


def test_epilogue_hands_its_geometry_or_refuses(fake_card):
    """(k, threads) reach cgx_sra_epilogue at every bucket: 1760 = 55 warps
    of positions, which no k splits into at most 512 threads, takes one
    CTA of 448 threads, four positions a thread; one launch a call."""
    ws, chunks = 4, 256
    words = torch.zeros(ws, chunks * 4 * 512, dtype=torch.int32)
    meta = torch.zeros(ws, chunks * 32, 2)
    codec_cuda.sra_epilogue_chunks(words, meta, torch.zeros(chunks * 32 * 512), 1, 4, 512)
    (name, args), = fake_card.calls
    assert name == "cgx_sra_epilogue" and tuple(args[11:13]) == (1, 512)
    assert codec_cuda.LAUNCHES["codec_sra_epilogue"] == 1
    words = torch.zeros(1, 4 * 1760, dtype=torch.int32)
    codec_cuda.sra_epilogue_chunks(words, torch.zeros(1, 32, 2), None, -1, 4, 1760)
    assert codec_cuda.cluster_geometry(1, 1760, 4) == codec_cuda.ClusterGeometry(1, 448, 4)
    (name, args) = fake_card.calls[-1]
    assert name == "cgx_sra_epilogue" and tuple(args[11:13]) == (1, 448)
    assert codec_cuda.LAUNCHES["codec_sra_epilogue"] == 2 and len(fake_card.calls) == 2


# ---------------------------------------------------------------------------
# The reciprocal quotient, modelled exactly.
# ---------------------------------------------------------------------------


def rn32(x: Fraction) -> Fraction:
    """``x`` rounded to float32, to nearest with ties to even (subnormals
    included; overflow to +-inf as a float)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1, -x) if x < 0 else (1, x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    quantum = max(e, -126) - 23
    scaled = x / Fraction(2) ** quantum
    m, r = divmod(scaled.numerator, scaled.denominator)
    if 2 * r > scaled.denominator or (2 * r == scaled.denominator and m % 2):
        m += 1
    out = Fraction(m) * Fraction(2) ** quantum
    if out >= Fraction(2) ** 128:
        return sign * Fraction(10) ** 400  # beyond float32: compared as inf below
    return sign * out


def as_f32(x: Fraction) -> np.float32:
    return np.float32(np.inf) if abs(x) > Fraction(2) ** 128 else np.float32(float(x))


def model_quotient(a: np.float32, d: np.float32) -> np.float32:
    """The kernels' div quotient: through the reciprocal where the divisor
    is in range and the numerator 0 or at least 2^-62, the IEEE divide
    (numpy's float32 one) elsewhere."""
    if not codec_cuda.rcp_in_range(float(d)) or not (
            a == 0 or a >= np.float32(codec_cuda.RCP_MIN_NUMERATOR)):
        return np.float32(a) / np.float32(d)
    if a == 0:
        return np.float32(a)  # q = a*r, a zero of a's sign
    fa, fd = Fraction(float(a)), Fraction(float(d))
    r = rn32(1 / fd)
    q = rn32(fa * r)
    e = rn32(fa - fd * q)  # __fmaf_rn(-safe, q, a)
    return as_f32(rn32(e * r + q))  # __fmaf_rn(e, rcp, q)


def test_rn32_is_numpys_float32_rounding():
    rng = np.random.default_rng(5)
    for a, d in rng.standard_normal((300, 2)).astype(np.float32):
        assert as_f32(rn32(Fraction(float(a)) / Fraction(float(d)))) == np.float32(a) / np.float32(d)


def _numerators(d: np.float32):
    """RN(t/2 * d) for t = 0 .. 513 (every 8-bit level and level boundary)
    and one float32 ulp on each side of each."""
    base = (np.arange(514, dtype=np.float32) * np.float32(0.5)) * d
    return np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(0))]).astype(np.float32)


def _levels(q):
    return np.clip(np.nan_to_num(np.floor(q + np.float32(0.5)), nan=0.0), 0, 255)


def _assert_same_quotients(a, d, what):
    """The modelled quotients of ``a / d`` equal numpy's bit for bit, and so
    do their 8-bit levels."""
    want = a / d
    got = np.array([model_quotient(x, d) for x in a], dtype=np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), what
    assert np.array_equal(_levels(got), _levels(want)), what


@pytest.mark.parametrize("e2", [-64, -1, 0, 23, 63])
def test_reciprocal_quotient_model_equals_the_ieee_divide(e2):
    """Over the level domain at divisors with edge significands (1, the
    largest below 2, and neighbours) and seeded random ones, at exponents
    from the bottom to the top of the guarded range."""
    rng = np.random.default_rng(e2 + 100)
    mants = [0, 1, 2, (1 << 22), (1 << 23) - 1, (1 << 23) - 2] + list(rng.integers(0, 1 << 23, 4))
    for m in mants:
        d = np.array(((127 + e2) << 23) | int(m), dtype=np.uint32).view(np.float32)
        assert codec_cuda.rcp_in_range(float(d))
        _assert_same_quotients(_numerators(d), d, (e2, m))


def test_reciprocal_guard_edges():
    """In range: 2^-64 <= safe < 2^64. Outside, the IEEE divide runs:
    subnormal, infinite and too small or too large divisors."""
    f = np.float32
    tiny, huge = f(2.0**-64), f(2.0**64)
    assert codec_cuda.rcp_in_range(float(tiny)) and codec_cuda.rcp_in_range(1.0)
    assert codec_cuda.rcp_in_range(float(np.nextafter(huge, f(0))))
    for d in (np.nextafter(tiny, f(0)), huge, f(1e-40), f(1.4e-45), f(np.inf), f(3.4e38)):
        assert not codec_cuda.rcp_in_range(float(d)), d
    # At both edges of the range the model still equals the IEEE divide.
    for d in (tiny, np.nextafter(tiny, f(1)), np.nextafter(huge, f(0))):
        _assert_same_quotients(_numerators(f(d))[::7], f(d), d)
    # The numerator's edge: 2^-62 and its neighbours, the smallest
    # subnormal, at the range's divisors and at 1.
    lo = f(codec_cuda.RCP_MIN_NUMERATOR)
    a = np.array([lo, np.nextafter(lo, f(0)), np.nextafter(lo, f(1)), f(1.4e-45), f(1e-38),
                  f(0.0), f(-0.0)], dtype=np.float32)
    for d in (tiny, np.nextafter(tiny, f(1)), f(1.0), np.nextafter(huge, f(0))):
        _assert_same_quotients(a, f(d), ("numerator edge", d))


def test_reciprocal_quotient_levels_on_plain_buckets():
    """A bucket's levels through the modelled quotient equal the plain
    version's (which divides) on tie-heavy data."""
    x = qbench.tie_operand(4 * 128, 128, 4, seed=3).reshape(4, 128)
    unit, bmin = codec.compute_meta(torch.from_numpy(x), 4)
    want = codec.encode_levels(torch.from_numpy(x), unit, bmin, 4).numpy()
    unit, bmin = unit.numpy(), bmin.numpy()
    for b in range(4):
        safe = unit[b] if unit[b] > 0 else np.float32(1)
        a = (x[b] - bmin[b]).astype(np.float32)
        q = np.array([model_quotient(v, safe) for v in a], dtype=np.float32)
        lvl = np.clip(np.floor(q + np.float32(0.5)), 0, 15).astype(np.int32)
        assert np.array_equal(lvl, want[b]), b


# ---------------------------------------------------------------------------
# The benchmark's shapes and operands.
# ---------------------------------------------------------------------------


def test_shapebench_shapes_are_the_steps_launch_shapes(monkeypatch):
    """B1 at 108, 144, 480 and 1,024 chunks and B5 at 307 are exactly the
    chunk counts of the GPT-2 124M step's compressed slices (bucket 512),
    from the port's grouping of the model's gradients."""
    monkeypatch.setenv("CGX_COMPRESSION_BUCKET_SIZE", "512")
    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "4")
    for k in ("CGX_STANDALONE_LAYER_ELEMS", "CGX_FUSION_BUFFER_SIZE_MB"):
        monkeypatch.delenv(k, raising=False)
    model = GPT2(GPT2Config.small(), device="meta")
    pl = allreduce.sorted_items(dict(model.named_parameters()))
    whole, tails = set(), set()
    for g in allreduce._group_leaves(pl, compress_small=False):
        if g.cc.enabled:
            n = sum(pl[i][1].numel() for i in g.indices)
            for _, ln in allreduce._fusion_slices(n, 4):
                c_r, t_r = divmod(codec.num_buckets(ln, 512), 32)
                (tails if t_r else whole).add(c_r)
    b1 = {c for kind, label, c, _, _ in shapebench.SHAPES if label.startswith("B1")}
    b5 = {c for kind, label, c, _, _ in shapebench.SHAPES if label.startswith("B5")}
    assert (b1, b5) == ({108, 144, 480, 1024}, {307})
    assert (whole, tails) == (b1, b5)


def test_shapebench_step_bounds(monkeypatch):
    """The world-size-1 step's launches by kernel (40 quantizes, 39 fused
    epilogues, 41 decodes: ``LaunchModel``'s counts in ``chip_smoke.py``)
    and the least device time each could take a step, at 3.35 TB/s."""
    monkeypatch.setenv("CGX_COMPRESSION_BUCKET_SIZE", "512")
    monkeypatch.setenv("CGX_COMPRESSION_QUANTIZATION_BITS", "4")
    for k in ("CGX_STANDALONE_LAYER_ELEMS", "CGX_FUSION_BUFFER_SIZE_MB"):
        monkeypatch.delenv(k, raising=False)
    got = shapebench.step_bounds(3.35e12)
    assert {k: v["launches"] for k, v in got.items()} == {"quantize": 40, "epilogue": 39, "dequantize": 41}
    assert got["quantize"]["bytes"] == 561_316_608 and got["epilogue"]["bytes"] == 123_002_880
    assert 0.167 < got["quantize"]["bound_ms"] < 0.168 and 0.036 < got["epilogue"]["bound_ms"] < 0.037


def test_shapebench_bytes():
    n = 144 * 32 * 512
    assert shapebench.shape_bytes("quantize", 144, 1, -1) == 4 * n + n // 2 + n // 64
    assert shapebench.shape_bytes("epilogue", 144, 1, -1) == 2 * (n // 2 + n // 64)
    # ws 4 with the raw own row: three peer payloads, the raw row, one out.
    n = 256 * 32 * 512
    assert shapebench.shape_bytes("epilogue", 256, 4, 1) == 4 * (n // 2 + n // 64) + 4 * n


def test_adversarial_operand_bucket_classes():
    """Each recipe lands where it should: unit 0, inf, subnormal, NaN, the
    reciprocal range's inside, outside and both edges."""
    x = torch.from_numpy(qbench.adversarial_operand(len(qbench.ADVERSARIAL_RECIPES) * 128, 128, 4))
    unit, bmin = codec.compute_meta(x.view(-1, 128), 4)
    by = dict(zip(qbench.ADVERSARIAL_RECIPES, zip(unit.tolist(), bmin.tolist())))
    assert by["constant"][0] == 0 and by["range_overflows"][0] == float("inf")
    assert 0 < by["subnormal_unit"][0] < np.finfo(np.float32).tiny
    assert np.isnan(by["nan_entry"][0]) and np.isnan(by["nan_entry"][1])  # amax/amin propagate NaN
    assert by["inf_entry"][0] == float("inf") and by["neg_inf_entry"][1] == float("-inf")
    assert by["level_midpoints"] == (1.0, 0.0)
    inside = {r: codec_cuda.rcp_in_range(by[r][0]) for r in (
        "normal", "unit_below_rcp_range", "unit_above_rcp_range", "unit_at_rcp_low_edge",
        "unit_at_rcp_high_edge", "ties")}
    assert inside == {"normal": True, "unit_below_rcp_range": False, "unit_above_rcp_range": False,
                      "unit_at_rcp_low_edge": True, "unit_at_rcp_high_edge": True, "ties": True}
    assert by["unit_at_rcp_low_edge"][0] < 2.0**-63 and by["unit_at_rcp_high_edge"][0] >= 2.0**63
