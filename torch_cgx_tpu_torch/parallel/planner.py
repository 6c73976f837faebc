"""The step planner (``CGX_PLANNER``): one plan for every fusion slice of a
step, solved against a cost model.

Counterpart of ``torch_cgx_tpu/parallel/planner.py`` on the eager plane:

* a :class:`CostModel` of codec rates, the wire rate, the overlap share and
  a fixed cost a pipelined block, from its defaults, a persisted file
  (``CGX_PLANNER_MODEL``), span files (:meth:`CostModel.from_spans`) or the
  autotune cache's measured rates (:meth:`CostModel.from_telemetry`);
* the joint solve (:func:`solve`): per slice a pipeline depth, and under
  ``CGX_PLANNER_AVG_BITS`` a bit width, minimizing the predicted step.
  Slice costs add up and the bit budget is the only coupling, so the bits
  come from ``adaptive.solve_bit_allocation`` and each depth is an
  independent argmin (held against :func:`solve_bruteforce`);
* a :class:`StepPlan` a layout, from a bounded LRU (:func:`plan_for_layout`),
  which ``allreduce.allreduce_tree`` consumes: each slice's depth goes to
  ``schedule.compiled_schedule(chunks=)``, its bits to the slice's config,
  and the plan's order is the groups' order. The producer adopts the depth
  of its slice (:func:`decide_slice`) and the DDP hook the depth of its
  bucket's rank chunks (:func:`bridge_chunks`).

Engagement: "on" plans anywhere, "off" never, and "auto" never in the port
(the JAX package engages it only on a real TPU backend); the hook honours
only "on", as the JAX bridge does. With the planner off every path runs as
it does unplanned. Without a bit budget a plan changes only depths and
order, and a pipelined slice reduces bit for bit like the monolithic one,
so the values do not change.

The plan LRU is keyed by what the solve reads: the groups' configs and
slices, the world size, the route, the reduction, the mode, the bit
budget, the registry's version, the model's fingerprint and the plan
version. The JAX key also holds the chip (its backend and device kind);
the solve reads nothing of the chip, so the port's key leaves it out. It is
cleared by ``allreduce.invalidate_layout_cache``. The JAX trace-time metrics
are the counters of :data:`COUNTS`.

Not here: the asynchronous plane's ``predict_outer``, ``solve_async_h`` and
``async_route``; the serving plane's ``predict_serve`` and
``solve_serve_plan``; the donated-buffer ``planned_allreduce``; the memory
ledger's ``memory_envelope`` and staging budget (``CGX_MEMLEDGER`` under the
planner raises ``NotImplementedError``); the elastic ``note_membership``;
and the bit controller that ``StepPlanner(avg_bits=)`` drives.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from .. import config as cfg_mod
from ..config import CompressionConfig
from ..ops import codec
from . import reducers
from . import schedule as sched_mod

# Pipeline depths the solve considers a slice (1: monolithic), clipped to
# what the slice's aligned row holds.
CHUNK_CANDIDATES = (1, 2, 4, 8, 16)

# The widths the solve may assign under an average-bits budget.
BITS_RANGE = (2, 8)

# The route a plan's decisions record: the JAX router's decision for a
# one-axis group off the TPU with its knob unset. The port has no router.
ROUTE = "unrouted"

# Plans solved, plan-cache hits, misses and invalidations, the hook's depth
# decisions, and the StepPlanner's adopted and unchanged re-plans (the JAX
# package's ``cgx.plan.*`` metrics).
COUNTS: Dict[str, int] = {}


def reset_counts() -> None:
    COUNTS.update(compiled=0, cache_hits=0, cache_misses=0, cache_invalidations=0,
                  bridge_hints=0, replans=0, replan_noops=0)


reset_counts()


# ---------------------------------------------------------------------------
# The cost model.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostModel:
    """The terms a step's time is predicted from. Rates are decimal GB/s:
    ``quantize_gbps`` a byte of float32 input, ``dequantize_gbps`` a byte of
    float32 output, ``wire_gbps`` a rank's link. ``overlap_frac``: the
    share of the collectives hidden under compute, credited when the groups
    go in reverse order. ``chunk_overhead_s``: the fixed cost of one
    pipelined block. ``compute_s``: the step's compute time (0: unknown).
    ``dcn_gbps``: the cross-slice link rate of the JAX asynchronous plane,
    kept for the file format; no decision of the port reads it."""

    quantize_gbps: float = 8.0
    dequantize_gbps: float = 16.0
    wire_gbps: float = 1.0
    overlap_frac: float = 0.0
    chunk_overhead_s: float = 100e-6
    compute_s: float = 0.0
    dcn_gbps: float = 0.25
    source: str = "default"

    @classmethod
    def default(cls) -> "CostModel":
        return cls()

    @classmethod
    def from_spans(cls, directory: str) -> "CostModel":
        """Calibrate from a directory's ``spans-rank*.jsonl`` files (one JSON
        event a line; a torn line is skipped). ``quantize`` spans set the
        codec rates from their ``elems`` float32 values (``codec.compress``
        the quantize, ``codec.decompress`` the dequantize; with no decompress
        span the dequantize rate is twice the quantize one; other names are
        skipped), ``wire`` spans the link rate from their ``bytes``, the mean
        ``wait`` span the cost a block, and the overlap of ``collective``
        spans with ``span`` (compute) spans the overlap share, measured a
        rank and averaged. Terms without spans keep their defaults;
        ``source`` names the calibrated ones."""
        q_bytes = q_s = d_bytes = d_s = w_bytes = w_s = wait_s = 0.0
        n_waits = 0
        overlaps: List[float] = []
        for path in sorted(glob.glob(os.path.join(directory, "spans-rank*.jsonl"))):
            try:
                with open(path) as f:
                    lines = f.readlines()
            except OSError:
                continue
            coll_iv: List[Tuple[float, float]] = []
            comp_iv: List[Tuple[float, float]] = []
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if ev.get("kind") != "span":
                    continue
                dur = float(ev.get("dur_s", 0.0))
                t0 = float(ev.get("t_mono", 0.0))
                cat = ev.get("cat")
                if cat == "quantize":
                    elems = float(ev.get("elems", 0.0))
                    if ev.get("name") == "codec.compress":
                        q_bytes += 4.0 * elems
                        q_s += dur
                    elif ev.get("name") == "codec.decompress":
                        d_bytes += 4.0 * elems
                        d_s += dur
                elif cat == "wire":
                    w_bytes += float(ev.get("bytes", 0.0))
                    w_s += dur
                elif cat == "wait":
                    wait_s += dur
                    n_waits += 1
                elif cat == "collective":
                    coll_iv.append((t0, t0 + dur))
                elif cat == "span":
                    comp_iv.append((t0, t0 + dur))
            coll_u = _merge_intervals(coll_iv)
            coll_total = sum(e - s for s, e in coll_u)
            if coll_total > 0:
                overlaps.append(
                    min(_overlap_len(coll_u, _merge_intervals(comp_iv)) / coll_total, 1.0)
                )
        kw: Dict[str, float] = {}
        fields = []
        if q_bytes and q_s:
            kw["quantize_gbps"] = q_bytes / q_s / 1e9
            kw["dequantize_gbps"] = (
                d_bytes / d_s / 1e9 if d_bytes and d_s else 2.0 * q_bytes / q_s / 1e9
            )
            fields.append("codec")
        if w_bytes and w_s:
            kw["wire_gbps"] = w_bytes / w_s / 1e9
            fields.append("wire")
        if n_waits and wait_s:
            kw["chunk_overhead_s"] = wait_s / n_waits
            fields.append("overhead")
        if overlaps:
            kw["overlap_frac"] = sum(overlaps) / len(overlaps)
            fields.append("overlap")
        return cls(source=f"spans:{'+'.join(fields) or 'none'}", **kw)

    @classmethod
    def from_telemetry(cls, spans_dir: Optional[str] = None) -> "CostModel":
        """What :meth:`StepPlanner.update` calibrates from: the span files
        of ``spans_dir`` (else ``CGX_METRICS_DIR``; neither: the defaults),
        then, where the spans left the quantize rate at its default, the
        best rate the autotune cache measured (``ops/autotune.py``) as the
        quantize rate and twice it as the dequantize one. The JAX version
        also reads the step-time histogram (``compute_s``) and the
        asynchronous plane's link gauge (``dcn_gbps``); their writers are
        the observability and asynchronous planes, which the port does not
        have, so those two terms keep their defaults."""
        directory = spans_dir or cfg_mod.metrics_dir()
        base = cls.from_spans(directory) if directory else cls.default()
        tuned = _best_autotune_gbps()
        if not (tuned and base.quantize_gbps == cls.quantize_gbps):
            return base
        return dataclasses.replace(
            base, source=f"{base.source}+autotune", quantize_gbps=tuned, dequantize_gbps=2.0 * tuned
        )

    def wire_bytes(self, n: int, bits: int, bucket: int) -> float:
        """Stage-1 wire bytes of ``n`` values at ``bits``
        (``codec.wire_bytes`` with float32 meta); float32 values where
        ``bits`` is not a compressed width."""
        if not 1 <= bits <= cfg_mod.MAX_BITS:
            return 4.0 * n
        return float(codec.wire_bytes(n, bits, max(1, bucket), 4))

    def _stages(self, n: int, ws: int, bits: int, bucket: int) -> Tuple[float, float]:
        """The codec's and the wire's seconds of one slice's SRA: quantize
        ``n(1+1/ws)`` values and dequantize ``n(2-1/ws)``, and move
        ``2(ws-1)/ws`` of the stage-1 wire bytes."""
        t_codec = 0.0
        if 1 <= bits <= cfg_mod.MAX_BITS:
            t_codec = (
                4.0 * n * (1 + 1 / ws) / (self.quantize_gbps * 1e9)
                + 4.0 * n * (2 - 1 / ws) / (self.dequantize_gbps * 1e9)
            )
        factor = 2.0 * (ws - 1) / ws
        return t_codec, factor * self.wire_bytes(n, bits, bucket) / (self.wire_gbps * 1e9)

    def predict_slice(
        self, n: int, ws: int, bits: int, bucket: int, chunks: int = 1, route: str = ROUTE
    ) -> float:
        """Predicted seconds of one fusion slice's allreduce at (``bits``,
        ``chunks``): the bottleneck stage in full, the other stage's time
        over the depth (only the pipeline's fill stays exposed), and the
        fixed cost of each block. 0 where nothing travels."""
        del route  # both planes share the stage structure
        n = int(n)
        ws = max(1, int(ws))
        if n <= 0 or ws == 1:
            return 0.0
        t_codec, t_wire = self._stages(n, ws, bits, bucket)
        c = max(1, int(chunks))
        bottleneck = max(t_codec, t_wire)
        exposed = (t_codec + t_wire - bottleneck) / c
        return bottleneck + exposed + c * self.chunk_overhead_s

    def predict_slice_components(
        self, n: int, ws: int, bits: int, bucket: int, chunks: int = 1, route: str = ROUTE
    ) -> Dict[str, float]:
        """:meth:`predict_slice` as ``{"quantize", "wire", "overhead"}``
        seconds: the bottleneck stage in full, the other over the depth."""
        del route
        n = int(n)
        ws = max(1, int(ws))
        if n <= 0 or ws == 1:
            return {"quantize": 0.0, "wire": 0.0, "overhead": 0.0}
        t_codec, t_wire = self._stages(n, ws, bits, bucket)
        c = max(1, int(chunks))
        if t_codec >= t_wire:
            q, w = t_codec, t_wire / c
        else:
            q, w = t_codec / c, t_wire
        return {"quantize": q, "wire": w, "overhead": c * self.chunk_overhead_s}

    def predict_step(
        self, slice_times: Sequence[float], *, compute_s: Optional[float] = None,
        reverse_order: bool = True,
    ) -> float:
        """Predicted step seconds: compute plus the collectives, less the
        overlap share of the smaller of the two where the groups go in
        reverse order."""
        coll = float(sum(slice_times))
        comp = self.compute_s if compute_s is None else float(compute_s)
        ov = self.overlap_frac if reverse_order else 0.0
        return comp + coll - ov * min(comp, coll)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "CostModel":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def save(self, path: str) -> None:
        """Write the model for ``CGX_PLANNER_MODEL``, so that every rank of
        a group plans from the same bytes."""
        with open(path, "w") as f:
            json.dump(self.as_dict(), f)


def _merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap_len(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted disjoint interval lists."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _best_autotune_gbps() -> float:
    """The best measured rate among the autotune cache's entries in memory
    (``ops.autotune``'s memo; no disk read), 0.0 when it has none."""
    from ..ops import autotune as at_mod

    with at_mod._LOCK:
        return max((t.gbps for t in at_mod._MEMO.values() if t.gbps), default=0.0)


# ---------------------------------------------------------------------------
# Engagement and the active model.
# ---------------------------------------------------------------------------


_MODEL: Optional[CostModel] = None  # None: the file, else the default
_PLAN_VERSION = 0  # bumped when StepPlanner adopts a changed model

# The CGX_PLANNER_MODEL file's model, keyed by (path, mtime_ns, size): a
# rewrite within one mtime tick changes the size or keeps the bytes' model.
_MODEL_FILE_CACHE: Dict[Tuple[str, int, int], CostModel] = {}


def _model_from_file() -> Optional[CostModel]:
    """The ``CGX_PLANNER_MODEL`` file's model; None where the knob is unset
    or the file is missing or unreadable."""
    path = cfg_mod.planner_model_path()
    if not path:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    key = (path, st.st_mtime_ns, st.st_size)
    hit = _MODEL_FILE_CACHE.get(key)
    if hit is not None:
        return hit
    try:
        with open(path) as f:
            model = CostModel.from_dict(json.load(f))
    except (OSError, ValueError, TypeError):
        return None
    _MODEL_FILE_CACHE.clear()
    _MODEL_FILE_CACHE[key] = model
    return model


def cost_model() -> CostModel:
    """The active model: one installed in the process (:func:`set_cost_model`,
    :class:`StepPlanner`), else the ``CGX_PLANNER_MODEL`` file's, else the
    default."""
    if _MODEL is not None:
        return _MODEL
    from_file = _model_from_file()
    return from_file if from_file is not None else CostModel.default()


def set_cost_model(model: Optional[CostModel]) -> None:
    """Install (None: clear) a model in the process and drop the plans."""
    global _MODEL
    _MODEL = model
    plan_cache_clear()


def engaged() -> bool:
    """Whether the planner plans a slice: ``CGX_PLANNER=on``."""
    return cfg_mod.planner_mode() == "on"


def engaged_bridge() -> bool:
    """Whether the DDP hook takes the planner's depth: ``CGX_PLANNER=on``
    (the JAX bridge honours only "on" too)."""
    return cfg_mod.planner_mode() == "on"


def _model_fingerprint(model: CostModel) -> Tuple:
    return dataclasses.astuple(model)


def cache_key_component() -> Tuple:
    """What a cache built from plans must key (the plan LRU does): the
    mode, the plan version, the bit budget and the active model's
    fingerprint (a model installed or a file rewritten changes the
    decisions without a version bump)."""
    return (
        cfg_mod.planner_mode(), _PLAN_VERSION, cfg_mod.planner_avg_bits(),
        _model_fingerprint(cost_model()),
    )


# ---------------------------------------------------------------------------
# Decisions and the joint solve.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SliceDecision:
    """One fusion slice's plan: its length, the world size, its bits, its
    pipeline depth, the route and the predicted seconds."""

    n: int
    ws: int
    bits: int
    chunks: int
    route: str
    predicted_s: float


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One step's plan: the decisions a group (in layout order) and slice,
    the groups' order, the predicted step (the collectives' part), the plan
    version, and the prediction's parts (``compute``, ``overhead``,
    ``quantize``, ``wire``)."""

    decisions: Tuple[Tuple[SliceDecision, ...], ...]
    order: Tuple[int, ...]
    predicted_s: float
    version: int
    pred_components: Tuple[Tuple[str, float], ...] = ()

    def components(self) -> Dict[str, float]:
        return dict(self.pred_components)


def chunk_candidates(n: int, ws: int, bucket: int) -> Tuple[int, ...]:
    """The depths a slice of ``n`` values over ``ws`` ranks can take: the
    candidates up to the aligned units of its row
    (``schedule.chunk_table``'s limit)."""
    if ws <= 1 or n <= 0:
        return (1,)
    width = reducers.chunk_layout(n, ws)[0]
    units = width // sched_mod.chunk_alignment(bucket)
    return tuple(c for c in CHUNK_CANDIDATES if c <= max(1, units))


def _slice_candidates(n: int, ws: int, cc: CompressionConfig) -> Tuple[int, ...]:
    """An uncompressed slice never pipelines."""
    if not cc.enabled:
        return (1,)
    return chunk_candidates(n, ws, cc.bucket_size)


def _best_chunks(
    model: CostModel, n: int, ws: int, bits: int, cc: CompressionConfig, route: str
) -> Tuple[int, float]:
    """The argmin depth and its prediction; a tie keeps the shallower."""
    best_c, best_t = 1, float("inf")
    for c in _slice_candidates(n, ws, cc):
        t = model.predict_slice(n, ws, bits, cc.bucket_size, chunks=c, route=route)
        if t < best_t - 1e-15:
            best_c, best_t = c, t
    return best_c, best_t


def solve(
    slices: Sequence[Tuple[int, CompressionConfig]],
    ws: int,
    *,
    model: Optional[CostModel] = None,
    route: str = ROUTE,
    avg_bits: float = 0.0,
) -> List[SliceDecision]:
    """The joint solve over a step's ``(length, config)`` slices: with
    ``avg_bits`` the compressed slices' bits from the payload-weighted
    allocation (``adaptive.solve_bit_allocation`` over unit ranges, in
    ``BITS_RANGE``), else each slice's own; then each slice's argmin depth.
    An uncompressed slice is priced and reported at 32 bits."""
    model = model or cost_model()
    bits_by_idx: Dict[int, int] = {}
    if avg_bits:
        from .adaptive import LayerStat, solve_bit_allocation

        stats = {
            str(i): LayerStat(numel=int(n), mean_sq_range=1.0)
            for i, (n, cc) in enumerate(slices)
            if cc.enabled and n > 0
        }
        if stats:
            alloc = solve_bit_allocation(stats, avg_bits, bits_range=BITS_RANGE)
            bits_by_idx = {int(k): int(v) for k, v in alloc.items()}
    out: List[SliceDecision] = []
    for i, (n, cc) in enumerate(slices):
        bits = bits_by_idx.get(i, cc.bits) if cc.enabled else 32
        chunks, t = _best_chunks(model, n, ws, bits, cc, route)
        out.append(SliceDecision(n=int(n), ws=int(ws), bits=int(bits), chunks=int(chunks),
                                 route=route, predicted_s=t))
    return out


def solve_bruteforce(
    slices: Sequence[Tuple[int, CompressionConfig]],
    ws: int,
    *,
    model: Optional[CostModel] = None,
    route: str = ROUTE,
) -> List[SliceDecision]:
    """The exhaustive reference (no bit budget): every assignment of depths
    across the slices, the least summed prediction (a tie keeps the first
    in the product's order). Exponential: for tests only."""
    model = model or cost_model()

    def bits_of(cc: CompressionConfig) -> int:
        return cc.bits if cc.enabled else 32

    def t_of(n, cc, c) -> float:
        return model.predict_slice(n, ws, bits_of(cc), cc.bucket_size, chunks=c, route=route)

    cands = [_slice_candidates(n, ws, cc) for (n, cc) in slices]
    best: Optional[Tuple[float, Tuple[int, ...]]] = None
    for combo in itertools.product(*cands) if cands else [()]:
        total = 0.0
        for (n, cc), c in zip(slices, combo):
            total += t_of(n, cc, c)
        if best is None or total < best[0] - 1e-15:
            best = (total, combo)
    assert best is not None
    return [
        SliceDecision(n=int(n), ws=int(ws), bits=int(bits_of(cc)), chunks=int(c), route=route,
                      predicted_s=t_of(n, cc, c))
        for (n, cc), c in zip(slices, best[1])
    ]


# ---------------------------------------------------------------------------
# The plan LRU.
# ---------------------------------------------------------------------------


_PLAN_CACHE: "OrderedDict" = OrderedDict()
_PLAN_CACHE_MAX = 32
_PLAN_STATS = {"hits": 0, "misses": 0}


def plan_cache_stats() -> Dict[str, int]:
    """The plan cache's hits and misses since it was last cleared."""
    return dict(_PLAN_STATS)


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    _PLAN_STATS.update(hits=0, misses=0)


def invalidate_plan_cache() -> None:
    """Drop every plan (``allreduce.invalidate_layout_cache`` calls it): a
    plan solved for another world's layouts is never valid. Counted."""
    plan_cache_clear()
    COUNTS["cache_invalidations"] += 1


def _plan_key(group_sig, ws, route, reduction) -> Tuple:
    """Everything the solve reads (see the module docstring): the layout's
    part, the registry's version, and :func:`cache_key_component`."""
    return (group_sig, int(ws), route, reduction, cfg_mod.registry_version()) + cache_key_component()


def plan_for_layout(groups: Sequence, ws: int, *, route: str = ROUTE,
                    reduction: str) -> Optional[StepPlan]:
    """The plan of one ``allreduce_tree`` layout (rows with ``cc`` and
    ``slices``, as ``allreduce._GroupLayout``), from the LRU or solved on a
    miss. None where nothing plans: ``ws`` 1, a reduction other than the
    SRA, the dummy codec, the fake ratio, or no compressed group; the caller
    then runs unplanned. The groups go last first (the backward produces the
    last layers' gradients first), which the overlap credit assumes.
    ``CGX_MEMLEDGER`` raises ``NotImplementedError`` (``config.refuse_memledger``)."""
    if ws <= 1 or reduction != cfg_mod.REDUCTION_SRA:
        return None
    if cfg_mod.dummy_compression() or cfg_mod.fake_ratio() is not None:
        return None
    if not any(g.cc.enabled for g in groups):
        return None
    cfg_mod.refuse_memledger()
    group_sig = tuple((g.cc, tuple(g.slices)) for g in groups)
    key = _plan_key(group_sig, ws, route, reduction)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        _PLAN_CACHE.move_to_end(key)
        _PLAN_STATS["hits"] += 1
        COUNTS["cache_hits"] += 1
        return hit
    _PLAN_STATS["misses"] += 1
    COUNTS["cache_misses"] += 1
    model = cost_model()
    flat: List[Tuple[int, CompressionConfig]] = []
    counts: List[int] = []
    for g in groups:
        counts.append(len(g.slices))
        flat.extend((ln, g.cc) for (_off, ln) in g.slices)
    decs = solve(flat, ws, model=model, route=route, avg_bits=cfg_mod.planner_avg_bits())
    per_group: List[Tuple[SliceDecision, ...]] = []
    pos = 0
    for n_s in counts:
        per_group.append(tuple(decs[pos : pos + n_s]))
        pos += n_s
    predicted = model.predict_step([d.predicted_s for d in decs], reverse_order=True)
    comp_tot = {"quantize": 0.0, "wire": 0.0, "overhead": 0.0}
    for (_n, cc), d in zip(flat, decs):
        parts = model.predict_slice_components(d.n, ws, d.bits, cc.bucket_size, chunks=d.chunks,
                                               route=route)
        for k, v in parts.items():
            comp_tot[k] += v
    comp_tot["compute"] = float(model.compute_s)
    plan = StepPlan(
        decisions=tuple(per_group),
        order=tuple(reversed(range(len(groups)))),
        predicted_s=predicted,
        version=_PLAN_VERSION,
        pred_components=tuple(sorted(comp_tot.items())),
    )
    _PLAN_CACHE[key] = plan
    if len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    COUNTS["compiled"] += 1
    return plan


@dataclasses.dataclass(frozen=True)
class _OneGroup:
    cc: CompressionConfig
    slices: Tuple[Tuple[int, int], ...]


def decide_slice(n: int, ws: int, cc: CompressionConfig, reduction: str, *,
                 route: str = ROUTE) -> Optional[SliceDecision]:
    """The plan of a layout of one slice of ``n`` values (the producer's
    view of its layer), or None where the planner is not engaged or nothing
    plans. Only its depth is adopted: under a bit budget a one-slice solve
    allocates bits differently from the whole layout's."""
    if not engaged():
        return None
    plan = plan_for_layout([_OneGroup(cc=cc, slices=((0, int(n)),))], ws, route=route,
                           reduction=reduction)
    return None if plan is None else plan.decisions[0][0]


def bridge_chunks(width: int, bucket: int, ws: int, bits: int, default: int) -> int:
    """The DDP hook's depth for a bucket whose largest rank chunk holds
    ``width`` values (``bucket``: the lcm of its layers' bucket sizes,
    ``bits``: its first compressed layer's): the argmin over the candidates
    up to ``width // bucket`` of the slice of ``width * ws`` values, under
    the active model. ``default`` where the hook does not take the
    planner's depth (:func:`engaged_bridge`) or nothing travels. Every rank
    must plan from the same model: a calibrated one goes through
    ``CGX_PLANNER_MODEL``. The JAX package keeps a copy of this function
    under its default model in its bridge, ``backend._plan_bridge_chunks``,
    which the port does not need."""
    if not engaged_bridge() or width <= 0 or ws <= 1:
        return default
    model = cost_model()
    best_c, best_t = 1, float("inf")
    units = width // max(1, bucket)
    for c in CHUNK_CANDIDATES:
        if c > max(1, units):
            continue
        t = model.predict_slice(width * ws, ws, bits, bucket, chunks=c, route="bridge")
        if t < best_t - 1e-15:
            best_c, best_t = c, t
    COUNTS["bridge_hints"] += 1
    return best_c


# ---------------------------------------------------------------------------
# The re-planning loop.
# ---------------------------------------------------------------------------


class StepPlanner:
    """Recalibrate and re-plan from the training loop::

        plr = StepPlanner(every=500)
        for step in range(n_steps):
            loss = train_step(tokens)
            plr.step()  # every 500 steps: recalibrate, re-plan on change

    :meth:`update` adopts a model (drops the plans and bumps the plan
    version) only when it changed; an unchanged one is a counted no-op.
    With ``CGX_PLANNER_MODEL`` set, every rank adopts that file's model, so
    the ranks re-plan together; write a new one with :meth:`calibrate_to`
    from one rank. Without it each process calibrates from its own
    telemetry, which only a single process may do: ranks that adopt
    different models frame their blocks differently and hang.

    ``avg_bits`` drives the JAX package's closed-loop bit controller
    (``wire/controller.py``), which is not ported: it raises
    ``NotImplementedError``."""

    def __init__(self, *, every: int = 500, avg_bits: Optional[float] = None,
                 spans_dir: Optional[str] = None):
        if avg_bits:
            raise NotImplementedError(
                "StepPlanner(avg_bits=...) drives the wire plane's bit controller "
                "(wire/controller.py), which is not ported (ROADMAP A11); set "
                f"{cfg_mod.PLANNER_AVG_BITS} for the planner's own bit budget"
            )
        if every < 0:
            raise ValueError(f"every must be >= 0, got {every}")
        self.every = every
        self.spans_dir = spans_dir
        self.updates = 0
        self._count = 0

    def step(self) -> bool:
        """Note one step; every ``every``-th runs :meth:`update`. True when
        an update ran (adopted or not)."""
        self._count += 1
        if self.every and self._count % self.every == 0:
            self.update()
            return True
        return False

    def calibrate_to(self, path: str) -> CostModel:
        """Calibrate from telemetry and write the model to ``path``."""
        model = CostModel.from_telemetry(self.spans_dir)
        model.save(path)
        return model

    def update(self) -> bool:
        """Resolve the model now (the ``CGX_PLANNER_MODEL`` file where set,
        else telemetry) and adopt it only if it changed, ``source`` aside.
        True when it was adopted."""
        global _MODEL, _PLAN_VERSION
        if cfg_mod.planner_model_path():
            model = _model_from_file() or CostModel.default()
        else:
            model = CostModel.from_telemetry(self.spans_dir)
        changed = dataclasses.replace(model, source="") != dataclasses.replace(
            cost_model(), source=""
        )
        if changed:
            _MODEL = model
            _PLAN_VERSION += 1
            plan_cache_clear()
            COUNTS["replans"] += 1
        else:
            COUNTS["replan_noops"] += 1
        self.updates += 1
        return changed
