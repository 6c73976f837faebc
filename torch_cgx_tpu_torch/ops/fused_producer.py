"""Producer-fused gradient quantization: the backward of a dense layer emits
the layer's SRA stage-1 wire payload.

Counterpart of ``torch_cgx_tpu/ops/fused_producer.py``, in PyTorch's idiom:

* :func:`matmul` is ``x @ w`` as a ``torch.autograd.Function``. Its backward
  returns the exact ``dx`` and stages the layer's wire payload: the
  quantized ``(ws, chunk)`` SRA stage-1 rows of ``dw / divisor`` and the
  raw own-chunk row, in a stash keyed by the parameter's dotted path. It
  returns the exact ``dw`` too (the same PyTorch call autograd makes for
  ``torch.matmul``), except where the sync of the same step will consume
  the payload (below).
* ``allreduce_tree`` (``parallel/allreduce.py``) looks each standalone
  compressed group's gradient up in the stash. Where
  :func:`consume_reason` allows, the SRA consumes the payload
  (``reducers._sra_exchange(pre=...)``) instead of quantizing the f32
  gradient itself; on any mismatch the plain path runs and the fallback is
  counted in :data:`COUNTS`, never silent.

The payload and the raw own row come from one launch of the
matmul-quantize kernel (``codec_cuda.matmul_quantize_chunks``, B8: a
register-tiled f32 GEMM whose tiles complete the quantize chunks through
the L2; only the words, the meta and the own row are returned), which
reads the operands in the layer's compute dtype (float32, bfloat16 or
float16), as the JAX kernel does, and takes its plain version for CPU
operands.

Where this differs from the JAX package:

* No ``CGX_PRODUCER_KERNEL`` and no compose path. A layer whose geometry
  does not align (:func:`_kernel_geometry`) stages nothing and falls back
  (``layout``); the allreduce then quantizes its gradient as it would
  unfused. The JAX package composes a payload there, which in eager
  PyTorch is that same quantize of the same ``dw / divisor``.
* Eager PyTorch has no dead-code elimination, and XLA's is what lets the
  JAX package drop the plain ``dw`` of an engaged layer. The port decides
  it in the backward instead (C4): inside ``make_train_step``, which owns
  the backward and the sync (``configure(skip_dw=True)``), a layer
  applied once in the step's forward whose payload the sync will consume
  (:func:`consume_reason`, the predicate the allreduce applies too)
  returns no ``dw``, counted as ``producer_dw_skipped``; the allreduce
  takes it from the stash by name and ``make_train_step`` writes its
  decoded average into ``p.grad``. A skipped layer the allreduce cannot
  consume raises ``RuntimeError``. A ``gradient_sync`` called directly
  keeps ``dw``. ``CGX_PRODUCER_FUSE=auto`` resolves to off (see
  ``config.producer_fuse``); "on" engages on any device.
* The raw own row is row ``own`` of the kernel's own product, from the
  same sums as the quantized rows, rounded to the compute dtype (the JAX
  package's ``dw_own.astype(w.dtype)``) and divided; the JAX package
  computes it with a separate 1/ws-sized dot in the compute dtype. The
  quantized rows are the float32 sums divided, which the JAX kernel
  quantizes too (its ``preferred_element_type=float32`` accumulator).
* The stash cannot match on the identity of the gradient object:
  ``AccumulateGrad`` may steal the returned tensor or copy it. An entry
  holds no strong reference to ``dw``; it matches a gradient by the storage
  (a weak reference), ``data_ptr()``, ``_version``, shape and the step's
  epoch, so an in-place rewrite (``p.grad.mul_``), an out-of-place one
  (``p.grad = p.grad * 1``) or a second backward in one step (gradient
  accumulation, or a layer applied twice) leaves it unclaimable, and the
  miss is counted (``producer_fallback_identity``; the JAX lookup misses
  silently).
* The kernel quantizes each chunk from a (32, B) f32 tile in shared
  memory, so buckets whose tile exceeds
  ``codec_cuda.MAX_EPILOGUE_TILE_BYTES`` fall back with the port-only
  reason ``tile`` where the JAX package would launch its kernel.
* Under ``CGX_SCHEDULE=on``, where the sync will pipeline the layer's
  slice (``parallel/schedule.py``), the backward stages one payload per
  column block of the schedule's table (``Produced.q_blocks``,
  ``Produced.table``), each quantized from the float32 ``dw / divisor``
  by the quantize kernel (B1), not by the matmul-quantize, as the JAX
  package does; the layer keeps its ``dw`` then, which the blocks are made
  from. Under ``CGX_PLANNER=on`` the table is the one at the step planner's
  depth for the layer's slice (``planner.decide_slice``, only the depth
  adopted, as in the JAX package); under ``CGX_PLANNER_AVG_BITS`` a payload
  whose width the plan moved falls back (``plan``), and the backward never
  skips ``dw``, since it cannot see the whole layout's bit allocation. The
  topology-router lookup is inert off the TPU with its knob unset.

Deterministic rounding only: stochastic configs fall back (``config``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from .. import config as cfg_mod
from ..config import CompressionConfig
from . import codec, codec_cuda
from .codec import QTensor

CHUNK_BUCKETS = codec.CHUNK_BUCKETS

FALLBACK_REASONS = (
    # the backward's gates (_maybe_stash / decide)
    "unconfigured", "ws1", "config", "debug_mode", "fused_group",
    "multi_slice", "layout", "reduction", "tile",
    # the allreduce's checks (lookup, allreduce_tree, allreduce_flat)
    "identity", "group", "routing", "plan",
)

# Counters under the JAX package's metric names (``cgx.codec.<name>``).
COUNTS: Dict[str, int] = {}


def reset_counts() -> None:
    COUNTS.clear()
    for k in ("producer_staged", "producer_fallbacks", "producer_kernel_slices",
              "producer_consumed_slices", "producer_invalidations", "producer_dw_skipped"):
        COUNTS[k] = 0
    for r in FALLBACK_REASONS:
        COUNTS[f"producer_fallback_{r}"] = 0


reset_counts()


def count(name: str) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + 1


def fallback(reason: str) -> None:
    count("producer_fallbacks")
    count(f"producer_fallback_{reason}")


def engaged() -> bool:
    """Whether the plane may engage: ``CGX_PRODUCER_FUSE=on`` (``auto``
    resolves to off, see ``config.producer_fuse``)."""
    return cfg_mod.producer_fuse() == "on"


# ---------------------------------------------------------------------------
# Configuration and stash.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Produced:
    """One layer's staged wire payload, waiting for the allreduce to claim
    it. It holds no reference to the gradient it was made from: it matches
    a gradient by storage, address, version counter, shape and epoch. A
    ``skipped`` entry stands for a gradient the backward never made (no
    ``p.grad``): the allreduce takes it by name and must consume it."""

    q: Optional[QTensor]  # the (ws, chunk) stage-1 rows of dw / divisor (None: per block)
    raw_row: torch.Tensor  # this rank's raw own chunk, divided
    cc: CompressionConfig
    ws: int
    n: int
    divisor: int
    epoch: int
    name: str
    storage: Optional[StorageWeakRef]  # None for a skipped gradient
    data_ptr: int
    version: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    skipped: bool = False
    consumed: bool = False
    # Under the schedule: the stage-1 payload of each column block of
    # ``table`` (q is None then); else both None.
    q_blocks: Optional[Tuple[QTensor, ...]] = None
    table: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def key(self) -> Tuple[CompressionConfig, int, int, int]:
        """What the allreduce must match: config, ranks, divisor, length."""
        return self.cc, self.ws, self.divisor, self.n

    def matches(self, leaf: torch.Tensor) -> bool:
        return (
            self.storage is not None
            and not self.storage.expired()
            and StorageWeakRef(leaf.untyped_storage()) == self.storage
            and leaf.data_ptr() == self.data_ptr
            and leaf._version == self.version
            and tuple(leaf.shape) == self.shape
        )


# The group's size and this rank's position in it, resolved by configure().
_CFG: Dict[str, object] = {
    "ws": 1, "rank": 0, "divisor": 1, "active": False, "configured": False, "epoch": 0,
    "skip_dw": False, "group": None,
}
# parameter path -> its entry of this epoch; None marks a layer whose
# backward ran twice in the epoch (unclaimable).
_STASH: Dict[str, Optional[Produced]] = {}
# parameter path -> forward applications of its layer this epoch.
_FORWARDS: Dict[str, int] = {}


def configure(group=None, *, divisor: int = 1, active: bool = True, skip_dw: bool = False) -> None:
    """Install the sync context the backward needs (``make_train_step``
    calls this; ``gradient_sync`` users may too): the data-parallel group
    (``None``: the default group), the averaging divisor and whether the
    plane is active. A ``TwoLevelGroup`` never activates it: the two-level
    scheme keeps the unfused path, as the JAX two-axis sync does. The
    ``CGX_PRODUCER_FUSE`` knob is read here, once a step, so that the
    forward of a wrapped layer reads one flag. ``skip_dw``: the caller owns
    the backward and the sync that follows it (``make_train_step``), so a
    layer whose payload that sync will consume returns no ``dw`` (C4)."""
    from ..parallel import group as group_mod
    from ..parallel.mesh import TwoLevelGroup

    if isinstance(group, TwoLevelGroup):
        ws, rank, active = group.size, 0, False
    else:
        ws, rank = group_mod.world_size(group), group_mod.rank(group)
    _CFG.update(
        ws=int(ws), rank=int(rank), divisor=int(divisor),
        active=bool(active) and engaged(), configured=True,
        skip_dw=bool(skip_dw), group=group,
    )


def deconfigure() -> None:
    _CFG.update(ws=1, rank=0, divisor=1, active=False, configured=False, skip_dw=False, group=None)
    _STASH.clear()
    _FORWARDS.clear()


def active() -> bool:
    """Whether a wrapped layer routes its product through :func:`matmul`
    (configured active with the knob on)."""
    return bool(_CFG["active"])


def begin_step() -> None:
    """Open a fresh stash epoch (the top of each train step): entries of an
    earlier step can never be claimed."""
    _CFG["epoch"] += 1
    _STASH.clear()
    _FORWARDS.clear()


def invalidate() -> None:
    """Drop the configuration and the stash and open a fresh epoch (the
    group belongs to a retired membership)."""
    deconfigure()
    begin_step()
    count("producer_invalidations")


def stash_size() -> int:
    return len(_STASH)


def lookup(name: str, leaf: torch.Tensor) -> Optional[Produced]:
    """The current epoch's entry for the parameter at ``name`` when it was
    made from exactly ``leaf`` (same storage, address, version and shape);
    else None. An entry that no longer matches is dropped and the miss
    counted (``identity``)."""
    if name not in _STASH:
        return None
    ent = _STASH[name]
    if ent is not None and ent.epoch != _CFG["epoch"]:
        del _STASH[name]
        return None
    if ent is None or not ent.matches(leaf):
        del _STASH[name]
        fallback("identity")
        return None
    return ent


def claim(name: str) -> None:
    """Remove a consumed entry so a second allreduce cannot spend it again."""
    _STASH.pop(name, None)


def drain() -> None:
    """Drop every remaining entry (``allreduce_tree`` after its sweep)."""
    _STASH.clear()


def skipped_entries() -> Dict[str, Produced]:
    """This epoch's entries whose backward returned no ``dw``, by name."""
    return {
        n: e for n, e in _STASH.items()
        if e is not None and e.skipped and e.epoch == _CFG["epoch"]
    }


def placeholder(ent: Produced) -> torch.Tensor:
    """A stand-in leaf for a skipped gradient: its shape and dtype, one
    value broadcast (no memory), read by the allreduce only for its length
    and dtype."""
    return torch.zeros((), dtype=ent.dtype, device=ent.raw_row.device).expand(ent.shape)


def _schedule_table(cc: CompressionConfig, ws: int, n: int, plan=None):
    """The column-block table the sync's SRA of a standalone slice of ``n``
    values will pipeline with (``schedule.compiled_schedule``, at the step
    planner's depth for it: ``plan``, the layout's decision for the slice,
    else ``planner.decide_slice``'s), or None where it stays monolithic."""
    from ..parallel import planner as planner_mod
    from ..parallel import schedule as sched_mod

    red = cfg_mod.intra_reduction()
    dec = plan if plan is not None else planner_mod.decide_slice(n, ws, cc, red)
    sched = sched_mod.compiled_schedule(
        n, ws, cc, reduction=red, chunks=dec.chunks if dec is not None else None
    )
    return None if sched is None else sched.table


def consume_reason(
    key: Tuple[CompressionConfig, int, int, int],
    *,
    cc: CompressionConfig,
    ws: int,
    divisor: int,
    n: int,
    elem_size: int,
    group,
    table=None,
    plan=None,
) -> str:
    """The consumption predicate, one for both sides: "" when
    ``allreduce_tree`` hands a payload staged at ``key`` (config, ranks,
    divisor, length) and block ``table`` (None: monolithic) to the
    multi-rank SRA of a standalone group of ``n`` values at ``cc`` over
    ``group`` (``ws`` ranks, averaging ``divisor``), else the fallback
    reason. The allreduce consumes only where it holds; the backward skips
    ``dw`` only where it holds for the arguments the sync will pass.
    ``plan``: the step planner's decision for the slice, whose depth sets
    the table and whose bits, where they differ from ``cc``'s, refuse the
    payload (``plan``)."""
    from ..parallel.mesh import TwoLevelGroup

    if isinstance(group, TwoLevelGroup) or not engaged() or cfg_mod.fake_ratio() is not None:
        return "routing"  # the two-level scheme and a shaped buffer never consume a payload
    if key != (cc, ws, divisor, n) or n > cfg_mod.fusion_threshold_elems(elem_size):
        return "group"  # another config, world, divisor or length; or several fusion slices
    if (
        ws <= 1
        or not cc.enabled
        or cfg_mod.intra_reduction() != cfg_mod.REDUCTION_SRA
        or cfg_mod.dummy_compression()
        or (plan is not None and plan.bits != cc.bits)
        or table != _schedule_table(cc, ws, n, plan)
    ):
        return "plan"  # only the multi-rank SRA consumes a payload, with its block plan
    return ""


# ---------------------------------------------------------------------------
# The wrapped contraction.
# ---------------------------------------------------------------------------


def _plain_dw(name: str, x2: torch.Tensor, g2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Autograd's own product for matmul's weight (of the layer at
    ``name``): the folded input transposed times the folded cotangent, then
    the cast."""
    return x2.t().mm(g2).to(dtype)


class _ProducedMatmul(torch.autograd.Function):
    """``x @ w.to(dtype)``; the backward returns the exact ``dx`` and, unless
    the sync will consume the payload in its place, the exact ``dw``, and
    stages ``dw``'s payload."""

    @staticmethod
    def forward(ctx, x, w, name, dtype):
        w_c = w.to(dtype)
        ctx.save_for_backward(x, w_c)
        ctx.name = name
        ctx.w_dtype = w.dtype
        return torch.matmul(x, w_c)

    @staticmethod
    def backward(ctx, g):
        x, w_c = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w_c.t())
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1])
            g2 = g.reshape(-1, g.shape[-1])
            w_shape = (x2.shape[1], g2.shape[1])
            plan = _plan(ctx.name, w_shape, ctx.w_dtype, x2.shape[0], x2.dtype)
            if plan is None or not plan[1]:
                dw = _plain_dw(ctx.name, x2, g2, ctx.w_dtype)
            if plan is not None:
                _stash(ctx.name, plan[0], w_shape, ctx.w_dtype, x2, g2, dw, plan[2])
        return dx, dw, None, None


def matmul(x: torch.Tensor, w: torch.Tensor, *, name: str, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w.to(dtype)`` whose backward stages the wire payload of ``dw``
    for the parameter at ``name`` when the plane is active (else the plain
    product). Each application is counted: a layer applied more than once
    in a step never skips its ``dw``."""
    if not active():
        return torch.matmul(x, w.to(dtype))
    _FORWARDS[name] = _FORWARDS.get(name, 0) + 1
    return _ProducedMatmul.apply(x, w, name, dtype)


# ---------------------------------------------------------------------------
# Payload staging (backward time).
# ---------------------------------------------------------------------------


def _eligible_cc(name: str, shape, dtype) -> Optional[CompressionConfig]:
    """The layer's resolved config, or None when its gradient would not be
    compressed or rounds stochastically."""
    from ..parallel import allreduce as ar_mod

    cc = ar_mod.resolve_leaf_config(name, torch.empty(shape, dtype=dtype, device="meta"))
    if not cc.enabled or cc.stochastic:
        return None
    return cc


def decide(
    name: str,
    w_shape: Tuple[int, int],
    k_total: int,
    ws: int,
    *,
    dtype: torch.dtype = torch.float32,
) -> Tuple[Optional[CompressionConfig], str]:
    """How the backward of the layer at ``name`` (weight ``w_shape``,
    contraction ``k_total``) stages its payload over ``ws`` ranks: ``(cc,
    "")`` when the kernel produces it (or, where the sync will pipeline the
    slice, the per-block quantizes), ``(None, reason)`` for a fallback.
    The gates of the JAX ``_maybe_stash``, in its order; a geometry the
    kernel cannot take falls back (``layout``, or ``tile`` when only the
    port's shared-memory tile is too large)."""
    if ws <= 1:
        return None, "ws1"
    cc = _eligible_cc(name, w_shape, dtype)
    if cc is None:
        return None, "config"
    if cfg_mod.dummy_compression():
        return None, "debug_mode"
    n = math.prod(w_shape)
    if n < cfg_mod.standalone_layer_elems():
        return None, "fused_group"  # only standalone groups consume
    if n > cfg_mod.fusion_threshold_elems(4):
        return None, "multi_slice"
    from ..parallel.reducers import chunk_layout

    chunk, _ = chunk_layout(n, ws)
    if chunk * ws != n or w_shape[0] % ws:
        return None, "layout"  # padding or a split row would misalign
    if cfg_mod.intra_reduction() != cfg_mod.REDUCTION_SRA:
        return None, "reduction"
    if _schedule_table(cc, ws, n) is not None:
        return cc, ""  # per-block payloads from dw: no kernel geometry to meet
    din, o = w_shape
    if _kernel_geometry(k_total, din, o, ws, chunk, cc, check_tile=False) is None:
        return None, "layout"
    if _kernel_geometry(k_total, din, o, ws, chunk, cc) is None:
        return None, "tile"
    return cc, ""


def _plan(
    name: str, w_shape, w_dtype, k_total: int, x_dtype: torch.dtype
) -> Optional[Tuple[CompressionConfig, bool, Optional[tuple]]]:
    """Whether the backward of the layer at ``name`` stages its payload:
    ``(cc, skip, table)`` when every gate passes, ``skip`` when the
    backward must not return ``dw`` (the sync of this step,
    ``make_train_step``'s, will consume the payload in its place), ``table``
    the schedule's column blocks where the sync will pipeline the slice
    (the payload is then per block, made from ``dw``, which is never
    skipped); else None, the fallback counted. A product in a dtype the
    kernel does not read (not float32, bfloat16 or float16) falls back
    (``config``)."""
    if not _CFG["active"]:
        return None
    if not _CFG["configured"]:
        fallback("unconfigured")
        return None
    if x_dtype not in codec_cuda.WIRE_DTYPES:
        fallback("config")
        return None
    ws, div = int(_CFG["ws"]), int(_CFG["divisor"])
    cc, reason = decide(name, w_shape, k_total, ws, dtype=w_dtype)
    if cc is None:
        fallback(reason)
        return None
    if name in _STASH:  # a second backward this step: p.grad is a sum now
        if _STASH[name] is not None and _STASH[name].skipped:
            raise RuntimeError(
                f"producer fusion: a second backward of {name!r} in one step after its "
                f"weight gradient was skipped; that gradient would be lost"
            )
        _STASH[name] = None
        return None
    n = math.prod(w_shape)
    table = _schedule_table(cc, ws, n)
    from ..parallel import planner as planner_mod

    skip = (
        bool(_CFG["skip_dw"])
        and table is None
        and not (planner_mod.engaged() and cfg_mod.planner_avg_bits())
        and _FORWARDS.get(name, 0) == 1
        and consume_reason(
            (cc, ws, div, n), cc=cc, ws=ws, divisor=div, n=n,
            elem_size=torch.empty((), dtype=w_dtype).element_size(), group=_CFG["group"],
        ) == ""
    )
    return cc, skip, table


def _stash(name: str, cc: CompressionConfig, w_shape, w_dtype, x2, g2, dw, table=None) -> None:
    """Stage the layer's payload, matched later to ``dw`` (None: a skipped
    gradient, taken by name): the matmul-quantize kernel's quantized rows
    and raw own row, both from one launch on the operands as the backward
    holds them; or, with a schedule ``table``, one quantize (B1) of each
    column block of the rows of ``dw / divisor`` in float32 and the own row
    of those rows."""
    ws, div, own = int(_CFG["ws"]), int(_CFG["divisor"]), int(_CFG["rank"])
    n = math.prod(w_shape)
    q = q_blocks = None
    if table is None:
        q, raw_row = _matmul_quantize_q(x2, g2, cc, ws=ws, chunk=n // ws, div=div, own=own)
        count("producer_kernel_slices")
    else:
        q_blocks, raw_row = _block_payloads(dw, cc, ws=ws, div=div, own=own, table=table)
    count("producer_staged")
    if dw is None:
        count("producer_dw_skipped")
    _STASH[name] = Produced(
        q=q, raw_row=raw_row, cc=cc, ws=ws, n=n, divisor=div,
        epoch=int(_CFG["epoch"]), name=name,
        storage=None if dw is None else StorageWeakRef(dw.untyped_storage()),
        data_ptr=0 if dw is None else dw.data_ptr(),
        version=0 if dw is None else dw._version,
        shape=tuple(w_shape), dtype=w_dtype, skipped=dw is None,
        q_blocks=q_blocks, table=table,
    )


def _block_payloads(dw, cc, *, ws, div, own, table):
    """The per-block stage-1 payloads of ``dw`` (the JAX ``_maybe_stash``
    under a schedule): the ``(ws, chunk)`` rows of ``dw / div`` in float32,
    each column block of ``table`` copied contiguous and quantized, and the
    raw own row."""
    from ..parallel import reducers
    from ..parallel import schedule as sched_mod

    flat = dw.reshape(-1).to(torch.float32)
    if div != 1:
        flat = flat / div
    xs = flat.view(ws, -1)
    blocks = tuple(
        reducers._quantize_rows(sched_mod.block_rows(xs, off, w), cc) for off, w in table
    )
    return blocks, xs[own]


# ---------------------------------------------------------------------------
# The matmul-quantize kernel's geometry and payload.
# ---------------------------------------------------------------------------

_KERNEL_MAX_ACC_ELEMS = 1 << 18  # the JAX kernel's f32 VMEM accumulator budget


def _kernel_geometry(
    k_total: int, din: int, o: int, ws: int, chunk: int,
    cc: CompressionConfig, *, check_tile: bool = True,
) -> Optional[Tuple[int, int]]:
    """The JAX kernel's (tm, tk) grid tiling, or None when the shapes do not
    align (JAX ``_kernel_geometry``, kept as it is: output row-blocks cover
    whole 32-bucket chunks, nest inside the (ws, chunk) wire rows and leave
    a VMEM-sized accumulator; the contraction splits evenly). The port adds
    one condition (``check_tile``): the kernel's (32, B) f32 tile must fit
    its shared memory."""
    b = cc.bucket_size
    if check_tile and CHUNK_BUCKETS * b * 4 > codec_cuda.MAX_EPILOGUE_TILE_BYTES:
        return None
    if b % 128 or o % 128 or chunk % (CHUNK_BUCKETS * b):
        return None
    rows_per = din // ws  # dw rows per wire row (caller checked din % ws)
    # tm rows of dw = tm*O flat elems: needs whole chunks + row nesting.
    t0 = (CHUNK_BUCKETS * b) // math.gcd(CHUNK_BUCKETS * b, o)
    if t0 == 0 or rows_per % t0:
        return None
    tm = t0
    while (
        tm * 2 <= rows_per
        and rows_per % (tm * 2) == 0
        and (tm * 2) * o <= _KERNEL_MAX_ACC_ELEMS
    ):
        tm *= 2
    if tm * o > _KERNEL_MAX_ACC_ELEMS:
        return None
    tk = None
    for cand in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if k_total % cand == 0:
            tk = cand
            break
    if tk is None:
        return None
    return tm, tk


def _matmul_quantize_q(x2, g2, cc, *, ws, chunk, div, own=None):
    """Run the matmul-quantize kernel over the whole ``dw`` and lay its
    words and meta out as the ``(ws, chunk)`` row-batched QTensor
    ``dispatch.quantize_batch`` gives (each row is whole chunks, so the
    flat wire layout splits into rows by a view). The operands go to the
    kernel in their own dtype, uncast. With ``own``, returns ``(q,
    raw_row)``: also row ``own`` of the product in that dtype, divided,
    from the same launch's sums."""
    b, bits = cc.bucket_size, cc.bits
    # The lowerings of fused_producer.py:512-513: the env's pack (no tuned
    # entry) and the encode.
    out = codec_cuda.matmul_quantize_chunks(
        x2.contiguous(), g2.contiguous(), div, bits, b, encode=cfg_mod.codec_encode(),
        pack=codec_cuda._pack_strategy(), own_row=None if own is None else (own, ws),
    )
    words, meta = out[0], out[1]
    q = QTensor(
        packed=words.view(ws, chunk * bits // 32),
        meta=meta.view(ws, chunk // b, 2),
        residual=torch.zeros((ws, 0), dtype=torch.float32, device=words.device),
        numel=chunk,
        bits=bits,
        bucket_size=b,
        dtype=torch.float32,
    )
    return q if own is None else (q, out[2])
