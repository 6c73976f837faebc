"""Producer-fused gradient quantization: the backward of a dense layer emits
the layer's SRA stage-1 wire payload.

Counterpart of ``torch_cgx_tpu/ops/fused_producer.py``, in PyTorch's idiom:

* :func:`matmul` is ``x @ w`` as a ``torch.autograd.Function``. Its backward
  returns the exact ``dx`` and ``dw`` (the same PyTorch calls autograd makes
  for ``torch.matmul``, so ``p.grad`` is bit-identical to the unwrapped
  layer's), and it also stages the layer's wire payload: the quantized
  ``(ws, chunk)`` SRA stage-1 rows of ``dw / divisor`` and the raw own-chunk
  row, in a stash keyed by the parameter's dotted path.
* ``allreduce_tree`` (``parallel/allreduce.py``) looks each standalone
  compressed group's gradient up in the stash. On a match the SRA consumes
  the payload (``reducers._sra_exchange(pre=...)``) instead of quantizing
  the f32 gradient itself; on any mismatch the plain path runs and the
  fallback is counted in :data:`COUNTS`, never silent.

The payload comes from the matmul-quantize kernel
(``codec_cuda.matmul_quantize_chunks``, B8: the product accumulated in
registers, divided and quantized in shared memory, only words and meta
written), which takes its plain version for CPU operands.

Where this differs from the JAX package:

* No ``CGX_PRODUCER_KERNEL`` and no compose path. A layer whose geometry
  does not align (:func:`_kernel_geometry`) stages nothing and falls back
  (``layout``); the allreduce then quantizes its gradient as it would
  unfused. The JAX package composes a payload there, which in eager
  PyTorch is that same quantize of the same ``dw / divisor``.

* Eager PyTorch has no dead-code elimination. The backward must return
  ``dw`` for ``p.grad``, and whether the payload is consumed is decided
  later, so an engaged layer runs the plain ``dw`` product and the kernel's
  (a second pass over the weight-gradient FLOPs). ``CGX_PRODUCER_FUSE=auto``
  therefore resolves to off for now; "on" engages on any device.
* The raw own row is ``dw.view(ws, chunk)[own] / divisor``, taken from the
  returned ``dw`` instead of a 1/ws-sized second matmul.
* The stash cannot match on the identity of the gradient object:
  ``AccumulateGrad`` may steal the returned tensor or copy it. An entry
  holds no strong reference to ``dw``; it matches a gradient by the storage
  (a weak reference), ``data_ptr()``, ``_version``, shape and the step's
  epoch, so an in-place rewrite (``p.grad.mul_``), an out-of-place one
  (``p.grad = p.grad * 1``) or a second backward in one step (gradient
  accumulation) leaves it unclaimable, and the miss is counted
  (``producer_fallback_identity``; the JAX lookup misses silently).
* The kernel keeps its (32, B) tile in shared memory, so buckets whose tile
  does not fit (``codec_cuda.MAX_EPILOGUE_TILE_BYTES``) fall back with the
  port-only reason ``tile`` where the JAX package would launch its kernel.
* The JAX schedule, planner and topology-router lookups are inert off the
  TPU with their knobs unset; only the monolithic payload is ported (the
  per-block ``q_blocks`` waits for the schedule compiler).

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
              "producer_consumed_slices", "producer_invalidations"):
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
    resolves to off, see the module docstring)."""
    return cfg_mod.producer_fuse() == "on"


# ---------------------------------------------------------------------------
# Configuration and stash.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Produced:
    """One layer's staged wire payload, waiting for the allreduce to claim
    it. It holds no reference to the gradient it was made from: it matches
    a gradient by storage, address, version counter, shape and epoch."""

    q: QTensor  # the (ws, chunk) stage-1 rows of dw / divisor
    raw_row: torch.Tensor  # this rank's raw own chunk, divided
    cc: CompressionConfig
    ws: int
    n: int
    divisor: int
    epoch: int
    name: str
    storage: StorageWeakRef
    data_ptr: int
    version: int
    shape: Tuple[int, ...]
    consumed: bool = False

    def matches(self, leaf: torch.Tensor) -> bool:
        return (
            not self.storage.expired()
            and StorageWeakRef(leaf.untyped_storage()) == self.storage
            and leaf.data_ptr() == self.data_ptr
            and leaf._version == self.version
            and tuple(leaf.shape) == self.shape
        )


# The group's size and this rank's position in it, resolved by configure().
_CFG: Dict[str, object] = {
    "ws": 1, "rank": 0, "divisor": 1, "active": False, "configured": False, "epoch": 0,
}
# parameter path -> its entry of this epoch; None marks a layer whose
# backward ran twice in the epoch (unclaimable).
_STASH: Dict[str, Optional[Produced]] = {}


def configure(group=None, *, divisor: int = 1, active: bool = True) -> None:
    """Install the sync context the backward needs (``make_train_step``
    calls this; ``gradient_sync`` users may too): the data-parallel group
    (``None``: the default group), the averaging divisor and whether the
    plane is active. A ``TwoLevelGroup`` never activates it: the two-level
    scheme keeps the unfused path, as the JAX two-axis sync does. The
    ``CGX_PRODUCER_FUSE`` knob is read here, once a step, so that the
    forward of a wrapped layer reads one flag."""
    from ..parallel import group as group_mod
    from ..parallel.mesh import TwoLevelGroup

    if isinstance(group, TwoLevelGroup):
        ws, rank, active = group.size, 0, False
    else:
        ws, rank = group_mod.world_size(group), group_mod.rank(group)
    _CFG.update(
        ws=int(ws), rank=int(rank), divisor=int(divisor),
        active=bool(active) and engaged(), configured=True,
    )


def deconfigure() -> None:
    _CFG.update(ws=1, rank=0, divisor=1, active=False, configured=False)
    _STASH.clear()


def active() -> bool:
    """Whether a wrapped layer routes its product through :func:`matmul`
    (configured active with the knob on)."""
    return bool(_CFG["active"])


def begin_step() -> None:
    """Open a fresh stash epoch (the top of each train step): entries of an
    earlier step can never be claimed."""
    _CFG["epoch"] += 1
    _STASH.clear()


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


# ---------------------------------------------------------------------------
# The wrapped contraction.
# ---------------------------------------------------------------------------


class _ProducedMatmul(torch.autograd.Function):
    """``x @ w.to(dtype)``; the backward returns the exact ``dx`` and ``dw``
    and stages ``dw``'s payload."""

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
            # Autograd's own product for matmul's weight: the folded input
            # transposed times the folded cotangent, then the cast back.
            x2 = x.reshape(-1, x.shape[-1])
            g2 = g.reshape(-1, g.shape[-1])
            dw = x2.t().mm(g2).to(ctx.w_dtype)
            _maybe_stash(ctx.name, dw, x2, g2)
        return dx, dw, None, None


def matmul(x: torch.Tensor, w: torch.Tensor, *, name: str, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w.to(dtype)`` whose backward stages the wire payload of ``dw``
    for the parameter at ``name`` when the plane is active (else the plain
    product)."""
    if not active():
        return torch.matmul(x, w.to(dtype))
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
    "")`` when the kernel produces it, ``(None, reason)`` for a fallback.
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
    din, o = w_shape
    if _kernel_geometry(k_total, din, o, ws, chunk, cc, check_tile=False) is None:
        return None, "layout"
    if _kernel_geometry(k_total, din, o, ws, chunk, cc) is None:
        return None, "tile"
    return cc, ""


def _maybe_stash(name: str, dw: torch.Tensor, x2: torch.Tensor, g2: torch.Tensor) -> None:
    """Stage the wire payload of this layer's gradient when every gate
    passes; otherwise count the fallback and stage nothing."""
    if not _CFG["active"]:
        return
    if not _CFG["configured"]:
        return fallback("unconfigured")
    ws, div = int(_CFG["ws"]), int(_CFG["divisor"])
    cc, reason = decide(name, tuple(dw.shape), x2.shape[0], ws, dtype=dw.dtype)
    if cc is None:
        return fallback(reason)
    if name in _STASH:  # a second backward this step: p.grad is a sum now
        _STASH[name] = None
        return
    n = dw.numel()
    chunk = n // ws
    # The raw own row from the returned dw: the same values the unfused
    # path's padded rows hold.
    raw_row = dw.view(ws, chunk)[int(_CFG["rank"])] / div
    q = _matmul_quantize_q(x2, g2, cc, ws=ws, chunk=chunk, div=div)
    count("producer_kernel_slices")
    count("producer_staged")
    _STASH[name] = Produced(
        q=q, raw_row=raw_row, cc=cc, ws=ws, n=n, divisor=div,
        epoch=int(_CFG["epoch"]), name=name,
        storage=StorageWeakRef(dw.untyped_storage()), data_ptr=dw.data_ptr(),
        version=dw._version, shape=tuple(dw.shape),
    )


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


def _matmul_quantize_q(x2, g2, cc, *, ws, chunk, div) -> QTensor:
    """Run the matmul-quantize kernel over the whole ``dw`` and lay its
    words and meta out as the ``(ws, chunk)`` row-batched QTensor
    ``dispatch.quantize_batch`` gives (each row is whole chunks, so the
    flat wire layout splits into rows by a view)."""
    b, bits = cc.bucket_size, cc.bits
    x2f = x2.to(torch.float32).contiguous()
    g2f = g2.to(torch.float32).contiguous()
    # The lowerings of fused_producer.py:512-513: the env's pack (no tuned
    # entry) and the encode.
    words, meta = codec_cuda.matmul_quantize_chunks(
        x2f, g2f, div, bits, b, encode=cfg_mod.codec_encode(), pack=codec_cuda._pack_strategy()
    )
    return QTensor(
        packed=words.view(ws, chunk * bits // 32),
        meta=meta.view(ws, chunk // b, 2),
        residual=torch.zeros((ws, 0), dtype=torch.float32, device=words.device),
        numel=chunk,
        bits=bits,
        bucket_size=b,
        dtype=torch.float32,
    )
