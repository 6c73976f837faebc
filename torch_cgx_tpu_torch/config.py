"""Configuration: the ``CGX_*`` knobs and the per-layer registry.

Counterpart of ``torch_cgx_tpu/config.py``, cut to what the compressed
gradient sync reads. Every knob is re-read from the environment on every
call, as the reference does. The registry is this package's own: it shares
no state with the JAX package, so both can live in one process.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Hashable, List, Optional, Tuple

from .utils import env as _env

COMPRESSION_QUANTIZATION_BITS = "CGX_COMPRESSION_QUANTIZATION_BITS"
COMPRESSION_BUCKET_SIZE = "CGX_COMPRESSION_BUCKET_SIZE"
COMPRESSION_MINIMAL_SIZE = "CGX_COMPRESSION_MINIMAL_SIZE"
COMPRESSION_SKIP_INCOMPLETE_BUCKETS = "CGX_COMPRESSION_SKIP_INCOMPLETE_BUCKETS"
FUSION_BUFFER_SIZE_MB = "CGX_FUSION_BUFFER_SIZE_MB"
INNER_REDUCTION_TYPE = "CGX_INNER_REDUCTION_TYPE"
CROSS_REDUCTION_TYPE = "CGX_CROSS_REDUCTION_TYPE"
INTRA_BROADCAST = "CGX_INTRA_BROADCAST"
INTRA_COMPRESS = "CGX_INTRA_COMPRESS"
DEBUG_DUMMY_COMPRESSION = "CGX_DEBUG_DUMMY_COMPRESSION"
DEBUG_ALL_TO_ALL_REDUCTION = "CGX_DEBUG_ALL_TO_ALL_REDUCTION"
DEBUG_FORCE_CODEC = "CGX_DEBUG_FORCE_CODEC"
STANDALONE_LAYER_ELEMS = "CGX_STANDALONE_LAYER_ELEMS"
STOCHASTIC_ROUNDING = "CGX_STOCHASTIC_ROUNDING"
# The seed of the DDP hook's per-rank stochastic-rounding generators.
SEED = "CGX_SEED"
SRA_EPILOGUE = "CGX_SRA_EPILOGUE"
SRA_EPILOGUE_MIN_ELEMS = "CGX_SRA_EPILOGUE_MIN_ELEMS"
PRODUCER_FUSE = "CGX_PRODUCER_FUSE"
CODEC_ENCODE = "CGX_CODEC_ENCODE"  # div | mul: the level encode of the quantizing kernels
# exact | int8: the fold of the fused reduce kernels (B3, B7c, B4; the
# staged lowering and the DDP hook always fold exactly, as the JAX
# package's do).
SRA_ACCUM = "CGX_SRA_ACCUM"
# The reference's debug traffic shaping: reduce only the leading fraction of
# each compressed buffer.
COMPRESSION_FAKE_RATIO = "CGX_COMPRESSION_FAKE_RATIO"
NONFINITE_GUARD = "CGX_NONFINITE_GUARD"  # off | skip | exact: the NaN/Inf gradient guard
PALLAS_DB = "CGX_PALLAS_DB"  # auto | on | off: the pipelined (DB) codec kernels
PALLAS_PACK = "CGX_PALLAS_PACK"  # sum | butterfly: the bit-plane pack lowering
PALLAS_TILE_CHUNKS = "CGX_PALLAS_TILE_CHUNKS"  # explicit tile override
AUTOTUNE = "CGX_AUTOTUNE"  # auto | on | off: the per-chip codec autotuner
AUTOTUNE_DIR = "CGX_AUTOTUNE_DIR"  # where the autotune cache lives
LAYER_ALIGNED_SPLIT = "CGX_LAYER_ALIGNED_SPLIT"  # the DDP hook's greedy chunk split
# auto | on | off: the column-block pipelined SRA (parallel/schedule.py and
# the DDP hook's pipelined bucket SRA), and its target depth.
SCHEDULE = "CGX_SCHEDULE"
SCHED_CHUNKS = "CGX_SCHED_CHUNKS"
# auto | on | off: the step planner (parallel/planner.py), its average-bits
# budget, its persisted cost model and the span directory it calibrates from.
PLANNER = "CGX_PLANNER"
PLANNER_AVG_BITS = "CGX_PLANNER_AVG_BITS"
PLANNER_MODEL = "CGX_PLANNER_MODEL"
METRICS_DIR = "CGX_METRICS_DIR"
# Read only to refuse it under CGX_PLANNER=on: the JAX package's memory
# ledger, whose staging budget vetoes the planner's depths, is not ported
# (ROADMAP A14).
MEMLEDGER = "CGX_MEMLEDGER"
# Read only to refuse "on": the JAX package's asynchronous cross-slice plane,
# which skips the two-level scheme's cross stage, is not ported (ROADMAP A14).
ASYNC = "CGX_ASYNC"
# The host key of the DDP hook's host map (torch_backend.host_fingerprint):
# ranks with one key share a host. Unset: "hostname:boot_id".
SHM_HOST_ID = "CGX_SHM_HOST_ID"

DEFAULT_BITS = 32  # 32 == compression off
DEFAULT_BUCKET_SIZE = 512
DEFAULT_MINIMAL_SIZE = 16
DEFAULT_FUSION_MB = 64
MIN_FUSION_SIZE = 2048
MAX_BITS = 8  # compression active iff bits <= 8
DEFAULT_STANDALONE_LAYER_ELEMS = 1 << 20
DEFAULT_SRA_EPILOGUE_MIN_ELEMS = 1 << 20

REDUCTION_SRA = "SRA"
REDUCTION_RING = "RING"
REDUCTION_ALLTOALL = "ALLTOALL"
REDUCTION_PSUM = "PSUM"
_VALID_REDUCTIONS = (REDUCTION_SRA, REDUCTION_RING, REDUCTION_ALLTOALL, REDUCTION_PSUM)


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Per-layer compression parameters: ``bits`` (1-8 active, anything
    above off; 0 = inherit the env default at lookup), quantization
    ``bucket_size``, the skip-incomplete-buckets toggle (the final partial
    bucket travels raw) and stochastic rounding."""

    bits: int = DEFAULT_BITS
    bucket_size: int = DEFAULT_BUCKET_SIZE
    skip_incomplete_buckets: bool = False
    stochastic: bool = False

    def __post_init__(self):
        if self.bits < 0:
            raise ValueError(f"bits must be >= 0, got {self.bits}")
        if self.bucket_size < 0:
            raise ValueError(f"bucket_size must be >= 0, got {self.bucket_size}")

    @property
    def enabled(self) -> bool:
        return 1 <= self.bits <= MAX_BITS

    def merged_with_default(self, default: "CompressionConfig") -> "CompressionConfig":
        """Back-fill unset (zero) fields from ``default``."""
        return CompressionConfig(
            bits=self.bits if self.bits else default.bits,
            bucket_size=self.bucket_size if self.bucket_size else default.bucket_size,
            skip_incomplete_buckets=self.skip_incomplete_buckets
            or default.skip_incomplete_buckets,
            stochastic=self.stochastic or default.stochastic,
        )


def stochastic_rounding() -> bool:
    return _env.get_bool_env_or_default(STOCHASTIC_ROUNDING, False)


def global_seed() -> int:
    return _env.get_int_env_or_default(SEED, 0)


def default_compression_config() -> CompressionConfig:
    return CompressionConfig(
        bits=_env.get_int_env_or_default(COMPRESSION_QUANTIZATION_BITS, DEFAULT_BITS),
        bucket_size=_env.get_int_env_or_default(
            COMPRESSION_BUCKET_SIZE, DEFAULT_BUCKET_SIZE
        ),
        skip_incomplete_buckets=_env.get_bool_env_or_default(
            COMPRESSION_SKIP_INCOMPLETE_BUCKETS, False
        ),
        stochastic=stochastic_rounding(),
    )


def minimal_size() -> int:
    return _env.get_int_env_or_default(COMPRESSION_MINIMAL_SIZE, DEFAULT_MINIMAL_SIZE)


def fusion_threshold_elems(element_size: int = 4) -> int:
    """Fusion slice capacity in elements (64 MB slices by default)."""
    mb = _env.get_int_env_or_default(FUSION_BUFFER_SIZE_MB, DEFAULT_FUSION_MB)
    return max(MIN_FUSION_SIZE, (mb * 1024 * 1024) // element_size)


def layer_aligned_split() -> bool:
    """CGX_LAYER_ALIGNED_SPLIT: the DDP hook splits a bucket's compressed
    values into rank chunks by the reference's greedy walk, which keeps
    layers whole within a chunk where it can
    (``torch_backend.backend._chunk_split_layer_aligned``), in place of the
    equal 8-aligned split."""
    return _env.get_bool_env_or_default(LAYER_ALIGNED_SPLIT, False)


def _tri_state(name: str) -> str:
    mode = _env.get_str_env_or_default(name, "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{name} must be auto|on|off, got {mode!r}")
    return mode


def schedule_mode() -> str:
    """CGX_SCHEDULE: auto | on | off. "on" pipelines the SRA of a flat
    group column block by column block (``parallel/schedule.py``, and the
    DDP hook's pipelined bucket SRA) wherever a slice sustains two blocks.
    "auto" and "off" run the monolithic SRA: the JAX package engages "auto"
    only on the staged in-XLA plane of a real TPU, which the port does not
    have, and runs the monolithic path everywhere else."""
    return _tri_state(SCHEDULE)


DEFAULT_SCHED_CHUNKS = 4


def sched_chunks() -> int:
    """CGX_SCHED_CHUNKS: the target pipeline depth, column blocks a fusion
    slice (default 4, floored at 1). A row too narrow for it gets fewer
    blocks, down to one: the monolithic SRA."""
    return max(_env.get_int_env_or_default(SCHED_CHUNKS, DEFAULT_SCHED_CHUNKS), 1)


def planner_mode() -> str:
    """CGX_PLANNER: auto | on | off, the step planner
    (``parallel/planner.py``), which sees every fusion slice of a step at
    once and picks each slice's pipeline depth (and, under
    ``CGX_PLANNER_AVG_BITS``, its bits) and the groups' order against a
    cost model. "on" plans every flat SRA and lets the DDP hook take the
    planner's depth too; "off" never plans. "auto" never plans in the port:
    the JAX package engages it only on a real TPU backend, and plans
    nowhere else."""
    return _tri_state(PLANNER)


def planner_avg_bits() -> float:
    """CGX_PLANNER_AVG_BITS: the payload-weighted average bit width of the
    planner's joint solve. Set, the planner re-allocates bits across a
    step's fusion slices (``adaptive.solve_bit_allocation``) in place of
    each slice's resolved width; 0 (the default) keeps the resolved widths,
    so a plan changes only the depths and the order, never the values."""
    v = _env.get_float_env_or_default(PLANNER_AVG_BITS, 0.0)
    if v and not 1.0 <= v <= float(MAX_BITS):
        raise ValueError(
            f"{PLANNER_AVG_BITS} must be 0 (off) or in [1, {MAX_BITS}], got {v}"
        )
    return v


def planner_model_path() -> Optional[str]:
    """CGX_PLANNER_MODEL: path of a persisted cost model
    (``planner.CostModel.save``'s JSON) that every rank reads at decision
    time, so that every rank of a group plans from the same bytes. Unset:
    the built-in default model, or one installed in the process
    (``planner.set_cost_model``)."""
    return _env.get_optional_str_env(PLANNER_MODEL)


def metrics_dir() -> Optional[str]:
    """CGX_METRICS_DIR: the directory of the ``spans-rank*.jsonl`` span
    files that ``planner.CostModel.from_telemetry`` calibrates from (unset:
    no span calibration). The port writes no span files itself yet."""
    return _env.get_optional_str_env(METRICS_DIR)


def memledger_enabled() -> bool:
    """CGX_MEMLEDGER, parsed as the JAX package does. The port has no memory
    ledger; under the planner the JAX ledger's staging budget can veto
    pipeline depths, so the planner refuses it (:func:`refuse_memledger`)."""
    return _env.get_bool_env_or_default(MEMLEDGER, False)


def refuse_memledger() -> None:
    """Raise ``NotImplementedError`` where the planner would plan under
    ``CGX_MEMLEDGER``: the JAX planner then filters depths by the ledger's
    staging budget, which the port does not have, and a plan without the
    filter could differ from the JAX package's without saying so. Callers
    check before any collective, on every rank alike."""
    if planner_mode() == "on" and memledger_enabled():
        raise NotImplementedError(
            f"the step planner's staging-budget filter ({PLANNER}=on with {MEMLEDGER} set) "
            f"is not ported; unset {MEMLEDGER}, or unset {PLANNER} or set it to auto or off"
        )


def async_mode() -> str:
    """CGX_ASYNC: off (default) | on | auto, parsed as the JAX package does.
    "on" makes the JAX package's two-level bucket reduction skip its cross
    stage for the asynchronous plane, which the port does not have: the DDP
    hook's two-level path raises under it."""
    mode = _env.get_str_env_or_default(ASYNC, "off").lower()
    if mode not in ("off", "on", "auto"):
        raise ValueError(f"{ASYNC} must be off|on|auto, got {mode!r}")
    return mode


def fake_ratio() -> Optional[float]:
    """CGX_COMPRESSION_FAKE_RATIO: the reference's debug traffic shaping,
    which reduces only the leading ``ceil(ratio * n)`` values of each
    compressed buffer and leaves the rest un-reduced. A value <= 0 or >= 1
    is off (None), as in the JAX package."""
    v = _env.get_float_env_or_default(COMPRESSION_FAKE_RATIO, 0.0)
    if v <= 0.0 or v >= 1.0:
        return None
    return v


NONFINITE_POLICIES = ("off", "skip", "exact")


def nonfinite_guard() -> str:
    """CGX_NONFINITE_GUARD: what the gradient sync does when any rank's
    gradients hold NaN or Inf (detected before the quantize, agreed over the
    whole world): "off" (default: the NaN is quantized and poisons every
    bucket it shares a chunk with, on every rank), "skip" (drop the step:
    ``make_train_step`` keeps the parameters, the optimizer state and the
    error-feedback residual; ``gradient_sync`` returns zeros) or "exact"
    (sum the sanitized gradients, NaN/Inf zeroed, uncompressed for that
    step). Anything else is a ``ValueError``."""
    v = _env.get_str_env_or_default(NONFINITE_GUARD, "off").lower()
    if v not in NONFINITE_POLICIES:
        raise ValueError(f"{NONFINITE_GUARD} must be one of {NONFINITE_POLICIES}, got {v!r}")
    return v


def _reduction_from_env(name: str, default: str) -> str:
    raw = _env.get_str_env_or_default(name, default).upper()
    if raw in ("SRA", "SCATTER_REDUCE_ALLGATHER"):
        return REDUCTION_SRA
    if raw == "RING":
        return REDUCTION_RING
    if raw in ("ALLTOALL", "ALL_TO_ALL"):
        return REDUCTION_ALLTOALL
    if raw == "PSUM":
        return REDUCTION_PSUM
    raise ValueError(f"{name}={raw!r}: expected one of {_VALID_REDUCTIONS}")


def intra_reduction() -> str:
    """The reduction type of a single-level data-parallel group (the intra
    level of :func:`topology_from_env`)."""
    if _env.get_bool_env_or_default(DEBUG_ALL_TO_ALL_REDUCTION, False):
        return REDUCTION_ALLTOALL
    return _reduction_from_env(INNER_REDUCTION_TYPE, REDUCTION_SRA)


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """The two-level (cross x intra) reduction scheme: each level's
    reduction type, the leader scheme (``intra_broadcast``: reduce-scatter
    inside the node, cross-reduce one chunk per rank, all-gather inside the
    node) and whether each level compresses."""

    intra_reduction: str = REDUCTION_SRA
    cross_reduction: str = REDUCTION_RING
    intra_broadcast: bool = True
    intra_compress: bool = True
    cross_compress: bool = True

    def __post_init__(self):
        for r in (self.intra_reduction, self.cross_reduction):
            if r not in _VALID_REDUCTIONS:
                raise ValueError(f"unknown reduction {r!r}")


def topology_from_env() -> TopologyConfig:
    """The reference's defaults: intra SRA, cross RING, leader scheme on,
    intra compression on; ``CGX_DEBUG_ALL_TO_ALL_REDUCTION`` sets both
    levels to ALLTOALL."""
    if _env.get_bool_env_or_default(DEBUG_ALL_TO_ALL_REDUCTION, False):
        intra = cross = REDUCTION_ALLTOALL
    else:
        intra = _reduction_from_env(INNER_REDUCTION_TYPE, REDUCTION_SRA)
        cross = _reduction_from_env(CROSS_REDUCTION_TYPE, REDUCTION_RING)
    return TopologyConfig(
        intra_reduction=intra,
        cross_reduction=cross,
        intra_broadcast=_env.get_bool_env_or_default(INTRA_BROADCAST, True),
        intra_compress=_env.get_bool_env_or_default(INTRA_COMPRESS, True),
    )


def dummy_compression() -> bool:
    """CGX_DEBUG_DUMMY_COMPRESSION: pass-through codec for debugging."""
    return _env.get_bool_env_or_default(DEBUG_DUMMY_COMPRESSION, False)


def force_codec() -> bool:
    """CGX_DEBUG_FORCE_CODEC: run the per-rank codec work of an SRA step
    even at world size 1, so one card can measure codec cost in a real
    train step."""
    return _env.get_bool_env_or_default(DEBUG_FORCE_CODEC, False)


def standalone_layer_elems() -> int:
    """Leaves at least this large form their own fusion group."""
    return _env.get_int_env_or_default(
        STANDALONE_LAYER_ELEMS, DEFAULT_STANDALONE_LAYER_ELEMS
    )


def sra_epilogue() -> str:
    """SRA epilogue lowering: "auto" (the fused CUDA kernel for CUDA
    payloads at or above ``CGX_SRA_EPILOGUE_MIN_ELEMS``, the staged path
    otherwise), "fused" (the fused epilogue at any size and on any device;
    on the CPU it runs the kernel's plain version) or "staged"."""
    mode = _env.get_str_env_or_default(SRA_EPILOGUE, "auto").lower()
    if mode not in ("auto", "fused", "staged"):
        raise ValueError(f"{SRA_EPILOGUE} must be auto|fused|staged, got {mode!r}")
    return mode


def sra_epilogue_min_elems() -> int:
    v = _env.get_int_env_or_default(
        SRA_EPILOGUE_MIN_ELEMS, DEFAULT_SRA_EPILOGUE_MIN_ELEMS
    )
    return max(v, 0)


def producer_fuse() -> str:
    """CGX_PRODUCER_FUSE: producer-fused gradient quantization
    (``ops/fused_producer.py``): the backward of a wrapped dense layer
    emits the layer's SRA stage-1 wire payload, which the allreduce then
    consumes in place of quantizing the f32 gradient itself.

    * "auto" (default): off in this package. Inside ``make_train_step`` an
      engaged layer no longer computes the plain weight gradient (its
      ``dw`` is skipped where the sync consumes the payload), so engaging
      pays exactly when the matmul-quantize kernel is no slower than the
      unfused route for the same payload: cuBLAS's product, the divide and
      the stage-1 quantize. On an NVIDIA H100 80GB HBM3 at 700 W
      (``chip_smoke.py`` phase 5, K = 1024, 4 bits, bucket 512, divisor 4)
      it is slower at GPT-2 124M's three dense shapes: 0.2389 / 0.1901 /
      0.2481 ms against 0.1721 / 0.1470 / 0.2403 ms at mlp_in / attn_qkv /
      mlp_out (1.39x / 1.29x / 1.03x). So "auto" stays off until it wins
      at all three.
    * "on": engage on any device (on the CPU the payload comes from the
      plain PyTorch versions).
    * "off": never engage."""
    mode = _env.get_str_env_or_default(PRODUCER_FUSE, "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{PRODUCER_FUSE} must be auto|on|off, got {mode!r}")
    return mode


def codec_encode() -> str:
    """CGX_CODEC_ENCODE: the level encode of the chunk kernels, "div" (the
    default: an IEEE divide per value, the bytes of every other codec) or
    "mul" (a multiply by the bucket's reciprocal, which may pick the
    neighbouring level at a last-ulp tie). The dense tail outside the
    kernels always divides."""
    raw = _env.get_str_env_or_default(CODEC_ENCODE, "div").lower()
    if raw not in ("div", "mul"):
        raise ValueError(f"{CODEC_ENCODE}={raw!r}: expected 'div' or 'mul'")
    return raw


def sra_accum() -> str:
    raw = _env.get_str_env_or_default(SRA_ACCUM, "exact").lower()
    if raw not in ("exact", "int8"):
        raise ValueError(f"{SRA_ACCUM}={raw!r}: expected 'exact' or 'int8'")
    return raw


def pallas_db() -> str:
    """CGX_PALLAS_DB: the pipelined lowering of the flat codec kernels
    (quantize, dequantize, the fused SRA epilogue): one persistent block
    per SM streams its chunks through a ring of shared-memory slots filled
    by bulk asynchronous copies (``csrc/codec.cu``, the ``*_db`` kernels).

    * "auto" (default): pipelined only where a persisted autotune entry for
      this card says it measured faster (``ops/autotune.py``); with no
      entry the single-stage kernels run unchanged.
    * "on": the pipelined kernels wherever their geometry applies (on the
      CPU their plain versions, which are the single-stage ones).
    * "off": never.

    Both lowerings give the same wire bytes."""
    mode = _env.get_str_env_or_default(PALLAS_DB, "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{PALLAS_DB} must be auto|on|off, got {mode!r}")
    return mode


def pallas_pack() -> Optional[str]:
    """CGX_PALLAS_PACK: the bit-plane pack lowering, "sum" or "butterfly"
    (unset: the autotuned or default one). Both lowerings give the same
    bytes: "sum" ORs each position's 32 bucket bits in one thread,
    "butterfly" takes each plane word as one warp ballot over the buckets."""
    raw = (_env.get_optional_str_env(PALLAS_PACK) or "").lower()
    if raw and raw not in ("sum", "butterfly"):
        raise ValueError(f"{PALLAS_PACK}={raw!r}: expected 'sum' or 'butterfly'")
    return raw or None


def pallas_tile_chunks() -> Optional[int]:
    """CGX_PALLAS_TILE_CHUNKS: chunks a pipelined block stages per ring
    slot, beating the autotuned entry and the heuristic (unset: None)."""
    forced = _env.get_optional_str_env(PALLAS_TILE_CHUNKS)
    if not forced:
        return None
    try:
        tc = int(forced)
    except ValueError:
        tc = 0
    if tc < 1:
        raise ValueError(f"{PALLAS_TILE_CHUNKS} must be a positive integer, got {forced!r}")
    return tc


def autotune_mode() -> str:
    """CGX_AUTOTUNE: the per-card codec autotuner (``ops/autotune.py``).

    * "auto" (default): consult the persisted cache where it has an entry
      for the (kernel, shape, bits, bucket, card); never measures.
    * "on": the same. Only :func:`ops.autotune.tune` measures, and no
      dispatch path calls it (the JAX package's docstring promises a
      measurement at first dispatch that its code never makes; the port
      follows the code).
    * "off": never consult; the heuristics only."""
    mode = _env.get_str_env_or_default(AUTOTUNE, "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{AUTOTUNE} must be auto|on|off, got {mode!r}")
    return mode


def autotune_dir() -> Optional[str]:
    """CGX_AUTOTUNE_DIR: directory of the persisted autotune cache
    (``autotune-<card-slug>.json``). Unset: ``~/.cache/torch_cgx_tpu_torch``."""
    return _env.get_optional_str_env(AUTOTUNE_DIR)


# ---------------------------------------------------------------------------
# Per-layer registries.
# ---------------------------------------------------------------------------

LayerId = Tuple[Hashable, int]  # (bucket key, layer_idx)

_layer_configs: Dict[LayerId, CompressionConfig] = {}
_layer_sizes: Dict[Hashable, List[int]] = {}
_pattern_configs: Dict[str, CompressionConfig] = {}
_registry_version = 0


def registry_version() -> int:
    """A count of the registries' changes: the layout cache's key reads it,
    so a change between two calls never hits a stale layout."""
    return _registry_version


def _bump_registry_version() -> None:
    global _registry_version
    _registry_version += 1


def register_layer(
    bucket_idx: Hashable,
    layer_idx: int,
    numel: int,
    bits: int = 0,
    bucket_size: int = 0,
) -> None:
    """Numeric registry, parity with ``torch_cgx.register_layer``. Zero
    bits/bucket_size inherit the env default at lookup."""
    sizes = _layer_sizes.setdefault(bucket_idx, [])
    if layer_idx == len(sizes):
        sizes.append(numel)
    elif layer_idx < len(sizes):
        sizes[layer_idx] = numel
    else:
        raise ValueError(
            f"layer_idx {layer_idx} out of order for bucket {bucket_idx} "
            f"(have {len(sizes)} layers)"
        )
    _layer_configs[(bucket_idx, layer_idx)] = CompressionConfig(
        bits=bits, bucket_size=bucket_size
    )
    _bump_registry_version()


def set_quantization_bits(layer_id: LayerId, bits: int) -> None:
    cfg = _layer_configs.get(layer_id, CompressionConfig(bits=0, bucket_size=0))
    _layer_configs[layer_id] = dataclasses.replace(cfg, bits=bits)
    _bump_registry_version()


def set_quantization_bucket_size(layer_id: LayerId, bucket_size: int) -> None:
    cfg = _layer_configs.get(layer_id, CompressionConfig(bits=0, bucket_size=0))
    _layer_configs[layer_id] = dataclasses.replace(cfg, bucket_size=bucket_size)
    _bump_registry_version()


def get_layer_config(layer_id: LayerId) -> CompressionConfig:
    default = default_compression_config()
    cfg = _layer_configs.get(layer_id)
    return default if cfg is None else cfg.merged_with_default(default)


def registered_layer_sizes(bucket_idx: Hashable) -> Optional[List[int]]:
    return _layer_sizes.get(bucket_idx)


def registered_buckets() -> list:
    """Bucket keys with registered layer sizes."""
    return list(_layer_sizes.keys())


def set_layer_pattern_config(pattern: str, config: CompressionConfig) -> None:
    """Per-layer config by regex over dotted parameter paths (e.g.
    ``r".*kernel$"``). Later registrations win."""
    re.compile(pattern)
    _pattern_configs[pattern] = config
    _bump_registry_version()


def resolve_pattern_config(path: str) -> Optional[CompressionConfig]:
    match = None
    for pattern, cfg in _pattern_configs.items():
        if re.search(pattern, path):
            match = cfg
    if match is None:
        return None
    return match.merged_with_default(default_compression_config())


def clear_registry() -> None:
    _layer_configs.clear()
    _layer_sizes.clear()
    _pattern_configs.clear()
    _bump_registry_version()
