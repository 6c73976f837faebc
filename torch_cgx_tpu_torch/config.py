"""Configuration: the ``CGX_*`` knobs and the per-layer registry.

Counterpart of ``torch_cgx_tpu/config.py``, cut to what the compressed
gradient sync reads. Every knob is re-read from the environment on every
call, as the reference does. The registry is this package's own: it shares
no state with the JAX package, so both can live in one process.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from .utils import env as _env

COMPRESSION_QUANTIZATION_BITS = "CGX_COMPRESSION_QUANTIZATION_BITS"
COMPRESSION_BUCKET_SIZE = "CGX_COMPRESSION_BUCKET_SIZE"
COMPRESSION_MINIMAL_SIZE = "CGX_COMPRESSION_MINIMAL_SIZE"
COMPRESSION_SKIP_INCOMPLETE_BUCKETS = "CGX_COMPRESSION_SKIP_INCOMPLETE_BUCKETS"
FUSION_BUFFER_SIZE_MB = "CGX_FUSION_BUFFER_SIZE_MB"
INNER_REDUCTION_TYPE = "CGX_INNER_REDUCTION_TYPE"
DEBUG_DUMMY_COMPRESSION = "CGX_DEBUG_DUMMY_COMPRESSION"
DEBUG_ALL_TO_ALL_REDUCTION = "CGX_DEBUG_ALL_TO_ALL_REDUCTION"
DEBUG_FORCE_CODEC = "CGX_DEBUG_FORCE_CODEC"
STANDALONE_LAYER_ELEMS = "CGX_STANDALONE_LAYER_ELEMS"
STOCHASTIC_ROUNDING = "CGX_STOCHASTIC_ROUNDING"
SRA_EPILOGUE = "CGX_SRA_EPILOGUE"
SRA_EPILOGUE_MIN_ELEMS = "CGX_SRA_EPILOGUE_MIN_ELEMS"
# Read only to refuse them: the CUDA kernels implement the default
# ``div`` encode and the exact f32 fold (ROADMAP Queue B).
CODEC_ENCODE = "CGX_CODEC_ENCODE"
SRA_ACCUM = "CGX_SRA_ACCUM"

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
    level of ``topology_from_env`` in the JAX package)."""
    if _env.get_bool_env_or_default(DEBUG_ALL_TO_ALL_REDUCTION, False):
        return REDUCTION_ALLTOALL
    return _reduction_from_env(INNER_REDUCTION_TYPE, REDUCTION_SRA)


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


def codec_encode() -> str:
    raw = _env.get_str_env_or_default(CODEC_ENCODE, "div").lower()
    if raw not in ("div", "mul"):
        raise ValueError(f"{CODEC_ENCODE}={raw!r}: expected 'div' or 'mul'")
    return raw


def sra_accum() -> str:
    raw = _env.get_str_env_or_default(SRA_ACCUM, "exact").lower()
    if raw not in ("exact", "int8"):
        raise ValueError(f"{SRA_ACCUM}={raw!r}: expected 'exact' or 'int8'")
    return raw


# ---------------------------------------------------------------------------
# Per-layer registries.
# ---------------------------------------------------------------------------

LayerId = Tuple[int, int]  # (bucket_idx, layer_idx)

_layer_configs: Dict[LayerId, CompressionConfig] = {}
_layer_sizes: Dict[int, List[int]] = {}
_pattern_configs: Dict[str, CompressionConfig] = {}


def register_layer(
    bucket_idx: int,
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


def get_layer_config(layer_id: LayerId) -> CompressionConfig:
    default = default_compression_config()
    cfg = _layer_configs.get(layer_id)
    return default if cfg is None else cfg.merged_with_default(default)


def set_layer_pattern_config(pattern: str, config: CompressionConfig) -> None:
    """Per-layer config by regex over dotted parameter paths (e.g.
    ``r".*kernel$"``). Later registrations win."""
    re.compile(pattern)
    _pattern_configs[pattern] = config


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
