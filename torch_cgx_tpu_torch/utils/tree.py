"""Path and alignment helpers.

Counterpart of ``torch_cgx_tpu/utils/tree.py``. Parameters and gradients
are ordered mappings of dotted paths (``h_0.attn.attn_qkv.kernel``) to
tensors: the paths a flax parameter tree flattens to, which the port's
module attribute names reproduce through ``named_parameters()``.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Tuple, TypeVar

T = TypeVar("T")


def round_up(value: int, multiple: int) -> int:
    """Round ``value`` up to a multiple of ``multiple``."""
    if multiple <= 0:
        return value
    return ((value + multiple - 1) // multiple) * multiple


def path_str(keys: Iterable) -> str:
    """Dotted path of a sequence of tree keys: ``("h_0", "ln_1", "scale")``
    -> ``"h_0.ln_1.scale"``."""
    return ".".join(str(k) for k in keys)


def path_key(path: str) -> Tuple[str, ...]:
    """Sort key that orders dotted paths as JAX flattens a nested dict: keys
    sorted level by level, so ``h_10`` sorts before ``h_2``."""
    return tuple(path.split("."))


def sorted_items(tree: Mapping[str, T]) -> List[Tuple[str, T]]:
    """``(path, leaf)`` pairs in JAX's flattening order."""
    return sorted(tree.items(), key=lambda kv: path_key(kv[0]))
