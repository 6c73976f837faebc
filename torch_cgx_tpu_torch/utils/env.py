"""Environment-variable helpers.

Counterpart of ``torch_cgx_tpu/utils/env.py``: the same ``CGX_*`` surface,
read lazily so callers can change a variable between calls (the codec and
the reducers re-read every knob on every call). A value that does not parse
raises a ``ValueError`` that names the variable.
"""

from __future__ import annotations

import os
from typing import Optional


def get_int_env_or_default(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"env var {name} must be an int, got {raw!r}") from None


def get_float_env_or_default(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"env var {name} must be a float, got {raw!r}") from None


def get_bool_env_or_default(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def get_str_env_or_default(name: str, default: str) -> str:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip()


def get_optional_str_env(name: str) -> Optional[str]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    return raw.strip()
