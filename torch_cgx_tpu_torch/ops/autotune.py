"""Per-card codec-kernel autotuner with a persisted on-disk cache.

Counterpart of ``torch_cgx_tpu/ops/autotune.py``. The codec kernels have
lowering choices the math does not pin: the tile (``tc``, chunks a
pipelined block stages per ring slot), the bit-plane pack and whether the
pipelined (``CGX_PALLAS_DB``) kernel beats the single-stage one. The
measured best choice for a (kernel kind, chunk count, bucket, bits, ws)
key lives in an in-memory memo backed by a JSON file per card kind, so one
sweep on a card serves every later run on the same kind of card.

* **Keying**: ``(kind, chunks, bucket, bits, ws)`` plus the lowering knobs
  an entry bakes in (``CGX_CODEC_ENCODE``). The card keys the file. The key
  string and the document are the JAX package's letter for letter, so a
  cache written by one package parses in the other.
* **Counters**: :func:`stats` (hits, misses, loads, tuned).
* **Invalidation**: :func:`invalidate` drops the memo; the next lookup
  re-reads the disk.
* **Inertness**: ``CGX_AUTOTUNE=auto`` (the default) only consults the
  cache; with no file every lookup misses and the heuristics run
  unchanged. Only :func:`tune` measures.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import config as cfg_mod

KIND_FLAT = "flat"  # flat quantize and flat dequantize share one entry
KIND_CHUNKS = "chunks"
KIND_EPILOGUE = "epilogue"
_KINDS = (KIND_FLAT, KIND_CHUNKS, KIND_EPILOGUE)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One measured best lowering for a key: the tile ``tc``, optionally a
    pack strategy and whether the pipelined kernel won, and the measured
    throughput behind the decision (GB/s of kernel input, diagnostic)."""

    tc: int
    pack: Optional[str] = None
    db: Optional[bool] = None
    gbps: float = 0.0


_LOCK = threading.RLock()
_MEMO: Dict[Tuple, TunedConfig] = {}
_LOADED: Dict[str, bool] = {}  # per cache-file path: disk image merged?
_STATS = {"hits": 0, "misses": 0, "loads": 0, "tuned": 0}


def stats() -> Dict[str, int]:
    """Copy of the {hits, misses, loads, tuned} counters."""
    with _LOCK:
        return dict(_STATS)


@functools.lru_cache(maxsize=None)
def _device_name() -> Optional[str]:
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def _chip_slug() -> str:
    """Filesystem-safe card identity: ``cuda-<device name>``, or ``cpu``
    without a GPU. An entry measured on one kind of card never serves
    another."""
    name = _device_name()
    raw = "cpu" if name is None else f"cuda-{name}"
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", raw)


def cache_path() -> Path:
    """The cache file for this card (written by :func:`record` and
    :func:`tune`; a lookup only reads it)."""
    base = cfg_mod.autotune_dir()
    if base is None:
        base = os.path.join(os.path.expanduser("~"), ".cache", "torch_cgx_tpu_torch")
    return Path(base) / f"autotune-{_chip_slug()}.json"


def _env_fingerprint() -> Tuple:
    """Lowering knobs an entry bakes in: one measured under one encode
    must not serve another."""
    return (cfg_mod.codec_encode(),)


def _key(kind: str, n_chunks: int, bucket_size: int, bits: int, ws: int):
    if kind not in _KINDS:
        raise ValueError(f"unknown autotune kind {kind!r} (one of {_KINDS})")
    return (kind, int(n_chunks), int(bucket_size), int(bits), int(ws), _env_fingerprint())


def _key_str(key: Tuple) -> str:
    kind, n_chunks, bucket, bits, ws, env = key
    return f"{kind}/c{n_chunks}/b{bucket}/q{bits}/w{ws}/e{'-'.join(env)}"


def _load_disk(path: Path) -> None:
    """Merge the on-disk image into the memo once per path. A torn or
    corrupt file is ignored, an unparseable entry skipped."""
    spath = str(path)
    if _LOADED.get(spath):
        return
    _LOADED[spath] = True
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return
    if not isinstance(raw, dict):
        return
    _STATS["loads"] += 1
    for ks, ent in raw.get("entries", {}).items():
        try:
            kind, c, b, q, w, e = ks.split("/")
            key = (kind, int(c[1:]), int(b[1:]), int(q[1:]), int(w[1:]),
                   tuple(x for x in e[1:].split("-") if x))
            cfg = TunedConfig(
                tc=int(ent["tc"]),
                pack=ent.get("pack"),
                db=ent.get("db"),
                gbps=float(ent.get("gbps", 0.0)),
            )
        except (KeyError, ValueError, TypeError):
            continue
        if cfg.tc >= 1 and key not in _MEMO:
            _MEMO[key] = cfg


def _persist(path: Path) -> None:
    """Rewrite the cache file from the memo, atomically, after merging the
    current disk image (two processes tuning different shapes keep both)."""
    _LOADED.pop(str(path), None)
    _load_disk(path)
    entries = {
        _key_str(k): {
            "tc": c.tc,
            **({"pack": c.pack} if c.pack else {}),
            **({"db": c.db} if c.db is not None else {}),
            "gbps": round(c.gbps, 3),
        }
        for k, c in _MEMO.items()
    }
    doc = {
        "chip": _chip_slug(),
        "updated": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "entries": entries,
    }
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # best effort: the memo still serves this process


def lookup(
    kind: str,
    *,
    n_chunks: int,
    bucket_size: int,
    bits: int = 0,
    ws: int = 0,
) -> Optional[TunedConfig]:
    """The tuned config for this kernel shape on this card, or ``None``
    (mode off, or no entry). Never measures, never writes."""
    if cfg_mod.autotune_mode() == "off":
        return None
    key = _key(kind, n_chunks, bucket_size, bits, ws)
    with _LOCK:
        _load_disk(cache_path())
        hit = _MEMO.get(key)
        _STATS["hits" if hit is not None else "misses"] += 1
        return hit


def record(
    kind: str,
    cfg: TunedConfig,
    *,
    n_chunks: int,
    bucket_size: int,
    bits: int = 0,
    ws: int = 0,
    persist: bool = True,
) -> None:
    """Install (and by default persist) a measured best config."""
    if cfg.tc < 1:
        raise ValueError(f"tuned tc must be >= 1, got {cfg.tc}")
    key = _key(kind, n_chunks, bucket_size, bits, ws)
    with _LOCK:
        _MEMO[key] = cfg
        _STATS["tuned"] += 1
        if persist:
            _persist(cache_path())


def tune(
    kind: str,
    candidates: Sequence[TunedConfig],
    measure: Callable[[TunedConfig], float],
    *,
    n_chunks: int,
    bucket_size: int,
    bits: int = 0,
    ws: int = 0,
    input_bytes: int = 0,
    persist: bool = True,
) -> Optional[TunedConfig]:
    """Measure ``candidates`` with ``measure(cfg) -> seconds`` and record
    the fastest. A candidate whose measurement raises is skipped; if all
    fail, nothing is recorded and None returned. Off under
    ``CGX_AUTOTUNE=off``."""
    if cfg_mod.autotune_mode() == "off" or not candidates:
        return None
    best: Optional[Tuple[float, TunedConfig]] = None
    for cand in candidates:
        try:
            t = float(measure(cand))
        except Exception:
            continue
        if t <= 0:
            continue
        if best is None or t < best[0]:
            best = (t, cand)
    if best is None:
        return None
    t, cand = best
    gbps = (input_bytes / t / 1e9) if input_bytes else 0.0
    winner = dataclasses.replace(cand, gbps=gbps)
    record(
        kind, winner, n_chunks=n_chunks, bucket_size=bucket_size,
        bits=bits, ws=ws, persist=persist,
    )
    return winner


def invalidate(reason: str = "reconfigure") -> None:
    """Drop the memo, the per-file load marks and the counters; the next
    lookup re-reads the disk. ``reason`` only documents the call site."""
    with _LOCK:
        _MEMO.clear()
        _LOADED.clear()
        _STATS.update(hits=0, misses=0, loads=0, tuned=0)


def snap_to_divisor(tc: int, n_chunks: int, cap: int) -> int:
    """Largest divisor of ``n_chunks`` that is <= min(tc, cap): a tile
    divides the chunk count exactly, and ``cap`` re-applies the
    shared-memory budget so a stale entry can never stage too much."""
    tc = max(1, min(int(tc), int(cap), n_chunks))
    for t in range(tc, 0, -1):
        if n_chunks % t == 0:
            return t
    return 1
