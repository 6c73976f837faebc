"""Registers and spills of every kernel a checkout's codec source builds.

Builds ``csrc/codec.cu`` of the checkout at ``--root`` (by that checkout's
own ``ops/codec_cuda.build``, in a subprocess, into its own ``_build/``),
parses the compiler's report with :func:`codec_cuda.ptxas_instances` and
prints one JSON record: the root, the build's seconds, the kernel count and
the table. With ``--out FILE`` the table of the f32 instances (every key
without ``:16`` and without ``tf32``) is also written there, the form of
``csrc/ptxas_f32.json``: the f32 instances, which the 16-bit wire dtypes
and every later instance set leave alone. ``--compare FILE`` holds this
build's f32 instances to such a table and exits 1 on any difference. The record also has each build part's seconds (its nvcc's,
all parts compiling at once). ``--part K`` instead compiles part K of the
checkout's source alone (this checkout's flags) and prints its seconds,
so that one part of two checkouts compares in turns. Needs ``nvcc`` (the
card's machine):

    python3 -m torch_cgx_tpu_torch.tools.ptxas_table [--root DIR] [--out F] [--compare F]
    python3 -m torch_cgx_tpu_torch.tools.ptxas_table --root DIR --part K
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict

from ..ops import codec_cuda

_BUILD = (
    "import json, sys; from torch_cgx_tpu_torch.ops import codec_cuda as c; c.build(force=True); "
    "json.dump({'seconds': c.BUILD_LOG['seconds'], 'ptxas': c.BUILD_LOG['ptxas'], "
    "'part_seconds': c.BUILD_LOG.get('part_seconds')}, sys.stdout)"
)


def build_report(root: Path) -> Dict[str, object]:
    """Build ``root``'s codec source with its own build function; returns
    its seconds and its ptxas report."""
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", _BUILD], cwd=root, env=env, check=True,
                         stdout=subprocess.PIPE, text=True, timeout=1200).stdout
    return json.loads(out)


def part_seconds(root: Path, part: int) -> float:
    """Seconds one nvcc takes for part ``part`` of ``root``'s codec source,
    compiled alone with this checkout's flags."""
    src = root / "torch_cgx_tpu_torch" / "csrc" / "codec.cu"
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        subprocess.run([codec_cuda._nvcc(), *codec_cuda.NVCC_FLAGS, f"-DCGX_PART={part}", "-c",
                        "-o", os.path.join(work, "part.o"), str(src)],
                       check=True, capture_output=True, timeout=1200)
        return time.perf_counter() - t0


def f32_table(table: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """The f32 instances: every key but the 16-bit ones (``:16``) and B8's
    split-TF32 kernels (``tf32`` in the name), which came after the table."""
    return {k: v for k, v in sorted(table.items()) if not k.endswith(":16") and "tf32" not in k}


def compare(table: Dict[str, Dict[str, int]], baseline: Dict[str, Dict[str, int]]) -> list:
    """The f32 instances whose registers or spills differ from
    ``baseline``'s, or that one of the two lacks."""
    mine = f32_table(table)
    keys = sorted(set(mine) | set(baseline))
    return [(k, baseline.get(k), mine.get(k)) for k in keys if baseline.get(k) != mine.get(k)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(codec_cuda.__file__).resolve().parents[2]))
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--part", type=int, default=None)
    a = ap.parse_args(argv)
    root = Path(a.root).resolve()
    if a.part is not None:
        print(json.dumps({"root": str(root), "part": a.part,
                          "seconds": part_seconds(root, a.part)}))
        return 0
    rep = build_report(root)
    table = codec_cuda.ptxas_instances(rep["ptxas"])
    record = {"root": str(root), "seconds": rep["seconds"], "part_seconds": rep["part_seconds"],
              "kernels": len(table), "table": table}
    if a.out:
        Path(a.out).write_text(json.dumps(f32_table(table), indent=0, sort_keys=True) + "\n")
    rc = 0
    if a.compare:
        diff = compare(table, json.loads(Path(a.compare).read_text()))
        record["f32_differences"] = diff
        rc = 1 if diff else 0
    print(json.dumps(record))
    return rc


if __name__ == "__main__":
    sys.exit(main())
