"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller asks for another device. With
no device given and no GPU present they raise: the port never moves to the
CPU on its own, because a CPU run of the codec is a different program from
the one a user measures (the CUDA kernels do not run there).
"""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "port's plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


# Published device-memory rates (NVIDIA data sheets), bytes/s, by the name
# fragment `nvidia-smi` reports; the longest matching fragment wins.
MEM_RATE = {
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
    "H100": 3.35e12,
    "H200": 4.8e12,
}


def mem_rate(name: str) -> float:
    """The published memory rate of the card called ``name`` (bytes/s)."""
    best = max((k for k in MEM_RATE if k in name), key=len, default=None)
    if best is None:
        raise RuntimeError(f"no memory rate on record for {name!r}")
    return MEM_RATE[best]


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: a
    card below its maximum power runs slower under load, so every time
    taken on it is kept beside this line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
