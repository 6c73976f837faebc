"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller asks for another device. With
no device given and no GPU present they raise: the port never moves to the
CPU on its own, because a CPU run of the codec is a different program from
the one a user measures (the CUDA kernels do not run there).
"""

from __future__ import annotations

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
