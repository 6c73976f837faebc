"""DDP communication hook: ``model.register_comm_hook(state, cgx_hook)``.

Counterpart of the JAX package's ``torch_backend/hooks.py`` with the same
semantics:

* :class:`CGXState` carries the process group, the compression parameters
  (from ``compression_params`` or the ``CGX_COMPRESSION_*`` env vars), a
  ``layer_min_size`` floor and the DDP step counter.
* ``should_compress_``: gradients of dim <= 1 (biases, norms) or of fewer
  than ``layer_min_size`` values stay uncompressed.
* :func:`cgx_hook` registers every bucket's layer layout at **step 2**:
  DDP rebuilds its buckets after iteration 0, so registration waits until
  they are stable. It always averages: the bucket is divided by the world
  size in its own dtype first, then summed, so the quantization sees the
  divided gradients.

The JAX hook hands the bucket to ``dist.all_reduce(..., async_op=True)`` on
its ``"cgx"`` backend, whose worker thread runs it. The port has no
backend: the hook hands ``bucket.buffer()`` and its tag to
``backend.allreduce_async``, which runs the bucket allreduce on the
group's FIFO worker thread (on the card on a side stream ordered after the
bucket's gradients) and returns a future, so a bucket's sync overlaps the
backward of the layers still to come. DDP calls the hook in bucket order on
every rank and the worker keeps that order, so the collectives line up;
DDP waits on every future before the backward returns, and raises the
exception a bucket raised.
"""

# NOTE: no `from __future__ import annotations` here: DDP's
# register_comm_hook checks the hook's annotations by identity (the bucket
# must be dist.GradBucket, the return torch.futures.Future[torch.Tensor]),
# which stringified annotations fail.

import itertools
from typing import Optional

import torch
import torch.distributed as dist

from .. import config as cfg
from . import backend

REGISTRATION_STEP = 2

# Each CGXState registers its buckets under its own namespace, so two DDP
# models (or a re-wrapped model) in one process cannot mix their per-layer
# configs through a shared ``bucket.index()``.
_ns_counter = itertools.count()


class CGXState:
    """State passed to :func:`cgx_hook` by
    ``model.register_comm_hook(state, cgx_hook)``."""

    def __init__(
        self,
        process_group: Optional[dist.ProcessGroup] = None,
        compression_params: Optional[dict] = None,
        layer_min_size: int = 1024,
    ):
        self.process_group = process_group
        self.step = 0
        self._registry_ns = next(_ns_counter)
        default = cfg.default_compression_config()
        params = compression_params or {}
        self.quantization_bits = int(params.get("bits", default.bits))
        self.quantization_bucket_size = int(params.get("bucket_size", default.bucket_size))
        self.layer_min_size = max(int(layer_min_size), cfg.minimal_size())

    def should_compress_(self, tensor: torch.Tensor) -> bool:
        return tensor.dim() > 1 and tensor.numel() >= self.layer_min_size


def _allreduce_fut(
    process_group: Optional[dist.ProcessGroup], tensor: torch.Tensor, bucket_key
) -> torch.futures.Future:
    """Average: divide in the bucket's dtype (on the calling thread), then
    the summing bucket allreduce on the group's worker; its future."""
    group = process_group if process_group is not None else dist.group.WORLD
    tensor.div_(dist.get_world_size(group=group))
    return backend.allreduce_async(tensor, process_group, bucket_key)


def cgx_hook(
    state: CGXState, bucket: dist.GradBucket
) -> torch.futures.Future[torch.Tensor]:
    bucket_key = (state._registry_ns, bucket.index())
    if state.step == REGISTRATION_STEP:
        for layer_idx, grad in enumerate(bucket.gradients()):
            bits = state.quantization_bits if state.should_compress_(grad) else 32
            cfg.register_layer(
                bucket_key, layer_idx, grad.numel(), bits, state.quantization_bucket_size
            )
    if bucket.is_last():
        state.step += 1
    # The tag goes with the bucket to the worker, which resolves this
    # bucket's layers by it.
    return _allreduce_fut(state.process_group, bucket.buffer(), bucket_key)
