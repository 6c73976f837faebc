"""Compressed data-parallel gradient sync over ``torch.distributed``."""

from .allreduce import allreduce_flat, allreduce_tree
from .grad_sync import gradient_sync, make_train_step
from .reducers import chunk_layout, quantized_allreduce, sra_allreduce

__all__ = [
    "allreduce_flat",
    "allreduce_tree",
    "chunk_layout",
    "gradient_sync",
    "make_train_step",
    "quantized_allreduce",
    "sra_allreduce",
]
