"""Compressed data-parallel gradient sync over ``torch.distributed``, over
one group or two levels (cross x intra)."""

from .allreduce import allreduce_flat, allreduce_tree
from .grad_sync import ErrorFeedbackState, gradient_sync, init_error_feedback, make_train_step
from .mesh import TwoLevelGroup, hierarchical_groups
from .reducers import (
    alltoall_allreduce,
    chunk_layout,
    hierarchical_allreduce,
    quantized_allreduce,
    ring_allreduce,
    sra_allreduce,
)
from .topology import two_level_config

__all__ = [
    "ErrorFeedbackState",
    "TwoLevelGroup",
    "allreduce_flat",
    "allreduce_tree",
    "alltoall_allreduce",
    "chunk_layout",
    "gradient_sync",
    "hierarchical_allreduce",
    "hierarchical_groups",
    "init_error_feedback",
    "make_train_step",
    "quantized_allreduce",
    "ring_allreduce",
    "sra_allreduce",
    "two_level_config",
]
