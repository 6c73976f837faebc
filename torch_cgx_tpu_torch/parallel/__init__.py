"""Compressed data-parallel gradient sync over ``torch.distributed``, over
one group or two levels (cross x intra)."""

from .adaptive import adapt_bits, apply_bit_allocation, measure_layer_stats, solve_bit_allocation
from .allreduce import allreduce_flat, allreduce_tree
from .grad_sync import ErrorFeedbackState, gradient_sync, init_error_feedback, make_train_step
from .mesh import TwoLevelGroup, hierarchical_groups
from .planner import CostModel, SliceDecision, StepPlan, StepPlanner
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
    "CostModel",
    "ErrorFeedbackState",
    "SliceDecision",
    "StepPlan",
    "StepPlanner",
    "TwoLevelGroup",
    "adapt_bits",
    "allreduce_flat",
    "allreduce_tree",
    "alltoall_allreduce",
    "apply_bit_allocation",
    "chunk_layout",
    "gradient_sync",
    "hierarchical_allreduce",
    "hierarchical_groups",
    "init_error_feedback",
    "make_train_step",
    "measure_layer_stats",
    "quantized_allreduce",
    "ring_allreduce",
    "solve_bit_allocation",
    "sra_allreduce",
    "two_level_config",
]
