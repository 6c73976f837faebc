"""The reference's two-level scheme as a topology override.

Counterpart of ``two_level_config`` in ``torch_cgx_tpu/parallel/topology.py``.
The rest of that module routes groups to the TPU's staged XLA programs by
slice id; it has no counterpart yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .. import config as cfg_mod


def two_level_config(
    base: Optional[cfg_mod.TopologyConfig] = None,
) -> cfg_mod.TopologyConfig:
    """``base`` (default: the env's) with an uncompressed intra level under
    the leader scheme: the node-local stage is a plain reduce-scatter and
    all-gather, and only the cross exchange carries the quantized wire."""
    base = base or cfg_mod.topology_from_env()
    return dataclasses.replace(base, intra_compress=False, intra_broadcast=True)
