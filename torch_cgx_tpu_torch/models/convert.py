"""Weights across the two packages.

The JAX package's GPT-2 parameters are a nested flax dict (``{"wte":
{"embedding": ...}, "h_0": {"attn": {"attn_qkv": {"kernel": ...}}}}``).
The port's modules reproduce its names and layouts, so the mapping is one
to one: each leaf's dotted path is its ``state_dict`` key, kernels stay
``(in, out)``. The leaves are numpy arrays on both sides of the boundary;
this module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = np.asarray(val)
    return out


def gpt2_params_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT-2 parameter tree (numpy leaves) -> the port's ``state_dict``
    (float32 CPU tensors keyed by dotted path)."""
    return {
        path: torch.from_numpy(np.array(leaf, dtype=np.float32))
        for path, leaf in _flatten(params_np).items()
    }


def gpt2_params_to_numpy(
    model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]]
) -> Dict[str, Any]:
    """Inverse of :func:`gpt2_params_from_jax`: a nested dict of numpy
    arrays in the flax tree's structure."""
    state = (
        model_or_state.state_dict()
        if isinstance(model_or_state, nn.Module)
        else model_or_state
    )
    tree: Dict[str, Any] = {}
    for path, t in state.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return tree
