"""Parameter layers with the JAX package's parameter names and layouts.

Counterpart of ``torch_cgx_tpu/models/layers.py`` and of the flax layers the
JAX models use. Every layer keeps flax's parameter names and shapes, so
``named_parameters()`` yields the dotted paths a flax parameter tree
flattens to (``h_0.attn.attn_qkv.kernel``) and the two packages exchange
weights one to one (``models/convert.py``):

* :class:`Dense`: ``kernel`` stored ``(in, out)`` and a separate ``bias``;
  the input and both parameters are cast to the compute ``dtype`` before the
  product, as flax promotes them. Producer fusion (the quantize in the
  weight-gradient epilogue) waits for its kernel.
* :class:`Embed`: ``embedding (num, features)``, looked up then cast.
* :class:`LayerNorm`: ``scale``/``bias``, epsilon 1e-6 (flax's default),
  computed in float32.

Initialisers follow flax's defaults (lecun-normal kernels, zero biases,
unit scales, fan-in normal embeddings) and draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# Standard deviation of a unit normal truncated to (-2, 2), which flax's
# truncated-normal initialisers divide by.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` in ``dtype`` (flax ``nn.Dense`` semantics)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        lecun_normal_(self.kernel.data, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return torch.matmul(x, self.kernel.to(self.dtype)) + self.bias.to(self.dtype)


class Embed(nn.Module):
    """Embedding table ``(num, features)``; lookups are cast to ``dtype``."""

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        *,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        nn.init.normal_(
            self.embedding.data, 0.0, math.sqrt(1.0 / num_embeddings), generator=generator
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis in float32, epsilon 1e-6."""

    def __init__(self, features: int, *, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.to(torch.float32), (x.shape[-1],), self.scale, self.bias, self.eps
        )
