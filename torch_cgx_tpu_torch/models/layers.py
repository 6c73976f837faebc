"""Parameter layers with the JAX package's parameter names and layouts.

Counterpart of ``torch_cgx_tpu/models/layers.py`` and of the flax layers the
JAX models use. Every layer keeps flax's parameter names and shapes, so
``named_parameters()`` yields the dotted paths a flax parameter tree
flattens to (``h_0.attn.attn_qkv.kernel``) and the two packages exchange
weights one to one (``models/convert.py``):

* :class:`Dense`: ``kernel`` stored ``(in, out)`` and a separate ``bias``;
  the input and both parameters are cast to the compute ``dtype`` before the
  product, as flax promotes them. The counterpart of ``CgxDense``: once its
  model names it (:func:`name_dense_layers`) and producer fusion is active,
  the product goes through ``ops.fused_producer.matmul``, whose backward
  also emits the kernel gradient's quantized wire payload.
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

from ..ops import fused_producer

# Standard deviation of a unit normal truncated to (-2, 2), which flax's
# truncated-normal initialisers divide by.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` in ``dtype`` (flax ``nn.Dense`` semantics).

    ``kernel_path`` is the kernel's dotted parameter path in its model
    (``h_0.attn.attn_qkv.kernel``), the name producer fusion stages the
    gradient's payload under; ``None`` (an unnamed layer) keeps the plain
    product."""

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
        self.kernel_path: Optional[str] = None
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        lecun_normal_(self.kernel.data, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.kernel_path is not None and fused_producer.active():
            y = fused_producer.matmul(x, self.kernel, name=self.kernel_path, dtype=self.dtype)
            return y + self.bias.to(self.dtype)
        return torch.matmul(x, self.kernel.to(self.dtype)) + self.bias.to(self.dtype)


def name_dense_layers(model: nn.Module) -> None:
    """Give every :class:`Dense` of ``model`` its kernel's dotted path, as
    ``named_parameters()`` spells it."""
    for name, m in model.named_modules():
        if isinstance(m, Dense):
            m.kernel_path = f"{name}.kernel" if name else "kernel"


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
    """Layer normalisation over the last axis in float32, epsilon 1e-6. The
    scale and bias are upcast too, so parameters cast to bf16 or f16 still
    normalise in float32, as flax's ``LayerNorm(dtype=float32)`` promotes
    them."""

    def __init__(self, features: int, *, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.to(torch.float32), (x.shape[-1],), self.scale.to(torch.float32),
            self.bias.to(torch.float32), self.eps,
        )
