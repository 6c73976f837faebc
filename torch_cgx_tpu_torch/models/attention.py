"""Multi-head attention and MLP blocks.

Counterpart of ``torch_cgx_tpu/models/attention.py`` with the same
numerics: scores in float32 (``preferred_element_type``), divided by
``sqrt(d)``, a causal mask of ``-1e30``, a float32 softmax and the
probabilities cast back to the activation dtype before the value product.
The attention is written out as einsums, like the JAX code: the JAX
package has no attention kernel, so nothing here is a kernel to port.
Parameter names (``attn_qkv``, ``attn_proj``, ``mlp_in``, ``mlp_out``)
match the flax modules; these four are ``Dense`` layers, which take part in
producer fusion once the enclosing model names them
(``layers.name_dense_layers``), as the JAX blocks' ``CgxDense`` do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(B, H, S, D)`` einsum attention with a float32 softmax.

    ``mask``: optional key-padding mask, bool ``(B, S)`` or broadcastable to
    ``(B, H, Sq, Sk)``; True = attend."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    scores = scores / math.sqrt(d)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=scores.device)
    if causal:
        s = q.shape[2]
        cm = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(cm, scores, neg)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[:, None, None, :]
        scores = torch.where(mask, scores, neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


class MultiHeadAttention(nn.Module):
    """qkv projection -> heads -> :func:`dense_attention` -> merge ->
    output projection."""

    def __init__(
        self,
        d_model: int,
        n_head: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
        causal: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.d_model = d_model
        self.n_head = n_head
        self.causal = causal
        self.attn_qkv = Dense(d_model, 3 * d_model, dtype=dtype, generator=generator)
        self.attn_proj = Dense(d_model, d_model, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        h = self.n_head
        d_head = self.d_model // h
        q, k, v = self.attn_qkv(x).split(self.d_model, dim=-1)

        def heads(t: torch.Tensor) -> torch.Tensor:  # (B, S, D) -> (B, H, S, d)
            return t.reshape(b, s, h, d_head).transpose(1, 2)

        o = dense_attention(heads(q), heads(k), heads(v), causal=self.causal, mask=mask)
        o = o.transpose(1, 2).reshape(b, s, self.d_model)
        return self.attn_proj(o)


class Mlp(nn.Module):
    """Dense -> tanh-approximated GELU (flax ``nn.gelu``) -> Dense."""

    def __init__(
        self,
        d_model: int,
        ratio: int = 4,
        *,
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.mlp_in = Dense(d_model, ratio * d_model, dtype=dtype, generator=generator)
        self.mlp_out = Dense(ratio * d_model, d_model, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
