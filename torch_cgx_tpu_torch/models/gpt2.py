"""GPT-2 style decoder-only transformer.

Counterpart of ``torch_cgx_tpu/models/gpt2.py`` (the dense branch; the
mixture-of-experts MLP waits for ``parallel/moe.py``). Same numerics:
bf16 activations with float32 parameters, LayerNorm in float32 then cast
to the activation dtype, a tied embedding head with float32 logits, and the
shifted next-token loss. Module attribute names reproduce the flax tree,
so ``named_parameters()`` yields ``wte.embedding``, ``h_0.ln_1.scale``,
``h_0.attn.attn_qkv.kernel`` and so on; each dense layer learns its
kernel's path (the name producer fusion stages its gradient under).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .attention import Mlp, MultiHeadAttention
from .layers import Embed, LayerNorm, name_dense_layers


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def small(**kw) -> "GPT2Config":
        """GPT-2 124M."""
        return GPT2Config(**kw)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        """Test config."""
        defaults = dict(vocab_size=512, n_layer=2, n_head=4, d_model=128, max_seq=128)
        defaults.update(kw)
        return GPT2Config(**defaults)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = cfg.dtype
        self.ln_1 = LayerNorm(cfg.d_model)
        self.attn = MultiHeadAttention(
            cfg.d_model, cfg.n_head, dtype=cfg.dtype, causal=True, generator=generator
        )
        self.ln_2 = LayerNorm(cfg.d_model)
        self.mlp = Mlp(cfg.d_model, dtype=cfg.dtype, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x).to(self.dtype), mask=mask)
        return x + self.mlp(self.ln_2(x).to(self.dtype))


class GPT2(nn.Module):
    """Token ids ``(B, S)`` -> float32 logits ``(B, S, vocab)``.

    Parameters are drawn from ``generator`` on the CPU and then moved to
    ``device`` (the GPU unless the caller passes another device)."""

    def __init__(
        self,
        cfg: GPT2Config,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype, generator=generator)
        self.wpe = Embed(cfg.max_seq, cfg.d_model, dtype=cfg.dtype, generator=generator)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, generator=generator))
        self.ln_f = LayerNorm(cfg.d_model)
        name_dense_layers(self)
        self.to(dev)

    def forward(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        _, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None, :]
        elif positions.dim() == 1:
            positions = positions[None, :]
        x = self.wte(tokens) + self.wpe(positions)
        for i in range(self.cfg.n_layer):
            x = getattr(self, f"h_{i}")(x, mask=attn_mask)
        x = self.ln_f(x)
        # tied embedding head, float32 logits
        return torch.matmul(x.to(torch.float32), self.wte.embedding.to(torch.float32).t())


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (shifted), mean over positions."""
    v = logits.shape[-1]
    return F.cross_entropy(
        logits[:, :-1].reshape(-1, v), tokens[:, 1:].reshape(-1).to(torch.long)
    )
