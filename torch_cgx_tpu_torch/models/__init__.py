"""Models: GPT-2 and the layers it is built from."""

from .attention import Mlp, MultiHeadAttention, dense_attention
from .convert import gpt2_params_from_jax, gpt2_params_to_numpy
from .gpt2 import GPT2, Block, GPT2Config, lm_loss
from .layers import Dense, Embed, LayerNorm

__all__ = [
    "GPT2",
    "Block",
    "Dense",
    "Embed",
    "GPT2Config",
    "LayerNorm",
    "Mlp",
    "MultiHeadAttention",
    "dense_attention",
    "gpt2_params_from_jax",
    "gpt2_params_to_numpy",
    "lm_loss",
]
