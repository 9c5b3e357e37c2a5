"""Transformer stack of the port (counterpart of
`mrclip_tpu/models/transformer.py`): pre-LN residual blocks, unrolled, and
the EVA02 block (`EvaBlock`: SwiGLU with sub-LN, inner attention LN, rope).

The JAX package's `scan_layers` and `remat` are compile-time choices of
XLA with no counterpart here; cross-attention and post-norm blocks belong
to towers not ported yet (ROADMAP: other configs and towers).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .layers import (MLP, EvaAttention, LayerNorm, LayerScale, MultiHeadAttention, SwiGLU,
                     dropout, gelu_exact)

__all__ = ["EvaBlock", "ResidualAttentionBlock", "Transformer", "text_global_pool"]


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x += ls_1(drop(attn(ln_1(x)))); x += ls_2(drop(mlp(ln_2(x)))).
    `dropout` (the text tower's, MR-CLIP's --textdropout) drops each
    branch before its LayerScale in train mode, from the forward's
    `generator`."""

    def __init__(
        self,
        width: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        ls_init_value: Optional[float] = None,
        act: Callable = gelu_exact,
        is_causal: bool = False,
        attn_impl: str = "xla",
        ln_eps: float = 1e-5,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.is_causal = is_causal
        self.dropout = dropout
        self.ln_1 = LayerNorm(width, eps=ln_eps)
        self.attn = MultiHeadAttention(width, num_heads, attn_impl=attn_impl, dtype=dtype)
        self.ln_2 = LayerNorm(width, eps=ln_eps)
        self.mlp = MLP(width, int(width * mlp_ratio), act=act, dtype=dtype)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(width, ls_init_value)
            self.ls_2 = LayerScale(width, ls_init_value)
        else:
            self.ls_1 = self.ls_2 = nn.Identity()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        y = self.attn(self.ln_1(x), is_causal=self.is_causal)
        x = x + self.ls_1(dropout(y, rate, generator))
        return x + self.ls_2(dropout(self.mlp(self.ln_2(x)), rate, generator))


class EvaBlock(nn.Module):
    """The EVA02 pre-norm block in timm `eva.py` names (`norm1`, `attn`,
    `norm2`, `mlp`): the JAX package's `ResidualAttentionBlock` with
    `mlp_type='swiglu'`, `mlp_norm`, `attn_inner_norm`, `attn_zero_k_bias`
    and the rope table passed through: x += attn(norm1(x)); x +=
    mlp(norm2(x))."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float,
                 attn_impl: str = "xla", ln_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(width, eps=ln_eps)
        self.attn = EvaAttention(width, num_heads, attn_impl=attn_impl, ln_eps=ln_eps, dtype=dtype)
        self.norm2 = LayerNorm(width, eps=ln_eps)
        self.mlp = SwiGLU(width, int(width * mlp_ratio), ln_eps=ln_eps, dtype=dtype)

    def forward(self, x: torch.Tensor, rope: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rope=rope)
        return x + self.mlp(self.norm2(x))


class Transformer(nn.Module):
    """Stack of residual attention blocks (`resblocks.N` as in open_clip)."""

    def __init__(
        self,
        width: int,
        layers: int,
        heads: int,
        mlp_ratio: float = 4.0,
        ls_init_value: Optional[float] = None,
        act: Callable = gelu_exact,
        is_causal: bool = False,
        attn_impl: str = "xla",
        ln_eps: float = 1e-5,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.width = width
        self.layers = layers
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(
                width, heads, mlp_ratio, ls_init_value, act, is_causal,
                attn_impl, ln_eps, dtype, dropout,
            )
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, generator)
        return x


def text_global_pool(x: torch.Tensor, tokens: Optional[torch.Tensor] = None,
                     pool_type: str = "argmax"):
    """Pool a text sequence: 'argmax' takes the position of the highest token
    id (EOT has the largest id in the CLIP vocab); 'first'/'last' take fixed
    positions; 'none' is identity. Returns (pooled, tokens_out)."""
    if pool_type == "first":
        return x[:, 0], x[:, 1:]
    if pool_type == "last":
        return x[:, -1], x[:, :-1]
    if pool_type == "argmax":
        if tokens is None:
            raise ValueError("argmax pooling needs the tokens")
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot], x
    return x, x
