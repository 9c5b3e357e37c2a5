"""Text tower of the port (counterpart of
`mrclip_tpu/models/text.py::TextTransformer`): token embedding, position
embedding, causal transformer, ln_final, argmax-EOT pool, text_projection.

`encode_tokens` is the forward pass over any module that holds those five
parts. `TextTransformer` uses it on itself; `CLIP` inlines the parts at its
root, as open_clip's CLIP does, so their state-dict keys are open_clip's
(`token_embedding.weight`, `transformer.resblocks.N...`, `text_projection`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .layers import LayerNorm, gelu_exact
from .transformer import Transformer, text_global_pool

__all__ = ["TextTransformer", "encode_tokens"]


class TextTransformer(nn.Module):
    def __init__(
        self,
        context_length: int = 98,
        vocab_size: int = 49408,
        width: int = 512,
        heads: int = 8,
        layers: int = 12,
        mlp_ratio: float = 4.0,
        ls_init_value: Optional[float] = None,
        output_dim: Optional[int] = 512,
        act: Callable = gelu_exact,
        ln_eps: float = 1e-5,
        attn_impl: str = "xla",
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.context_length = context_length
        self.compute_dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = Transformer(
            width, layers, heads, mlp_ratio, ls_init_value, act,
            is_causal=True, attn_impl=attn_impl, ln_eps=ln_eps, dtype=dtype, dropout=dropout,
        )
        self.ln_final = LayerNorm(width, eps=ln_eps)
        self.text_projection = (
            nn.Parameter(torch.zeros(width, output_dim)) if output_dim is not None else None
        )

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return encode_tokens(self, tokens, generator)


def encode_tokens(tower: nn.Module, tokens: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`tokens`: [B, L] int token ids, zero-padded after EOT -> [B, output_dim].
    `generator`: the source of the blocks' dropout masks in train mode."""
    dt = tower.compute_dtype
    seq_len = tokens.shape[1]
    x = tower.token_embedding(tokens.long()).to(dt)
    x = x + tower.positional_embedding[:seq_len].to(dt)
    x = tower.transformer(x, generator)
    x = tower.ln_final(x)
    pooled, _ = text_global_pool(x, tokens, "argmax")
    if tower.text_projection is not None:
        pooled = pooled @ tower.text_projection.to(pooled.dtype)
    return pooled
