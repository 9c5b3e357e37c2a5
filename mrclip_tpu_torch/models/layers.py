"""Core blocks of the port (counterpart of `mrclip_tpu/models/layers.py`).

Precision follows the JAX package: parameters stay fp32 and each layer
computes in `dtype`. A dense layer casts its weight (and bias) to `dtype` at
use, as `flax.linen.Dense(dtype=...)` does; LayerNorm takes its statistics in
fp32 and returns the input's type. Parameter names are open_clip's, so an
open_clip state dict loads with `strict=True`.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_attn import fused_attention_packed_ref, fused_attention_qkv

__all__ = [
    "LayerNorm",
    "Linear",
    "gelu_exact",
    "gelu_tanh",
    "quick_gelu",
    "LayerScale",
    "MLP",
    "MultiHeadAttention",
    "ATTN_IMPLS",
]

# 'xla' = plain softmax math under ordinary autograd (the JAX package's
# jax.nn.dot_product_attention path, same rounding order); 'fusedp' = the
# packed Hopper kernels, forward (K1) and backward (K3).
ATTN_IMPLS = ("xla", "fusedp")


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics; output cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` over fp32 parameters."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP activation `x * sigmoid(1.702 x)`."""
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU (the --gelu-approx throughput mode)."""
    return F.gelu(x, approximate="tanh")


class LayerScale(nn.Module):
    """Learned per-channel residual scaling."""

    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class MLP(nn.Module):
    """Transformer MLP: c_fc -> act -> c_proj."""

    def __init__(self, width: int, hidden: int, act: Callable = gelu_exact,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c_fc = Linear(width, hidden, dtype=dtype)
        self.c_proj = Linear(hidden, width, dtype=dtype)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class MultiHeadAttention(nn.Module):
    """Self-attention with the fused in_proj (torch MHA's parameter layout:
    `in_proj_weight` [3W, W], `in_proj_bias`, `out_proj`)."""

    def __init__(self, width: int, num_heads: int, attn_impl: str = "xla",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} is not ported; the port has {ATTN_IMPLS} "
                "(ROADMAP: 'fused' with K4, 'flash' with K10, 'manual'/'bf16' "
                "with the other configs)"
            )
        if width % num_heads:
            raise ValueError(f"width {width} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor, *, is_causal: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        w = x.shape[-1]
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        if self.attn_impl == "fusedp":
            # The kernels read the column slices of the [B, N, 3W] projection
            # uncopied, and the backward writes its gradient in one piece.
            out = fused_attention_qkv(qkv, heads=self.num_heads, is_causal=is_causal)
        else:
            q, k, v = qkv[..., :w], qkv[..., w : 2 * w], qkv[..., 2 * w :]
            out, _ = fused_attention_packed_ref(q, k, v, is_causal=is_causal, heads=self.num_heads)
        return self.out_proj(out)
