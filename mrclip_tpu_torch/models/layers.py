"""Core blocks of the port (counterpart of `mrclip_tpu/models/layers.py`).

Precision follows the JAX package: parameters stay fp32 and each layer
computes in `dtype`. A dense layer casts its weight (and bias) to `dtype` at
use, as `flax.linen.Dense(dtype=...)` does; LayerNorm takes its statistics in
fp32 and returns the input's type. Parameter names are open_clip's (timm
`eva.py`'s for the EVA02 parts: `EvaAttention`, `SwiGLU`), so an open_clip
state dict loads with `strict=True`.
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
    "SwiGLU",
    "MultiHeadAttention",
    "EvaAttention",
    "apply_rope_cat",
    "ATTN_IMPLS",
]

# 'xla' = plain softmax math under ordinary autograd (the JAX package's
# jax.nn.dot_product_attention path, same rounding order, rope rotated
# outside in fp32); 'fusedp' = the packed Hopper kernels, forward (K1, or K2
# with rope) and backward (K3, or K3r).
ATTN_IMPLS = ("xla", "fusedp")


def _check_attn_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} is not ported; the port has {ATTN_IMPLS} "
            "(ROADMAP: 'fused' with K4, 'flash' with K10, 'manual'/'bf16' "
            "with the other configs)"
        )


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


class SwiGLU(nn.Module):
    """The EVA02 FFN, split-gate layout with sub-LN (the JAX package's
    `SwiGLU(use_norm=True, fused_gate=False)`, timm `layers/mlp.py`):
    fc2(norm(silu(fc1_g(x)) * fc1_x(x)))."""

    def __init__(self, width: int, hidden: int, ln_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1_g = Linear(width, hidden, dtype=dtype)
        self.fc1_x = Linear(width, hidden, dtype=dtype)
        self.norm = LayerNorm(hidden, eps=ln_eps)
        self.fc2 = Linear(hidden, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.norm(F.silu(self.fc1_g(x)) * self.fc1_x(x)))


def apply_rope_cat(t: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """Rotate q or k by a concatenated sin||cos rope table, in fp32 (the JAX
    package's `apply_rope_cat` with `compute_dtype=None`, the out-of-kernel
    rope of the 'xla' path): `t` [B, N, H, hd]; `rope` [N, 2*hd], the table
    of `ops.fused_attn.rope_table` with its identity rows (sin 0, cos 1)
    over the prefix (CLS) tokens, which so pass through unchanged.
    y = x * cos + rot(x) * sin, cast back to t's type."""
    sin, cos = rope.float().chunk(2, dim=-1)  # [N, hd]
    x = t.float()
    rot = torch.stack((-x[..., 1::2], x[..., 0::2]), dim=-1).flatten(-2)
    # broadcast [N, hd] over [B, N, H, hd]
    return (x * cos[None, :, None, :] + rot * sin[None, :, None, :]).to(t.dtype)


def _attend(qkv: torch.Tensor, heads: int, attn_impl: str, is_causal: bool,
            rope: torch.Tensor | None) -> torch.Tensor:
    """Attention over the three column slices of one `[B, N, 3W]` projection
    -> `[B, N, W]`. `rope` is the `[N, 2D]` sin||cos table with identity
    prefix rows (`ops.fused_attn.rope_table`): in the compute type for
    'fusedp', whose kernels rotate q and k inside; in fp32 for 'xla', which
    rotates them first with `apply_rope_cat`."""
    if attn_impl == "fusedp":
        # The kernels read the column slices of the [B, N, 3W] projection
        # uncopied, and the backward writes its gradient in one piece.
        return fused_attention_qkv(qkv, heads=heads, is_causal=is_causal, rope=rope)
    q, k, v = qkv.chunk(3, dim=-1)
    if rope is not None:
        q, k = (apply_rope_cat(t.unflatten(-1, (heads, -1)), rope).flatten(-2)
                for t in (q, k))
    out, _ = fused_attention_packed_ref(q, k, v, is_causal=is_causal, heads=heads)
    return out


class MultiHeadAttention(nn.Module):
    """Self-attention with the fused in_proj (torch MHA's parameter layout:
    `in_proj_weight` [3W, W], `in_proj_bias`, `out_proj`)."""

    def __init__(self, width: int, num_heads: int, attn_impl: str = "xla",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_attn_impl(attn_impl)
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
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        return self.out_proj(_attend(qkv, self.num_heads, self.attn_impl, is_causal, None))


class EvaAttention(nn.Module):
    """EVA02 self-attention in timm `eva.py` parameter names: `q_proj`,
    `k_proj` (no bias), `v_proj`, the sub-LN `norm` over the merged heads
    and `proj`. The JAX package's `MultiHeadAttention` with `zero_k_bias`
    (`ZeroKBiasQKV`), `inner_norm` and `rope`: one `[B, N, 3W]` projection
    with the bias `[bq, 0, bv]` (the k bias is no parameter at all, so it
    cannot drift), attention over its column slices, q and k rotated by the
    rope table (`_attend`), LayerNorm, then `proj`."""

    def __init__(self, width: int, num_heads: int, attn_impl: str = "xla",
                 ln_eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_attn_impl(attn_impl)
        if width % num_heads:
            raise ValueError(f"width {width} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.compute_dtype = dtype
        self.q_proj = Linear(width, width, dtype=dtype)
        self.k_proj = Linear(width, width, bias=False, dtype=dtype)
        self.v_proj = Linear(width, width, dtype=dtype)
        self.norm = LayerNorm(width, eps=ln_eps)
        self.proj = Linear(width, width, dtype=dtype)

    def qkv(self, x: torch.Tensor) -> torch.Tensor:
        """The `ZeroKBiasQKV` projection: one F.linear over the concatenated
        weights (each cast to the compute type) with the bias [bq, 0, bv]."""
        dt = self.compute_dtype
        weight = torch.cat([m.weight.to(dt) for m in (self.q_proj, self.k_proj, self.v_proj)])
        bq, bv = self.q_proj.bias.to(dt), self.v_proj.bias.to(dt)
        return F.linear(x.to(dt), weight, torch.cat([bq, torch.zeros_like(bq), bv]))

    def forward(self, x: torch.Tensor, *, rope: torch.Tensor | None = None) -> torch.Tensor:
        out = _attend(self.qkv(x), self.num_heads, self.attn_impl, False, rope)
        return self.proj(self.norm(out))
