"""Core blocks of the port (counterpart of `mrclip_tpu/models/layers.py`).

Precision follows the JAX package: parameters stay fp32 and each layer
computes in `dtype`. A dense layer casts its weight (and bias) to `dtype` at
use, as `flax.linen.Dense(dtype=...)` does; LayerNorm takes its statistics in
fp32 and returns the input's type. Parameter names are open_clip's (timm
`eva.py`'s for the EVA parts: `EvaAttention`, `SwiGLU`), so an open_clip
state dict loads with `strict=True`. `DepthwiseConv` keeps the JAX package's
`kernel`/`bias` pair as the `weight [C, 1, K, K]` / `bias` of a depthwise
`Conv2d`.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dw_conv import dw_conv
from ..ops.flash_attn import flash_attention_unpadded
from ..ops.fused_attn import fused_attention, fused_attention_packed_ref, fused_attention_qkv

__all__ = [
    "DepthwiseConv",
    "LayerNorm",
    "Linear",
    "gelu_exact",
    "gelu_tanh",
    "quick_gelu",
    "LayerScale",
    "MLP",
    "dropout",
    "SwiGLU",
    "MultiHeadAttention",
    "EvaAttention",
    "MAPHead",
    "TimmAttention",
    "TimmMlp",
    "apply_rope_cat",
    "attn_out_saved",
    "ATTN_IMPLS",
    "ROPE_IN_COMPUTE_DTYPE",
]

# The JAX package's six attention options (its `MultiHeadAttention`):
# 'xla' = plain softmax math under ordinary autograd (the
#   jax.nn.dot_product_attention path, same rounding order);
# 'manual' = fp32 logits and softmax, probs cast to the compute type before
#   P V; 'bf16' = logits in the compute type, softmax upcast to fp32, probs
#   cast back (both plain PyTorch: the JAX package leaves them to XLA);
# 'fused' = the grouped-layout Hopper kernels K4 (forward) and K5 (backward);
# 'flash' = the flash Hopper kernels K10 (forward) and K10b (backward);
# 'fusedp' = the packed Hopper kernels, forward (K1, or K2 with rope) and
#   backward (K3, or K3r).
# A rope rotates q and k outside the kernels in fp32 under 'xla' and
# 'manual', in the compute type under 'bf16', 'flash' and 'fused', and
# inside K2/K3r under 'fusedp'.
ATTN_IMPLS = ("xla", "manual", "bf16", "flash", "fused", "fusedp")
# the options that rotate (and so build the rope table) in the compute type
ROPE_IN_COMPUTE_DTYPE = ("bf16", "flash", "fused", "fusedp")


class _Marker:
    """A context whose `depth` is non-zero inside it."""

    depth = 0

    def __enter__(self):
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1


# Marks the attention branch's last projection, the JAX package's
# `checkpoint_name(y, "attn_out")`: the 'mlp_only' remat policy keeps its
# output (models/transformer.py).
attn_out_saved = _Marker()


def _check_attn_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r} is not one of {ATTN_IMPLS}")


class DepthwiseConv(nn.Module):
    """Stride-1 SAME depthwise convolution over NHWC activations (the JAX
    package's `DepthwiseConv`): `weight [C, 1, K, K]`, `bias [C]`, computing
    in `dtype`.

    The implementation is `impl`, kept on the module; without one, the JAX
    package's environment switch `MRCLIP_DW_IMPL`, read when the module is
    built: 'pallas' runs the Hopper kernels K8/K9 (`ops.dw_conv`, the weight
    as an fp32 `[K*K, C]` table, fp32 accumulation); any other value, and
    the default, is 'xla', a grouped `F.conv2d` with the weight cast to the
    compute type, as `conv_general_dilated` computes it. The bias is added
    after either, in the compute type."""

    def __init__(self, features: int, kernel_size: int, dtype: torch.dtype = torch.float32,
                 impl: str | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, 1, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = dtype
        if impl is None:
            impl = os.environ.get("MRCLIP_DW_IMPL", "xla")
        self.impl = "pallas" if impl == "pallas" else "xla"

    def extra_repr(self) -> str:
        c, _, k, _ = self.weight.shape
        return f"{c}, kernel_size={k}, impl={self.impl!r}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.impl == "pallas":
            y = dw_conv(x.to(dt), self.weight)
        else:
            c, _, k, _ = self.weight.shape
            y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), padding=k // 2,
                         groups=c).permute(0, 2, 3, 1)
        return y + self.bias.to(y.dtype)


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


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `nn.Dropout(rate)` in train mode: keep each element with
    probability 1 - rate, scaled by 1 / (1 - rate), else 0. The mask is
    drawn from `generator` (on x's device), never from the global RNG, so
    the same generator state gives the same mask."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs the step's torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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


class TimmMlp(nn.Module):
    """timm's `Mlp` (`fc1` -> act -> `fc2`): `MLP` in timm's names."""

    def __init__(self, width: int, hidden: int, act: Callable = gelu_exact,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(width, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, width, dtype=dtype)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


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


def apply_rope_cat(t: torch.Tensor, rope: torch.Tensor,
                   compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Rotate q or k by a concatenated sin||cos rope table (the JAX
    package's `apply_rope_cat`): `t` [B, N, H, hd]; `rope` [N, 2*hd], the
    table of `ops.fused_attn.rope_table` with its identity rows (sin 0, cos
    1) over the prefix (CLS) tokens, which so pass through unchanged.
    y = x * cos + rot(x) * sin in fp32 (`compute_dtype=None`, the rotation
    of 'xla' and 'manual') or in `compute_dtype` (that of 'bf16', 'flash'
    and 'fused'), each product and sum rounded in that type; cast back to
    t's type."""
    rdt = torch.float32 if compute_dtype is None else compute_dtype
    sin, cos = rope.to(rdt).chunk(2, dim=-1)  # [N, hd]
    x = t.to(rdt)
    rot = torch.stack((-x[..., 1::2], x[..., 0::2]), dim=-1).flatten(-2)
    # broadcast [N, hd] over [B, N, H, hd]
    return (x * cos[None, :, None, :] + rot * sin[None, :, None, :]).to(t.dtype)


def _score_attention(q, k, v, is_causal: bool, score_dtype: torch.dtype) -> torch.Tensor:
    """'manual' (`score_dtype` fp32) and 'bf16' (`score_dtype` the compute
    type), the JAX package's explicit-softmax paths (layers.py:507-532): q,
    k, v [B, L, H, D]; logits q k^T in `score_dtype`, scaled in it, causal
    pairs set to -inf, softmax in fp32, probs cast to the compute type
    before P V. Returns [B, N, H, D]."""
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, D]
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=score_dtype)
    logits = qh.to(score_dtype) @ kh.to(score_dtype).transpose(-1, -2) * scale.to(q.device)
    if is_causal:
        n, nk = logits.shape[-2:]
        above = torch.ones(n, nk, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(above, -math.inf)
    probs = torch.softmax(logits.float(), dim=-1).to(dt)
    return (probs @ vh).transpose(1, 2)


def _attend(qkv: torch.Tensor, heads: int, attn_impl: str, is_causal: bool,
            rope: torch.Tensor | None) -> torch.Tensor:
    """Attention over the three column slices of one `[B, N, 3W]` projection
    -> `[B, N, W]`. `rope` is the `[N, 2D]` sin||cos table with identity
    prefix rows (`ops.fused_attn.rope_table`), in the compute type where the
    rotation runs in it (`ROPE_IN_COMPUTE_DTYPE`: 'fusedp', whose kernels
    rotate q and k inside, 'bf16', 'flash' and 'fused'), in fp32 for 'xla'
    and 'manual'."""
    if attn_impl == "fusedp":
        # The kernels read the column slices of the [B, N, 3W] projection
        # uncopied, and the backward writes its gradient in one piece.
        return fused_attention_qkv(qkv, heads=heads, is_causal=is_causal, rope=rope)
    q, k, v = (t.unflatten(-1, (heads, -1)) for t in qkv.chunk(3, dim=-1))  # [B, N, H, D]
    if rope is not None:
        rdt = qkv.dtype if attn_impl in ROPE_IN_COMPUTE_DTYPE else None
        q, k = (apply_rope_cat(t, rope, compute_dtype=rdt) for t in (q, k))
    if attn_impl == "fused":
        out = fused_attention(q, k, v, is_causal=is_causal)
    elif attn_impl == "flash":
        out = flash_attention_unpadded(q, k, v, is_causal=is_causal)
    elif attn_impl in ("manual", "bf16"):
        out = _score_attention(q, k, v, is_causal,
                               torch.float32 if attn_impl == "manual" else qkv.dtype)
    else:
        out, _ = fused_attention_packed_ref(q, k, v, is_causal=is_causal)
    return out.flatten(-2)


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
        out = _attend(qkv, self.num_heads, self.attn_impl, is_causal, None)
        with attn_out_saved:
            return self.out_proj(out)


class EvaAttention(nn.Module):
    """EVA self-attention in timm `eva.py` parameter names. The JAX
    package's `MultiHeadAttention` with `zero_k_bias` (`ZeroKBiasQKV`): one
    `[B, N, 3W]` projection with the bias `[bq, 0, bv]` (the k bias is no
    parameter at all, so it cannot drift), attention over its column slices
    (`_attend`), then `proj`.

    EVA02-B/L (timm `qkv_fused=False`): `q_proj`, `k_proj` (no bias),
    `v_proj`, q and k rotated by the rope table, and the sub-LN `norm` over
    the merged heads before `proj` (JAX `inner_norm`). EVA02-E and EVA01-g
    (`qkv_fused=True`): one bias-free `qkv` weight [3W, W] beside the
    `q_bias` and `v_bias` parameters, no rope and no norm."""

    def __init__(self, width: int, num_heads: int, attn_impl: str = "xla",
                 ln_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 qkv_fused: bool = False):
        super().__init__()
        _check_attn_impl(attn_impl)
        if width % num_heads:
            raise ValueError(f"width {width} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.compute_dtype = dtype
        self.qkv_fused = qkv_fused
        if qkv_fused:
            self.qkv = Linear(width, 3 * width, bias=False, dtype=dtype)
            self.q_bias = nn.Parameter(torch.zeros(width))
            self.v_bias = nn.Parameter(torch.zeros(width))
            self.norm = None
        else:
            self.q_proj = Linear(width, width, dtype=dtype)
            self.k_proj = Linear(width, width, bias=False, dtype=dtype)
            self.v_proj = Linear(width, width, dtype=dtype)
            self.norm = LayerNorm(width, eps=ln_eps)
        self.proj = Linear(width, width, dtype=dtype)

    def project_qkv(self, x: torch.Tensor) -> torch.Tensor:
        """The `ZeroKBiasQKV` projection: one F.linear over the fused weight
        (or the split ones concatenated), cast to the compute type, with
        the bias [bq, 0, bv] put together once a call."""
        dt = self.compute_dtype
        if self.qkv_fused:
            weight, bq, bv = self.qkv.weight.to(dt), self.q_bias.to(dt), self.v_bias.to(dt)
        else:
            weight = torch.cat([m.weight.to(dt) for m in (self.q_proj, self.k_proj, self.v_proj)])
            bq, bv = self.q_proj.bias.to(dt), self.v_proj.bias.to(dt)
        return F.linear(x.to(dt), weight, torch.cat([bq, torch.zeros_like(bq), bv]))

    def forward(self, x: torch.Tensor, *, rope: torch.Tensor | None = None) -> torch.Tensor:
        out = _attend(self.project_qkv(x), self.num_heads, self.attn_impl, False, rope)
        if self.norm is not None:
            out = self.norm(out)
        with attn_out_saved:
            return self.proj(out)


class TimmAttention(nn.Module):
    """timm ViT self-attention (`qkv` [3W, W] with its bias, `proj`): the
    JAX package's `MultiHeadAttention` (`in_proj`, `out_proj`) in the names
    of open_clip's timm-wrapped SigLIP tower."""

    def __init__(self, width: int, num_heads: int, attn_impl: str = "xla",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_attn_impl(attn_impl)
        if width % num_heads:
            raise ValueError(f"width {width} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = Linear(width, 3 * width, dtype=dtype)
        self.proj = Linear(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor, *, is_causal: bool = False) -> torch.Tensor:
        out = _attend(self.qkv(x), self.num_heads, self.attn_impl, is_causal, None)
        with attn_out_saved:
            return self.proj(out)


class MAPHead(nn.Module):
    """timm's `AttentionPoolLatent`, SigLIP's "map" pool (the JAX package's
    `MAPHead`): one learned latent query attends over all tokens, then a
    residual MLP on the normed result:

        y = proj(softmax(q(latent) k(x)^T / sqrt(dh)) v(x));  y + mlp(norm(y))

    The scores are a product in the compute type, the softmax in fp32 and
    the probabilities cast back before the product with v, as JAX computes
    them: plain products, no attention kernel (one query a head). Names are
    timm's: `latent` [1, 1, W], `q`, `kv`, `proj`, `norm`, `mlp.fc1`/`fc2`."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 act: Callable = gelu_exact, ln_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.latent = nn.Parameter(torch.zeros(1, 1, width))
        self.q = Linear(width, width, dtype=dtype)
        self.kv = Linear(width, 2 * width, dtype=dtype)
        self.proj = Linear(width, width, dtype=dtype)
        self.norm = LayerNorm(width, eps=ln_eps)
        self.mlp = TimmMlp(width, int(width * mlp_ratio), act=act, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """`x`: [B, N, W] -> [B, W]."""
        b, n, w = x.shape
        h = self.num_heads
        q = self.q(self.latent.to(self.compute_dtype).expand(b, 1, w))
        k, v = self.kv(x).chunk(2, dim=-1)
        q = q.reshape(b, 1, h, -1).transpose(1, 2)  # [B, H, 1, dh]
        k, v = (t.reshape(b, n, h, -1).transpose(1, 2) for t in (k, v))  # [B, H, N, dh]
        scores = (q @ k.transpose(-1, -2)) * (w // h) ** -0.5
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        y = self.proj((probs @ v).transpose(1, 2).reshape(b, 1, w))
        y = y + self.mlp(self.norm(y))
        return y[:, 0]
