"""Transformer stack of the port (counterpart of
`mrclip_tpu/models/transformer.py`): pre-LN residual blocks, unrolled, the
EVA02-B/L block (`EvaBlock`: SwiGLU with sub-LN, inner attention LN, rope)
and the EVA02-E / EVA01-g block (`EvaFusedBlock`: fused qkv, GELU MLP,
post-norm or pre-norm).

Per-block remat (the JAX package's `remat`, open_clip's
`grad_checkpointing`) is `remat_call`: `torch.utils.checkpoint` without
reentrance, under the JAX package's three policies (`REMAT_POLICIES`).
The JAX package's `scan_layers` is a compile-time choice of XLA with no
counterpart here; cross-attention blocks belong to towers not ported yet
(ROADMAP: modules item 5).
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .layers import (MLP, EvaAttention, LayerNorm, LayerScale, MultiHeadAttention, SwiGLU,
                     TimmAttention, TimmMlp, attn_out_saved, dropout, gelu_exact)

__all__ = ["EvaBlock", "EvaFusedBlock", "REMAT_POLICIES", "ResidualAttentionBlock", "TimmBlock",
           "Transformer", "remat_call", "running_stats", "text_global_pool"]

# The JAX package's policies (models/transformer.py REMAT_POLICIES):
# 'full' recomputes the whole block in the backward; 'dots' keeps the
# products with a weight (no batch dimension: `mm`, `addmm`) and recomputes
# the rest, attention included; 'mlp_only' keeps only the attention
# branch's output (its last projection, where `layers.attn_out_saved` marks
# it: JAX's `attn_out` tag) and recomputes the rest. The attention kernels
# write outputs the dispatcher sees only as `empty`, which no policy keeps:
# the recompute runs their autograd Function again and launches them again.
REMAT_POLICIES = ("full", "dots", "mlp_only")
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in _WEIGHT_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _keep_attn_out(ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in _WEIGHT_PRODUCTS and attn_out_saved.depth
            else CheckpointPolicy.PREFER_RECOMPUTE)


_POLICY_FNS = {"dots": _keep_dots, "mlp_only": _keep_attn_out}


def _check_policy(policy: Optional[str]) -> None:
    if policy is not None and policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} is not one of {REMAT_POLICIES}")


def running_stats(module: nn.Module) -> list:
    """(buffer, copy) of every BatchNorm running statistic under `module`."""
    return [(b, b.clone()) for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm) for b in m.buffers()]


@contextlib.contextmanager
def _as_in_forward(module: nn.Module, generator: Optional[torch.Generator], snapshot):
    """The recompute sees what the forward saw: the generator at its
    state before the block (so dropout draws the same masks), and BatchNorm
    running statistics that the recompute's train-mode forward does not move
    a second time. Both come back as they were after."""
    now = generator.get_state() if generator is not None else None
    stats = running_stats(module)
    if generator is not None:
        generator.set_state(snapshot)
    try:
        yield
    finally:
        if generator is not None:
            generator.set_state(now)
        with torch.no_grad():
            for b, saved in stats:
                b.copy_(saved)


def remat_call(module: nn.Module, *args, policy: str = "full",
               generator: Optional[torch.Generator] = None):
    """`module(*args)` with its activations recomputed in the backward
    (`torch.utils.checkpoint`, no reentrance) under `policy`; a plain call
    where no gradient is recorded. `generator`, the source of the module's
    dropout masks, is passed in `args` too: an explicit generator is no part
    of the global RNG state that checkpointing preserves, so its state is
    taken here and set again for the recompute."""
    if not torch.is_grad_enabled():
        return module(*args)
    snapshot = generator.get_state() if generator is not None else None
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return module(*a)
        with _as_in_forward(module, generator, snapshot):
            return module(*a)

    kw = {}
    if policy != "full":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, _POLICY_FNS[policy])
    return checkpoint(run, *args, use_reentrant=False, **kw)


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


class EvaFusedBlock(nn.Module):
    """The EVA02-E and EVA01-g block in timm `eva.py` names (`norm1`,
    `attn` with the fused `qkv` and `q_bias`/`v_bias`, `norm2`, `mlp.fc1`,
    `mlp.fc2`): the JAX package's `ResidualAttentionBlock` with
    `attn_zero_k_bias`, a plain MLP and no rope. Pre-norm (EVA01-g, timm
    `EvaBlock`): x += attn(norm1(x)); x += mlp(norm2(x)). With `post_norm`
    (EVA02-E, timm `EvaBlockPostNorm`) the branch output is normed before
    it is added: x += norm1(attn(x)); x += norm2(mlp(x)). The 'mlp_only'
    remat policy keeps the attention's projection, before `norm1`, where
    JAX tags `attn_out`."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float, post_norm: bool = False,
                 act: Callable = gelu_exact, attn_impl: str = "xla", ln_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.post_norm = post_norm
        self.norm1 = LayerNorm(width, eps=ln_eps)
        self.attn = EvaAttention(width, num_heads, attn_impl=attn_impl, dtype=dtype,
                                 qkv_fused=True)
        self.norm2 = LayerNorm(width, eps=ln_eps)
        self.mlp = TimmMlp(width, int(width * mlp_ratio), act=act, dtype=dtype)

    def forward(self, x: torch.Tensor, rope: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.post_norm:
            x = x + self.norm1(self.attn(x, rope=rope))
            return x + self.norm2(self.mlp(x))
        x = x + self.attn(self.norm1(x), rope=rope)
        return x + self.mlp(self.norm2(x))


class TimmBlock(nn.Module):
    """timm's ViT `Block` (`norm1`, `attn.qkv`, `attn.proj`, `norm2`,
    `mlp.fc1`, `mlp.fc2`), the SigLIP tower's: the JAX package's
    `ResidualAttentionBlock` without LayerScale or dropout. x += attn(norm1(x));
    x += mlp(norm2(x))."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float, act: Callable = gelu_exact,
                 attn_impl: str = "xla", ln_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(width, eps=ln_eps)
        self.attn = TimmAttention(width, num_heads, attn_impl=attn_impl, dtype=dtype)
        self.norm2 = LayerNorm(width, eps=ln_eps)
        self.mlp = TimmMlp(width, int(width * mlp_ratio), act=act, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Transformer(nn.Module):
    """Stack of residual attention blocks (`resblocks.N` as in open_clip);
    each block remat'd under `remat` (a `REMAT_POLICIES` name) if given."""

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
        remat: Optional[str] = None,
    ):
        super().__init__()
        _check_policy(remat)
        self.width = width
        self.layers = layers
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(
                width, heads, mlp_ratio, ls_init_value, act, is_causal,
                attn_impl, ln_eps, dtype, dropout,
            )
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.resblocks:
            if self.remat is None:
                x = block(x, generator)
            else:
                x = remat_call(block, x, generator, policy=self.remat, generator=generator)
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
