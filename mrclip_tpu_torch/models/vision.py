"""ViT image encoders of the port (counterparts of
`mrclip_tpu/models/vision.py::VisionTransformer`): the plain open_clip ViT
(patchify, CLS, learnable position embedding, ln_pre unless `no_ln_pre`,
transformer, `tok` or `avg` pool with ln_post before or after it, proj),
the EVA towers (`EvaVisionTransformer`: EVA02-B/L/E, EVA01-g) and the
SigLIP tower (`SiglipVisionTransformer`: no CLS, the MAP pool, timm's
names).

Images are NHWC `[B, H, W, 3]` float, already normalized, as in the JAX
package. Patchify is the JAX package's reshape plus one matmul; the weight
is held in the conv layout `[W, 3, p, p]` (`visual.conv1.weight`,
`visual.trunk.patch_embed.proj.weight`) and flattened in the JAX
`(ph, pw, c)` order at use.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.fused_attn import rope_table
from ..ops.pos_embed import rope_cat_2d
from ..utils import to_2tuple
from .layers import ROPE_IN_COMPUTE_DTYPE, LayerNorm, Linear, MAPHead, gelu_exact
from .transformer import (EvaBlock, EvaFusedBlock, TimmBlock, Transformer, _check_policy,
                          remat_call)

__all__ = ["EvaVisionTransformer", "SiglipVisionTransformer", "VisionTransformer"]


def _patch_embed(images: torch.Tensor, conv: nn.Conv2d, grid_size, dt) -> torch.Tensor:
    """[B, H, W, 3] -> [B, gh*gw, W]: the stride-p conv `conv` as the JAX
    package's reshape plus one matmul (and its bias, if it has one)."""
    ph, pw = conv.kernel_size
    gh, gw = grid_size
    b = images.shape[0]
    x = images.to(dt)
    if x.shape[1] != gh * ph or x.shape[2] != gw * pw:
        # a stride-p VALID conv drops the trailing remainder pixels
        x = x[:, : gh * ph, : gw * pw, :]
    x = x.reshape(b, gh, ph, gw, pw, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, ph * pw * 3)
    # [W, 3, ph, pw] -> [ph, pw, 3, W] -> [ph*pw*3, W]: the JAX kernel order
    x = x @ conv.weight.permute(2, 3, 1, 0).reshape(ph * pw * 3, -1).to(dt)
    return x if conv.bias is None else x + conv.bias.to(dt)


def _grid(image_size, patch_size):
    image_size, patch_size = to_2tuple(image_size), to_2tuple(patch_size)
    return image_size, patch_size, (image_size[0] // patch_size[0],
                                    image_size[1] // patch_size[1])


class VisionTransformer(nn.Module):
    """The open_clip ViT. `no_ln_pre` leaves out ln_pre (CLIPA); `pool_type`
    'tok' takes the CLS row, 'avg' the mean of the patch rows; ln_post
    comes before the pool, or after it with `final_ln_after_pool`, as in
    the JAX package."""

    def __init__(
        self,
        image_size=224,
        patch_size=16,
        width: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp_ratio: float = 4.0,
        ls_init_value: Optional[float] = None,
        output_dim: Optional[int] = 512,
        act: Callable = gelu_exact,
        ln_eps: float = 1e-5,
        attn_impl: str = "xla",
        dtype: torch.dtype = torch.float32,
        remat: Optional[str] = None,
        no_ln_pre: bool = False,
        pool_type: str = "tok",
        final_ln_after_pool: bool = False,
    ):
        super().__init__()
        if pool_type not in ("tok", "avg"):
            raise ValueError(f"pool_type={pool_type!r} is not 'tok' or 'avg'")
        self.pool_type = pool_type
        self.final_ln_after_pool = final_ln_after_pool
        self.image_size, self.patch_size, self.grid_size = _grid(image_size, patch_size)
        self.width = width
        self.compute_dtype = dtype
        ph, pw = self.patch_size
        self.conv1 = nn.Conv2d(3, width, (ph, pw), stride=(ph, pw), bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        n_pos = self.grid_size[0] * self.grid_size[1] + 1
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, width))
        self.ln_pre = None if no_ln_pre else LayerNorm(width, eps=ln_eps)
        self.transformer = Transformer(
            width, layers, heads, mlp_ratio, ls_init_value, act,
            is_causal=False, attn_impl=attn_impl, ln_eps=ln_eps, dtype=dtype, remat=remat,
        )
        self.ln_post = LayerNorm(width, eps=ln_eps)
        self.proj = (
            nn.Parameter(torch.zeros(width, output_dim)) if output_dim is not None else None
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """`images`: [B, H, W, 3] float (already normalized) -> [B, output_dim]."""
        dt = self.compute_dtype
        b = images.shape[0]
        x = _patch_embed(images, self.conv1, self.grid_size, dt)
        cls = self.class_embedding.to(dt).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(dt)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        x = self.transformer(x)
        if not self.final_ln_after_pool:
            x = self.ln_post(x)
        pooled = x[:, 1:].mean(dim=1) if self.pool_type == "avg" else x[:, 0]
        if self.final_ln_after_pool:
            pooled = self.ln_post(pooled)
        if self.proj is not None:
            pooled = pooled @ self.proj.to(pooled.dtype)
        return pooled


class EvaVisionTransformer(nn.Module):
    """The EVA image encoders (the JAX package's `VisionTransformer` as
    `_build_timm_vit_tower` configures it for `eva02_*` and `eva_giant_*`):
    patchify with bias, CLS, learned absolute position embedding, no
    ln_pre, the blocks, final norm, `tok` pool and a bias-free linear head.
    EVA02-B/L: pre-norm `EvaBlock`s with the axial 2D rope on q and k
    (`rope_cat_2d`, identity on the CLS row). With `qkv_fused` (EVA02-E,
    EVA01-g): `EvaFusedBlock`s with the GELU MLP `act` and no rope,
    post-norm with `post_norm` (EVA02-E), else pre-norm (EVA01-g).

    Parameter names are those of open_clip's timm-wrapped tower, as
    `mrclip_tpu.hub.export_torch_state_dict` writes them:
    `trunk.{cls_token [1,1,W], pos_embed [1,N,W], patch_embed.proj,
    blocks.N, norm}` and `head.proj`.

    The rope table is built once, at construction, in the form the
    attention takes it (`ops.fused_attn.rope_table`): in the compute type
    where q and k rotate in it ('bf16', 'flash', 'fused', and the kernels of
    'fusedp'), in fp32 for 'xla' and 'manual', as the JAX package casts it.
    It is a buffer outside the state dict, so it follows the module's
    device; None without rope. `remat` (a `REMAT_POLICIES` name) remats
    each block.
    """

    def __init__(
        self,
        image_size=224,
        patch_size=16,
        width: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp_ratio: float = 4 * 2 / 3,
        output_dim: int = 512,
        rope_ref_feat_shape=(16, 16),
        ln_eps: float = 1e-6,
        attn_impl: str = "xla",
        dtype: torch.dtype = torch.float32,
        remat: Optional[str] = None,
        qkv_fused: bool = False,
        post_norm: bool = False,
        act: Callable = gelu_exact,
    ):
        super().__init__()
        _check_policy(remat)
        self.image_size, self.patch_size, self.grid_size = _grid(image_size, patch_size)
        self.width = width
        self.compute_dtype = dtype
        self.remat = remat
        gh, gw = self.grid_size
        # plain containers, so the parameters carry timm's names
        self.trunk = nn.Module()
        self.trunk.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.trunk.pos_embed = nn.Parameter(torch.zeros(1, gh * gw + 1, width))
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.proj = nn.Conv2d(3, width, self.patch_size, stride=self.patch_size)
        if qkv_fused:
            blocks = (EvaFusedBlock(width, heads, mlp_ratio, post_norm=post_norm, act=act,
                                    attn_impl=attn_impl, ln_eps=ln_eps, dtype=dtype)
                      for _ in range(layers))
        else:
            blocks = (EvaBlock(width, heads, mlp_ratio, attn_impl=attn_impl, ln_eps=ln_eps,
                               dtype=dtype) for _ in range(layers))
        self.trunk.blocks = nn.ModuleList(blocks)
        self.trunk.norm = LayerNorm(width, eps=ln_eps)
        self.head = nn.Module()
        self.head.proj = Linear(width, output_dim, bias=False, dtype=dtype)
        table = None
        if not qkv_fused:
            rope = rope_cat_2d(width // heads, gh, gw, ref_feat_shape=rope_ref_feat_shape)
            table_dtype = dtype if attn_impl in ROPE_IN_COMPUTE_DTYPE else torch.float32
            table = rope_table(rope, 1, table_dtype)
        self.register_buffer("rope", table, persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """`images`: [B, H, W, 3] float (already normalized) -> [B, output_dim]."""
        dt = self.compute_dtype
        trunk = self.trunk
        x = _patch_embed(images, trunk.patch_embed.proj, self.grid_size, dt)
        cls = trunk.cls_token.to(dt).expand(x.shape[0], 1, self.width)
        x = torch.cat([cls, x], dim=1) + trunk.pos_embed.to(dt)
        for block in trunk.blocks:
            if self.remat is None:
                x = block(x, self.rope)
            else:
                x = remat_call(block, x, self.rope, policy=self.remat)
        x = trunk.norm(x)
        return self.head.proj(x[:, 0])


class SiglipVisionTransformer(nn.Module):
    """The SigLIP image encoder (the JAX package's `VisionTransformer` as
    `_build_timm_vit_tower` configures it for `vit_*_patch*_siglip_*` with
    the released configs' `timm_pool='map'`, `timm_proj='none'`): patchify
    with bias, a learned position embedding and no CLS token, no ln_pre,
    pre-norm `TimmBlock`s, the final norm, then the MAP head; no
    projection, so the output is `width` wide.

    Parameter names are those of open_clip's timm-wrapped tower:
    `trunk.{patch_embed.proj, pos_embed [1, N, W], blocks.N, norm,
    attn_pool}`. `remat` (a `REMAT_POLICIES` name) remats each block.
    """

    def __init__(
        self,
        image_size=224,
        patch_size=16,
        width: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp_ratio: float = 4.0,
        act: Callable = gelu_exact,
        ln_eps: float = 1e-6,
        attn_impl: str = "xla",
        dtype: torch.dtype = torch.float32,
        remat: Optional[str] = None,
    ):
        super().__init__()
        _check_policy(remat)
        self.image_size, self.patch_size, self.grid_size = _grid(image_size, patch_size)
        self.width = width
        self.compute_dtype = dtype
        self.remat = remat
        gh, gw = self.grid_size
        # plain containers, so the parameters carry timm's names
        self.trunk = nn.Module()
        self.trunk.pos_embed = nn.Parameter(torch.zeros(1, gh * gw, width))
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.proj = nn.Conv2d(3, width, self.patch_size, stride=self.patch_size)
        self.trunk.blocks = nn.ModuleList(
            TimmBlock(width, heads, mlp_ratio, act=act, attn_impl=attn_impl, ln_eps=ln_eps,
                      dtype=dtype)
            for _ in range(layers)
        )
        self.trunk.norm = LayerNorm(width, eps=ln_eps)
        self.trunk.attn_pool = MAPHead(width, heads, mlp_ratio, act=act, ln_eps=ln_eps,
                                       dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """`images`: [B, H, W, 3] float (already normalized) -> [B, width]."""
        trunk = self.trunk
        x = _patch_embed(images, trunk.patch_embed.proj, self.grid_size, self.compute_dtype)
        x = x + trunk.pos_embed.to(x.dtype)
        for block in trunk.blocks:
            x = block(x) if self.remat is None else remat_call(block, x, policy=self.remat)
        return trunk.attn_pool(trunk.norm(x))
