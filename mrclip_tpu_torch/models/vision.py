"""ViT image encoders of the port (counterparts of
`mrclip_tpu/models/vision.py::VisionTransformer`): the plain open_clip ViT
(patchify, CLS, learnable position embedding, ln_pre, transformer, `tok`
pool, ln_post, proj) and the EVA02 tower (`EvaVisionTransformer`).

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
from .layers import LayerNorm, Linear, gelu_exact
from .transformer import EvaBlock, Transformer

__all__ = ["EvaVisionTransformer", "VisionTransformer"]


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


class VisionTransformer(nn.Module):
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
    ):
        super().__init__()
        self.image_size = to_2tuple(image_size)
        self.patch_size = to_2tuple(patch_size)
        self.grid_size = (
            self.image_size[0] // self.patch_size[0],
            self.image_size[1] // self.patch_size[1],
        )
        self.width = width
        self.compute_dtype = dtype
        ph, pw = self.patch_size
        self.conv1 = nn.Conv2d(3, width, (ph, pw), stride=(ph, pw), bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        n_pos = self.grid_size[0] * self.grid_size[1] + 1
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, width))
        self.ln_pre = LayerNorm(width, eps=ln_eps)
        self.transformer = Transformer(
            width, layers, heads, mlp_ratio, ls_init_value, act,
            is_causal=False, attn_impl=attn_impl, ln_eps=ln_eps, dtype=dtype,
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
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x)
        pooled = x[:, 0]
        if self.proj is not None:
            pooled = pooled @ self.proj.to(pooled.dtype)
        return pooled


class EvaVisionTransformer(nn.Module):
    """The EVA02-B/L image encoder (the JAX package's `VisionTransformer`
    as `_build_timm_vit_tower` configures it for `eva02_{base,large}_*`):
    patchify with bias, CLS, learned absolute position embedding, no
    ln_pre, pre-norm `EvaBlock`s with the axial 2D rope on q and k
    (`rope_cat_2d`, identity on the CLS row), final norm, `tok` pool and a
    bias-free linear head.

    Parameter names are those of open_clip's timm-wrapped tower, as
    `mrclip_tpu.hub.export_torch_state_dict` writes them:
    `trunk.{cls_token [1,1,W], pos_embed [1,N,W], patch_embed.proj,
    blocks.N, norm}` and `head.proj`.

    The rope table is built once, at construction, in the form the
    attention takes it (`ops.fused_attn.rope_table`): in the compute type
    for the kernels of 'fusedp', in fp32 for 'xla'. It is a buffer outside
    the state dict, so it follows the module's device.
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
    ):
        super().__init__()
        self.image_size = to_2tuple(image_size)
        self.patch_size = to_2tuple(patch_size)
        self.grid_size = (
            self.image_size[0] // self.patch_size[0],
            self.image_size[1] // self.patch_size[1],
        )
        self.width = width
        self.compute_dtype = dtype
        gh, gw = self.grid_size
        # plain containers, so the parameters carry timm's names
        self.trunk = nn.Module()
        self.trunk.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.trunk.pos_embed = nn.Parameter(torch.zeros(1, gh * gw + 1, width))
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.proj = nn.Conv2d(3, width, self.patch_size, stride=self.patch_size)
        self.trunk.blocks = nn.ModuleList(
            EvaBlock(width, heads, mlp_ratio, attn_impl=attn_impl, ln_eps=ln_eps, dtype=dtype)
            for _ in range(layers)
        )
        self.trunk.norm = LayerNorm(width, eps=ln_eps)
        self.head = nn.Module()
        self.head.proj = Linear(width, output_dim, bias=False, dtype=dtype)
        rope = rope_cat_2d(width // heads, gh, gw, ref_feat_shape=rope_ref_feat_shape)
        table_dtype = dtype if attn_impl == "fusedp" else torch.float32
        self.register_buffer("rope", rope_table(rope, 1, table_dtype), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """`images`: [B, H, W, 3] float (already normalized) -> [B, output_dim]."""
        dt = self.compute_dtype
        trunk = self.trunk
        x = _patch_embed(images, trunk.patch_embed.proj, self.grid_size, dt)
        cls = trunk.cls_token.to(dt).expand(x.shape[0], 1, self.width)
        x = torch.cat([cls, x], dim=1) + trunk.pos_embed.to(dt)
        for block in trunk.blocks:
            x = block(x, rope=self.rope)
        x = trunk.norm(x)
        return self.head.proj(x[:, 0])
