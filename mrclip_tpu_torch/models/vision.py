"""ViT image encoder of the port (counterpart of
`mrclip_tpu/models/vision.py::VisionTransformer`, plain open_clip ViT:
patchify, CLS, learnable position embedding, ln_pre, transformer, `tok`
pool, ln_post, proj).

Images are NHWC `[B, H, W, 3]` float, already normalized, as in the JAX
package. Patchify is the JAX package's reshape plus one matmul; the weight
is held in open_clip's conv layout `[W, 3, p, p]` (`visual.conv1.weight`)
and flattened in the JAX `(ph, pw, c)` order at use.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..utils import to_2tuple
from .layers import LayerNorm, gelu_exact
from .transformer import Transformer

__all__ = ["VisionTransformer"]


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
        ph, pw = self.patch_size
        gh, gw = self.grid_size
        b = images.shape[0]
        x = images.to(dt)
        if x.shape[1] != gh * ph or x.shape[2] != gw * pw:
            # a stride-p VALID conv drops the trailing remainder pixels
            x = x[:, : gh * ph, : gw * pw, :]
        x = x.reshape(b, gh, ph, gw, pw, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, ph * pw * 3)
        # [W, 3, ph, pw] -> [ph, pw, 3, W] -> [ph*pw*3, W]: the JAX kernel order
        w = self.conv1.weight.permute(2, 3, 1, 0).reshape(ph * pw * 3, self.width)
        x = x @ w.to(dt)

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
