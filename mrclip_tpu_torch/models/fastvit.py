"""The MobileCLIP-S1/S2 image tower of the port (counterpart of
`mrclip_tpu/models/fastvit.py::FastViT`): FastViT/MCi in its
reparameterised (deploy) form, NHWC, as the JAX package's factory builds it
from scratch (`norm='ln'`, `stem='2conv'`):

  stem     two stride-2 conv3x3 + act                          (1/4 res)
  stage i  RepMixer blocks (i < 3): x += scale * dw3x3(x);
           x += fc2(act(fc1(LN(dw7x7(x)))))
           separated by dw7x7/s2 + LN + pw1x1 downsamples
  stage 3  dw7x7/s2 downsample, x += dw7x7(x) (the conditional position
           embedding), pre-LN transformer over the flattened 1/32 tokens
  head     pw expand -> act -> global average -> LN -> proj

Activations stay NHWC as in the JAX package; a `Conv2d` sees them through a
`permute`d view. Every stride-1 depthwise convolution (the blocks' mixer
and FFN convolutions and the position embedding: 73 in MCi1) is a
`DepthwiseConv`, so `MRCLIP_DW_IMPL=pallas` puts it on the Hopper kernels
K8/K9; the stem and the stride-2 downsamples stay `F.conv2d`, as the JAX
package leaves them to XLA.

Parameter names are the JAX tree's (`stem_conv1`, `stage0_block0.mixer_dw`,
`.mixer_scale`, `.ffn.conv_dw`, `.ffn.norm`, `.ffn.fc1`, `downsample1`,
`pos_emb_dw`, `head_conv`, `head_norm`, `proj`), with the attention stage
as open_clip's `transformer.resblocks.N`. No public open_clip or timm
layout holds this deploy form (timm's `fastvit_mci1` carries the
reparameterisation branches and BatchNorm), so the port's rule of open_clip
names gives way here. The Apple-checkpoint import form (`norm='affine'`,
`stem='3conv'`), MobileCLIP-B's hybrid ViT, `output_tokens` and remat are
not ported (ROADMAP: later slice 4, other towers).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import to_2tuple
from .layers import DepthwiseConv, LayerNorm, Linear, gelu_exact
from .transformer import Transformer

__all__ = ["FASTVIT_DIMS", "Conv2d", "FastViT", "RepMixerBlock"]

# (stage depths, stage dims, mlp_ratio), as in the JAX package
FASTVIT_DIMS = {
    "fastvit_mci0": ((2, 6, 10, 2), (64, 128, 256, 512), 3.0),
    "fastvit_mci1": ((4, 12, 20, 4), (64, 128, 256, 512), 3.0),
    "fastvit_mci2": ((4, 12, 24, 4), (80, 160, 320, 640), 3.0),
}


class Conv2d(nn.Conv2d):
    """A convolution over NHWC activations computing in `dtype` over fp32
    parameters, as `flax.linen.Conv(dtype=...)`: input and weight cast to
    `dtype`, the bias added after the convolution in `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         groups=groups)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), None, self.stride,
                     self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1) + self.bias.to(dt)


class ConvFFN(nn.Module):
    """dw7x7 -> LN -> 1x1 expand -> act -> 1x1 project (`_ConvFFN`); the
    caller adds the residual."""

    def __init__(self, dim: int, mlp_ratio: float = 3.0, act: Callable = gelu_exact,
                 dtype: torch.dtype = torch.float32, dw_impl: Optional[str] = None):
        super().__init__()
        self.conv_dw = DepthwiseConv(dim, 7, dtype=dtype, impl=dw_impl)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.fc1 = Linear(dim, int(dim * mlp_ratio), dtype=dtype)
        self.fc2 = Linear(int(dim * mlp_ratio), dim, dtype=dtype)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(self.norm(self.conv_dw(x)))))


class RepMixerBlock(nn.Module):
    """Deploy-form RepMixer: x += mixer_scale * dw3x3(x); x += ffn(x)."""

    def __init__(self, dim: int, mlp_ratio: float = 3.0, act: Callable = gelu_exact,
                 dtype: torch.dtype = torch.float32, dw_impl: Optional[str] = None):
        super().__init__()
        self.mixer_dw = DepthwiseConv(dim, 3, dtype=dtype, impl=dw_impl)
        self.mixer_scale = nn.Parameter(torch.ones(dim))
        self.ffn = ConvFFN(dim, mlp_ratio, act, dtype, dw_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.mixer_dw(x) * self.mixer_scale.to(x.dtype)
        return x + self.ffn(x)


class PatchDownsample(nn.Module):
    """dw7x7/s2 -> LN -> pw1x1 into the next stage's width (`_PatchDownsample`)."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_dw = Conv2d(in_dim, in_dim, 7, stride=2, padding=3, groups=in_dim, dtype=dtype)
        self.norm = LayerNorm(in_dim, eps=1e-6)
        self.conv_pw = Linear(in_dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_pw(self.norm(self.conv_dw(x)))


class FastViT(nn.Module):
    """MCi image encoder (MobileCLIP S1/S2): [B, H, W, 3] normalised images
    -> [B, output_dim] pooled embedding."""

    def __init__(
        self,
        image_size=256,
        depths: Sequence[int] = (4, 12, 20, 4),
        dims: Sequence[int] = (64, 128, 256, 512),
        mlp_ratio: float = 3.0,
        output_dim: Optional[int] = 512,
        head_expand: float = 2.0,
        act: Callable = gelu_exact,
        attn_impl: str = "xla",
        dtype: torch.dtype = torch.float32,
        dw_impl: Optional[str] = None,
    ):
        super().__init__()
        self.image_size = to_2tuple(image_size)
        if any(s % 32 for s in self.image_size):
            raise ValueError(f"image_size {image_size} not divisible by 32")
        self.width = dims[3]
        self.depths = tuple(depths)
        self.act = act
        c = dims
        self.stem_conv1 = Conv2d(3, c[0], 3, stride=2, padding=1, dtype=dtype)
        self.stem_conv2 = Conv2d(c[0], c[0], 3, stride=2, padding=1, dtype=dtype)
        for s in range(3):
            if s > 0:
                setattr(self, f"downsample{s}", PatchDownsample(c[s - 1], c[s], dtype))
            for i in range(depths[s]):
                setattr(self, f"stage{s}_block{i}",
                        RepMixerBlock(c[s], mlp_ratio, act, dtype, dw_impl))
        self.downsample3 = PatchDownsample(c[2], c[3], dtype)
        self.pos_emb_dw = DepthwiseConv(c[3], 7, dtype=dtype, impl=dw_impl)
        self.transformer = Transformer(
            c[3], depths[3], max(1, c[3] // 64), mlp_ratio, None, act,
            is_causal=False, attn_impl=attn_impl, ln_eps=1e-6, dtype=dtype,
        )
        hidden = int(c[3] * head_expand)
        self.head_conv = Linear(c[3], hidden, dtype=dtype)
        self.head_norm = LayerNorm(hidden, eps=1e-6)
        self.proj = nn.Parameter(torch.zeros(hidden, output_dim)) if output_dim is not None else None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.act(self.stem_conv1(images))
        x = self.act(self.stem_conv2(x))
        for s in range(3):
            if s > 0:
                x = getattr(self, f"downsample{s}")(x)
            for i in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{i}")(x)
        x = self.downsample3(x)
        x = x + self.pos_emb_dw(x)  # RepCPE
        b, h, w, c = x.shape
        tokens = self.act(self.head_conv(self.transformer(x.reshape(b, h * w, c))))
        pooled = self.head_norm(tokens.mean(dim=1))
        if self.proj is not None:
            pooled = pooled @ self.proj.to(pooled.dtype)
        return pooled
