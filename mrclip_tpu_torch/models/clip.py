"""CLIP assembly of the port (counterpart of `mrclip_tpu/models/clip.py`):
the plain ViT, the EVA02-B/L or the FastViT/MCi (MobileCLIP-S1/S2) tower and
the causal text tower, L2-normalized embeddings and a learned temperature.

Attribute names follow open_clip's CLIP, whose text tower is inlined at the
root, so the state dict that `mrclip_tpu.hub.export_torch_state_dict` writes
(and an open_clip `.pt` of the same model) loads with `strict=True`.
Configuration options of towers outside this slice raise
`NotImplementedError` naming the ROADMAP slice that will port them.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .fastvit import FASTVIT_DIMS, FastViT
from .layers import gelu_exact, gelu_tanh, quick_gelu
from .text import TextTransformer, encode_tokens
from .vision import EvaVisionTransformer, VisionTransformer

__all__ = ["CLIP", "CLIPVisionCfg", "CLIPTextCfg", "build_vision_tower", "build_text_tower"]


def _select_act(quick_gelu_act):
    """True/'quick' -> QuickGELU, 'tanh' -> tanh-approx GELU, else erf GELU."""
    if quick_gelu_act is True or quick_gelu_act == "quick":
        return quick_gelu
    if quick_gelu_act == "tanh":
        return gelu_tanh
    return gelu_exact


def _resolve_act_norm(act_sel, act_kwargs, norm_kwargs, what):
    """Config-level act/norm kwargs (GELU approximate='tanh', LN eps), as the
    JAX package resolves them. Returns (act, ln_eps)."""
    act = _select_act(act_sel)
    if act_kwargs and not (act_sel is True or act_sel in ("quick", "tanh")):
        unknown = set(act_kwargs) - {"approximate"}
        if unknown:
            raise NotImplementedError(f"unsupported {what} act_kwargs keys: {sorted(unknown)}")
        approx = act_kwargs.get("approximate", "none")
        if approx == "tanh":
            act = gelu_tanh
        elif approx not in ("none", None):
            raise NotImplementedError(f"unsupported GELU approximate={approx!r}")
    ln_eps = 1e-5
    if norm_kwargs:
        unknown = set(norm_kwargs) - {"eps"}
        if unknown:
            raise NotImplementedError(f"unsupported {what} norm_kwargs keys: {sorted(unknown)}")
        ln_eps = float(norm_kwargs["eps"])
    return act, ln_eps


@dataclass
class CLIPVisionCfg:
    """Vision tower config (the JAX package's fields, so one JSON fits both)."""

    layers: Union[Tuple[int, int, int, int], int] = 12
    width: int = 768
    head_width: int = 64
    mlp_ratio: float = 4.0
    patch_size: int = 16
    image_size: Union[int, Tuple[int, int]] = 224
    ls_init_value: Optional[float] = None
    patch_dropout: float = 0.0
    attentional_pool: bool = False
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    no_ln_pre: bool = False
    pos_embed_type: str = "learnable"
    final_ln_after_pool: bool = False
    pool_type: str = "tok"
    output_tokens: bool = False
    act_kwargs: Optional[dict] = None
    norm_kwargs: Optional[dict] = None
    mlp_fused_gate: bool = False
    timm_model_name: Optional[str] = None
    timm_model_pretrained: bool = False
    timm_pool: str = "avg"
    timm_proj: str = "linear"
    timm_proj_bias: bool = False
    timm_drop: float = 0.0
    timm_drop_path: Optional[float] = None
    timm_deploy_import: bool = False


@dataclass
class CLIPTextCfg:
    """Text tower config (the JAX package's fields)."""

    context_length: int = 98
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    embed_cls: bool = False
    pad_id: Optional[int] = None
    dropout: float = 0.0
    no_causal_mask: bool = False
    final_ln_after_pool: bool = False
    pool_type: str = "argmax"
    proj_bias: bool = False
    output_tokens: bool = False
    act_kwargs: Optional[dict] = None
    norm_kwargs: Optional[dict] = None
    hf_model_name: Optional[str] = None
    hf_model_pretrained: bool = True
    hf_tokenizer_name: Optional[str] = None
    hf_proj_type: str = "mlp"
    hf_pooler_type: str = "mean_pooler"
    hf_model_config: Optional[dict] = None


def _filter_cfg(cfg_cls, d):
    if isinstance(d, cfg_cls):
        return d
    names = {f.name for f in dataclasses.fields(cfg_cls)}
    return cfg_cls(**{k: v for k, v in dict(d).items() if k in names})


def _reject(unsupported: dict, what: str, roadmap: str) -> None:
    for name, bad in unsupported.items():
        if bad:
            raise NotImplementedError(f"{what}: {name} is not ported yet (ROADMAP: {roadmap})")


_EVA02 = re.compile(r"eva02_(base|large|enormous)_patch(\d+)(?:_plus)?_clip_(224|336)$")
_EVA02_DIMS = {"base": (768, 12, 12), "large": (1024, 24, 16)}  # width, layers, heads


def _build_eva02_tower(embed_dim: int, cfg: CLIPVisionCfg, dtype: torch.dtype,
                       attn_impl: str) -> EvaVisionTransformer:
    """The EVA02-B/L tower of the JAX package's `_build_timm_vit_tower`
    (`eva02_{base,large}_patch*_clip_{224,336}`): SwiGLU hidden
    int(width * 8/3) with sub-LN, inner attention LN, zero k bias, axial 2D
    rope on the (16, 16) pretraining grid, LN eps 1e-6."""
    m = _EVA02.match(cfg.timm_model_name)
    _reject({
        "EVA02-E (eva02_enormous: post-norm blocks, no rope)": m.group(1) == "enormous",
        "the fused SwiGLU gate (mlp_fused_gate)": cfg.mlp_fused_gate,
        "drop path (timm_drop_path)": cfg.timm_drop_path,
        # JAX rejects it too: rope indexes patches by grid position
        "patch dropout with rope": cfg.patch_dropout > 0,
        f"timm_proj={cfg.timm_proj!r} (linear only)": cfg.timm_proj != "linear",
        "timm_proj_bias": cfg.timm_proj_bias,
    }, "EVA02 tower", "later slice 2, other configs")
    if cfg.timm_pool not in ("token", "tok", ""):
        raise NotImplementedError(
            f"timm_pool={cfg.timm_pool!r} unsupported for EVA02 (token pooling only)")
    width, layers, heads = _EVA02_DIMS[m.group(1)]
    return EvaVisionTransformer(
        image_size=cfg.image_size or int(m.group(3)),
        patch_size=int(m.group(2)),
        width=width,
        layers=layers,
        heads=heads,
        mlp_ratio=4 * 2 / 3,
        output_dim=embed_dim,
        rope_ref_feat_shape=(16, 16),
        ln_eps=1e-6,
        attn_impl=attn_impl,
        dtype=dtype,
    )


def _build_fastvit_tower(embed_dim: int, cfg: CLIPVisionCfg, act, dtype: torch.dtype,
                        attn_impl: str, dw_impl: Optional[str]) -> FastViT:
    """The MobileCLIP tower of the JAX package's `_build_timm_vit_tower`
    (`fastvit_mci{0,1,2}`) in its from-scratch form (`norm='ln'`,
    `stem='2conv'`)."""
    name = cfg.timm_model_name
    _reject({
        "MobileCLIP-B's hybrid ViT tower (vit_base_mci_224)": name == "vit_base_mci_224",
        "the Apple-checkpoint import form (timm_deploy_import: norm='affine', stem='3conv')":
            cfg.timm_deploy_import,
        "output_tokens": cfg.output_tokens,
    }, "MobileCLIP tower", "later slice 4, other towers")
    if name not in FASTVIT_DIMS:
        raise NotImplementedError(
            f"timm fastvit variant '{name}' has no stage table; supported: "
            f"{sorted(FASTVIT_DIMS)} (MobileCLIP MCi)")
    depths, dims, mlp_ratio = FASTVIT_DIMS[name]
    return FastViT(
        image_size=cfg.image_size or 256,
        depths=depths,
        dims=dims,
        mlp_ratio=mlp_ratio,
        output_dim=None if cfg.timm_proj == "none" else embed_dim,
        act=act,
        attn_impl=attn_impl,
        dtype=dtype,
        dw_impl=dw_impl,
    )


def build_vision_tower(embed_dim: int, vision_cfg, quick_gelu_act=False,
                       dtype: torch.dtype = torch.float32,
                       attn_impl: str = "xla", dw_impl: Optional[str] = None):
    """The plain open_clip ViT, the EVA02-B/L or the FastViT/MCi tower
    (its depthwise convolutions on `dw_impl`; without one, MRCLIP_DW_IMPL
    decides); other vision towers raise."""
    cfg = _filter_cfg(CLIPVisionCfg, vision_cfg)
    act, ln_eps = _resolve_act_norm(quick_gelu_act, cfg.act_kwargs, cfg.norm_kwargs, "vision")
    if cfg.timm_model_name and _EVA02.match(cfg.timm_model_name):
        return _build_eva02_tower(embed_dim, cfg, dtype, attn_impl)  # SwiGLU: no act
    if cfg.timm_model_name and (cfg.timm_model_name.startswith("fastvit_")
                                or cfg.timm_model_name == "vit_base_mci_224"):
        return _build_fastvit_tower(embed_dim, cfg, act, dtype, attn_impl, dw_impl)
    _reject({
        f"timm tower {cfg.timm_model_name!r}": cfg.timm_model_name,
        "the ModifiedResNet tower": isinstance(cfg.layers, (tuple, list)),
    }, "vision tower", "later slice 4, other towers")
    _reject({
        "patch dropout": cfg.patch_dropout > 0,
        "attentional pooling": cfg.attentional_pool,
        "no_ln_pre": cfg.no_ln_pre,
        f"pos_embed_type={cfg.pos_embed_type!r}": cfg.pos_embed_type != "learnable",
        "final_ln_after_pool": cfg.final_ln_after_pool,
        f"pool_type={cfg.pool_type!r}": cfg.pool_type != "tok",
        "output_tokens": cfg.output_tokens,
    }, "vision tower", "later slice 2, other configs")
    return VisionTransformer(
        image_size=cfg.image_size,
        patch_size=cfg.patch_size,
        width=cfg.width,
        layers=cfg.layers,
        heads=cfg.width // cfg.head_width,
        mlp_ratio=cfg.mlp_ratio,
        ls_init_value=cfg.ls_init_value,
        output_dim=embed_dim,
        act=act,
        ln_eps=ln_eps,
        attn_impl=attn_impl,
        dtype=dtype,
    )


def build_text_tower(embed_dim: int, text_cfg, quick_gelu_act=False,
                     dtype: torch.dtype = torch.float32,
                     attn_impl: str = "xla") -> TextTransformer:
    """The causal open_clip text transformer; other text towers raise."""
    cfg = _filter_cfg(CLIPTextCfg, text_cfg)
    _reject({f"HF text tower {cfg.hf_model_name!r}": cfg.hf_model_name},
            "text tower", "later slice 4, other towers")
    _reject({
        "embed_cls (CoCa)": cfg.embed_cls,
        "no_causal_mask": cfg.no_causal_mask,
        f"pool_type={cfg.pool_type!r}": cfg.pool_type != "argmax",
        "proj_bias": cfg.proj_bias,
        "final_ln_after_pool": cfg.final_ln_after_pool,
        "output_tokens": cfg.output_tokens,
    }, "text tower", "later slice 2, other configs")
    act, ln_eps = _resolve_act_norm(quick_gelu_act, cfg.act_kwargs, cfg.norm_kwargs, "text")
    return TextTransformer(
        context_length=cfg.context_length,
        vocab_size=cfg.vocab_size,
        width=cfg.width,
        heads=cfg.heads,
        layers=cfg.layers,
        mlp_ratio=cfg.mlp_ratio,
        ls_init_value=cfg.ls_init_value,
        output_dim=embed_dim,
        act=act,
        ln_eps=ln_eps,
        attn_impl=attn_impl,
        dtype=dtype,
        dropout=cfg.dropout,
    )


class CLIP(nn.Module):
    """Dual-tower CLIP producing L2-normalized embeddings + logit scale.

    `logit_scale_trainable=False` is MR-CLIP's frozen temperature: the
    scale is fixed at ln 10 whatever `init_logit_scale` says (the JAX
    package's constant, the reference's `torch.ones(lshape) * np.log(10)`),
    held as a non-persistent buffer, so it is in neither the state dict nor
    the trained parameters."""

    def __init__(
        self,
        embed_dim: int = 512,
        vision_cfg: Any = None,
        text_cfg: Any = None,
        quick_gelu: bool = False,
        act_impl: str = "erf",
        init_logit_scale: float = math.log(1 / 0.07),
        init_logit_bias: Optional[float] = None,
        attn_impl: str = "xla",
        dtype: torch.dtype = torch.float32,
        dw_impl: Optional[str] = None,
        logit_scale_trainable: bool = True,
    ):
        super().__init__()
        act = True if quick_gelu else act_impl
        self.compute_dtype = dtype
        self.visual = build_vision_tower(
            embed_dim, vision_cfg or CLIPVisionCfg(), act, dtype, attn_impl, dw_impl
        )
        # open_clip inlines the text tower's parts at the root of CLIP
        text = build_text_tower(embed_dim, text_cfg or CLIPTextCfg(), act, dtype, attn_impl)
        self.context_length = text.context_length
        self.token_embedding = text.token_embedding
        self.positional_embedding = text.positional_embedding
        self.transformer = text.transformer
        self.ln_final = text.ln_final
        self.text_projection = text.text_projection
        if logit_scale_trainable:
            self.logit_scale = nn.Parameter(torch.tensor(float(init_logit_scale)))
        else:
            self.register_buffer("logit_scale", torch.tensor(math.log(10.0)), persistent=False)
        self.logit_bias = (
            nn.Parameter(torch.tensor(float(init_logit_bias)))
            if init_logit_bias is not None else None
        )

    def encode_image(self, images: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        feats = self.visual(images)
        return F.normalize(feats, dim=-1, eps=0.0) if normalize else feats

    def encode_text(self, tokens: torch.Tensor, normalize: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator`: the source of the text dropout's masks in train mode."""
        feats = encode_tokens(self, tokens, generator)
        return F.normalize(feats, dim=-1, eps=0.0) if normalize else feats

    def get_logits(self, images: torch.Tensor, tokens: torch.Tensor):
        """(logits_per_image, logits_per_text) at the current temperature."""
        img = self.encode_image(images, normalize=True).float()
        txt = self.encode_text(tokens, normalize=True).float()
        logits_per_image = self.logit_scale.exp() * img @ txt.T
        if self.logit_bias is not None:
            logits_per_image = logits_per_image + self.logit_bias
        return logits_per_image, logits_per_image.T

    def forward(self, images: Optional[torch.Tensor] = None,
                tokens: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> dict:
        """`generator`: the step's source of randomness (the text dropout's
        masks in train mode), as the JAX package's `dropout` rng."""
        out = {}
        if images is not None:
            out["image_features"] = self.encode_image(images, normalize=True)
        if tokens is not None:
            out["text_features"] = self.encode_text(tokens, normalize=True, generator=generator)
        out["logit_scale"] = self.logit_scale.exp()
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out
