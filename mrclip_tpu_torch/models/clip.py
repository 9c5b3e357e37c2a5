"""CLIP assembly of the port (counterpart of `mrclip_tpu/models/clip.py`):
the plain ViT (with CLIPA's options), the timm SigLIP ViT, the EVA (EVA02-B/L/E,
EVA01-g) or the FastViT/MCi (MobileCLIP-S1/S2) tower and the open_clip text tower
(causal or not, any pool, a projection with or without bias), L2-normalized
embeddings, a learned temperature and SigLIP's logit bias.

Attribute names follow open_clip's CLIP, whose text tower is inlined at the
root, so the state dict that `mrclip_tpu.hub.export_torch_state_dict` writes
(and an open_clip `.pt` of the same model; a CustomTextCLIP's `text.`
prefix is dropped on load) loads with `strict=True`. Configuration options
not ported yet raise `NotImplementedError` naming their ROADMAP item.
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
from .vision import EvaVisionTransformer, SiglipVisionTransformer, VisionTransformer

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


# The ROADMAP items (its "Still to port: modules") that refusals name
OTHER_CONFIGS = "modules item 4, the other configs"
OTHER_TOWERS = "modules item 5, the other towers"


def _reject(unsupported: dict, what: str, roadmap: str) -> None:
    for name, bad in unsupported.items():
        if bad:
            raise NotImplementedError(f"{what}: {name} is not ported yet (ROADMAP: {roadmap})")


_EVA02 = re.compile(r"eva02_(base|large|enormous)_patch(\d+)(?:_plus)?_clip_(224|336)$")
_EVA_GIANT = re.compile(r"eva_giant_patch14(?:_clip)?_(224|336)$")
# width, layers, heads: EVA02-B/L/E, and EVA01-g ("giant")
_EVA_DIMS = {"base": (768, 12, 12), "large": (1024, 24, 16), "enormous": (1792, 64, 16),
             "giant": (1408, 40, 16)}
_EVA_MLP_RATIO = {"enormous": 15360 / 1792, "giant": 6144 / 1408}  # else SwiGLU's 8/3


def _eva_tower(name: Optional[str]):
    """(size, patch, resolution) of an EVA tower name, or None."""
    if m := _EVA02.match(name or ""):
        return m.group(1), int(m.group(2)), int(m.group(3))
    if m := _EVA_GIANT.match(name or ""):
        return "giant", 14, int(m.group(1))
    return None


def _build_eva_tower(embed_dim: int, cfg: CLIPVisionCfg, act, dtype: torch.dtype,
                     attn_impl: str, remat: Optional[str]) -> EvaVisionTransformer:
    """The EVA towers of the JAX package's `_build_timm_vit_tower`, LN eps
    1e-6 and a zero k bias in all: EVA02-B/L (`eva02_{base,large}_patch*
    _clip_{224,336}`: SwiGLU hidden int(width * 8/3) with sub-LN, inner
    attention LN, axial 2D rope on the (16, 16) pretraining grid), EVA02-E
    (`eva02_enormous_*`: post-norm blocks, fused qkv, GELU MLP of 15360, no
    rope) and EVA01-g (`eva_giant_patch14_{224,336}`: pre-norm blocks, fused
    qkv, GELU MLP of 6144, no rope)."""
    size, patch, res = _eva_tower(cfg.timm_model_name)
    rope = size in ("base", "large")
    _reject({
        "the fused SwiGLU gate (mlp_fused_gate)": cfg.mlp_fused_gate and rope,
        "drop path (timm_drop_path)": cfg.timm_drop_path,
        # with rope JAX refuses it too: rope indexes patches by grid position
        "patch dropout": cfg.patch_dropout > 0,
        f"timm_proj={cfg.timm_proj!r} (linear only)": cfg.timm_proj != "linear",
        "timm_proj_bias": cfg.timm_proj_bias,
    }, "EVA tower", OTHER_CONFIGS)
    if cfg.timm_pool not in ("token", "tok", ""):
        raise NotImplementedError(
            f"timm_pool={cfg.timm_pool!r} unsupported for EVA (token pooling only)")
    width, layers, heads = _EVA_DIMS[size]
    return EvaVisionTransformer(
        image_size=cfg.image_size or res,
        patch_size=patch,
        width=width,
        layers=layers,
        heads=heads,
        mlp_ratio=_EVA_MLP_RATIO.get(size, 4 * 2 / 3),
        output_dim=embed_dim,
        rope_ref_feat_shape=(16, 16),
        ln_eps=1e-6,
        attn_impl=attn_impl,
        dtype=dtype,
        remat=remat,
        qkv_fused=not rope,
        post_norm=size == "enormous",
        act=act,
    )


def _build_fastvit_tower(embed_dim: int, cfg: CLIPVisionCfg, act, dtype: torch.dtype,
                        attn_impl: str, dw_impl: Optional[str], remat: Optional[str]) -> FastViT:
    """The MobileCLIP tower of the JAX package's `_build_timm_vit_tower`
    (`fastvit_mci{0,1,2}`) in its from-scratch form (`norm='ln'`,
    `stem='2conv'`)."""
    name = cfg.timm_model_name
    _reject({
        "MobileCLIP-B's hybrid ViT tower (vit_base_mci_224)": name == "vit_base_mci_224",
        "the Apple-checkpoint import form (timm_deploy_import: norm='affine', stem='3conv')":
            cfg.timm_deploy_import,
        "output_tokens": cfg.output_tokens,
    }, "MobileCLIP tower", OTHER_TOWERS)
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
        remat=remat,
    )


# timm's ViT sizes: width, layers, heads (the JAX package's table), and
# SigLIP's shape-optimized 400M MLP (hidden 4304)
_TIMM_VIT_DIMS = {
    "tiny": (192, 12, 3),
    "small": (384, 12, 6),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
    "huge": (1280, 32, 16),
    "so400m": (1152, 27, 16),
}
_TIMM_VIT_MLP_RATIO = {"so400m": 4304 / 1152}
_TIMM_VIT = re.compile(
    r"vit_(tiny|small|base|large|huge|so400m)_patch(\d+)((?:_[a-z0-9]+)*?)_(\d+)$")


def _build_siglip_tower(embed_dim: int, cfg: CLIPVisionCfg, act, dtype: torch.dtype,
                        attn_impl: str, remat: Optional[str]) -> SiglipVisionTransformer:
    """The SigLIP branch of the JAX package's `_build_timm_vit_tower`
    (`vit_{size}_patch{P}_siglip_{RES}`) as the released configs set it
    (`timm_pool='map'`, `timm_proj='none'`, so embed_dim == width): no CLS
    token, no ln_pre, the MAP pool, LN eps 1e-6, GELU with the tanh
    approximation unless the config asks for another activation."""
    m = _TIMM_VIT.match(cfg.timm_model_name)
    size, patch, res = m.group(1), int(m.group(2)), int(m.group(4))
    width, layers, heads = _TIMM_VIT_DIMS[size]
    _reject({
        f"timm_pool={cfg.timm_pool!r} (map only)": cfg.timm_pool not in ("map", ""),
        f"timm_proj={cfg.timm_proj!r} (none only)": cfg.timm_proj not in ("none", ""),
        "timm_proj_bias": cfg.timm_proj_bias,
        "drop path (timm_drop_path)": cfg.timm_drop_path,
    }, "SigLIP tower", OTHER_CONFIGS)
    if embed_dim != width:
        raise ValueError(f"SigLIP tower {cfg.timm_model_name!r} with timm_proj=none needs "
                         f"embed_dim == width ({width}), got {embed_dim}")
    return SiglipVisionTransformer(
        image_size=cfg.image_size or res,
        patch_size=patch,
        width=width,
        layers=layers,
        heads=heads,
        mlp_ratio=_TIMM_VIT_MLP_RATIO.get(size, 4.0),
        # timm's SigLIP definitions fix gelu_tanh (big_vision's GELU); only a
        # quick-GELU or act_kwargs override changes it
        act=gelu_tanh if act is gelu_exact else act,
        ln_eps=1e-6,
        attn_impl=attn_impl,
        dtype=dtype,
        remat=remat,
    )


def build_vision_tower(embed_dim: int, vision_cfg, quick_gelu_act=False,
                       dtype: torch.dtype = torch.float32,
                       attn_impl: str = "xla", dw_impl: Optional[str] = None,
                       remat: Optional[str] = None):
    """The plain open_clip ViT, the timm SigLIP ViT, an EVA tower or the
    FastViT/MCi tower (its depthwise convolutions on `dw_impl`; without one,
    MRCLIP_DW_IMPL decides), its blocks remat'd under the policy `remat` if
    given; other vision towers raise."""
    cfg = _filter_cfg(CLIPVisionCfg, vision_cfg)
    act, ln_eps = _resolve_act_norm(quick_gelu_act, cfg.act_kwargs, cfg.norm_kwargs, "vision")
    if _eva_tower(cfg.timm_model_name):  # SwiGLU (EVA02-B/L) takes no act
        return _build_eva_tower(embed_dim, cfg, act, dtype, attn_impl, remat)
    if cfg.timm_model_name and (cfg.timm_model_name.startswith("fastvit_")
                                or cfg.timm_model_name == "vit_base_mci_224"):
        return _build_fastvit_tower(embed_dim, cfg, act, dtype, attn_impl, dw_impl, remat)
    m = _TIMM_VIT.match(cfg.timm_model_name or "")
    if m and "_siglip" in m.group(3):
        return _build_siglip_tower(embed_dim, cfg, act, dtype, attn_impl, remat)
    _reject({
        f"timm tower {cfg.timm_model_name!r}": cfg.timm_model_name,
        "the ModifiedResNet tower": isinstance(cfg.layers, (tuple, list)),
    }, "vision tower", OTHER_TOWERS)
    _reject({
        "patch dropout": cfg.patch_dropout > 0,
        "attentional pooling": cfg.attentional_pool,
        f"pos_embed_type={cfg.pos_embed_type!r}": cfg.pos_embed_type != "learnable",
        f"pool_type={cfg.pool_type!r} (tok and avg are ported)":
            cfg.pool_type not in ("tok", "avg"),
        "output_tokens": cfg.output_tokens,
    }, "vision tower", OTHER_CONFIGS)
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
        remat=remat,
        no_ln_pre=cfg.no_ln_pre,
        pool_type=cfg.pool_type,
        final_ln_after_pool=cfg.final_ln_after_pool,
    )


def build_text_tower(embed_dim: int, text_cfg, quick_gelu_act=False,
                     dtype: torch.dtype = torch.float32,
                     attn_impl: str = "xla", remat: Optional[str] = None) -> TextTransformer:
    """The open_clip text transformer, causal unless `no_causal_mask`, with
    its pool and projection options (its blocks remat'd under the policy
    `remat` if given); other text towers raise."""
    cfg = _filter_cfg(CLIPTextCfg, text_cfg)
    _reject({f"HF text tower {cfg.hf_model_name!r}": cfg.hf_model_name},
            "text tower", OTHER_TOWERS)
    _reject({
        "embed_cls (CoCa)": cfg.embed_cls,
        "final_ln_after_pool": cfg.final_ln_after_pool,
        "output_tokens": cfg.output_tokens,
    }, "text tower", OTHER_CONFIGS)
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
        remat=remat,
        no_causal_mask=cfg.no_causal_mask,
        pool_type=cfg.pool_type,
        proj_bias=cfg.proj_bias,
    )


class CLIP(nn.Module):
    """Dual-tower CLIP producing L2-normalized embeddings + logit scale.

    `logit_scale_trainable=False` is MR-CLIP's frozen temperature: the
    scale is fixed at ln 10 whatever `init_logit_scale` says (the JAX
    package's constant, the reference's `torch.ones(lshape) * np.log(10)`),
    held as a non-persistent buffer, so it is in neither the state dict nor
    the trained parameters. `remat`, a `transformer.REMAT_POLICIES` name,
    recomputes each block of both towers in the backward (the JAX package's
    `remat` and `remat_policy`)."""

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
        remat: Optional[str] = None,
    ):
        super().__init__()
        act = True if quick_gelu else act_impl
        self.compute_dtype = dtype
        self.visual = build_vision_tower(
            embed_dim, vision_cfg or CLIPVisionCfg(), act, dtype, attn_impl, dw_impl, remat
        )
        # open_clip inlines the text tower's parts at the root of CLIP
        text = build_text_tower(embed_dim, text_cfg or CLIPTextCfg(), act, dtype, attn_impl,
                                remat)
        self.context_length = text.context_length
        self.text_pool_type = text.pool_type
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
        feats = encode_tokens(self, tokens, generator, self.text_pool_type)
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
