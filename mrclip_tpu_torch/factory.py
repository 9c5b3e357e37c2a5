"""Model factory and JSON config registry of the port (counterpart of
`mrclip_tpu/factory.py`: `list_models`, `get_model_config`,
`add_model_config`, `get_tokenizer`, `create_model`,
`create_model_and_transforms`, `create_loss`).

The registry scans the port's own `model_configs/` (byte-identical copies of
the JAX package's files). `create_model` returns a `CLIP` module on its
device, initialized at random from `rng_seed` or loaded from an
open_clip-layout state dict.
"""

from __future__ import annotations

import json
import math
import re
from copy import deepcopy
from functools import partial
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .losses.contrastive import (
    clip_loss,
    distill_clip_loss,
    multipositive_clip_loss,
    multipositive_clip_loss_vision_only,
    multipositive_clip_loss_with_distance,
    multipositive_clip_loss_with_vision,
    siglip_loss,
)
from .constants import DEFAULT_CONTEXT_LENGTH
from .models import CLIP
from .ops.fused_loss import chunked_multipositive_clip_loss
from .ops.pallas_loss import pallas_multipositive_clip_loss
from .tokenizer import SimpleTokenizer
from .transforms import PreprocessCfg, image_transform_v2, merge_preprocess_dict
from .utils import resolve_device

__all__ = [
    "list_models",
    "get_model_config",
    "add_model_config",
    "get_tokenizer",
    "create_model",
    "create_model_and_transforms",
    "create_loss",
    "model_from_config",
    "cast_dtype",
]

_MODEL_CONFIG_PATHS = [Path(__file__).parent / "model_configs/"]
# top-level config keys `create_model(**model_kwargs)` may override
_CFG_KEYS = ("embed_dim", "vision_cfg", "text_cfg", "quick_gelu", "init_logit_scale",
             "init_logit_bias")
_MODEL_CONFIGS: Dict[str, dict] = {}


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def _rescan_model_configs():
    global _MODEL_CONFIGS
    config_files = []
    for config_path in _MODEL_CONFIG_PATHS:
        if config_path.is_dir():
            config_files.extend(config_path.glob("*.json"))
        elif config_path.is_file() and config_path.suffix == ".json":
            config_files.append(config_path)
    for cf in config_files:
        with open(cf) as f:
            cfg = json.load(f)
        if all(k in cfg for k in ("embed_dim", "vision_cfg", "text_cfg")):
            _MODEL_CONFIGS[cf.stem] = cfg
    _MODEL_CONFIGS = dict(sorted(_MODEL_CONFIGS.items(), key=lambda x: _natural_key(x[0])))


_rescan_model_configs()


def list_models():
    """Registered model architectures."""
    return list(_MODEL_CONFIGS.keys())


def get_model_config(model_name: str) -> Optional[dict]:
    if model_name in _MODEL_CONFIGS:
        return deepcopy(_MODEL_CONFIGS[model_name])
    return None


def add_model_config(path) -> None:
    """Register model configs from a file or directory."""
    _MODEL_CONFIG_PATHS.append(Path(path))
    _rescan_model_configs()


def get_tokenizer(model_name: str = "", context_length: Optional[int] = None, **kwargs):
    """The model's tokenizer: the CLIP BPE tokenizer at the config's context
    length (default 98) with the config's `tokenizer_kwargs`; HF tokenizers
    raise."""
    text_config = (get_model_config(model_name) or {}).get("text_cfg", {})
    tokenizer_kwargs = dict(text_config.get("tokenizer_kwargs", {}), **kwargs)
    if context_length is None:
        context_length = text_config.get("context_length", DEFAULT_CONTEXT_LENGTH)
    if "hf_tokenizer_name" in text_config:
        raise NotImplementedError(
            "HF tokenizers are not ported (ROADMAP: modules item 5, the other towers)")
    return SimpleTokenizer(context_length=context_length, **tokenizer_kwargs)


def cast_dtype(precision: str) -> torch.dtype:
    """Compute dtype of a precision name; parameters stay fp32 either way."""
    if precision.startswith("pure_"):
        raise NotImplementedError(
            f"precision={precision!r} (low-precision weights) is not ported "
            "(ROADMAP: modules item 7, int8 and export)"
        )
    if precision in ("bf16", "amp_bf16", "amp_bfloat16", "fp16", "amp", "amp_fp16"):
        # as in the JAX package, fp16 requests map to bf16
        return torch.bfloat16
    return torch.float32


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


def _init_weights(model: CLIP, generator: torch.Generator) -> None:
    """Random init in the spirit of the JAX package's initializers: normal
    with std fan_in^-0.5 for projections and convolutions (lecun_normal),
    small normals for embeddings, unit LayerNorm and RepMixer scales, zero
    biases."""
    norm_scales = {f"{name}.weight" for name, m in model.named_modules()
                   if isinstance(m, torch.nn.LayerNorm)}
    for name, p in model.named_parameters():
        if name in ("logit_scale", "logit_bias"):
            continue  # keep the configured initial values
        if name.endswith("bias"):
            torch.nn.init.zeros_(p)
        elif name in norm_scales:
            torch.nn.init.ones_(p)
        elif name == "token_embedding.weight":
            _normal_(p, 0.02, generator)
        elif name == "positional_embedding":
            _normal_(p, 0.01, generator)
        elif name.endswith("mixer_scale"):
            torch.nn.init.ones_(p)
        elif name in ("visual.class_embedding", "visual.positional_embedding",
                      "visual.trunk.cls_token", "visual.trunk.pos_embed",
                      "visual.trunk.attn_pool.latent"):
            _normal_(p, model.visual.width ** -0.5, generator)
        elif p.dim() == 4:  # convolutions [out, in / groups, kh, kw]: fan_in = p[0].numel()
            _normal_(p, p[0].numel() ** -0.5, generator)
        elif name in ("visual.proj", "text_projection"):
            _normal_(p, p.shape[0] ** -0.5, generator)
        elif name.endswith("gamma"):
            continue  # LayerScale keeps its configured init value
        else:  # [out, in] projection weights
            _normal_(p, p.shape[1] ** -0.5, generator)


def model_from_config(
    cfg: dict, *, precision: str = "fp32", attn_impl: str = "xla", gelu_approx: bool = False,
    dw_impl: Optional[str] = None, logit_scale_trainable: bool = True,
    remat: Optional[str] = None,
) -> CLIP:
    """An uninitialized CLIP on the CPU for a resolved config dict, its
    depthwise convolutions (MobileCLIP) on `dw_impl` ('pallas' or 'xla';
    without one, MRCLIP_DW_IMPL decides), its temperature learned or, with
    `logit_scale_trainable=False`, fixed at ln 10, its blocks remat'd under
    the policy `remat` if given. The other arguments are kept on the module
    as `build_args`, from which `serving.export_model` writes what
    rebuilding it takes."""
    if "multimodal_cfg" in cfg:
        raise NotImplementedError("CoCa is not ported (ROADMAP: modules item 5, the other towers)")
    model = CLIP(
        embed_dim=cfg["embed_dim"],
        vision_cfg=cfg["vision_cfg"],
        text_cfg=cfg["text_cfg"],
        quick_gelu=cfg.get("quick_gelu", False),
        act_impl="tanh" if gelu_approx else "erf",
        init_logit_scale=cfg.get("init_logit_scale", math.log(1 / 0.07)),
        init_logit_bias=cfg.get("init_logit_bias"),
        attn_impl=attn_impl,
        dtype=cast_dtype(precision),
        dw_impl=dw_impl,
        logit_scale_trainable=logit_scale_trainable,
        remat=remat,
    )
    model.build_args = {
        "model_cfg": deepcopy(cfg),
        "precision": precision,
        "attn_impl": attn_impl,
        "gelu_approx": bool(gelu_approx),
        "logit_scale_trainable": bool(logit_scale_trainable),
    }
    return model


def _load_open_clip(path_or_sd) -> Dict[str, torch.Tensor]:
    """An open_clip state dict in the port's layout: unwrapped from
    "state_dict", without a DDP "module." prefix, and with a CustomTextCLIP's
    `text.` tower inlined at the root (as `mrclip_tpu.checkpoint` does)."""
    sd = path_or_sd
    if not isinstance(sd, dict):
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return {k.removeprefix("text."): v for k, v in sd.items()}


def create_model(
    model_name: str,
    pretrained: Optional[Union[str, dict]] = None,
    precision: str = "fp32",
    *,
    device=None,
    force_quick_gelu: bool = False,
    force_patch_dropout: Optional[float] = None,
    force_image_size: Optional[Union[int, Tuple[int, int]]] = None,
    force_context_length: Optional[int] = None,
    text_dropout: float = 0.0,
    logit_scale_trainable: bool = True,
    grad_checkpointing: bool = False,
    remat_policy: str = "dots",
    attn_impl: str = "xla",
    gelu_approx: bool = False,
    init_params: bool = True,
    rng_seed: int = 0,
    **model_kwargs,
) -> CLIP:
    """Build a CLIP module on `device` (CUDA unless given; raises without a
    card), in eval mode.

    `pretrained`: an open_clip-layout state dict, or the path of a `.pt`
    holding one (optionally under "state_dict", optionally "module."
    prefixed); it loads with `strict=True`. Without it, parameters are drawn
    from a `torch.Generator` seeded with `rng_seed`, unless `init_params` is
    False (a load follows). The JAX package's options as there:
    `force_quick_gelu`, `force_image_size` and `force_context_length` set
    the config's `quick_gelu`, vision `image_size` and text
    `context_length`; `text_dropout` (MR-CLIP's --textdropout) the text
    blocks' dropout; `logit_scale_trainable=False` (--logitscaletrainable)
    fixes the temperature at ln 10; `grad_checkpointing` remats every
    block of both towers under `remat_policy` ('full', 'dots' or
    'mlp_only'; FastViT's RepMixer blocks always 'full'). `model_kwargs`
    override top-level config keys (e.g. `init_logit_bias`); its other
    options (scan_layers, force_patch_dropout) raise.
    """
    dev = resolve_device(device)
    model_name = model_name.replace("/", "-")
    cfg = get_model_config(model_name)
    if cfg is None:
        raise RuntimeError(f"Model config for {model_name} not found; available: {list_models()}")
    unported = sorted(set(model_kwargs) - set(_CFG_KEYS))
    if force_patch_dropout is not None:
        unported.append("force_patch_dropout")
    if unported:
        raise NotImplementedError(
            f"create_model options {unported} are not ported: scan_layers is an XLA "
            "compile-time choice the unrolled stack has no use for; force_patch_dropout "
            "comes with the ViT's patch dropout (ROADMAP: modules item 4, the other configs)"
        )
    if force_quick_gelu:
        cfg["quick_gelu"] = True
    if force_image_size is not None:
        cfg["vision_cfg"]["image_size"] = force_image_size
    if force_context_length is not None:
        cfg["text_cfg"]["context_length"] = force_context_length
    if text_dropout:
        cfg["text_cfg"]["dropout"] = text_dropout
    cfg.update(model_kwargs)

    model = model_from_config(
        cfg, precision=precision, attn_impl=attn_impl, gelu_approx=gelu_approx,
        logit_scale_trainable=logit_scale_trainable,
        remat=remat_policy if grad_checkpointing else None,
    )
    if pretrained is not None:
        model.load_state_dict(_load_open_clip(pretrained), strict=True)
    elif init_params:
        _init_weights(model, torch.Generator().manual_seed(rng_seed))
    return model.to(dev).eval()


def create_model_and_transforms(
    model_name: str,
    pretrained: Optional[Union[str, dict]] = None,
    precision: str = "fp32",
    *,
    image_mean: Optional[Tuple[float, ...]] = None,
    image_std: Optional[Tuple[float, ...]] = None,
    image_interpolation: Optional[str] = None,
    image_resize_mode: Optional[str] = None,
    aug_cfg=None,
    **kwargs,
):
    """(model, train transform, eval transform): `create_model` and the
    host transforms of the model's `PreprocessCfg` (OpenAI mean and std,
    bicubic, shortest-edge resize at the config's image size, unless
    overridden here). The pretrained registry's per-tag preprocessing is not
    ported: `pretrained` is a state dict or a file."""
    model = create_model(model_name, pretrained, precision, **kwargs)
    cfg = get_model_config(model_name.replace("/", "-")) or {}
    overlay = {
        "mean": image_mean,
        "std": image_std,
        "interpolation": image_interpolation,
        "resize_mode": image_resize_mode,
        "size": kwargs.get("force_image_size") or cfg.get("vision_cfg", {}).get("image_size"),
    }
    pp_cfg = PreprocessCfg(**merge_preprocess_dict(PreprocessCfg(), overlay))
    train_t = image_transform_v2(pp_cfg, is_train=True, aug_cfg=aug_cfg)
    eval_t = image_transform_v2(pp_cfg, is_train=False)
    return model, train_t, eval_t


def create_loss(args) -> Callable[..., dict]:
    """Loss from the CLI flags, dispatched as the JAX package dispatches
    them: `distill`; `siglip` (`loss_dist_impl`); `multipositiveloss` with
    `visiononly`, `distance` (`delta`), `pallas_loss` (the fused kernels),
    `chunked_loss` (`loss_chunk_size`, default 1024) or dense (`delta`);
    `lam`; else plain `clip_loss`. `args` is any object with the flags as
    attributes. CoCa's captioning loss raises."""
    get = lambda name, default=None: getattr(args, name, default)  # noqa: E731
    gather = get("gather_with_grad", True)

    if get("distill"):
        return partial(distill_clip_loss, gather_with_grad=gather)
    if "coca" in (get("model", "") or "").lower():
        raise NotImplementedError(
            "the CoCa captioning loss is not ported (ROADMAP: modules item 5, the other towers)")
    if get("siglip"):
        return partial(siglip_loss, impl=get("loss_dist_impl", "bidir"))
    if get("multipositiveloss"):
        if get("visiononly"):
            return partial(multipositive_clip_loss_vision_only, gather_with_grad=gather)
        if get("distance"):
            return partial(multipositive_clip_loss_with_distance, delta=get("delta", 0.5),
                           gather_with_grad=gather)
        if get("pallas_loss"):
            return partial(pallas_multipositive_clip_loss, delta=get("delta", 0.5),
                           gather_with_grad=gather)
        if get("chunked_loss"):
            return partial(chunked_multipositive_clip_loss, delta=get("delta", 0.5),
                           chunk_size=get("loss_chunk_size", 1024), gather_with_grad=gather)
        return partial(multipositive_clip_loss, delta=get("delta", 0.5), gather_with_grad=gather)
    if get("lam"):
        return partial(multipositive_clip_loss_with_vision, lam=get("lam"), gather_with_grad=gather)
    return partial(clip_loss, gather_with_grad=gather)
