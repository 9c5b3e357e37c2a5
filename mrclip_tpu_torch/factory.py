"""Model factory and JSON config registry of the port (counterpart of
`mrclip_tpu/factory.py`: `list_models`, `get_model_config`,
`add_model_config`, `create_model`, `create_loss`).

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
from typing import Callable, Dict, Optional, Union

import torch

from .losses.contrastive import clip_loss, multipositive_clip_loss
from .models import CLIP
from .ops.pallas_loss import pallas_multipositive_clip_loss
from .utils import resolve_device

__all__ = [
    "list_models",
    "get_model_config",
    "add_model_config",
    "create_model",
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


def cast_dtype(precision: str) -> torch.dtype:
    """Compute dtype of a precision name; parameters stay fp32 either way."""
    if precision.startswith("pure_"):
        raise NotImplementedError(
            f"precision={precision!r} (low-precision weights) is not ported "
            "(ROADMAP: later slice 6, int8 and export)"
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
                      "visual.trunk.cls_token", "visual.trunk.pos_embed"):
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
    dw_impl: Optional[str] = None,
) -> CLIP:
    """An uninitialized CLIP on the CPU for a resolved config dict, its
    depthwise convolutions (MobileCLIP) on `dw_impl` ('pallas' or 'xla';
    without one, MRCLIP_DW_IMPL decides). The other arguments are kept on
    the module as `build_args`, from which `serving.export_model` writes
    what rebuilding it takes."""
    if "multimodal_cfg" in cfg:
        raise NotImplementedError("CoCa is not ported (ROADMAP: later slice 4, other towers)")
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
    )
    model.build_args = {
        "model_cfg": deepcopy(cfg),
        "precision": precision,
        "attn_impl": attn_impl,
        "gelu_approx": bool(gelu_approx),
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
    attn_impl: str = "xla",
    gelu_approx: bool = False,
    rng_seed: int = 0,
    **model_kwargs,
) -> CLIP:
    """Build a CLIP module on `device` (CUDA unless given; raises without a
    card), in eval mode.

    `pretrained`: an open_clip-layout state dict, or the path of a `.pt`
    holding one (optionally under "state_dict", optionally "module."
    prefixed); it loads with `strict=True`. Without it, parameters are drawn
    from a `torch.Generator` seeded with `rng_seed`. `model_kwargs`
    override top-level config keys (e.g. `init_logit_bias`); the JAX
    package's other options (scan_layers, remat, force_*) raise.
    """
    dev = resolve_device(device)
    model_name = model_name.replace("/", "-")
    cfg = get_model_config(model_name)
    if cfg is None:
        raise RuntimeError(f"Model config for {model_name} not found; available: {list_models()}")
    unported = sorted(set(model_kwargs) - set(_CFG_KEYS))
    if unported:
        raise NotImplementedError(
            f"create_model options {unported} are not ported: scan_layers is an XLA "
            "compile-time choice the unrolled stack has no use for; training is ported "
            "but remat (grad_checkpointing, remat_policy) is not (ROADMAP: later slice 3, "
            "the training CLI's options); force_* overrides come with the other configs "
            "(ROADMAP: later slice 2)"
        )
    cfg.update(model_kwargs)

    model = model_from_config(
        cfg, precision=precision, attn_impl=attn_impl, gelu_approx=gelu_approx
    )
    if pretrained is not None:
        model.load_state_dict(_load_open_clip(pretrained), strict=True)
    else:
        _init_weights(model, torch.Generator().manual_seed(rng_seed))
    return model.to(dev).eval()


def _unported_loss(what: str, roadmap: str):
    raise NotImplementedError(f"the {what} loss is not ported (ROADMAP: {roadmap})")


def create_loss(args) -> Callable[..., dict]:
    """Loss from the CLI flags, as the JAX package dispatches them: dense
    `multipositiveloss` (`delta`), its fused-kernel form with
    `pallas_loss`, or the plain symmetric `clip_loss`. `args` is any object
    with the flags as attributes; the losses of other slices raise."""
    get = lambda name, default=None: getattr(args, name, default)  # noqa: E731

    if get("distill"):
        _unported_loss("distill", "later slice 2, other losses")
    if "coca" in (get("model", "") or "").lower():
        _unported_loss("CoCa captioning", "later slice 4, other towers")
    if get("siglip"):
        _unported_loss("SigLIP", "later slice 2, other losses")
    if get("multipositiveloss"):
        if get("visiononly"):
            _unported_loss("vision-only multipositive", "later slice 2, other losses")
        if get("distance"):
            _unported_loss("distance-weighted multipositive", "later slice 2, other losses")
        if get("pallas_loss"):
            return partial(pallas_multipositive_clip_loss, delta=get("delta", 0.5),
                           gather_with_grad=get("gather_with_grad", True))
        if get("chunked_loss"):
            _unported_loss("chunked multipositive", "later slice 2, other losses")
        return partial(multipositive_clip_loss, delta=get("delta", 0.5),
                       gather_with_grad=get("gather_with_grad", True))
    if get("lam"):
        _unported_loss("multipositive-with-vision (lam)", "later slice 2, other losses")
    return partial(clip_loss, gather_with_grad=get("gather_with_grad", True))
