"""Model export + serving of the port (counterpart of `mrclip_tpu/serving.py`).

The JAX package serializes its jitted encoders as StableHLO. The port's
artifact is a zip holding `meta.json` (the JAX artifact's keys, plus the
model config, precision, activation, `attn_impl` and the depthwise
convolution's implementation `dw_impl` needed to rebuild the module) and
`model.pt`, the `torch.save`d fp32 state dict.

API:
  exp = export_model(model)                     # model from factory.create_model
  save_exported(exp, "model.mrclip")            # bytes on disk
  served = load_exported("model.mrclip")        # rebuilt on the card
  served.encode_image(images); served.encode_text(tokens); served.logits(...)
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile

import numpy as np
import torch

from .factory import model_from_config
from .models import CLIP
from .models.layers import DepthwiseConv
from .utils import resolve_device

__all__ = ["ExportedModel", "ServedModel", "export_model", "save_exported", "load_exported"]


@dataclasses.dataclass
class ExportedModel:
    """In-memory export: the fp32 state dict and the artifact metadata."""

    state_dict: dict
    meta: dict


@dataclasses.dataclass
class ServedModel:
    """A loaded artifact. The encoders take numpy arrays (or anything
    `np.asarray` takes) and return fp32 numpy features; each call runs under
    `torch.inference_mode()` on the model's device."""

    model: CLIP
    meta: dict

    @property
    def device(self) -> torch.device:
        return self.model.logit_scale.device

    def encode_image(self, images) -> np.ndarray:
        """[B, H, W, 3] normalized float images -> [B, embed_dim] unit features."""
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
            return self.model.encode_image(x, normalize=True).float().cpu().numpy()

    def encode_text(self, tokens) -> np.ndarray:
        """[B, L] token ids -> [B, embed_dim] unit features."""
        with torch.inference_mode():
            t = torch.as_tensor(np.asarray(tokens, np.int64)).to(self.device)
            return self.model.encode_text(t, normalize=True).float().cpu().numpy()

    def logits(self, images, tokens) -> np.ndarray:
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        return (
            self.meta.get("logit_scale", 100.0) * img @ txt.T
            + self.meta.get("logit_bias", 0.0)
        )


def export_model(model: CLIP) -> ExportedModel:
    """Capture the weights of a model built by `factory.create_model` and
    what rebuilding it takes, with the `impl` its depthwise convolutions
    were built with as `dw_impl` (None without any), as the JAX export keeps
    the path it traced."""
    bias = model.logit_bias
    dw_impls = {m.impl for m in model.modules() if isinstance(m, DepthwiseConv)}
    if len(dw_impls) > 1:
        raise ValueError(f"the model mixes depthwise convolution impls {sorted(dw_impls)}")
    meta = {
        "image_size": list(model.visual.image_size),
        "context_length": int(model.context_length),
        "int8": False,
        # None = any batch size, so the server may coalesce requests
        "batch_size": None,
        "tokenizer": "clip-bpe",
        "logit_scale": float(model.logit_scale.detach().float().exp().cpu()),
        "logit_bias": float(bias.detach().float().cpu()) if bias is not None else 0.0,
        **model.build_args,
        "dw_impl": dw_impls.pop() if dw_impls else None,
    }
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    return ExportedModel(sd, meta)


def save_exported(exported: ExportedModel, path: str) -> None:
    """Serialize weights + metadata into one zip artifact."""
    buf = io.BytesIO()
    torch.save(exported.state_dict, buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("meta.json", json.dumps(exported.meta))
        zf.writestr("model.pt", buf.getvalue())


def load_exported(path: str, device=None) -> ServedModel:
    """Rebuild an artifact's model on `device` (CUDA unless given; raises
    without a card), its depthwise convolutions on the artifact's `dw_impl`
    whatever the loading process's `MRCLIP_DW_IMPL` says."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        sd = torch.load(io.BytesIO(zf.read("model.pt")), map_location="cpu", weights_only=True)
    model = model_from_config(
        meta["model_cfg"], precision=meta["precision"], attn_impl=meta["attn_impl"],
        gelu_approx=meta["gelu_approx"], dw_impl=meta.get("dw_impl"),
        logit_scale_trainable=meta.get("logit_scale_trainable", True),
    )
    model.load_state_dict(sd, strict=True)
    return ServedModel(model.to(dev).eval(), meta)
