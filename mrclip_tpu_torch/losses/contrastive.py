"""Contrastive losses on one device (the port of `clip_loss` and
`multipositive_clip_loss` from `mrclip_tpu/losses/contrastive.py`).

Each returns a dict of named scalars including `"loss"`. Features of any
float type are taken to fp32 before the logits, as the JAX package's type
promotion does (an fp32 `logit_scale` times bf16 features is fp32 there).
The gathered multi-device forms (`axis_name`) raise: they come with
multi-GPU training, ROADMAP later slice 5.
"""

from __future__ import annotations

from typing import Optional

import torch

from .functional import arange_cross_entropy, multi_positive_cross_entropy_loss, pos_mask_from_labels

__all__ = ["clip_loss", "multipositive_clip_loss", "single_device"]


def single_device(axis_name: Optional[str], what: str) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"{what}: axis_name={axis_name!r} (features gathered across devices) is not "
            "ported (ROADMAP: later slice 5, multi-GPU)"
        )


def _pair_logits(image_features, text_features, logit_scale):
    """(logits_per_image, logits_per_text), fp32."""
    img, txt = image_features.float(), text_features.float()
    scale = logit_scale.float()
    return scale * img @ txt.T, scale * txt @ img.T


def clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    axis_name: Optional[str] = None,
    gather_with_grad: bool = True,
) -> dict:
    """Symmetric InfoNCE with arange labels."""
    single_device(axis_name, "clip_loss")
    logits_i, logits_t = _pair_logits(image_features, text_features, logit_scale)
    loss = (arange_cross_entropy(logits_i) + arange_cross_entropy(logits_t)) / 2.0
    return {"loss": loss, "contrastive_loss": loss}


def multipositive_clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    labels: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    delta: float = 0.5,
    axis_name: Optional[str] = None,
    gather_with_grad: bool = True,
) -> dict:
    """The MR-CLIP objective: any (i, j) with matching labels is a positive
    pair; `delta` weights image->text against text->image."""
    single_device(axis_name, "multipositive_clip_loss")
    logits_i, logits_t = _pair_logits(image_features, text_features, logit_scale)
    pos_mask = pos_mask_from_labels(labels)
    loss_img = multi_positive_cross_entropy_loss(logits_i, pos_mask)
    loss_txt = multi_positive_cross_entropy_loss(logits_t, pos_mask)
    loss = delta * loss_img + (1.0 - delta) * loss_txt
    return {
        "loss": loss,
        "multi_contrastive_loss": loss,
        "image_to_text_loss": loss_img,
        "text_to_image_loss": loss_txt,
    }
