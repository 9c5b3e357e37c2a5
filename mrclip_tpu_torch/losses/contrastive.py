"""Contrastive losses on one device (the port of
`mrclip_tpu/losses/contrastive.py`, CoCa's aside).

| function                              | reference class (loss.py / loss copy.py) |
|---------------------------------------|------------------------------------------|
| clip_loss                             | ClipLoss                                 |
| multipositive_clip_loss               | MultiPositiveClipLoss                    |
| multipositive_clip_loss_with_distance | MultiPositiveClipLossWithDistance        |
| multipositive_clip_loss_vision_only   | MultiPositiveClipLossVisionOnly          |
| multipositive_clip_loss_with_vision   | MultiPositiveClipLosswithVision (lam)    |
| siglip_loss                           | SigLipLoss                               |
| distill_clip_loss                     | DistillClipLoss                          |

Each returns the JAX function's dict of named scalars, `"loss"` among them.
Features of any float type are taken to fp32 before the logits, as the JAX
package's type promotion does (an fp32 `logit_scale` times bf16 features is
fp32 there); fp64 stays fp64. The gathered multi-device forms (`axis_name`,
and SigLIP's ring and gather `impl`s with it) raise: they come with
multi-GPU training (ROADMAP: modules item 6). CoCa's loss comes with CoCa
(modules item 5).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .functional import (
    _f32,
    arange_cross_entropy,
    mahalanobis_distance,
    multi_positive_cross_entropy_loss,
    multi_positive_cross_entropy_loss_with_distance,
    pos_mask_from_labels,
    sigmoid_pair_loss,
    weighted_euclidean_distance,
)

__all__ = [
    "clip_loss",
    "distill_clip_loss",
    "multipositive_clip_loss",
    "multipositive_clip_loss_vision_only",
    "multipositive_clip_loss_with_distance",
    "multipositive_clip_loss_with_vision",
    "siglip_loss",
    "single_device",
]

_DISTANCES = {"weighted_euclidean": weighted_euclidean_distance,
              "mahalanobis": mahalanobis_distance}


def single_device(axis_name: Optional[str], what: str) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"{what}: axis_name={axis_name!r} (features gathered across devices) is not "
            "ported (ROADMAP: modules item 6, multi-GPU)"
        )


def _pair_logits(image_features, text_features, logit_scale):
    """(logits_per_image, logits_per_text), fp32 (fp64 for fp64 features)."""
    img, txt, scale = _f32(image_features), _f32(text_features), _f32(logit_scale)
    return scale * img @ txt.T, scale * txt @ img.T


def _self_logits(image_features, logit_scale):
    """scale * img @ img.T, fp32 (fp64 for fp64 features)."""
    img = _f32(image_features)
    return _f32(logit_scale) * img @ img.T


def _without_self(pos_mask):
    """The positive mask with the self pairs (its diagonal) removed."""
    return pos_mask * (1.0 - torch.eye(pos_mask.shape[0], device=pos_mask.device))


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


def _two_directions(loss_img, loss_txt, delta):
    loss = delta * loss_img + (1.0 - delta) * loss_txt
    return {
        "loss": loss,
        "multi_contrastive_loss": loss,
        "image_to_text_loss": loss_img,
        "text_to_image_loss": loss_txt,
    }


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
    return _two_directions(multi_positive_cross_entropy_loss(logits_i, pos_mask),
                           multi_positive_cross_entropy_loss(logits_t, pos_mask), delta)


def multipositive_clip_loss_with_distance(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    labels: torch.Tensor,
    echo_time: torch.Tensor,
    repetition_time: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    delta: float = 0.5,
    distance_fn: str = "weighted_euclidean",
    axis_name: Optional[str] = None,
    gather_with_grad: bool = True,
) -> dict:
    """The multipositive loss with the pairwise TE/TR distance
    (`distance_fn`: 'weighted_euclidean' or 'mahalanobis') added to the
    negatives inside the row max (`multi_positive_cross_entropy_loss_with_distance`)."""
    single_device(axis_name, "multipositive_clip_loss_with_distance")
    logits_i, logits_t = _pair_logits(image_features, text_features, logit_scale)
    pos_mask = pos_mask_from_labels(labels)
    distance = (_DISTANCES.get(distance_fn, weighted_euclidean_distance)
                (echo_time, repetition_time, echo_time, repetition_time))
    return _two_directions(
        multi_positive_cross_entropy_loss_with_distance(logits_i, pos_mask, distance),
        multi_positive_cross_entropy_loss_with_distance(logits_t, pos_mask, distance), delta)


def multipositive_clip_loss_vision_only(
    image_features: torch.Tensor,
    labels: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    axis_name: Optional[str] = None,
    gather_with_grad: bool = True,
) -> dict:
    """Image<->image SupCon over `scale * img @ img.T`, the self pairs
    removed from the positives (not from the denominator)."""
    single_device(axis_name, "multipositive_clip_loss_vision_only")
    logits = _self_logits(image_features, logit_scale)
    loss = multi_positive_cross_entropy_loss(logits, _without_self(pos_mask_from_labels(labels)))
    return {"loss": loss, "multi_contrastive_loss": loss}


def multipositive_clip_loss_with_vision(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    labels: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    lam: float = 0.3,
    axis_name: Optional[str] = None,
    gather_with_grad: bool = True,
) -> dict:
    """(i2t + t2i) / 2 + lam * img2img, the last with the self pairs removed
    from the positives."""
    single_device(axis_name, "multipositive_clip_loss_with_vision")
    logits_i, logits_t = _pair_logits(image_features, text_features, logit_scale)
    logits_ii = _self_logits(image_features, logit_scale)
    pos_mask = pos_mask_from_labels(labels)
    loss_img = multi_positive_cross_entropy_loss(logits_i, pos_mask)
    loss_txt = multi_positive_cross_entropy_loss(logits_t, pos_mask)
    loss_ii = multi_positive_cross_entropy_loss(logits_ii, _without_self(pos_mask))
    return {
        "loss": (loss_img + loss_txt) / 2.0 + lam * loss_ii,
        "loss_img": loss_img,
        "loss_txt": loss_txt,
        "loss_img_to_img": loss_ii,
    }


def siglip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    logit_bias: torch.Tensor,
    *,
    axis_name: Optional[str] = None,
    impl: str = "bidir",
) -> dict:
    """SigLIP's pairwise sigmoid loss on one device (every `impl` is the
    same sum there; its ring and gather forms need `axis_name`)."""
    single_device(axis_name, f"siglip_loss (impl={impl!r})")
    loss = sigmoid_pair_loss(image_features, text_features, logit_scale, logit_bias)
    return {"loss": loss, "contrastive_loss": loss}


def distill_clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    dist_image_features: torch.Tensor,
    dist_text_features: torch.Tensor,
    dist_logit_scale: torch.Tensor,
    *,
    axis_name: Optional[str] = None,
    gather_with_grad: bool = True,
) -> dict:
    """clip_loss plus the teacher->student soft cross entropy in both
    directions."""
    single_device(axis_name, "distill_clip_loss")
    logits_i, logits_t = _pair_logits(image_features, text_features, logit_scale)
    t_logits_i, t_logits_t = _pair_logits(dist_image_features, dist_text_features,
                                          dist_logit_scale)
    contrastive = (arange_cross_entropy(logits_i) + arange_cross_entropy(logits_t)) / 2.0

    def soft_ce(student, teacher):
        return -(F.softmax(teacher, dim=-1) * F.log_softmax(student, dim=-1)).sum(dim=-1).mean()

    distill = (soft_ce(logits_i, t_logits_i) + soft_ce(logits_t, t_logits_t)) / 2.0
    return {
        "loss": contrastive + distill,
        "contrastive_loss": contrastive,
        "distill_loss": distill,
    }
