"""Contrastive losses of the port (counterpart of `mrclip_tpu/losses`)."""

from .contrastive import (
    clip_loss,
    distill_clip_loss,
    multipositive_clip_loss,
    multipositive_clip_loss_vision_only,
    multipositive_clip_loss_with_distance,
    multipositive_clip_loss_with_vision,
    siglip_loss,
)
from .functional import (
    arange_cross_entropy,
    mahalanobis_distance,
    multi_positive_cross_entropy_loss,
    multi_positive_cross_entropy_loss_with_distance,
    pos_mask_from_labels,
    sigmoid_pair_loss,
    supervised_contrastive_loss,
    weighted_euclidean_distance,
)

__all__ = [
    "arange_cross_entropy",
    "clip_loss",
    "distill_clip_loss",
    "mahalanobis_distance",
    "multi_positive_cross_entropy_loss",
    "multi_positive_cross_entropy_loss_with_distance",
    "multipositive_clip_loss",
    "multipositive_clip_loss_vision_only",
    "multipositive_clip_loss_with_distance",
    "multipositive_clip_loss_with_vision",
    "pos_mask_from_labels",
    "siglip_loss",
    "sigmoid_pair_loss",
    "supervised_contrastive_loss",
    "weighted_euclidean_distance",
]
