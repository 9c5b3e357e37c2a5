"""Contrastive losses of the port (counterpart of `mrclip_tpu/losses`)."""

from .contrastive import clip_loss, multipositive_clip_loss
from .functional import (
    arange_cross_entropy,
    multi_positive_cross_entropy_loss,
    pos_mask_from_labels,
)

__all__ = [
    "arange_cross_entropy",
    "clip_loss",
    "multi_positive_cross_entropy_loss",
    "multipositive_clip_loss",
    "pos_mask_from_labels",
]
