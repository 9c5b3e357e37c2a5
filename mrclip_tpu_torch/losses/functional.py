"""Loss math on plain tensors (the port of the part of
`mrclip_tpu/losses/functional.py` that the multipositive and CLIP losses
use): the positive mask, SupCon Eq. (2) and the arange InfoNCE core."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "pos_mask_from_labels",
    "multi_positive_cross_entropy_loss",
    "arange_cross_entropy",
]

_EPS = 1e-12


def pos_mask_from_labels(labels_row: torch.Tensor,
                         labels_col: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pos_mask[i, j] = 1 where the labels match. fp32."""
    if labels_col is None:
        labels_col = labels_row
    return (labels_row[:, None] == labels_col[None, :]).float()


def multi_positive_cross_entropy_loss(logits: torch.Tensor, pos_mask: torch.Tensor) -> torch.Tensor:
    """SupCon Eq. (2): `-mean_i mean_{j in P(i)} log softmax(logits)_ij`,
    with the row max detached, the 1e-12 inside the log and the positive
    count clamped to 1, as the JAX package (and the reference) compute it."""
    logits = logits.float()
    row_max = logits.amax(dim=1, keepdim=True).detach()
    shifted = logits - row_max
    log_denom = torch.log(torch.exp(shifted).sum(dim=1, keepdim=True) + _EPS)
    log_prob = shifted - log_denom
    num_pos = pos_mask.sum(dim=1).clamp(min=1.0)
    per_sample = -(pos_mask * log_prob).sum(dim=1) / num_pos
    return per_sample.mean()


def arange_cross_entropy(logits: torch.Tensor, label_offset: int = 0) -> torch.Tensor:
    """Mean cross entropy with diagonal targets `arange(B) + offset`."""
    b = logits.shape[0]
    labels = torch.arange(b, device=logits.device) + label_offset
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp[torch.arange(b, device=logits.device), labels].mean()
