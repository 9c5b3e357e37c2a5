"""Loss math on plain tensors (the port of `mrclip_tpu/losses/functional.py`):
the positive mask, SupCon Eq. (2) and its TE/TR distance-weighted form, the
pairwise TE/TR distances, the arange InfoNCE core, the SigLIP pair loss and
SupCon with self-exclusion."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "pos_mask_from_labels",
    "multi_positive_cross_entropy_loss",
    "multi_positive_cross_entropy_loss_with_distance",
    "weighted_euclidean_distance",
    "mahalanobis_distance",
    "arange_cross_entropy",
    "sigmoid_pair_loss",
    "supervised_contrastive_loss",
]

_EPS = 1e-12


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, as the JAX package's `astype(jnp.float32)` gives it; fp64
    stays fp64 (a reference computed in double precision)."""
    return x if x.dtype == torch.float64 else x.float()


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
    logits = _f32(logits)
    row_max = logits.amax(dim=1, keepdim=True).detach()
    shifted = logits - row_max
    log_denom = torch.log(torch.exp(shifted).sum(dim=1, keepdim=True) + _EPS)
    log_prob = shifted - log_denom
    num_pos = pos_mask.sum(dim=1).clamp(min=1.0)
    per_sample = -(pos_mask * log_prob).sum(dim=1) / num_pos
    return per_sample.mean()


def multi_positive_cross_entropy_loss_with_distance(
    logits: torch.Tensor, pos_mask: torch.Tensor, distance: torch.Tensor
) -> torch.Tensor:
    """The TE/TR distance-weighted form: the distance is added to the
    negative logits inside the detached row max only, the exponentials take
    `logits - row_max`, the log is outside the positive sum with 1e-12
    twice inside it, and each row is divided by |P(i)| after the log. So
    the distance cancels from pos_sum / all_sum except through the two
    1e-12 terms: at TE/TR in seconds the loss does not depend on it; at
    milliseconds a far negative pushes the row max up until rows underflow.
    The JAX package's (and the reference's) numerics, kept as they are."""
    logits = _f32(logits)
    dist_neg = _f32(distance) * (1.0 - pos_mask)
    row_max = (logits + dist_neg).amax(dim=1, keepdim=True).detach()
    exp_shifted = torch.exp(logits - row_max)
    pos_sum = (exp_shifted * pos_mask).sum(dim=1)
    all_sum = exp_shifted.sum(dim=1)
    per_sample = -torch.log(pos_sum / (all_sum + _EPS) + _EPS)
    num_pos = pos_mask.sum(dim=1).clamp(min=1.0)
    return (per_sample / num_pos).mean()


def weighted_euclidean_distance(te: torch.Tensor, tr: torch.Tensor, all_te: torch.Tensor,
                                all_tr: torch.Tensor, w_te: float = 0.2,
                                w_tr: float = 10.0) -> torch.Tensor:
    """Pairwise `sqrt(dTE^2 / w_te + dTR^2 / w_tr)`, [len(te), len(all_te)]."""
    te_diff = te[:, None] - all_te[None, :]
    tr_diff = tr[:, None] - all_tr[None, :]
    return torch.sqrt(te_diff**2 / w_te + tr_diff**2 / w_tr)


def mahalanobis_distance(te: torch.Tensor, tr: torch.Tensor, all_te: torch.Tensor,
                         all_tr: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Pairwise Mahalanobis distance in (TE, TR) space under the covariance
    of (all_te, all_tr) (ddof 1, as `jnp.cov`) plus eps I."""
    local = torch.stack([te, tr], dim=1)
    global_ = torch.stack([all_te, all_tr], dim=1)
    cov = torch.cov(global_.T) + eps * torch.eye(2, dtype=global_.dtype, device=global_.device)
    inv_cov = torch.linalg.inv(cov)
    diffs = local[:, None, :] - global_[None, :, :]
    return torch.sqrt(torch.einsum("bij,jk,bik->bi", diffs, inv_cov, diffs))


def arange_cross_entropy(logits: torch.Tensor, label_offset: int = 0) -> torch.Tensor:
    """Mean cross entropy with diagonal targets `arange(B) + offset`."""
    b = logits.shape[0]
    labels = torch.arange(b, device=logits.device) + label_offset
    logp = F.log_softmax(_f32(logits), dim=-1)
    return -logp[torch.arange(b, device=logits.device), labels].mean()


def sigmoid_pair_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, logit_bias: Optional[torch.Tensor] = None,
                      negative_only: bool = False) -> torch.Tensor:
    """SigLIP's pairwise sigmoid loss, summed over pairs and divided by the
    batch; `negative_only` is the ring-chunk form where every pair is a
    negative. The logits are taken in the features' type promoted with the
    scale's (bf16 features and an fp32 scale give fp32, as in JAX, where
    torch would keep bf16), then cast to fp32 for the log-sigmoid."""
    dt = torch.promote_types(image_features.dtype, logit_scale.dtype)
    logits = logit_scale.to(dt) * image_features.to(dt) @ text_features.to(dt).T
    if logit_bias is not None:
        logits = logits + logit_bias
    b, nt = image_features.shape[0], text_features.shape[0]
    labels = -torch.ones((b, nt), dtype=torch.float32, device=logits.device)
    if not negative_only:
        labels = labels + 2.0 * torch.eye(b, nt, dtype=torch.float32, device=logits.device)
    return -F.logsigmoid(labels * _f32(logits)).sum() / b


def supervised_contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                                temperature: float = 0.07) -> torch.Tensor:
    """SupCon with self-exclusion (the reference's
    `example_sup_contrastive_loss.py`)."""
    b = features.shape[0]
    mask = pos_mask_from_labels(labels)
    logits = _f32(features @ features.T / temperature)
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    self_mask = 1.0 - torch.eye(b, device=logits.device)
    mask = mask * self_mask
    exp_logits = torch.exp(logits) * self_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True) + _EPS)
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / (mask.sum(dim=1) + _EPS)
    return -mean_log_prob_pos.mean()
