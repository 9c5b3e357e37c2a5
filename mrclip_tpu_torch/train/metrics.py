"""Retrieval metrics: same-label ranking, R@K, 3D volume voting.

Capability parity with reference `src/open_clip_train/train.py`:
- `get_clip_metrics` (:465-534): for each anchor, ranks of all same-label
  candidates; mean/median/mean-of-mean rank (1-based) and R@{1,5,10} where a
  hit is any same-label item in the top-k; both `general` (binned label) and
  `unique` (exact caption) ground truths; optional top-10 trace vocabulary.
- 3D volume voting (`test_metrics` :987-1071): slice-level top-k predictions
  grouped per volume, majority vote over all slice votes and over first
  labels.

Vectorized (the reference loops over anchors in Python): the whole rank
matrix comes from one argsort + inverse permutation.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["get_clip_metrics", "rank_metrics", "volume_voting_metrics"]


def _inverse_permutation(order: np.ndarray) -> np.ndarray:
    """inv[i, order[i, k]] = k — the rank position of each candidate."""
    n, m = order.shape
    inv = np.empty_like(order)
    rows = np.arange(n)[:, None]
    inv[rows, order] = np.arange(m)[None, :]
    return inv


def rank_metrics(
    logits: np.ndarray, labels_row: np.ndarray, labels_col: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """Same-label retrieval ranks for one direction.

    preds[i] = best rank of any same-label candidate; preds_mean[i] = mean
    rank (reference train.py:493-511, exact +1 / floor conventions kept).
    """
    if labels_col is None:
        labels_col = labels_row
    order = np.argsort(-logits, axis=1, kind="stable")
    inv = _inverse_permutation(order)
    same = labels_row[:, None] == labels_col[None, :]
    ranks = np.where(same, inv, np.iinfo(np.int64).max)
    preds = ranks.min(axis=1).astype(np.float64)
    with np.errstate(invalid="ignore"):
        preds_mean = np.where(same, inv, np.nan)
        preds_mean = np.nanmean(preds_mean, axis=1)

    out = {
        "meanofmean_rank": float(np.mean(preds_mean) + 1),
        "mean_rank": float(preds.mean() + 1),
        "median_rank": float(np.floor(np.median(preds)) + 1),
    }
    for k in (1, 5, 10):
        out[f"R@{k}"] = float(np.mean(preds < k))
    return out


def get_clip_metrics(
    image_features: np.ndarray,
    text_features: np.ndarray,
    logit_scale: float,
    ground_truth_general: Sequence,
    ground_truth_unique: Optional[Sequence] = None,
    trace: bool = False,
):
    """Reference `get_clip_metrics` (train.py:465-534)."""
    image_features = np.asarray(image_features)
    text_features = np.asarray(text_features)
    logits_per_image = float(logit_scale) * image_features @ text_features.T
    logits = {"image_to_text": logits_per_image, "text_to_image": logits_per_image.T}

    metrics: Dict[str, float] = {}
    vocabulary: Dict = {}
    gt_general = np.asarray(ground_truth_general)
    gts = [("general", gt_general)]
    if ground_truth_unique is not None:
        gts.append(("unique", np.asarray(ground_truth_unique)))

    for gt_name, gt in gts:
        for direction, logit in logits.items():
            name = f"{direction}_{gt_name}"
            for key, val in rank_metrics(logit, gt).items():
                metrics[f"{name}_{key}"] = val
            if trace and gt_name == "general":
                # top-10 of the first 201 anchors only — argpartition over
                # those rows, not a second full [N, M] argsort (rank_metrics
                # already paid the big one)
                n_tr = min(len(gt), 201)
                rows = -logit[:n_tr]
                k = min(10, rows.shape[1])
                order = []
                for r in rows:
                    if k < r.shape[0]:
                        # exact match of np.argsort(r, kind="stable")[:k]
                        # incl. tie order: argpartition alone breaks ties
                        # (both inside the window and at the k-th boundary)
                        # by arbitrary position, not lowest-index-first
                        part = np.argpartition(r, k - 1)[:k]
                        kth = r[part].max()
                        better = np.nonzero(r < kth)[0]
                        ties = np.nonzero(r == kth)[0][: k - better.size]
                        cand = np.concatenate([better, ties])
                        order.append(cand[np.argsort(r[cand], kind="stable")])
                    else:
                        order.append(np.argsort(r, kind="stable"))
                vocab = {}
                for i in range(n_tr):
                    top10 = order[i][:10].tolist()
                    vocab[i] = {
                        "anchor": i,
                        "gt": gt[i].item() if hasattr(gt[i], "item") else gt[i],
                        "indices": top10,
                        "labels": [gt[j].item() if hasattr(gt[j], "item") else gt[j] for j in top10],
                    }
                vocabulary[name] = vocab

    if trace:
        return metrics, vocabulary
    return metrics


def volume_voting_metrics(
    slice_topk_labels: Dict[str, List[List]],
    volume_true_labels: Dict[str, List],
    topks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """3D volume majority voting (reference train.py:1014-1071).

    `slice_topk_labels[vol]` = per-slice lists of top-10 predicted labels.
    `volume_true_labels[vol]` = per-slice true labels (constant per volume).
    For each top-k: pool the first k predictions of every slice in the
    volume, majority-vote, compare against the volume's true label. Also
    reports the all-votes majority and first-label (top-1 of first slice)
    accuracies.
    """
    if not slice_topk_labels:
        return {}
    metrics = {}
    n_vols = len(slice_topk_labels)

    for k in topks:
        correct = 0
        for vol, slices in slice_topk_labels.items():
            votes = [label for sl in slices for label in sl[:k]]
            majority = Counter(votes).most_common(1)[0][0]
            true = volume_true_labels[vol][0]
            correct += int(majority == true)
        metrics[f"3d_vote_top{k}_accuracy"] = correct / n_vols

    correct_all = 0
    correct_first = 0
    for vol, slices in slice_topk_labels.items():
        true = volume_true_labels[vol][0]
        votes = [label for sl in slices for label in sl]
        correct_all += int(Counter(votes).most_common(1)[0][0] == true)
        first_labels = [sl[0] for sl in slices if sl]
        correct_first += int(Counter(first_labels).most_common(1)[0][0] == true)
    metrics["3d_vote_all_accuracy"] = correct_all / n_vols
    metrics["3d_vote_first_label_accuracy"] = correct_first / n_vols
    return metrics
