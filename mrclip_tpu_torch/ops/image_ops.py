"""Image normalisation on the device (the port of
`mrclip_tpu/ops/image_ops.py::normalize_images`, ToTensor + Normalize; the
rest of that module, the fused augmentation pipeline, belongs to the data
slice, ROADMAP later slice 3)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

__all__ = ["normalize_images"]


def normalize_images(
    images: torch.Tensor,
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
    std: Tuple[float, ...] = OPENAI_DATASET_STD,
) -> torch.Tensor:
    """uint8 or float [B, H, W, C] -> normalised fp32 on the tensor's device:
    uint8 is scaled to [0, 1] first, then (x - mean) / std per channel."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (x - mean_t) / std_t
