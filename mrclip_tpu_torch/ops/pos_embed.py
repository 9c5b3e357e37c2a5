"""Rotary position table of the EVA02 towers: the port's verbatim copy of
`mrclip_tpu/ops/pos_embed.py::rope_cat_2d` (numpy only; a test holds the two
equal)."""

from __future__ import annotations

import numpy as np

__all__ = ["rope_cat_2d"]


def rope_cat_2d(
    head_dim: int,
    grid_h: int,
    grid_w: int,
    ref_feat_shape: tuple | None = None,
    temperature: float = 10000.0,
) -> np.ndarray:
    """Axial 2D rotary-embedding table in concatenated sin||cos layout.

    The EVA02 rope (timm `RotaryEmbeddingCat(in_pixels=False)`): per image
    axis, `head_dim // 4` frequency bands `1 / T^(i / nb)` over integer
    patch coordinates — rescaled by `coord / grid * ref` when
    `ref_feat_shape` is given so fine-tuned resolutions reuse the
    pretraining frequency range — then each band value duplicated onto the
    channel pair it rotates. Returns [grid_h*grid_w, 2*head_dim] float32:
    first half sin, second half cos; per-position channel layout
    [h-bands x2 ..., w-bands x2 ...].
    """
    assert head_dim % 4 == 0, "2D rope needs head_dim % 4 == 0"
    nb = head_dim // 4
    bands = 1.0 / temperature ** (np.arange(nb, dtype=np.float64) / nb)
    th = np.arange(grid_h, dtype=np.float64)
    tw = np.arange(grid_w, dtype=np.float64)
    if ref_feat_shape is not None:
        th = th / grid_h * ref_feat_shape[0]
        tw = tw / grid_w * ref_feat_shape[1]
    grid = np.stack(np.meshgrid(th, tw, indexing="ij"), axis=-1)  # [H, W, 2]
    pos = grid[..., None] * bands  # [H, W, 2, nb]
    pos = pos.reshape(grid_h * grid_w, 2 * nb)
    pos = np.repeat(pos, 2, axis=-1)  # pair-duplicate -> [HW, head_dim]
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=-1).astype(np.float32)
