"""Tower locking and freezing as an update mask (counterpart of
`mrclip_tpu/parallel/freeze.py`).

- `--lock-image` freezes the visual tower, `--lock-image-unlocked-groups`
  N leaving its last N groups trainable, of [stem, block 0 .. block L-2,
  block L-1 + the final norm, the projection];
- `--lock-text` does the same to the text tower
  (`--lock-text-unlocked-layers`);
- `--freeze` freezes the text transformer's blocks, `--freezelast` leaving
  its last two trainable.

As in the JAX package, every gradient is computed and the optimizer runs
on every parameter; the mask (1.0 trainable, 0.0 frozen, by parameter
name) multiplies the final update, weight decay included
(`chain_with_mask`). So `grad_norm`, the global-norm clip and the frozen
parameters' moments count the frozen towers too, where open_clip's
`requires_grad=False` would leave them out. The towers' parameters keep
the port's names (open_clip's; timm's for EVA02 and SigLIP, the JAX tree's
for FastViT); `_tower_key` maps each to the JAX tree's key. Parameters of a
tower outside the JAX package's group list (FastViT's stem, stages and
head) are frozen with the tower and never unlocked, as there. HF text
towers are not ported (ROADMAP: modules item 5), so neither is their
locking.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

__all__ = ["build_trainable_mask", "chain_with_mask"]

# The EVA02 and SigLIP towers' timm names -> the JAX tree's keys
_TIMM_KEYS = {"trunk.patch_embed.proj": "conv1", "trunk.cls_token": "class_embedding",
              "trunk.pos_embed": "positional_embedding", "trunk.norm": "ln_post",
              "trunk.attn_pool": "attn_pool", "head.proj": "proj"}


def _tower_key(name: str) -> Tuple[Optional[str], str, Optional[int]]:
    """(tower, key in the JAX tower's tree, block index or None) of a
    parameter name; tower None for the logit scale and bias."""
    if name.startswith("visual."):
        tower, rest = "visual", name[len("visual."):]
    elif name in ("logit_scale", "logit_bias"):
        return None, name, None
    else:
        tower, rest = "text", name
    for prefix in ("transformer.resblocks.", "trunk.blocks."):
        if rest.startswith(prefix):
            return tower, "transformer", int(rest[len(prefix):].split(".")[0])
    for timm, key in _TIMM_KEYS.items():
        if rest == timm or rest.startswith(timm + "."):
            return tower, key, None
    return tower, rest.split(".")[0], None


def _lock_tower(mask: Dict[str, float], keys: dict, unlocked_groups: int) -> None:
    """Freeze a tower's parameters (`keys`: name -> (key, block)), keeping
    its last `unlocked_groups` groups of [stem, block_0 .. block_{L-2},
    block_{L-1} + post-norm, proj] trainable (JAX `_freeze_tower`)."""
    n_layers = len({b for _, b in keys.values() if b is not None})
    n_groups = 1 + max(n_layers - 1, 0) + 1 + 1
    first_unlocked = n_groups - max(0, min(unlocked_groups, n_groups))
    for name, (key, block) in keys.items():
        if key == "transformer":
            group = 1 + block if block < n_layers - 1 else n_groups - 2
        elif key in ("conv1", "class_embedding", "positional_embedding", "ln_pre",
                     "token_embedding"):
            group = 0
        elif key in ("proj", "text_projection"):
            group = n_groups - 1
        elif key in ("ln_post", "ln_final", "attn_pool"):
            group = n_groups - 2
        else:
            group = -1
        mask[name] = 1.0 if group >= 0 and group >= first_unlocked else 0.0


def build_trainable_mask(params: Dict[str, torch.Tensor], args) -> Optional[Dict[str, float]]:
    """{name: 1.0 or 0.0} over `params` from the lock and freeze flags of
    `args`; None if nothing is frozen."""
    lock_image = getattr(args, "lock_image", False)
    lock_text = getattr(args, "lock_text", False)
    freeze = getattr(args, "freeze", False)
    if not (lock_image or lock_text or freeze):
        return None
    mask = {name: 1.0 for name in params}
    towers: Dict[str, dict] = {"visual": {}, "text": {}}
    for name in params:
        tower, key, block = _tower_key(name)
        if tower is not None:
            towers[tower][name] = (key, block)
    if lock_image and towers["visual"]:
        _lock_tower(mask, towers["visual"], getattr(args, "lock_image_unlocked_groups", 0))
    if lock_text and towers["text"]:
        _lock_tower(mask, towers["text"], getattr(args, "lock_text_unlocked_layers", 0))
    if freeze and towers["text"]:
        # the text transformer frozen but its last k blocks (k = 2 under
        # --freezelast, or freezelast itself where it is an int)
        keep_last = getattr(args, "freezelast", False)
        k = (int(keep_last) if isinstance(keep_last, int) and not isinstance(keep_last, bool)
             else (2 if keep_last else 0))
        blocks = {name: b for name, (key, b) in towers["text"].items() if key == "transformer"}
        n_layers = len(set(blocks.values()))
        for name, b in blocks.items():
            mask[name] = 1.0 if b >= n_layers - k else 0.0
    return mask


def chain_with_mask(tx, mask: Optional[Dict[str, float]]):
    """`tx` with its final updates multiplied by `mask` (a copy; `tx`
    itself is left as it was), or `tx` for no mask."""
    if mask is None:
        return tx
    masked = copy.copy(tx)
    masked.mask = dict(mask)
    return masked
