"""Image-only train step of the port (counterpart of
`build_vision_only_step` in `mrclip_tpu/train/vision_only.py`): the model
is called with images only, and the image<->image logits feed the
vision-only multipositive SupCon (`multipositive_clip_loss_vision_only`).

The epoch loop and evaluation (`train_one_epoch_vision_only`,
`evaluate_vision_only`) come with the training CLI (ROADMAP: modules item
3).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..losses import multipositive_clip_loss_vision_only
from ..parallel.train_step import AdamW, TrainState, _grads, _no_mesh, apply_updates

__all__ = ["build_vision_only_step"]


def build_vision_only_step(model: nn.Module, tx: AdamW, mesh=None):
    """`step_fn(state, batch, generator=None) -> (state, metrics)`: an
    image-only forward in train mode, the vision-only loss on
    batch['labels'], the gradients, the update and the logit-scale clamp.
    metrics: the loss dict and `grad_norm`. Parameters the image forward
    does not reach (the text tower) get zero gradients, as in JAX."""
    _no_mesh(mesh, "build_vision_only_step")

    def step_fn(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None):
        model.train()
        out = model(batch["images"], None, generator=generator)
        ldict = multipositive_clip_loss_vision_only(out["image_features"], batch["labels"],
                                                    out["logit_scale"])
        grads = _grads(ldict["loss"], state.params)
        return apply_updates(tx, state, grads, {k: v.detach() for k, v in ldict.items()})

    return step_fn
