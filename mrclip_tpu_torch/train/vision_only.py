"""Image-only (SimCLR-style) train step, epoch loop and eval of the port
(counterpart of `mrclip_tpu/train/vision_only.py`): the model is called
with images only, and the image<->image logits feed the vision-only
multipositive SupCon (`multipositive_clip_loss_vision_only`); retrieval
ranks images against images, each image's own row left out. Images reach
the model as the loader made them: under `--native-loader` its uint8
canvases, unnormalised, as in the JAX package (whose vision-only loop takes
no `augment_fn` and normalises nothing either).
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..losses import multipositive_clip_loss_vision_only
from ..ops import launch_counts, launches_since
from ..parallel.train_step import TrainState, _grads, _no_mesh, apply_updates
from .loop import AverageMeter, _device_of, _to_device, append_results_jsonl
from .metrics import rank_metrics

__all__ = ["build_vision_only_step", "evaluate_vision_only", "train_one_epoch_vision_only"]


def build_vision_only_step(model: nn.Module, tx, mesh=None):
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


def train_one_epoch_vision_only(step_fn, state, data, epoch: int, args, schedule=None,
                                generator: Optional[torch.Generator] = None):
    """One epoch of image-only steps (the JAX package's loop): the batch
    copied to the model's device, the step, the loss meter and a log line
    every `--log-every-n-steps`, and the kernels launched in the epoch.
    `generator` is seeded from --seed and the epoch. Returns (state,
    {'loss': the epoch's mean})."""
    data["train"].set_epoch(epoch)
    loader = data["train"].dataloader
    device = _device_of(state)
    if generator is not None:
        generator.manual_seed(args.seed + epoch)
    losses_m, batch_time_m = defaultdict(AverageMeter), AverageMeter()
    counts0 = launch_counts()
    end = time.time()
    for i, batch in enumerate(loader):
        batch = _to_device(batch, device)
        state, metrics = step_fn(state, batch, generator)
        losses_m["loss"].update(float(metrics["loss"]), args.batch_size)
        batch_time_m.update(time.time() - end)
        end = time.time()
        if i % args.log_every_n_steps == 0:
            logging.info(f"VisionOnly Epoch: {epoch} [{i}/{len(loader)}] "
                         f"Loss: {losses_m['loss'].val:.5g} Batch (t): {batch_time_m.avg:.3f}")
    logging.info(f"Train Epoch: {epoch} kernel launches: {json.dumps(launches_since(counts0))}")
    return state, {k: m.avg for k, m in losses_m.items()}


@torch.no_grad()
def evaluate_vision_only(model, state, data, epoch: int, args) -> dict:
    """Image<->image same-label retrieval over the val set (the diagonal
    masked), `vision_only_val_loss` at the learned temperature (exp of
    `state.params['logit_scale']`; 1 where the scale is no parameter, as the
    JAX package reads it), appended to results.jsonl."""
    if "val" not in data:
        return {}
    loader = data["val"].dataloader
    device = _device_of(state)
    model.eval()
    ls = state.params.get("logit_scale")
    scale = (torch.exp(ls.detach().float()) if ls is not None
             else torch.tensor(1.0, device=device))
    counts0 = launch_counts()
    feats, labels = [], []
    cum_loss, n = 0.0, 0
    for batch in loader:
        batch = _to_device(batch, device)
        img_f = model(batch["images"], None)["image_features"]
        ldict = multipositive_clip_loss_vision_only(img_f, batch["labels"], scale)
        cum_loss += float(ldict["loss"]) * img_f.shape[0]
        n += img_f.shape[0]
        feats.append(img_f.float().cpu().numpy())
        labels.append(batch["labels"].cpu().numpy())
    if n == 0:
        return {}
    img, lbl = np.concatenate(feats), np.concatenate(labels)
    logits = img @ img.T
    np.fill_diagonal(logits, -np.inf)  # no image retrieves itself
    metrics = {f"image_to_image_{k}": v for k, v in rank_metrics(logits, lbl).items()}
    metrics["vision_only_val_loss"] = cum_loss / n
    metrics["epoch"] = epoch
    logging.info(f"VisionOnly Eval {epoch}: "
                 + " ".join(f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, float)))
    logging.info(f"Eval Epoch: {epoch} kernel launches: {json.dumps(launches_since(counts0))}")
    append_results_jsonl(args, metrics)
    return metrics
