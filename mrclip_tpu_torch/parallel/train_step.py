"""Train state and train step of the port (counterpart of
`mrclip_tpu/parallel/train_step.py`), on one device.

- The optimizers (AdamW, SGD, Lion, Adafactor, the JAX package's
  weight-decay mask) are `parallel/optim.py`'s, re-exported here.
- One train step: forward in train mode (text dropout from the step's
  generator; a frozen teacher's forward for the distill loss), the loss,
  the gradients, the update (masked for frozen parameters by
  `parallel/freeze.py`), and the logit-scale clamp to ln(100).
- Gradient accumulation over `accum_freq` consecutive microbatches of the
  batch, plain (the microbatch gradients averaged) or cached-feature (a
  no-gradient pass caches every microbatch's features; each microbatch is
  then run again with gradients, its live features spliced into the cached
  batch, and the gradients summed), as the JAX package has them.

Unlike the JAX package's pure functions, the step updates the model's
parameters and the optimizer's moments in place (no second copy of either
lives on the card); the returned state holds the same tensors. The device
mesh raises `NotImplementedError` naming its ROADMAP slice.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.transformer import running_stats
from .optim import AdamW, AdamWState, _wd_mask, create_optimizer, global_norm  # noqa: F401

__all__ = [
    "AdamW",
    "AdamWState",
    "LOGIT_SCALE_MAX",
    "apply_updates",
    "TrainState",
    "build_eval_step",
    "build_train_step",
    "create_optimizer",
    "create_train_state",
    "global_norm",
    "loss_and_grads",
    "make_loss_apply",
]

LOGIT_SCALE_MAX = math.log(100.0)

Params = Dict[str, torch.Tensor]


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: a device mesh is not ported (ROADMAP: modules item 6, multi-GPU)")


@dataclasses.dataclass
class TrainState:
    """Step count, the model's trainable parameters by name (the module's
    own tensors), the optimizer state and the constants: the frozen
    `logit_scale` buffer of a model built with `logit_scale_trainable=False`
    (the module's own tensor; a checkpoint saves it)."""

    step: int
    params: Params
    opt_state: object
    constants: Params = dataclasses.field(default_factory=dict)


def create_train_state(model: nn.Module, tx, mesh=None) -> TrainState:
    """The train state of `model`'s trainable parameters (mesh=None only)."""
    _no_mesh(mesh, "create_train_state")
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    constants = {n: b for n, b in model.named_buffers() if n == "logit_scale"}
    return TrainState(step=0, params=params, opt_state=tx.init(params), constants=constants)


@torch.no_grad()
def _clamp_logit_scale(params: Params) -> None:
    """Clamp the learned temperature to [0, ln 100], in place."""
    if "logit_scale" in params:
        params["logit_scale"].clamp_(0, LOGIT_SCALE_MAX)


# Loss function -> ordered positional arguments, each taken from the batch
# or the model output (the JAX package's argument orders). Keyed by
# "<module>.<qualname>"; unknown losses fail.
_MP_SPEC = ("image_features", "text_features", "labels", "logit_scale")
_LOSS_ARG_SPECS: dict = {
    "mrclip_tpu_torch.losses.contrastive.clip_loss": (
        "image_features", "text_features", "logit_scale"),
    "mrclip_tpu_torch.losses.contrastive.multipositive_clip_loss": _MP_SPEC,
    "mrclip_tpu_torch.ops.fused_loss.chunked_multipositive_clip_loss": _MP_SPEC,
    "mrclip_tpu_torch.ops.pallas_loss.pallas_multipositive_clip_loss": _MP_SPEC,
    "mrclip_tpu_torch.losses.contrastive.multipositive_clip_loss_with_vision": _MP_SPEC,
    "mrclip_tpu_torch.losses.contrastive.multipositive_clip_loss_with_distance": (
        "image_features", "text_features", "labels",
        "echo_time", "repetition_time", "logit_scale"),
    "mrclip_tpu_torch.losses.contrastive.multipositive_clip_loss_vision_only": (
        "image_features", "labels", "logit_scale"),
    "mrclip_tpu_torch.losses.contrastive.siglip_loss": (
        "image_features", "text_features", "logit_scale", "logit_bias"),
    "mrclip_tpu_torch.losses.contrastive.distill_clip_loss": (
        "image_features", "text_features", "logit_scale",
        "dist_image_features", "dist_text_features", "dist_logit_scale"),
}
# Fields sourced from the data batch; everything else comes from model_out.
_BATCH_FIELDS = frozenset({"labels", "echo_time", "repetition_time"})


def _loss_key(fn: Callable) -> str:
    return f"{fn.__module__}.{fn.__qualname__}"


def _resolve_loss_arg(name: str, model_out: dict, batch: dict):
    if name in _BATCH_FIELDS:
        if name not in batch:
            raise ValueError(f"loss requires batch['{name}'] but the batch has "
                             f"{sorted(batch)}")
        return batch[name]
    if name == "logit_bias":  # a model without one: SigLIP with a zero bias
        return model_out.get("logit_bias", torch.tensor(0.0, device=model_out["logit_scale"].device))
    if name not in model_out:
        raise ValueError(f"loss requires model output '{name}' but the model produced "
                         f"{sorted(model_out)}")
    return model_out[name]


def make_loss_apply(loss_fn: Callable[..., dict], mesh=None) -> Callable[[dict, dict], dict]:
    """Adapt a `create_loss` loss to `(model_out, batch) -> dict`."""
    _no_mesh(mesh, "make_loss_apply")
    fn = loss_fn
    while isinstance(fn, partial):
        fn = fn.func
    spec = _LOSS_ARG_SPECS.get(_loss_key(fn))
    if spec is None:
        raise ValueError(
            f"No loss adapter registered for {_loss_key(fn)}; known losses: "
            f"{sorted(_LOSS_ARG_SPECS)}")

    def loss_apply(model_out: dict, batch: dict) -> dict:
        return loss_fn(*(_resolve_loss_arg(name, model_out, batch) for name in spec))

    return loss_apply


def _model_out(model: nn.Module, batch: dict, generator: Optional[torch.Generator] = None,
               teacher: Optional[nn.Module] = None) -> dict:
    """The train-mode forward (dropout masks from `generator`) and, with a
    `teacher`, its eval-mode forward without gradients as the distillation
    targets `dist_image_features`, `dist_text_features` and
    `dist_logit_scale`."""
    model.train()
    out = model(batch["images"], batch["tokens"], generator=generator)
    if teacher is not None:
        teacher.eval()
        with torch.no_grad():
            t_out = teacher(batch["images"], batch["tokens"])
        out = dict(out, dist_image_features=t_out["image_features"],
                   dist_text_features=t_out["text_features"],
                   dist_logit_scale=t_out["logit_scale"])
    return out


def _grads(loss: torch.Tensor, params: Params) -> Params:
    """Gradients by name; a parameter the loss does not reach gets zeros."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return dict(zip(params, grads))


def loss_and_grads(model: nn.Module, loss_apply: Callable[[dict, dict], dict],
                   params: Params, batch: dict, generator: Optional[torch.Generator] = None,
                   teacher: Optional[nn.Module] = None):
    """(grads by name, loss dict) of one train-mode forward and backward.
    A parameter the loss does not reach gets a zero gradient."""
    ldict = loss_apply(_model_out(model, batch, generator, teacher), batch)
    return _grads(ldict["loss"], params), {k: v.detach() for k, v in ldict.items()}


def apply_updates(tx, state: TrainState, grads: Params, ldict: dict):
    """The update, the logit-scale clamp and the metrics (the loss dict and
    `grad_norm`, the global L2 norm of the gradients): (state, metrics)."""
    grad_norm = global_norm(grads.values())
    opt_state = tx.update(grads, state.opt_state, state.params, grad_norm=grad_norm)
    _clamp_logit_scale(state.params)
    metrics = dict(ldict, grad_norm=grad_norm)
    return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics


def _micro(batch: dict, accum_freq: int, i: int) -> dict:
    """Microbatch `i` of `accum_freq` consecutive ones (the JAX package's
    `micro(i)`: rows i*m .. (i+1)*m - 1)."""
    n = len(batch["images"])
    if n % accum_freq:
        raise ValueError(f"a batch of {n} rows does not split into {accum_freq} microbatches")
    m = n // accum_freq
    return {k: v[i * m:(i + 1) * m] for k, v in batch.items()}


def _add_(total: Optional[Params], grads: Params) -> Params:
    if total is None:
        return grads
    torch._foreach_add_(list(total.values()), [grads[n] for n in total])
    return total


def build_train_step(
    model: nn.Module,
    loss_apply: Callable[[dict, dict], dict],
    tx,
    mesh=None,
    *,
    accum_freq: int = 1,
    cached_features_accum: bool = False,
    teacher: Optional[nn.Module] = None,
    freeze_bn_subtrees: tuple = (),
):
    """The train step `step_fn(state, batch, generator=None) -> (state,
    metrics)`.

    batch: {'images': [N, H, W, 3] normalised float, 'tokens': [N, L],
    'labels': [N]} on the model's device, and 'echo_time' and
    'repetition_time' [N] for the distance loss. `generator` is the step's
    source of randomness: the text dropout draws its masks from it (a CUDA
    generator for a model on the card), and a model with dropout needs one.
    `teacher`: a frozen model for the distill loss, run in eval mode without
    gradients on the same batch. metrics: the loss dict and `grad_norm`, as
    tensors on the device. Parameters and moments are updated in place.

    With `accum_freq` A > 1, N = A m and the step runs A microbatches of m
    consecutive rows: plain, each microbatch's loss and gradients on its own
    rows, the gradients averaged; with `cached_features_accum`, pass 1
    caches every microbatch's features in train mode without gradients,
    pass 2 runs each microbatch again with gradients (from the generator
    state its pass-1 forward started from, so it draws the same dropout
    masks), its live rows spliced into the cache, the loss on all N rows
    and the gradients summed. Either way metrics are {'loss': the mean of
    the A losses, 'grad_norm'}. BatchNorm running statistics move in every
    train-mode forward, in order; under `freeze_bn_subtrees` (towers such
    as 'visual') they are put back after the step
    (`--lock-image-freeze-bn-stats`).
    """
    _no_mesh(mesh, "build_train_step")
    if accum_freq < 1:
        raise ValueError(f"accum_freq must be >= 1, got {accum_freq}")

    def single(state, batch, generator):
        return loss_and_grads(model, loss_apply, state.params, batch, generator, teacher)

    def plain(state, batch, generator):
        grads, loss_sum = None, 0.0
        for i in range(accum_freq):
            g, ld = loss_and_grads(model, loss_apply, state.params, _micro(batch, accum_freq, i),
                                   generator, teacher)
            grads, loss_sum = _add_(grads, g), loss_sum + ld["loss"]
        torch._foreach_mul_(list(grads.values()), 1.0 / accum_freq)
        return grads, {"loss": loss_sum / accum_freq}

    def cached(state, batch, generator):
        micro = [_micro(batch, accum_freq, i) for i in range(accum_freq)]
        starts, img, txt = [], [], []
        model.train()
        with torch.no_grad():
            for mb in micro:
                starts.append(generator.get_state() if generator is not None else None)
                out = model(mb["images"], mb["tokens"], generator=generator)
                img.append(out["image_features"])
                txt.append(out["text_features"])
        end = generator.get_state() if generator is not None else None
        grads, loss_sum = None, 0.0
        for i, mb in enumerate(micro):
            if generator is not None:
                generator.set_state(starts[i])
            out = model(mb["images"], mb["tokens"], generator=generator)
            spliced = dict(out, image_features=torch.cat([*img[:i], out["image_features"],
                                                          *img[i + 1:]]),
                           text_features=torch.cat([*txt[:i], out["text_features"],
                                                    *txt[i + 1:]]))
            loss = loss_apply(spliced, batch)["loss"]
            grads, loss_sum = _add_(grads, _grads(loss, state.params)), loss_sum + loss.detach()
        if generator is not None:
            generator.set_state(end)
        return grads, {"loss": loss_sum / accum_freq}

    compute = single if accum_freq == 1 else cached if cached_features_accum else plain

    def step_fn(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None):
        frozen_stats = [s for tower in freeze_bn_subtrees if hasattr(model, tower)
                        for s in running_stats(getattr(model, tower))]
        grads, ldict = compute(state, batch, generator)
        state, metrics = apply_updates(tx, state, grads, ldict)
        with torch.no_grad():
            for b, saved in frozen_stats:
                b.copy_(saved)
        return state, metrics

    return step_fn


def build_eval_step(model: nn.Module, mesh=None):
    """Inference step: `eval_fn(batch) -> model output dict`, in eval mode
    without gradients."""
    _no_mesh(mesh, "build_eval_step")

    @torch.no_grad()
    def eval_fn(batch: dict) -> dict:
        model.eval()
        return model(batch["images"], batch["tokens"])

    return eval_fn
