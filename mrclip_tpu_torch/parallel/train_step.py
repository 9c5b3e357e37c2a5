"""Train state, optimizer and train step of the port (counterpart of
`mrclip_tpu/parallel/train_step.py`), on one device.

- AdamW with the JAX package's weight-decay mask (no decay for parameters
  with fewer than two dimensions or whose name holds `bn`, `batchnorm` or
  `logit`), optional global-norm clipping, lr as a float or a step -> lr
  schedule, and the first moment stored in `moments_dtype`. It is the
  port's own, in plain tensor code, following optax 0.2.6's
  `clip_by_global_norm` + `scale_by_adam` + `add_decayed_weights` +
  `scale_by_learning_rate` operation by operation, roundings included
  (`torch.optim.AdamW` cannot keep a bf16 first moment beside fp32
  parameters).
- One train step: forward in train mode (text dropout from the step's
  generator; a frozen teacher's forward for the distill loss), the loss,
  the gradients, the update, and the logit-scale clamp to ln(100).

Unlike the JAX package's pure functions, the step updates the model's
parameters and the optimizer's moments in place (no second copy of either
lives on the card); the returned state holds the same tensors. Gradient
accumulation (both modes), the device mesh and the other optimizers raise
`NotImplementedError` naming their ROADMAP slice.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Dict, Optional

import torch
from torch import nn

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
            f"{what}: a device mesh is not ported (ROADMAP: later slice 5, multi-GPU)")


def _wd_mask(params: Params) -> Dict[str, bool]:
    """True where weight decay applies: not for ndim < 2 (biases, norms,
    embeddings' scalars) nor for anything bn-like or the logit scale/bias.
    Leading singleton dims do not count, so timm's `cls_token` [1, 1, W]
    and `pos_embed` [1, N, W] decide as the JAX package's `class_embedding`
    [W] and `positional_embedding` [N, W] do."""

    def decide(name: str, p: torch.Tensor) -> bool:
        name = name.lower()
        shape = list(p.shape)
        while shape and shape[0] == 1:
            shape.pop(0)
        if len(shape) < 2:
            return False
        return not ("bn" in name or "batchnorm" in name or "logit" in name)

    return {name: decide(name, p) for name, p in params.items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax.global_norm).
    One multi-tensor norm that accumulates in fp64: PyTorch's fp32 CPU norm
    adds one element after another and drifts (1.9e-4 relative on 6.3M
    elements, the size of a token embedding table), where XLA sums
    pairwise."""
    norms = torch._foreach_norm([t.float() for t in tensors], 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Params
    nu: Params


class AdamW:
    """optax.adamw (with an optional clip_by_global_norm in front) on a
    dict of named parameters, updated in place."""

    def __init__(self, lr, b1: float, b2: float, eps: float, wd: float,
                 grad_clip_norm: Optional[float], mu_dtype: Optional[torch.dtype]):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, wd
        self.grad_clip_norm = grad_clip_norm
        self.mu_dtype = mu_dtype

    def init(self, params: Params) -> AdamWState:
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> AdamWState:
        """One step: moments and parameters change in place; returns the
        state with the count advanced. `grad_norm`, when the caller has it,
        saves recomputing it for the clip. The fp32 arithmetic runs as
        multi-tensor operations over every parameter (`torch._foreach_*`);
        only the two steps that mix mu's stored type with fp32 go tensor by
        tensor."""
        b1, b2 = self.b1, self.b2
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        count = state.count + 1
        # optax: 1 - decay**count in fp32, the moments divided by it
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n].float() for n in names]
        mu_prev = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        if self.grad_clip_norm is not None:
            g_norm = global_norm(g) if grad_norm is None else grad_norm
            keep = g_norm < self.grad_clip_norm
            g = [torch.where(keep, x, x / g_norm * self.grad_clip_norm) for x in g]
        # mu = (1 - b1) g + b1 mu: b1 * mu in mu's own type with b1 rounded to
        # it (JAX's weak typing), added in fp32; mu stays unrounded until it
        # is stored
        b1_stored = float(torch.tensor(b1, dtype=mu_prev[0].dtype)) if mu_prev else b1
        mu = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(mu_prev, b1_stored))
        # nu = (1 - b2) g^2 + b2 nu, fp32
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        # update = mu_hat / (sqrt(nu_hat) + eps) [+ wd p], then * -lr
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, den)
        mask = _wd_mask(params)
        decay = [i for i, n in enumerate(names) if mask[n]]
        if decay:
            torch._foreach_add_([update[i] for i in decay],
                                torch._foreach_mul([p[i] for i in decay], self.wd))
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(p, update)
        torch._foreach_copy_(mu_prev, mu)  # the cast to moments_dtype happens here, last
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


def create_optimizer(
    *,
    lr: Callable[[int], float] | float,
    beta1: float = 0.9,
    beta2: float = 0.98,
    eps: float = 1e-6,
    wd: float = 0.2,
    grad_clip_norm: Optional[float] = None,
    opt: str = "adamw",
    moments_dtype: Optional[str] = None,
) -> AdamW:
    """AdamW with the JAX package's defaults (b1 0.9, b2 0.98, eps 1e-6,
    wd 0.2) and weight-decay mask; `moments_dtype='bfloat16'` stores the
    first moment in bf16. Other optimizers raise."""
    if opt != "adamw":
        raise NotImplementedError(
            f"opt={opt!r} is not ported; the port has adamw (ROADMAP: later slice 3, "
            "the training CLI's options)")
    mu_dtype = getattr(torch, moments_dtype) if moments_dtype else None
    if mu_dtype is not None and not isinstance(mu_dtype, torch.dtype):
        raise ValueError(f"moments_dtype={moments_dtype!r} is not a torch dtype")
    return AdamW(lr, beta1, beta2, eps, wd, grad_clip_norm, mu_dtype)


@dataclasses.dataclass
class TrainState:
    """Step count, the model's trainable parameters by name (the module's
    own tensors), the optimizer state and the constants: the frozen
    `logit_scale` buffer of a model built with `logit_scale_trainable=False`
    (the module's own tensor; a checkpoint saves it)."""

    step: int
    params: Params
    opt_state: AdamWState
    constants: Params = dataclasses.field(default_factory=dict)


def create_train_state(model: nn.Module, tx: AdamW, mesh=None) -> TrainState:
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


def apply_updates(tx: AdamW, state: TrainState, grads: Params, ldict: dict):
    """The update, the logit-scale clamp and the metrics (the loss dict and
    `grad_norm`, the global L2 norm of the gradients): (state, metrics)."""
    grad_norm = global_norm(grads.values())
    opt_state = tx.update(grads, state.opt_state, state.params, grad_norm=grad_norm)
    _clamp_logit_scale(state.params)
    metrics = dict(ldict, grad_norm=grad_norm)
    return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics


def build_train_step(
    model: nn.Module,
    loss_apply: Callable[[dict, dict], dict],
    tx: AdamW,
    mesh=None,
    *,
    accum_freq: int = 1,
    cached_features_accum: bool = False,
    teacher: Optional[nn.Module] = None,
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
    """
    _no_mesh(mesh, "build_train_step")
    if accum_freq != 1 or cached_features_accum:
        raise NotImplementedError(
            "gradient accumulation (accum_freq > 1, plain or cached-feature) is not "
            "ported (ROADMAP: modules item 3, the training CLI's options)")

    def step_fn(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None):
        grads, ldict = loss_and_grads(model, loss_apply, state.params, batch, generator, teacher)
        return apply_updates(tx, state, grads, ldict)

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
