"""The port's optimizers (counterpart of `create_optimizer` in
`mrclip_tpu/parallel/train_step.py`): AdamW, SGD with Nesterov momentum,
Lion and Adafactor on a dict of named parameters, updated in place.

Each follows its optax 0.2.6 chain operation by operation, roundings
included, in plain tensor code over every parameter at once
(`torch._foreach_*`; Adafactor's per-tensor second-moment statistics go
tensor by tensor):
- adamw: `clip_by_global_norm`, `scale_by_adam`, `add_decayed_weights`,
  `scale_by_learning_rate` (`optax.adamw`);
- sgd: `add_decayed_weights`, `trace(momentum or 0.9, nesterov=True)`,
  `scale_by_learning_rate` (the JAX package's chain);
- lion: `scale_by_lion`, `add_decayed_weights`, `scale_by_learning_rate`
  (`optax.lion`);
- adafactor: `scale_by_factored_rms` (decay 1 - t^-0.8, eps 1e-30,
  factored where the two largest dims are both >= 128),
  `clip_by_block_rms(1)`, the learning rate, `scale_by_param_block_rms`
  (min 1e-3), `add_decayed_weights`, `scale(-1)` (`optax.adafactor`): the
  weight decay comes after the learning rate, as optax has it.
`grad_clip_norm` clips by the global norm first, for all four. Weight
decay follows the JAX package's mask (`_wd_mask`). An optimizer carrying a
`mask` (`parallel.freeze.chain_with_mask`) multiplies each frozen
parameter's final update by 0 (the JAX package's `apply_update_mask`); its
moments move as the others do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["AdamW", "AdamWState", "Adafactor", "AdafactorState", "Lion", "LionState", "SGD",
           "SGDState", "create_optimizer", "global_norm"]

Params = Dict[str, torch.Tensor]


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


def _stored(x: float, like: torch.Tensor) -> float:
    """`x` rounded to `like`'s type: a Python float times a bf16 array
    computes in bf16 under JAX's weak typing."""
    return float(torch.tensor(x, dtype=like.dtype))


class _Optimizer:
    """What the four share: the learning rate (a float or a step -> lr
    schedule of the update count), the global-norm clip, weight decay on
    `_wd_mask`'s parameters, and the update mask."""

    mask: Optional[Dict[str, float]] = None

    def __init__(self, lr, wd: float, grad_clip_norm: Optional[float]):
        self.lr, self.wd, self.grad_clip_norm = lr, wd, grad_clip_norm

    def _lr(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def _grads(self, grads: Params, p: List[torch.Tensor], names: List[str],
               grad_norm: Optional[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients in `names`' order in their parameters' type (fp32;
        float64 for a reference run), clipped to the global norm."""
        g = [grads[n].to(x.dtype) for n, x in zip(names, p)]
        if self.grad_clip_norm is not None:
            g_norm = global_norm(g) if grad_norm is None else grad_norm
            keep = g_norm < self.grad_clip_norm
            g = [torch.where(keep, x, x / g_norm * self.grad_clip_norm) for x in g]
        return g

    def _decay(self, update: List[torch.Tensor], p: List[torch.Tensor], names: List[str]):
        """update += wd * p where weight decay applies, 32 tensors at a time
        (the wd * p temporaries stay small beside 2.5 B parameters)."""
        mask = _wd_mask(dict(zip(names, p)))
        decay = [i for i, n in enumerate(names) if mask[n]]
        for k in range(0, len(decay), 32):
            idx = decay[k:k + 32]
            torch._foreach_add_([update[i] for i in idx],
                                torch._foreach_mul([p[i] for i in idx], self.wd))

    def _apply(self, p: List[torch.Tensor], update: List[torch.Tensor], names: List[str]):
        """p += update, each frozen parameter's update multiplied by 0."""
        if self.mask is not None:
            frozen = [u for n, u in zip(names, update) if self.mask[n] != 1.0]
            if frozen:
                torch._foreach_mul_(frozen, 0.0)
        torch._foreach_add_(p, update)


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Params
    nu: Params


class AdamW(_Optimizer):
    """optax.adamw (with an optional clip_by_global_norm in front); the
    first moment stored in `mu_dtype` (`torch.optim.AdamW` cannot keep a
    bf16 first moment beside fp32 parameters)."""

    def __init__(self, lr, b1: float, b2: float, eps: float, wd: float,
                 grad_clip_norm: Optional[float], mu_dtype: Optional[torch.dtype]):
        super().__init__(lr, wd, grad_clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
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
        saves recomputing it for the clip. Only the two steps that mix mu's
        stored type with fp32 go tensor by tensor."""
        b1, b2 = self.b1, self.b2
        lr = self._lr(state.count)
        count = state.count + 1
        # optax: 1 - decay**count in fp32, the moments divided by it
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        names = list(params)
        p = [params[n] for n in names]
        g = self._grads(grads, p, names, grad_norm)
        mu_prev = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        # mu = (1 - b1) g + b1 mu: b1 * mu in mu's own type with b1 rounded to
        # it (JAX's weak typing), added in fp32; mu stays unrounded until it
        # is stored
        mu = torch._foreach_mul(g, 1 - b1)
        if mu_prev:
            torch._foreach_add_(mu, torch._foreach_mul(mu_prev, _stored(b1, mu_prev[0])))
        # nu = (1 - b2) g^2 + b2 nu, fp32
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        del g2
        torch._foreach_copy_(mu_prev, mu)  # the cast to moments_dtype; mu stays fp32 below
        # update = mu_hat / (sqrt(nu_hat) + eps) [+ wd p], then * -lr, in
        # mu's buffers: two parameter-sized fp32 temporaries at most (mu and
        # den), not four
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        update = mu
        torch._foreach_div_(update, bc1)
        torch._foreach_div_(update, den)
        del den
        self._decay(update, p, names)
        torch._foreach_mul_(update, -lr)
        self._apply(p, update, names)
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


@dataclasses.dataclass
class SGDState:
    count: int
    trace: Params


class SGD(_Optimizer):
    """The JAX package's sgd: `add_decayed_weights(wd)`, then
    `trace(momentum, nesterov=True)` (trace = u + m trace; update = u + m
    trace), then the learning rate."""

    def __init__(self, lr, momentum: float, wd: float, grad_clip_norm: Optional[float]):
        super().__init__(lr, wd, grad_clip_norm)
        self.momentum = momentum

    def init(self, params: Params) -> SGDState:
        return SGDState(count=0, trace={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: SGDState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> SGDState:
        lr = self._lr(state.count)
        names = list(params)
        p = [params[n] for n in names]
        update = self._grads(grads, p, names, grad_norm)
        if self.grad_clip_norm is None:  # _grads returned the gradients themselves
            update = [u.clone() for u in update]
        self._decay(update, p, names)
        trace = [state.trace[n] for n in names]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, update)
        torch._foreach_add_(update, torch._foreach_mul(trace, self.momentum))
        torch._foreach_mul_(update, -lr)
        self._apply(p, update, names)
        return SGDState(count=state.count + 1, trace=state.trace)


@dataclasses.dataclass
class LionState:
    count: int
    mu: Params


class Lion(_Optimizer):
    """optax.lion: update = sign((1 - b1) g + b1 mu) [+ wd p], times -lr;
    mu = (1 - b2) g + b2 mu, stored in `mu_dtype` (b1 mu and b2 mu in mu's
    own type, as AdamW's first moment). The step goes 32 tensors at a time:
    its fp32 temporaries (the update and the new moment) then stay small
    beside 4.7 B parameters (EVA02-E-14), where all at once they would be
    two more parameter-sized buffers."""

    def __init__(self, lr, b1: float, b2: float, wd: float, grad_clip_norm: Optional[float],
                 mu_dtype: Optional[torch.dtype]):
        super().__init__(lr, wd, grad_clip_norm)
        self.b1, self.b2, self.mu_dtype = b1, b2, mu_dtype

    def init(self, params: Params) -> LionState:
        return LionState(count=0, mu={n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                                      for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: LionState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> LionState:
        lr = self._lr(state.count)
        names = list(params)
        if self.grad_clip_norm is not None and grad_norm is None:
            grad_norm = global_norm([grads[n] for n in names])  # the clip's, over all
        for k in range(0, len(names), 32):
            group = names[k:k + 32]
            p = [params[n] for n in group]
            g = self._grads(grads, p, group, grad_norm)
            mu_prev = [state.mu[n] for n in group]
            update = torch._foreach_mul(g, 1 - self.b1)
            torch._foreach_add_(update, torch._foreach_mul(mu_prev, _stored(self.b1, mu_prev[0])))
            torch._foreach_sign_(update)
            mu = torch._foreach_mul(g, 1 - self.b2)
            torch._foreach_add_(mu, torch._foreach_mul(mu_prev, _stored(self.b2, mu_prev[0])))
            self._decay(update, p, group)
            torch._foreach_mul_(update, -lr)
            self._apply(p, update, group)
            torch._foreach_copy_(mu_prev, mu)
        return LionState(count=state.count + 1, mu=state.mu)


@dataclasses.dataclass
class AdafactorState:
    count: int
    v_row: Params
    v_col: Params
    v: Params


def _factored_dims(shape) -> Optional[tuple]:
    """optax's `_factored_dims` at min_dim_size_to_factor 128: the two
    largest dims (numpy's argsort, as optax sorts them), or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _block_rms(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """sqrt(mean(x^2)) of each tensor, fp32."""
    sums = torch._foreach_mul(tensors, tensors)
    return [torch.sqrt(s.mean()) for s in sums]


class Adafactor(_Optimizer):
    """optax.adafactor(learning_rate=lr, weight_decay_rate=wd) with the
    JAX package's weight-decay mask."""

    eps = 1e-30
    decay_rate = 0.8
    clip = 1.0
    min_scale = 1e-3

    def init(self, params: Params) -> AdafactorState:
        one = lambda p: torch.zeros(1, dtype=p.dtype, device=p.device)  # noqa: E731
        v_row, v_col, v = {}, {}, {}
        for n, p in params.items():
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                v_row[n], v_col[n], v[n] = one(p), one(p), torch.zeros_like(p)
            else:
                d1, d0 = dims
                v_row[n] = torch.zeros(np.delete(p.shape, d0).tolist(), dtype=p.dtype,
                                       device=p.device)
                v_col[n] = torch.zeros(np.delete(p.shape, d1).tolist(), dtype=p.dtype,
                                       device=p.device)
                v[n] = one(p)
        return AdafactorState(count=0, v_row=v_row, v_col=v_col, v=v)

    @torch.no_grad()
    def update(self, grads: Params, state: AdafactorState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> AdafactorState:
        lr = self._lr(state.count)
        names = list(params)
        p = [params[n] for n in names]
        g = self._grads(grads, p, names, grad_norm)
        # the second-moment decay of this step, fp32 (optax's _decay_rate_pow)
        decay = 1.0 - torch.tensor(state.count + 1, dtype=torch.float32) ** -self.decay_rate
        keep, fresh = float(decay), float(1.0 - decay)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_add_(g2, self.eps)
        update = []
        for n, x, x2 in zip(names, g, g2):
            dims = _factored_dims(tuple(x.shape))
            if dims is None:
                v = state.v[n]
                v.mul_(keep).add_(x2 * fresh)
                update.append(x * v ** -0.5)
                continue
            d1, d0 = dims
            v_row, v_col = state.v_row[n], state.v_col[n]
            v_row.mul_(keep).add_(x2.mean(dim=d0) * fresh)
            v_col.mul_(keep).add_(x2.mean(dim=d1) * fresh)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            update.append(x * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1))
        # clip_by_block_rms(1): u / max(1, rms(u) / 1)
        denom = [torch.clamp_min(r / self.clip, 1.0) for r in _block_rms(update)]
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, lr)
        # scale_by_param_block_rms: u * max(rms(p), 1e-3)
        scale = [torch.where(r <= self.min_scale, self.min_scale, r) for r in _block_rms(p)]
        torch._foreach_mul_(update, scale)
        self._decay(update, p, names)
        torch._foreach_neg_(update)
        self._apply(p, update, names)
        return dataclasses.replace(state, count=state.count + 1)


def create_optimizer(
    *,
    lr: Callable[[int], float] | float,
    beta1: float = 0.9,
    beta2: float = 0.98,
    eps: float = 1e-6,
    wd: float = 0.2,
    grad_clip_norm: Optional[float] = None,
    opt: str = "adamw",
    momentum: Optional[float] = None,
    moments_dtype: Optional[str] = None,
):
    """The JAX package's `create_optimizer`: adamw (its defaults b1 0.9, b2
    0.98, eps 1e-6, wd 0.2), sgd (Nesterov, momentum `momentum or 0.9`),
    lion (b1, b2 from beta1, beta2) or adafactor, each with the weight-decay
    mask and an optional global-norm clip in front.
    `moments_dtype='bfloat16'` stores AdamW's and Lion's first moment in
    bf16."""
    mu_dtype = getattr(torch, moments_dtype) if moments_dtype else None
    if mu_dtype is not None and not isinstance(mu_dtype, torch.dtype):
        raise ValueError(f"moments_dtype={moments_dtype!r} is not a torch dtype")
    if opt == "adamw":
        return AdamW(lr, beta1, beta2, eps, wd, grad_clip_norm, mu_dtype)
    if opt == "sgd":
        return SGD(lr, momentum or 0.9, wd, grad_clip_norm)
    if opt == "lion":
        return Lion(lr, beta1, beta2, wd, grad_clip_norm, mu_dtype)
    if opt == "adafactor":
        return Adafactor(lr, wd, grad_clip_norm)
    raise ValueError(f"unknown optimizer {opt}")
