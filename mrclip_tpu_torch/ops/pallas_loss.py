"""Fused multipositive contrastive loss: the port of `ops/pallas_loss.py`
(K6 `_fwd_kernel`, K7 `_grad_q_kernel` and `_grad_k_kernel`) to three
hand-written Hopper kernels in `csrc/supcon_loss.cu`.

SupCon Eq. (2) over `z = scale * q @ k.T` without the `[Nq, Nk]` logits in
device memory. Forward, per row i: m_i = max_j z_ij, s_i = sum_j
exp(z_ij - m_i), pos_sum_i = sum_{j in P(i)} z_ij, P_i = |P(i)|;
loss = mean_i [-(pos_sum_i - P_i m_i) / P_i + log(s_i + 1e-12)], with P_i
clamped to 1, exactly as the JAX package writes it. The backward recomputes
each tile for dq (and the per-row logit-scale terms) and for dk.

Each kernel wrapper launches on CUDA tensors or raises, and runs its plain
version only for CPU tensors. `MultipositiveLoss` binds them for autograd
(the JAX package's custom VJP), and `pallas_multipositive_clip_loss` is the
two-direction, `delta`-weighted loss that `create_loss(pallas_loss=True)`
returns. The kernels mask their own ragged tiles, so any batch size works
without the TPU version's block fitting.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from ..losses.contrastive import single_device
from . import build

__all__ = [
    "MultipositiveLoss",
    "pallas_multipositive_clip_loss",
    "pallas_multipositive_loss",
    "supcon_grad_k",
    "supcon_grad_k_ref",
    "supcon_grad_q",
    "supcon_grad_q_ref",
    "supcon_stats",
    "supcon_stats_ref",
    "launches",
    "reset_launches",
    "load_kernels",
]

_EPS = 1e-12

# Launches of each CUDA kernel since import or the last reset_launches().
launches = {"supcon_stats": 0, "supcon_grad_q": 0, "supcon_grad_k": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _count_launch(name: str) -> None:
    with _count_lock:
        launches[name] += 1


@functools.lru_cache(maxsize=None)
def load_kernels():
    """Build (at first use) and bind the three C entry points."""
    lib = build.load_library("supcon_loss")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fns = {
        "supcon_stats": [ptr] * 9 + [i] * 3 + [ptr],
        "supcon_grad_q": [ptr] * 11 + [i] * 3 + [ptr],
        "supcon_grad_k": [ptr] * 10 + [i] * 3 + [ptr],
    }
    out = {}
    for name, argtypes in fns.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _logits(q, k, scale):
    return scale * (q.float() @ k.float().T)


def _pos(labels_q, labels_k):
    return (labels_q[:, None] == labels_k[None, :]).float()


def supcon_stats_ref(q, k, labels_q, labels_k, scale):
    """Plain version of K6: (m, s, pos_sum, pos_cnt), each fp32 [Nq]."""
    z = _logits(q, k, scale)
    pos = _pos(labels_q, labels_k)
    m = z.amax(dim=1)
    s = torch.exp(z - m[:, None]).sum(dim=1)
    return m, s, (pos * z).sum(dim=1), pos.sum(dim=1)


def _coeff(q, k, labels_q, labels_k, scale, m, s, cnt, gbar):
    qk = q.float() @ k.float().T
    p = torch.exp(scale * qk - m[:, None]) / s[:, None]
    coeff = (p - _pos(labels_q, labels_k) / cnt[:, None]) * gbar * scale
    return qk, coeff


def supcon_grad_q_ref(q, k, labels_q, labels_k, scale, m, s, cnt, gbar):
    """Plain version of K7's `grad_q`: (dq fp32 [Nq, D], ds_rows fp32 [Nq])."""
    qk, coeff = _coeff(q, k, labels_q, labels_k, scale, m, s, cnt, gbar)
    return coeff @ k.float(), (coeff * qk).sum(dim=1) / scale


def supcon_grad_k_ref(q, k, labels_q, labels_k, scale, m, s, cnt, gbar):
    """Plain version of K7's `grad_k`: dk fp32 [Nk, D]."""
    _, coeff = _coeff(q, k, labels_q, labels_k, scale, m, s, cnt, gbar)
    return coeff.T @ q.float()


def _kernel_args(name, q, k, labels_q, labels_k, scalars, rows=()):
    """Check what the kernels take and return the contiguous operands."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    tensors = (q, k, labels_q, labels_k, *scalars, *rows)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices: {[t.device for t in tensors]}")
    if q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"{name}: q [Nq, D] and k [Nk, D] expected; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if q.dtype != torch.float32 or k.dtype != torch.float32:
        raise TypeError(f"{name}: kernel takes fp32 q and k; got {q.dtype}, {k.dtype}")
    if labels_q.shape != (q.shape[0],) or labels_k.shape != (k.shape[0],):
        raise ValueError(f"{name}: labels must be [Nq] and [Nk]; got {tuple(labels_q.shape)}, "
                         f"{tuple(labels_k.shape)}")
    if labels_q.dtype != torch.int32 or labels_k.dtype != torch.int32:
        raise TypeError(f"{name}: kernel takes int32 labels; got {labels_q.dtype}, "
                        f"{labels_k.dtype}")
    for t in scalars:
        if t.numel() != 1 or t.dtype != torch.float32:
            raise ValueError(f"{name}: scale and gbar must be one fp32 value each")
    for t in rows:
        if t.shape != (q.shape[0],) or t.dtype != torch.float32:
            raise ValueError(f"{name}: row statistics must be fp32 [Nq]; got {tuple(t.shape)} "
                             f"{t.dtype}")
    if q.shape[0] == 0 or k.shape[0] == 0 or q.shape[1] == 0:
        raise ValueError(f"{name}: empty operands {tuple(q.shape)}, {tuple(k.shape)}")
    return [t.contiguous() for t in tensors]


def _launch(name, *args):
    fn = load_kernels()[name]
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _count_launch(name)


def supcon_stats(q, k, labels_q, labels_k, scale):
    """K6: per-row (m, s, pos_sum, pos_cnt) of z = scale * q k^T, fp32 [Nq]
    each. q [Nq, D] and k [Nk, D] fp32, int32 labels, `scale` a one-element
    fp32 tensor. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return supcon_stats_ref(q, k, labels_q, labels_k, scale)
    q, k, lq, lk, sc = _kernel_args("supcon_stats", q, k, labels_q, labels_k, (scale,))
    outs = [torch.empty(q.shape[0], dtype=torch.float32, device=q.device) for _ in range(4)]
    _launch("supcon_stats", q, k, lq, lk, sc, *outs, q.shape[0], k.shape[0], q.shape[1])
    return tuple(outs)


def supcon_grad_q(q, k, labels_q, labels_k, scale, m, s, cnt, gbar):
    """K7 `grad_q`: (dq fp32 [Nq, D], ds_rows fp32 [Nq]) from the forward's
    m, s and clamped count; `gbar` (= g / Nq) and `scale` are one-element
    fp32 tensors. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return supcon_grad_q_ref(q, k, labels_q, labels_k, scale, m, s, cnt, gbar)
    q, k, lq, lk, sc, gb, m, s, cnt = _kernel_args(
        "supcon_grad_q", q, k, labels_q, labels_k, (scale, gbar), (m, s, cnt))
    dq = torch.empty_like(q)
    ds_rows = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    _launch("supcon_grad_q", q, k, lq, lk, m, s, cnt, sc, gb, dq, ds_rows,
            q.shape[0], k.shape[0], q.shape[1])
    return dq, ds_rows


def supcon_grad_k(q, k, labels_q, labels_k, scale, m, s, cnt, gbar):
    """K7 `grad_k`: dk fp32 [Nk, D]. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return supcon_grad_k_ref(q, k, labels_q, labels_k, scale, m, s, cnt, gbar)
    q, k, lq, lk, sc, gb, m, s, cnt = _kernel_args(
        "supcon_grad_k", q, k, labels_q, labels_k, (scale, gbar), (m, s, cnt))
    dk = torch.empty_like(k)
    _launch("supcon_grad_k", q, k, lq, lk, m, s, cnt, sc, gb, dk,
            q.shape[0], k.shape[0], q.shape[1])
    return dk


class MultipositiveLoss(torch.autograd.Function):
    """SupCon Eq. (2) of `scale * q @ k.T` through K6 forward and K7
    backward; gradients for q, k and the (exponentiated) logit scale."""

    @staticmethod
    def forward(ctx, q, k, labels_q, labels_k, logit_scale):
        qf, kf = q.float(), k.float()
        lq, lk = labels_q.to(torch.int32), labels_k.to(torch.int32)
        scale = logit_scale.detach().float().reshape(1)
        m, s, pos_sum, pos_cnt = supcon_stats(qf, kf, lq, lk, scale)
        cnt = pos_cnt.clamp(min=1.0)
        per_sample = -(pos_sum - cnt * m) / cnt + torch.log(s + _EPS)
        ctx.save_for_backward(qf, kf, lq, lk, scale, m, s, cnt)
        ctx.dtypes = (q.dtype, k.dtype, logit_scale.dtype, logit_scale.shape)
        return per_sample.mean()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        qf, kf, lq, lk, scale, m, s, cnt = ctx.saved_tensors
        q_dtype, k_dtype, scale_dtype, scale_shape = ctx.dtypes
        gbar = (g.float() / qf.shape[0]).reshape(1)
        dq, ds_rows = supcon_grad_q(qf, kf, lq, lk, scale, m, s, cnt, gbar)
        dk = supcon_grad_k(qf, kf, lq, lk, scale, m, s, cnt, gbar)
        # d loss / d scale = sum_ij dL/dz_ij * (q_i . k_j); gbar is in ds_rows
        dscale = ds_rows.sum().to(scale_dtype).reshape(scale_shape)
        return dq.to(q_dtype), dk.to(k_dtype), None, None, dscale


def pallas_multipositive_loss(q, k, labels_q, labels_k, logit_scale):
    """SupCon Eq. (2) over `logit_scale * q @ k.T` through the fused kernels;
    the JAX package's `pallas_multipositive_loss` numerics."""
    return MultipositiveLoss.apply(q, k, labels_q, labels_k, logit_scale)


def pallas_multipositive_clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    labels: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    delta: float = 0.5,
    axis_name: Optional[str] = None,
    gather_with_grad: bool = True,
) -> dict:
    """`multipositive_clip_loss` through the fused kernels: each direction
    is one forward (K6) and one backward (K7) pass, `delta`-weighted."""
    single_device(axis_name, "pallas_multipositive_clip_loss")
    loss_img = pallas_multipositive_loss(image_features, text_features, labels, labels,
                                         logit_scale)
    loss_txt = pallas_multipositive_loss(text_features, image_features, labels, labels,
                                         logit_scale)
    loss = delta * loss_img + (1.0 - delta) * loss_txt
    return {
        "loss": loss,
        "multi_contrastive_loss": loss,
        "image_to_text_loss": loss_img,
        "text_to_image_loss": loss_txt,
    }
