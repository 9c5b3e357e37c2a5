"""Streaming multipositive contrastive loss (the port of
`chunked_multipositive_loss` and `chunked_multipositive_clip_loss` from
`mrclip_tpu/ops/fused_loss.py`): SupCon Eq. (2) over
`scale * queries @ keys.T` without the [Nq, Nk] logits.

Per query row it keeps the running max, the running sum of exponentials,
the positive logit sum and the positive count, over key chunks of
`chunk_size` (an online log-sum-exp, as flash attention's). The JAX package
has no Pallas kernel here (a `lax.scan` with `jax.checkpoint` on its body),
so the port is torch ops: a `torch.autograd.Function` whose forward keeps
the four [Nq] statistics and whose backward recomputes each chunk's logits
from them, so that both passes hold O(Nq x chunk) at a time, as the
checkpointed scan does. CoCa's `chunked_caption_xent` and
`coca_loss_chunked` come with CoCa (ROADMAP: modules item 5).

The type rule is JAX's: `queries @ k_blk.T` is taken in the features' own
type and only then cast to fp32 (the dense losses promote to fp32 first).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..losses.contrastive import _two_directions, single_device

__all__ = ["chunked_multipositive_loss", "chunked_multipositive_clip_loss"]

_EPS = 1e-12


def _chunk_pos(labels_q, labels_blk, c0, offset):
    """The positive mask of one key chunk starting at key c0, fp32; with an
    `offset`, position (i, offset + i) removed (the self pair)."""
    pos = (labels_q[:, None] == labels_blk[None, :]).float()
    if offset is not None:
        rows = torch.arange(pos.shape[0], device=pos.device)
        cols = rows + offset - c0
        keep = (cols >= 0) & (cols < pos.shape[1])
        pos[rows[keep], cols[keep]] = 0.0
    return pos


class _ChunkedMultipositive(torch.autograd.Function):
    """Loss forward over key chunks; the backward recomputes each chunk.

    d loss / d z_ij = (p_ij - pos_ij / |P(i)|) / Nq with p_ij =
    exp(z_ij - m_i) / (s_i + 1e-12): the row max m enters the loss as
    `m - m (s / (s + 1e-12))`, so its own gradient is 1e-12 / (s + 1e-12) <=
    1e-12 of the rest and is left out (JAX's AD carries it through the
    max)."""

    @staticmethod
    def forward(ctx, queries, keys, logit_scale, labels_q, labels_k, chunk, offset):
        n_q = queries.shape[0]
        scale = logit_scale.float()
        m = torch.full((n_q,), -torch.inf, device=queries.device)
        s, pos_sum, pos_cnt = (torch.zeros(n_q, device=queries.device) for _ in range(3))
        for c0 in range(0, keys.shape[0], chunk):
            z = scale * (queries @ keys[c0:c0 + chunk].T).float()
            pos = _chunk_pos(labels_q, labels_k[c0:c0 + chunk], c0, offset)
            new_m = torch.maximum(m, z.amax(dim=1))
            s = s * torch.exp(m - new_m) + torch.exp(z - new_m[:, None]).sum(dim=1)
            m = new_m
            pos_sum = pos_sum + (pos * z).sum(dim=1)
            pos_cnt = pos_cnt + pos.sum(dim=1)
        num_pos = pos_cnt.clamp(min=1.0)
        per_sample = -(pos_sum - num_pos * m) / num_pos + torch.log(s + _EPS)
        ctx.save_for_backward(queries, keys, logit_scale, labels_q, labels_k, m, s, num_pos)
        ctx.chunk, ctx.offset = chunk, offset
        return per_sample.mean()

    @staticmethod
    def backward(ctx, grad):
        queries, keys, logit_scale, labels_q, labels_k, m, s, num_pos = ctx.saved_tensors
        scale = logit_scale.float()
        coef = grad.float() / queries.shape[0]
        want_q, want_k, want_scale = ctx.needs_input_grad[:3]
        dq = torch.zeros(queries.shape, device=queries.device) if want_q else None
        dk = torch.empty_like(keys) if want_k else None
        dscale = torch.zeros((), device=queries.device) if want_scale else None
        inv_s = 1.0 / (s + _EPS)
        for c0 in range(0, keys.shape[0], ctx.chunk):
            k_blk = keys[c0:c0 + ctx.chunk]
            raw = (queries @ k_blk.T).float()
            pos = _chunk_pos(labels_q, labels_k[c0:c0 + ctx.chunk], c0, ctx.offset)
            p = torch.exp(scale * raw - m[:, None]) * inv_s[:, None]
            dz = (p - pos / num_pos[:, None]) * coef
            if want_scale:
                dscale += (dz * raw).sum()
            g = (dz * scale).to(queries.dtype)  # the cast's transpose: back to the features' type
            if want_q:
                dq += (g @ k_blk).float()
            if want_k:
                dk[c0:c0 + ctx.chunk] = g.T @ queries
        return (dq.to(queries.dtype) if want_q else None, dk,
                dscale.to(logit_scale.dtype).reshape(logit_scale.shape) if want_scale else None,
                None, None, None, None)


def chunked_multipositive_loss(
    queries: torch.Tensor,
    keys: torch.Tensor,
    labels_q: torch.Tensor,
    labels_k: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    chunk_size: int = 1024,
    exclude_diagonal_offset: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """SupCon Eq. (2) over `scale * queries @ keys.T`, key chunk by key
    chunk: `multi_positive_cross_entropy_loss`'s value (same eps, same
    positive normalization) to float rounding. `exclude_diagonal_offset`:
    position (i, offset + i) is removed from the positives (vision-only
    SupCon). The keys must tile by `chunk_size` or be fewer."""
    n_k = keys.shape[0]
    if not (n_k % chunk_size == 0 or n_k < chunk_size):  # JAX's assert, kept under -O
        raise AssertionError(f"keys ({n_k}) must tile by chunk_size ({chunk_size})")
    offset = None if exclude_diagonal_offset is None else int(exclude_diagonal_offset)
    return _ChunkedMultipositive.apply(queries, keys, logit_scale, labels_q, labels_k,
                                       min(chunk_size, n_k), offset)


def chunked_multipositive_clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    labels: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    delta: float = 0.5,
    chunk_size: int = 1024,
    axis_name: Optional[str] = None,
    gather_with_grad: bool = True,
) -> dict:
    """`multipositive_clip_loss` with streamed negatives: the same keys and
    values."""
    single_device(axis_name, "chunked_multipositive_clip_loss")
    loss_img = chunked_multipositive_loss(image_features, text_features, labels, labels,
                                          logit_scale, chunk_size=chunk_size)
    loss_txt = chunked_multipositive_loss(text_features, image_features, labels, labels,
                                          logit_scale, chunk_size=chunk_size)
    return _two_directions(loss_img, loss_txt, delta)
