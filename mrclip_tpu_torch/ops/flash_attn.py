"""Flash attention, `attn_impl='flash'`: the port of the JAX package's
`ops/flash_attn.py::flash_attention_unpadded`, which pads q, k and v to 128
rows and calls jax's Pallas TPU flash attention, to hand-written Hopper
kernels in `csrc/flash_attn.cu` (K10, the forward) and
`csrc/flash_attn_bwd.cu` (K10b, the backward, its dkv and dq passes in one
call).

Both follow jax's kernels' rounding order, which differs from the fused
kernels' (K1, K4): the keys are walked in blocks of `pick_block(Np)` (256
or 128 of the padded length Np, as `flash_attention_unpadded` picks them),
a causal block wholly above the diagonal of the query's block is skipped,
and with more than one block the UNnormalised P is rounded to the input
type before P V and the block's product is scaled by 1 / l afterwards
(jax's single-block kernel normalises first, as K4 does). The residuals
are the row sum l and row max m, not the log-sum-exp, and the backward
takes di = rowsum(O * dO) in fp32, computed outside the kernel.

jax masks the padded kv columns (segment ids) and the causal pairs by
adding -0.7 * FLT_MAX; every visited block of a row holds one unmasked key
(key 0 is in the first block), so their exp is exactly 0 and the unpadded
q, k, v here give jax's values on every real row (jax slices its padded
query rows off).

`FlashAttention` binds them for autograd. By default (`save_residuals=False`,
the JAX package's `jax.checkpoint` wrapper) it keeps only q, k and v (the
column slices of the in_proj output, uncopied) and its backward launches
K10 again for o, l and m before K10b; with `save_residuals=True` it keeps o,
l and m instead. `flash_attention` and `flash_attention_bwd` launch the
kernels for CUDA tensors and raise on what they cannot take; only CPU
tensors take the plain versions `flash_attention_ref` and
`flash_attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import build
from .fused_attn import bwd_route, check_head_dim, check_rows_aligned_16, fwd_route

__all__ = [
    "FlashAttention",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_ref",
    "flash_attention_unpadded",
    "flash_di",
    "launches",
    "width_launches",
    "route_launches",
    "bwd_launches",
    "load_kernels",
    "pick_block",
    "reset_launches",
]

_LANE = 128
_MASK = -0.7 * float(torch.finfo(torch.float32).max)  # jax's DEFAULT_MASK_VALUE

# Launches since import or the last reset_launches() of K10 (forward) and
# K10b (backward, both passes); one wrapper call counts one launch.
launches = 0
bwd_launches = 0
_COUNTERS = ("launches", "bwd_launches")
# The same launches by (counter name, head dim); K10's also by (counter
# name, head dim, route: fused_attn.FWD_ROUTES).
width_launches: dict[tuple[str, int], int] = {}
route_launches: dict[tuple[str, int, str], int] = {}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in _COUNTERS:
            globals()[name] = 0
        width_launches.clear()
        route_launches.clear()


def _count(name: str, d: int, route: str | None = None) -> None:
    with _count_lock:
        globals()[name] += 1
        width_launches[name, d] = width_launches.get((name, d), 0) + 1
        if route is not None:
            route_launches[name, d, route] = route_launches.get((name, d, route), 0) + 1


def _pad(n: int) -> int:
    return -n % _LANE + n


def pick_block(n: int) -> int:
    """jax's block width for a padded length `n`: the largest of 256 and
    128 that divides it (`flash_attention_unpadded`'s `pick_block`)."""
    for cand in (256, 128):
        if n % cand == 0:
            return cand
    return n


def _blocks(n: int, nk: int) -> tuple[int, int, int]:
    """(query block, key block, number of key blocks) jax uses for N, Nk."""
    blk_q, blk_k = pick_block(_pad(n)), pick_block(_pad(nk))
    return blk_q, blk_k, _pad(nk) // blk_k


def _heads_first(t: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    return t.transpose(1, 2).to(acc)  # [B, L, H, D] -> [B, H, L, D]


def _scores(qf, kf, is_causal):
    """Scaled fp32 scores [B, H, N, Nk] with jax's additive causal mask."""
    s = qf @ kf.transpose(-1, -2) * (1.0 / math.sqrt(qf.shape[-1]))
    if is_causal:
        col = torch.arange(kf.shape[-2], device=s.device)
        row = torch.arange(qf.shape[-2], device=s.device)
        s = s + torch.where(col[None, :] > row[:, None], _MASK, 0.0)
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        is_causal: bool = False):
    """Plain PyTorch version of K10: q `[B, N, H, D]`, k and v `[B, Nk, H,
    D]` -> (o `[B, N, H, D]` in q's type, l and m `[B, H, N]` fp32), in
    jax's block walk and rounding order."""
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)  # fp32 (fp64 stays fp64)
    qf, kf, vf = (_heads_first(t, acc) for t in (q, k, v))
    n, nk = q.shape[1], k.shape[1]
    s = _scores(qf, kf, is_causal)
    blk_q, blk_k, nblk = _blocks(n, nk)

    def cast(p):  # P rounded to the input type before P V
        return p.to(dt).to(acc)

    if nblk == 1:  # jax's single-step kernel: P normalised, then rounded
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = cast(p / l) @ vf
    else:
        m = torch.full(s.shape[:-1] + (1,), -math.inf, dtype=acc, device=s.device)
        l = torch.zeros_like(m)
        o = torch.zeros_like(qf)
        q_block = torch.arange(n, device=s.device)[:, None] // blk_q
        for c in range(nblk):
            lo, hi = c * blk_k, min((c + 1) * blk_k, nk)
            sc = s[..., lo:hi]
            m_next = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_next)
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0, 1.0, 1.0 / l_next)
            o_next = o * (l_corr * inv) + (cast(p) @ vf[..., lo:hi, :]) * inv
            if is_causal:  # below_or_on_diag: blocks above are not visited
                run = (q_block + 1) * blk_q - 1 > lo
                m_next, l_next, o_next = (torch.where(run, a, b) for a, b in
                                          ((m_next, m), (l_next, l), (o_next, o)))
            m, l, o = m_next, l_next, o_next
    return o.to(dt).transpose(1, 2), l[..., 0], m[..., 0]


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    l: torch.Tensor, m: torch.Tensor, di: torch.Tensor, *, is_causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K10b: (dq, dk, dv) `[B, L, H, D]` in q's
    type from the forward's l and m and di = rowsum(O * dO) (`[B, H, N]`
    fp32), in jax's rounding order: P = exp(S - m) * (1 / l); dV =
    round(P)^T dO; dS = (dP - di) P scale, rounded before dS K and dS^T Q;
    fp32 sums, each gradient cast once."""
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    qf, kf, vf, dof = (_heads_first(t, acc) for t in (q, k, v, do))
    p = torch.exp(_scores(qf, kf, is_causal) - m[..., None].to(acc)) * (1 / l[..., None].to(acc))
    dv = p.to(dt).to(acc).transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    ds = ((dp - di[..., None].to(acc)) * p * (1.0 / math.sqrt(q.shape[-1]))).to(dt).to(acc)
    grads = (ds @ kf, ds.transpose(-1, -2) @ qf, dv)
    return tuple(g.to(dt).transpose(1, 2) for g in grads)


def flash_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(O * dO) in fp32, `[B, H, N]`, the torch ops outside the
    kernels that jax's `_flash_attention_bwd` runs before the dkv and dq
    kernels."""
    acc = torch.promote_types(o.dtype, torch.float32)
    return (o.to(acc) * do.to(acc)).sum(-1).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def load_kernels():
    """Build (at first use) and bind K10 and K10b, `flash_attn_fwd` of
    `csrc/flash_attn.cu` and `flash_attn_bwd` of `csrc/flash_attn_bwd.cu`
    (two libraries, built in parallel)."""
    libs = build.load_libraries(("flash_attn", "flash_attn_bwd"))
    fwd, bwd = libs["flash_attn"].flash_attn_fwd, libs["flash_attn_bwd"].flash_attn_bwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(name, ts):
    """Refuse what K10/K10b cannot take: `[B, L, H, D]` views on one CUDA
    device, fp32 or bf16 of one type, a head dim of fused_attn.HEAD_DIMS, heads contiguous
    within a row, base pointer and batch and row strides multiples of 16
    bytes (the forward copies each row's head slice in 16-byte pieces)."""
    first = ts[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    if any(t.device != first.device for t in ts):
        raise ValueError(f"{name}: tensors on different devices: {[t.device for t in ts]}")
    if first.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != first.dtype for t in ts):
        raise TypeError(f"{name}: kernel takes fp32 or bf16 tensors of one type; got "
                        f"{[t.dtype for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError(f"{name}: expected [B, L, H, D] tensors; got {[tuple(t.shape) for t in ts]}")
    d = first.shape[3]
    check_head_dim(name, d)
    if any(t.stride(3) != 1 or t.stride(2) != d for t in ts):
        raise ValueError(f"{name}: the heads of a row must be contiguous (strides [.., D, 1])")
    check_rows_aligned_16(name, ts)


def _check_stats(name, stats, shape, device):
    for s in stats:
        if tuple(s.shape) != shape or s.dtype != torch.float32 or not s.is_contiguous():
            raise ValueError(f"{name}: l, m and di must be contiguous fp32 {shape}; got "
                             f"{tuple(s.shape)} {s.dtype}")
        if s.device != device:
            raise ValueError(f"{name}: l/m/di on {s.device}, q on {device}")


def _strides(*ts):
    """(batch, row) element strides of up to eight tensors, as the kernels'
    16-entry stride array (unused pairs zero)."""
    vals = [s for t in ts for s in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * 16)(*vals, *([0] * (16 - len(vals))))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    is_causal: bool = False):
    """K10: q `[B, N, H, D]`, k and v `[B, Nk, H, D]` (any batch and row
    stride: column slices of one projection go in uncopied) -> (o `[B, N, H,
    D]` contiguous in q's type, l and m `[B, H, N]` fp32). CPU tensors take
    the plain version; CUDA tensors launch the Hopper kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, is_causal=is_causal)
    _check("flash_attention", (q, k, v))
    b, n, h, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, h, d) or v.shape != k.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    l = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    if b == 0 or n == 0:
        return o, l, m
    if nk == 0:
        raise ValueError("attention over zero keys")
    blk_q, blk_k, nblk = _blocks(n, nk)
    with torch.cuda.device(q.device):
        err = load_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
            int(q.dtype == torch.bfloat16), b, n, nk, h, d, _strides(q, k, v, o),
            1.0 / math.sqrt(d), int(is_causal), blk_q, blk_k, nblk,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    _count("launches", d,
           fwd_route("flash_attn", q.dtype == torch.bfloat16, d, False, nk, nblk, is_causal))
    return o, l, m


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    l: torch.Tensor, m: torch.Tensor, di: torch.Tensor, *, is_causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10b: the gradients (dq, dk, dv), contiguous `[B, L, H, D]`, of
    `flash_attention` for the output gradient `do` (o's shape, q's type),
    from its l and m and di = `flash_di(o, do)`. CPU tensors take the plain
    version; CUDA tensors launch the Hopper kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, do, l, m, di, is_causal=is_causal)
    _check("flash_attention_bwd", (q, k, v, do))
    b, n, h, d = q.shape
    nk = k.shape[1]
    if do.shape != q.shape or k.shape != (b, nk, h, d) or v.shape != k.shape:
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, do {tuple(do.shape)}")
    _check_stats("flash_attention_bwd", (l, m, di), (b, h, n), q.device)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    if b and n and nk:
        with torch.cuda.device(q.device):
            err = load_kernels()[1](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), l.data_ptr(),
                m.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                int(q.dtype == torch.bfloat16), b, n, nk, h, d,
                _strides(q, k, v, do, do, dq, dk, dv), 1.0 / math.sqrt(d), int(is_causal),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {err}")
        _count("bwd_launches", d,
               bwd_route("flash_attn_bwd", q.dtype == torch.bfloat16, d, False, n, nk, is_causal))
    elif nk == 0 and n:
        raise ValueError("attention over zero keys")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K10 forward, K10b backward. Keeps q, k and v (`save_residuals=False`:
    the backward launches K10 again for o, l and m, as jax's checkpoint
    recomputes the flash forward) or q, k, v, o, l and m
    (`save_residuals=True`). On CPU tensors both directions run the plain
    versions."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, is_causal: bool,
                save_residuals: bool) -> torch.Tensor:
        o, l, m = flash_attention(q, k, v, is_causal=is_causal)
        ctx.save_for_backward(q, k, v, *((o, l, m) if save_residuals else ()))
        ctx.is_causal = is_causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do: torch.Tensor):
        q, k, v, *res = ctx.saved_tensors
        o, l, m = res or flash_attention(q, k, v, is_causal=ctx.is_causal)
        do = do.to(q.dtype).contiguous()
        grads = flash_attention_bwd(q, k, v, do, l, m, flash_di(o, do), is_causal=ctx.is_causal)
        return (*grads, None, None)


def flash_attention_unpadded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             is_causal: bool = False,
                             save_residuals: bool = False) -> torch.Tensor:
    """The port of the JAX package's `flash_attention_unpadded`: q, k, v
    `[B, N|Nk, H, D]` -> `[B, N, H, D]`, scale 1/sqrt(D), differentiable
    through K10/K10b (`FlashAttention`)."""
    return FlashAttention.apply(q, k, v, is_causal, save_residuals)
