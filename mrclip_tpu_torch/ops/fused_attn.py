"""Packed fused attention, forward: the port of `ops/fused_attn.py`'s
`_packed_fwd_kernel` (batched-head mode, no rope) to a hand-written Hopper
kernel, `csrc/packed_attn_fwd.cu`.

q, k and v stay in the natural layout the QKV projection produces,
`[B, N, H, D]` or packed `[B, N, H*D]`, with any batch and row stride and a
contiguous head dimension: the three column slices of one `in_proj` output
go to the kernel with no copies. The `[N, Nk]` scores never reach device
memory. The kernel returns o and the fp32 log-sum-exp `[B, H, N]` that the
backward (still to be ported) recomputes P from.

`fused_attention_packed` launches the kernel for CUDA tensors and raises on
anything it cannot take; only for tensors on the CPU does it run the plain
version, `fused_attention_packed_ref`, which follows the TPU kernel's
rounding order: fp32 scores, P divided by l in fp32 and cast to the input
type, then P @ V accumulated in fp32.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import build

__all__ = [
    "fused_attention_packed",
    "fused_attention_packed_ref",
    "launches",
    "reset_launches",
    "load_kernel",
]

_NEG = -1e30  # the TPU kernel's additive causal mask value
_HEAD_DIMS = (32, 64)

# Launches of the CUDA kernel since import or the last reset_launches().
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def _as_packed(t: torch.Tensor, heads):
    """[B, N, H, D] or [B, N, H*D] -> ([B, N, H*D] view, H, D)."""
    if t.dim() == 4:
        b, n, h, d = t.shape
        return t.reshape(b, n, h * d), h, d
    if t.dim() != 3 or heads is None:
        raise ValueError(
            "expected [B, N, H, D], or [B, N, H*D] with heads=H; "
            f"got shape {tuple(t.shape)} and heads={heads}"
        )
    if t.shape[2] % heads:
        raise ValueError(f"packed width {t.shape[2]} is not a whole number of {heads} heads")
    return t, heads, t.shape[2] // heads


def _split(q, k, v, heads):
    q3, h, d = _as_packed(q, heads)
    k3, hk, dk = _as_packed(k, h)
    v3, hv, dv = _as_packed(v, h)
    if (hk, dk) != (h, d) or (hv, dv) != (h, d) or k3.shape != v3.shape:
        raise ValueError(
            f"q/k/v head layouts differ: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if q3.shape[0] != k3.shape[0]:
        raise ValueError(f"batch sizes differ: q {q3.shape[0]}, k {k3.shape[0]}")
    return q3, k3, v3, h, d


def fused_attention_packed_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    is_causal: bool = False, heads: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same inputs, same outputs
    (o in q's layout and type, lse [B, H, N] fp32), TPU rounding order."""
    q3, k3, v3, h, d = _split(q, k, v, heads)
    b, n, _ = q3.shape
    nk = k3.shape[1]

    def heads_first(t):  # [B, L, H*D] -> [B, H, L, D] fp32
        return t.reshape(b, t.shape[1], h, d).transpose(1, 2).float()

    s = heads_first(q3) @ heads_first(k3).transpose(-1, -2) * (1.0 / math.sqrt(d))
    if is_causal:
        col = torch.arange(nk, device=s.device)
        row = torch.arange(n, device=s.device)
        s = s + torch.where(col[None, :] > row[:, None], _NEG, 0.0)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    pn = (p / l).to(q.dtype).float()
    o = (pn @ heads_first(v3)).to(q.dtype)  # [B, H, N, D]
    o = o.transpose(1, 2).reshape(q.shape)
    return o, lse


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Build (at first use) and bind the CUDA kernel's C entry point."""
    fn = build.load_library("packed_attn_fwd").packed_attn_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def fused_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    is_causal: bool = False, heads: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(D) [+ causal]) v per head, forward only.

    q: [B, N, H, D] or [B, N, H*D] (pass `heads` for the packed form);
    k, v: the same with Nk rows (Nk may differ from N). Returns
    (o in q's layout and type, lse [B, H, N] fp32). bf16 and fp32, head dim
    32 or 64. CPU tensors take the plain version; CUDA tensors launch the
    Hopper kernel or raise.
    """
    if q.device.type == "cpu":
        return fused_attention_packed_ref(q, k, v, is_causal=is_causal, heads=heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_packed: unsupported device {q.device}")
    q3, k3, v3, h, d = _split(q, k, v, heads)
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"kernel takes fp32 or bf16 q/k/v of one type; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head dim {_HEAD_DIMS}; got {d}")
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.stride(2) != 1:
            raise ValueError(f"{name}: the packed head dimension must be contiguous")
    b, n, hd = q3.shape
    nk = k3.shape[1]
    o = torch.empty((b, n, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return o.reshape(q.shape), lse
    if nk == 0:
        raise ValueError("attention over zero keys")
    kernel = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), b, n, nk, h, d,
            q3.stride(0), q3.stride(1), k3.stride(0), k3.stride(1),
            v3.stride(0), v3.stride(1),
            1.0 / math.sqrt(d), int(is_causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"packed_attn_fwd launch failed: cudaError {err}")
    _count_launch()
    return o.reshape(q.shape), lse
