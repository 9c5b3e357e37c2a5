"""Depthwise convolution, stride 1, SAME zero padding, NHWC: the port of the
JAX package's `ops/dw_conv.py` (K8 `_fwd_kernel`, K9 `_bwd_kernel`) to two
hand-written Hopper kernels in `csrc/dw_conv.cu`.

A K x K depthwise convolution is a per-channel sum of K^2 shifted images:
y[b, p, q, c] = sum_{i, j} x[b, p + i - K//2, q + j - K//2, c] * w[i*K + j, c],
zero outside the image. The weight is the JAX kernel's `[K*K, C]` fp32 table
(`dw_conv.py:163`): the kernels accumulate in fp32 in the JAX kernel's tap
order `(i, j)` and round once to x's type. The backward (one call, one
launch counted) gives dx, the same stencil over dy with the taps flipped, in
x's type, and dw `[K*K, C]` in fp32, the per-tap sums of x shifted times dy;
dy is first rounded to x's type, as `_core_bwd` does (:143).

Unlike the JAX kernel, whose static slices run out of bounds when H or W is
at most K//2 (the 7 x 7 CPE on a 2 x 2 map), the kernels and the plain
versions here take any H and W: a tap that reaches no output is skipped, as
SAME zero padding has it.

Each kernel wrapper launches on CUDA tensors or raises, and runs its plain
version (`dw_conv_fwd_ref`, `dw_conv_bwd_ref`) only for CPU tensors. How a
launch cuts its work (the tile of output pixels, 16-byte or element-wise
copies, K9's dw partition) is decided here, by `plan`, so the CPU tests
check that it covers every output.
`DwConv` binds them for autograd (the JAX package's custom VJP) and
`dw_conv` takes the port's `[C, 1, K, K]` convolution weight.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass

import torch

from . import build

__all__ = [
    "DwConv",
    "dw_conv",
    "dw_conv_bwd",
    "dw_conv_bwd_ref",
    "dw_conv_fwd",
    "dw_conv_fwd_ref",
    "launches",
    "load_kernels",
    "plan",
    "reset_launches",
]

# kernel sizes the CUDA source instantiates: FastViT's 3 and 7, and 5
KERNEL_SIZES = (3, 5, 7)
# The kernels' tiling (csrc/dw_conv.cu): a block of 8 warps owns 64 channels
# of a tile of output pixels; a thread a channel pair and a strip of 8
# outputs along W, so a tile's width is a multiple of 8.
TILE_C = 64
STRIP = 8
# Shared memory of one block at most, by kernel: three K8 blocks or two K9
# blocks share an SM's 228 KB (each with 1 KB the card reserves; K9's
# registers allow two blocks, K8's four).
SMEM_BUDGET = {False: 75 * 1024, True: 112 * 1024}
# K9's dw reduction: about this many blocks in its first kernel, each
# walking a fixed run of tiles of one 64-channel slice into its own partial
# (tools/dw_conv_variants.py: 1024 and 2048 took longer)
_DW_BLOCKS = 512

# Launches of each CUDA kernel since import or the last reset_launches().
launches = {"dw_conv_fwd": 0, "dw_conv_bwd": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


@functools.lru_cache(maxsize=None)
def load_kernels():
    """Build (at first use) and bind K8 and K9, `dw_conv_fwd` and
    `dw_conv_bwd` of `csrc/dw_conv.cu`."""
    lib = build.load_library("dw_conv")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fns = {"dw_conv_fwd": [ptr] * 3 + [i] * 10 + [ptr],
           "dw_conv_bwd": [ptr] * 6 + [i] * 12 + [ptr]}
    out = {}
    for name, argtypes in fns.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _kernel_size(w2: torch.Tensor) -> int:
    k = math.isqrt(w2.shape[0])
    if w2.dim() != 2 or k * k != w2.shape[0] or k % 2 == 0:
        raise ValueError(f"the weight table must be [K*K, C] with K odd; got {tuple(w2.shape)}")
    return k


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or float64 for float64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _taps(h: int, w: int, k: int):
    """(tap, output rows, output cols, input rows, input cols) of each tap
    (i, j) in order that reaches an output: the JAX kernel's `_tap_slices`,
    without the empty ones (H or W at most K//2)."""
    p = k // 2
    for i in range(k):
        for j in range(k):
            di, dj = i - p, j - p
            or0, or1 = max(0, -di), h - max(0, di)
            oc0, oc1 = max(0, -dj), w - max(0, dj)
            if or1 > or0 and oc1 > oc0:
                yield (i * k + j, slice(or0, or1), slice(oc0, oc1),
                       slice(or0 + di, or1 + di), slice(oc0 + dj, oc1 + dj))


def dw_conv_fwd_ref(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: x [B, H, W, C], w2 [K*K, C] fp32 -> y [B, H, W, C]
    in x's type; the K^2 shifted slices accumulated in fp32 in tap order,
    each product rounded, then added (no fused multiply-add)."""
    k = _kernel_size(w2)
    acc = torch.zeros(x.shape, dtype=_acc_dtype(x.dtype), device=x.device)
    for t, orow, ocol, irow, icol in _taps(x.shape[1], x.shape[2], k):
        acc[:, orow, ocol] += x[:, irow, icol].to(acc.dtype) * w2[t]
    return acc.to(x.dtype)


def dw_conv_bwd_ref(x: torch.Tensor, w2: torch.Tensor, dy: torch.Tensor):
    """Plain version of K9: (dx [B, H, W, C] in x's type, dw [K*K, C] fp32).
    dy is rounded to x's type first; dx is the flipped-tap stencil over dy
    accumulated in fp32 in tap order, dw the per-tap sums of x shifted
    times dy."""
    k = _kernel_size(w2)
    dy = dy.to(x.dtype)
    acc = torch.zeros(x.shape, dtype=_acc_dtype(x.dtype), device=x.device)
    dw = torch.zeros(w2.shape, dtype=acc.dtype, device=x.device)
    for t, orow, ocol, irow, icol in _taps(x.shape[1], x.shape[2], k):
        g = dy[:, orow, ocol].to(acc.dtype)
        acc[:, irow, icol] += g * w2[t]
        dw[t] = (x[:, irow, icol].to(acc.dtype) * g).sum(dim=(0, 1, 2))
    return acc.to(x.dtype), dw


def smem_bytes(k: int, itemsize: int, th: int, tw: int, backward: bool = False) -> int:
    """Dynamic shared memory of a K8 block (or a K9 block): the [K*K, 64]
    fp32 weight slice, the input (dy) tile with its halo, and K9's x tile
    (or, if larger, K9's [groups - 1, K*K, 32] float2 of row-group sums)."""
    halo = (th + k - 1) * (tw + k - 1) * TILE_C * itemsize
    weights = k * k * TILE_C * 4
    if not backward:
        return weights + halo
    groups = max(1, 8 // k)
    return weights + max(halo + th * tw * TILE_C * itemsize, (groups - 1) * k * k * 32 * 8)


@dataclass(frozen=True)
class Plan:
    """How a K8 or K9 launch cuts its work, as the kernels run it. `th` x
    `tw` output pixels x 64 channels a tile; `tiles` per channel slice (B x
    ceil(H/th) x ceil(W/tw), the image slowest, then the tile row); `slices`
    of 64 channels; `wide`: 16-byte copies and pair stores; `smem`: a
    block's dynamic shared memory, bytes; K9's first kernel runs `parts`
    blocks per slice, each walking `per_part` consecutive tiles (the last
    maybe fewer), and writes one partial each."""

    th: int
    tw: int
    tiles: int
    slices: int
    wide: bool
    smem: int
    parts: int
    per_part: int


@functools.lru_cache(maxsize=1024)
def plan(b: int, h: int, w: int, c: int, k: int, itemsize: int, backward: bool = False,
         aligned: bool = True, *, tile: tuple[int, int] | None = None,
         dw_blocks: int = _DW_BLOCKS) -> Plan:
    """The tile, copy width and dw partition of one call. The tile is 16
    outputs wide at maps of 16 and wider, else the map's width rounded up to
    8, and up to 256 / tw rows (never more than H): square where the map
    allows, the least halo per output; halved in height (then narrowed)
    until a block fits in SMEM_BUDGET. 16-byte copies (`wide`) need C a
    multiple of 16 bytes' elements and every tensor of the call 16-byte
    aligned (`aligned`); otherwise the kernels copy and store element by
    element. K9: about `dw_blocks` blocks, none without a tile (no atomics:
    the partials are added in order, the same on every run). `tile` (th,
    tw), tw a multiple of 8, starts the fit from another tile than the
    default one (tools/dw_conv_variants.py)."""
    if tile is None:
        tw = min(16, -(-w // STRIP) * STRIP)
        th = min(h, max(1, 256 // tw))
    else:
        th, tw = tile
    while (smem := smem_bytes(k, itemsize, th, tw, backward)) > SMEM_BUDGET[backward]:
        if th > 1:
            th = -(-th // 2)
        elif tw > STRIP:
            tw -= STRIP
        else:
            raise ValueError(f"no tile of K={k} fits in {SMEM_BUDGET[backward]} bytes")
    tiles = b * -(-h // th) * -(-w // tw)
    slices = -(-c // TILE_C)
    wide = aligned and c % (16 // itemsize) == 0
    if not backward:
        return Plan(th, tw, tiles, slices, wide, smem, tiles, 1)
    per_part = -(-tiles // max(1, min(tiles, -(-dw_blocks // slices))))
    return Plan(th, tw, tiles, slices, wide, smem, -(-tiles // per_part), per_part)


def _plan_for(x: torch.Tensor, k: int, *tensors: torch.Tensor, backward: bool = False,
              **overrides) -> Plan:
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *tensors))
    return plan(*x.shape, k, x.element_size(), backward, aligned, **overrides)


def _kernel_args(name, x, w2, dy=None):
    """Check what the kernels take; returns K."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    tensors = (x, w2) if dy is None else (x, w2, dy)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices: {[t.device for t in tensors]}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes fp32 or bf16 x; got {x.dtype}")
    if x.dim() != 4 or 0 in x.shape or x.numel() >= 2**31:
        raise ValueError(f"{name}: x must be a non-empty [B, H, W, C] of fewer than 2^31 "
                         f"elements (32-bit offsets); got {tuple(x.shape)}")
    if not x.is_contiguous() or (dy is not None and not dy.is_contiguous()):
        raise ValueError(f"{name}: x and dy must be contiguous NHWC")
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype):
        raise ValueError(f"{name}: dy must be x's shape and type; got {tuple(dy.shape)} {dy.dtype}")
    k = _kernel_size(w2)
    if w2.dtype != torch.float32 or w2.shape[1] != x.shape[3] or not w2.is_contiguous():
        raise ValueError(f"{name}: the weight table must be contiguous fp32 [K*K, C={x.shape[3]}]; "
                         f"got {tuple(w2.shape)} {w2.dtype}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"{name}: kernel size {k} is not built; the kernels take {KERNEL_SIZES}")
    return k


def _launch(fn, name, *args):
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    with _count_lock:
        launches[name] += 1


def _run_fwd(x, w2, y, k, p: Plan, fn) -> None:
    """Launch K8 through `fn` (the bound `dw_conv_fwd`) into y, as plan `p`
    cuts it; counted."""
    _launch(fn, "dw_conv_fwd", x, w2, y, *x.shape[1:], k, int(x.dtype == torch.bfloat16),
            p.th, p.tw, int(p.wide), p.tiles, p.smem)


def _run_bwd(x, w2, dy, dx, dw, k, p: Plan, fn) -> None:
    """Launch K9 through `fn` (the bound `dw_conv_bwd`) into dx and dw, as
    plan `p` cuts it; counted."""
    partial = torch.empty(p.parts, k * k, x.shape[3], dtype=torch.float32, device=x.device)
    _launch(fn, "dw_conv_bwd", x, w2, dy, dx, partial, dw, *x.shape[1:], k,
            int(x.dtype == torch.bfloat16), p.th, p.tw, int(p.wide), p.tiles, p.parts,
            p.per_part, p.smem)


def dw_conv_fwd(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K8: y [B, H, W, C] in x's type from contiguous x (bf16 or fp32) and
    the fp32 [K*K, C] table. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return dw_conv_fwd_ref(x, w2)
    k = _kernel_args("dw_conv_fwd", x, w2)
    y = torch.empty_like(x)
    _run_fwd(x, w2, y, k, _plan_for(x, k, y), load_kernels()["dw_conv_fwd"])
    return y


def dw_conv_bwd(x: torch.Tensor, w2: torch.Tensor, dy: torch.Tensor):
    """K9: (dx in x's type, dw fp32 [K*K, C]) in one call (one kernel reads
    x and dy once, writes dx and a dw partial per block; a second adds the
    partials in order). dy is rounded to x's type first. CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return dw_conv_bwd_ref(x, w2, dy)
    dy = dy.to(x.dtype)
    k = _kernel_args("dw_conv_bwd", x, w2, dy)
    dx = torch.empty_like(x)
    dw = torch.empty(k * k, x.shape[3], dtype=torch.float32, device=x.device)
    _run_bwd(x, w2, dy, dx, dw, k, _plan_for(x, k, dy, dx, backward=True),
             load_kernels()["dw_conv_bwd"])
    return dx, dw


class DwConv(torch.autograd.Function):
    """K8 forward, K9 backward (the JAX package's `_core` custom VJP)."""

    @staticmethod
    def forward(ctx, x, w2):
        ctx.save_for_backward(x, w2)
        return dw_conv_fwd(x, w2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w2 = ctx.saved_tensors
        dx, dw = dw_conv_bwd(x, w2, dy.contiguous())
        return dx, dw.to(w2.dtype)


def dw_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Depthwise convolution, stride 1, SAME padding: x [B, H, W, C] (bf16
    or fp32, contiguous), `weight` the `[C, 1, K, K]` parameter of a
    depthwise `Conv2d` (K odd). Returns [B, H, W, C] in x's type;
    differentiable in x and the weight."""
    c, group, k, k2 = weight.shape
    if group != 1 or k != k2 or k % 2 == 0 or c != x.shape[-1]:
        raise ValueError(f"dw_conv: the weight must be [C={x.shape[-1]}, 1, K, K] with K odd; "
                         f"got {tuple(weight.shape)}")
    # [C, 1, K, K] -> [K*K, C], tap i*K + j: the JAX kernel's [K, K, 1, C] table
    w2 = weight.reshape(c, k * k).t().to(_acc_dtype(weight.dtype)).contiguous()
    return DwConv.apply(x, w2)
