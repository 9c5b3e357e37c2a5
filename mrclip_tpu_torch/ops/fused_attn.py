"""Fused attention: the port of `ops/fused_attn.py`'s kernels to
hand-written Hopper kernels.

'fusedp', the packed layout: `_packed_fwd_kernel` and `_packed_bwd_kernel`
(batched-head mode) are `csrc/packed_attn_fwd.cu` (K1, and K2 with rope;
bf16 on the tensor cores through `csrc/attn_mma_fwd.cuh`, the forward K4
runs, fp32 on an FMA kernel) and `csrc/packed_attn_bwd.cu` (K3, and K3r
with rope; bf16 on the tensor cores through `csrc/attn_mma_bwd.cuh`, the
backward K5 runs, fp32 on FMA kernels), bound together for autograd by `FusedAttentionPacked` (the JAX
package's `_pcore` and `_pcore_rope` custom VJPs).

'fused', the grouped layout: `_fwd_kernel` and `_bwd_kernel` (driven by
`_run_fwd` and `_core_bwd`) are `csrc/grouped_attn.cu` (K4) and
`csrc/grouped_attn_bwd.cu` (K5), bound
by `FusedAttention` (the JAX package's `_core` custom VJP) behind
`fused_attention`. As the JAX package's `prep` does, q, k and v are
transposed to contiguous `[B*H, N, D]` tiles first, and o back after; the
residuals are the grouped (q, k, v, o, lse). The TPU also pads N to 128
rows and B*H to a multiple of 8 (Mosaic's tiling): its padded key columns
enter with -1e30, whose exp is exactly 0 in fp32, and its padded query
rows are sliced off with zero cotangents, so the unpadded kernels here,
which skip keys >= Nk, give the same values on every real row.

With `rope=` (the EVA02 towers' axial 2D rope) q and k rotate inside the
kernels by an `[N, 2D]` sin||cos table in q's type (`rope_table`, identity
rows over the CLS prefix): the rotated tensors and their gradients never
reach device memory. The backward keeps the unrotated q and k, rotates them
again and un-rotates dq and dk before storing them.

q, k and v stay in the natural layout the QKV projection produces,
`[B, N, H, D]` or packed `[B, N, H*D]`, with any batch and row stride and a
contiguous head dimension: the three column slices of one `in_proj` output
go to the kernels with no copies, and the backward writes dq, dk and dv
into the three column slices of one `[B, N, 3*H*D]` gradient buffer. The
`[N, Nk]` scores never reach device memory. The forward returns o and the
fp32 log-sum-exp `[B, H, N]` that the backward recomputes P from.

`fused_attention_packed` and `fused_attention_packed_bwd` launch their
kernels for CUDA tensors and raise on anything the kernels cannot take; only
for tensors on the CPU do they run the plain versions,
`fused_attention_packed_ref` and `fused_attention_packed_bwd_ref`, which
follow the TPU kernels' rounding order.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import build

__all__ = [
    "FusedAttention",
    "FusedAttentionPacked",
    "fused_attention",
    "fused_attention_bwd_ref",
    "fused_attention_grouped",
    "fused_attention_grouped_bwd",
    "fused_attention_ref",
    "group_heads",
    "ungroup_heads",
    "fused_attention_packed",
    "fused_attention_packed_bwd",
    "fused_attention_packed_bwd_ref",
    "fused_attention_packed_ref",
    "fused_attention_qkv",
    "rope_table",
    "rows_aligned_16",
    "check_rows_aligned_16",
    "check_head_dim",
    "HEAD_DIMS",
    "ROPE_HEAD_DIMS",
    "FWD_ROUTES",
    "fwd_route",
    "BWD_ROUTES",
    "bwd_route",
    "launches",
    "width_launches",
    "route_launches",
    "bwd_launches",
    "rope_launches",
    "rope_bwd_launches",
    "grouped_launches",
    "grouped_bwd_launches",
    "reset_launches",
    "load_kernel",
    "load_bwd_kernel",
    "load_rope_kernel",
    "load_rope_bwd_kernel",
    "load_grouped_kernels",
]

_NEG = -1e30  # the TPU kernel's additive causal mask value
# Head dims the CUDA kernels take: ViT-B/L and SigLIP-B/L (64), the small
# towers (32), ViT-SO400M-SigLIP (72), ViT-H-14 (80), ViT-g-14 and
# EVA01-g-14 (88), ViT-bigG-14 (104) and EVA02-E-14 (112); the rope kernels
# (K2, K3r) take EVA02-B/L's 64 and 32 only. flash_attn.py takes the same.
HEAD_DIMS = (32, 64, 72, 80, 88, 104, 112)
ROPE_HEAD_DIMS = (32, 64)

# Launches since import or the last reset_launches() of the packed forward
# (K1), backward (K3), rope forward (K2) and rope backward (K3r) and of the
# grouped forward (K4) and backward (K5) CUDA kernels; one wrapper call
# counts one launch.
launches = 0
bwd_launches = 0
rope_launches = 0
rope_bwd_launches = 0
grouped_launches = 0
grouped_bwd_launches = 0
_COUNTERS = ("launches", "bwd_launches", "rope_launches", "rope_bwd_launches",
             "grouped_launches", "grouped_bwd_launches")
# The same launches by (counter name, head dim), and by (counter name, head
# dim, route).
width_launches: dict[tuple[str, int], int] = {}
route_launches: dict[tuple[str, int, str], int] = {}
_count_lock = threading.Lock()

# The forward kernels' routes, by the value of the libraries' C entry
# `attn_fwd_route` (`csrc/attn_mma_fwd.cuh::fwd_route`, the launchers' own
# choice): fp32 FMA kernels; bf16 `mma_fwd_kernel` (mma.sync),
# `wgmma_fwd_kernel` (D = 64, one key block of at most 256 keys, K2 too),
# `wgmma_wide_fwd_kernel` (no rope, D = 64-112, at most 272 keys) or
# `wgmma_long_fwd_kernel` (no rope, not causal, D = 64-112, past 272 keys).
FWD_ROUTES = ("fma", "mma_sync", "wgmma", "wgmma_wide", "wgmma_long")
# The backward kernels' routes, the first four names by the value of
# `attn_bwd_route` (`csrc/attn_mma_bwd.cuh::bwd_route`): fp32 FMA kernels;
# bf16 `mma_bwd_*` (mma.sync), `wgmma_bwd_*` (D = 64, n and nk at most 256,
# K3r and causal too) or `wgmma_wide_bwd_*` (no rope, not causal, D =
# 64-112, n and nk at most 272, not both within one 64-row sub-tile).
BWD_ROUTES = FWD_ROUTES


@functools.lru_cache(maxsize=None)
def _route_entry(library: str, entry: str, nargs: int):
    fn = getattr(build.load_library(library), entry)
    fn.argtypes = [ctypes.c_int] * nargs
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=4096)
def fwd_route(library: str, is_bf16: bool, d: int, rope: bool, nk: int, nblk: int = 1,
              causal: bool = False) -> str:
    """The route (`FWD_ROUTES`) by which the forward of `csrc/<library>.cu`
    launches at head dim `d` over `nk` keys in `nblk` jax key blocks (K10;
    1 for K1, K2, K4), causal or not, asked of the built library itself."""
    entry = _route_entry(library, "attn_fwd_route", 6)
    return FWD_ROUTES[entry(int(is_bf16), d, int(rope), nk, nblk, int(causal))]


@functools.lru_cache(maxsize=4096)
def bwd_route(library: str, is_bf16: bool, d: int, rope: bool, n: int, nk: int,
              causal: bool) -> str:
    """The route (`BWD_ROUTES`) by which the backward of `csrc/<library>.cu`
    (K3 and K3r: packed_attn_bwd; K5: grouped_attn_bwd; K10b:
    flash_attn_bwd) launches at head dim `d` over `n` query rows and `nk`
    keys, asked of the built library itself."""
    entry = _route_entry(library, "attn_bwd_route", 6)
    return BWD_ROUTES[entry(int(is_bf16), d, int(rope), n, nk, int(causal))]


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


def check_head_dim(name: str, d: int, rope: bool = False) -> None:
    """Refuse, with ValueError naming it, a head dim the CUDA kernels do not
    take (`HEAD_DIMS`; `ROPE_HEAD_DIMS` with a rope table)."""
    dims = ROPE_HEAD_DIMS if rope else HEAD_DIMS
    if d not in dims:
        raise ValueError(f"{name}: kernel takes head dim {dims}{' with rope' if rope else ''}; "
                         f"got {d}")


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


def rope_table(rope, prefix: int, dtype: torch.dtype) -> torch.Tensor:
    """The kernels' rope operand, built as the JAX package's
    `fused_attention_packed` builds it (fused_attn.py:881-888): the
    `[N - prefix, 2D]` sin||cos table of `ops.pos_embed.rope_cat_2d` with
    `prefix` identity rows (sin 0, cos 1) in front for the CLS tokens,
    `[N, 2D]`, cast to `dtype` (q's type, so in bf16 sin and cos are
    themselves rounded). Build it once per tower call, not per layer."""
    rope = torch.as_tensor(rope)
    sin, cos = rope.chunk(2, dim=-1)
    sin = torch.nn.functional.pad(sin, (0, 0, prefix, 0))
    cos = torch.nn.functional.pad(cos, (0, 0, prefix, 0), value=1.0)
    return torch.cat([sin, cos], dim=-1).to(dtype).contiguous()


def _rot(x: torch.Tensor) -> torch.Tensor:
    """rot(x)[2i] = -x[2i+1], rot(x)[2i+1] = x[2i] over the last dim: the
    pair swap of interleaved-pair rope (the TPU's `_rot_matrix` product)."""
    return torch.stack((-x[..., 1::2], x[..., 0::2]), dim=-1).flatten(-2)


def _check_table(rope, n, nk, d, dtype):
    """A rope table is `[N, 2D]` in q's type; rope is self-attention only."""
    if nk != n:
        raise ValueError(f"rope applies to self-attention only; got N={n}, Nk={nk}")
    if rope.shape != (n, 2 * d):
        raise ValueError(f"rope table must be [N, 2D] = {(n, 2 * d)}; got {tuple(rope.shape)}")
    if rope.dtype != dtype:
        raise TypeError(f"rope table must have q's type {dtype} (rope_table casts it); "
                        f"got {rope.dtype}")


def _rope_rotate(x, sin, cos, dt):
    """The TPU's `_rope_rotate`: x * cos + rot(x) * sin in `x`'s (fp32)
    type, rounded to `dt`. x: [B, H, L, D]; sin, cos: [L, D]."""
    return (x * cos + _rot(x) * sin).to(dt).to(x.dtype)


def _rope_unrotate_grad(g, sin, cos, dt):
    """The TPU's `_rope_unrotate_grad`, the VJP of `_rope_rotate`:
    g * cos - rot(round_dt(g * sin)), in g's (fp32) type."""
    return g * cos - _rot((g * sin).to(dt).to(g.dtype))


def _scores(q, k, d, is_causal):
    """fp32 scaled scores [B, H, N, Nk] with the TPU kernels' additive
    causal mask."""
    s = q @ k.transpose(-1, -2) * (1.0 / math.sqrt(d))
    if is_causal:
        col = torch.arange(k.shape[-2], device=s.device)
        row = torch.arange(q.shape[-2], device=s.device)
        s = s + torch.where(col[None, :] > row[:, None], _NEG, 0.0)
    return s


def fused_attention_packed_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    is_causal: bool = False, heads: int | None = None, rope: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernels K1 and (with `rope`) K2: same
    inputs, same outputs (o in q's layout and type, lse [B, H, N] fp32),
    TPU rounding order."""
    q3, k3, v3, h, d = _split(q, k, v, heads)
    b, n, _ = q3.shape
    nk = k3.shape[1]

    acc = torch.promote_types(q.dtype, torch.float32)  # fp32 (fp64 stays fp64)

    def heads_first(t):  # [B, L, H*D] -> [B, H, L, D] in acc
        return t.reshape(b, t.shape[1], h, d).transpose(1, 2).to(acc)

    qf, kf = heads_first(q3), heads_first(k3)
    if rope is not None:
        _check_table(rope, n, nk, d, q.dtype)
        sin, cos = rope.to(acc).chunk(2, dim=-1)
        qf, kf = _rope_rotate(qf, sin, cos, q.dtype), _rope_rotate(kf, sin, cos, q.dtype)
    s = _scores(qf, kf, d, is_causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    pn = (p / l).to(q.dtype).to(acc)
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


@functools.lru_cache(maxsize=None)
def load_rope_kernel():
    """Bind K2, the rope forward (`packed_attn_rope_fwd`, same library)."""
    fn = build.load_library("packed_attn_fwd").packed_attn_rope_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(name, packed, d):
    """Refuse what the CUDA kernels cannot take: packed `[B, L, H*D]` views
    on one CUDA device, fp32 or bf16 of one type, a head dim of `HEAD_DIMS`,
    a contiguous packed head dimension."""
    first = packed[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    if any(t.device != first.device for t in packed):
        raise ValueError(f"{name}: tensors on different devices: {[t.device for t in packed]}")
    if first.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != first.dtype for t in packed):
        raise TypeError(f"{name}: kernel takes fp32 or bf16 tensors of one type; got "
                        f"{[t.dtype for t in packed]}")
    check_head_dim(name, d)
    if any(t.stride(2) != 1 for t in packed):
        raise ValueError(f"{name}: the packed head dimension must be contiguous")


def rows_aligned_16(ptr: int, strides, itemsize: int) -> bool:
    """Whether a view at address `ptr` whose stepped (batch, row) element
    strides are `strides` can be copied row by row in 16-byte pieces, as the
    bf16 tensor-core kernels (K1, K2, K4, K10; K3, K3r, K5, K10b) stage their
    rows: the base pointer and each stride, in bytes, are multiples of 16."""
    return ptr % 16 == 0 and all(s * itemsize % 16 == 0 for s in strides)


def check_rows_aligned_16(name, tensors):
    """Refuse, with ValueError, a `[B, L, ...]` view that `rows_aligned_16`
    refuses; the stride of a dimension of size 1 is never stepped."""
    for t in tensors:
        shape, stride = t.shape, t.stride()  # one call each: this runs on every launch
        steps = [s for s, m in zip(stride[:2], shape[:2]) if m > 1]
        if not rows_aligned_16(t.data_ptr(), steps, t.element_size()):
            raise ValueError(f"{name}: base pointer, batch and row strides must be multiples of "
                             f"16 bytes; got strides {t.stride()} of {t.element_size()}-byte "
                             f"elements at offset {t.data_ptr() % 16} mod 16")


def _check_kernel_table(name, rope, q3, nk, d):
    """Refuse a rope table the kernels cannot take: `[N, 2D]`, q's type and
    device, contiguous; self-attention only; D in `ROPE_HEAD_DIMS`."""
    check_head_dim(name, d, rope=True)
    _check_table(rope, q3.shape[1], nk, d, q3.dtype)
    if rope.device != q3.device:
        raise ValueError(f"{name}: rope table on {rope.device}, q on {q3.device}")
    if not rope.is_contiguous():
        raise ValueError(f"{name}: the rope table must be contiguous")


def fused_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    is_causal: bool = False, heads: int | None = None, rope: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(D) [+ causal]) v per head, forward only.

    q: [B, N, H, D] or [B, N, H*D] (pass `heads` for the packed form);
    k, v: the same with Nk rows (Nk may differ from N). `rope`: an `[N, 2D]`
    sin||cos table in q's type (`rope_table`) by which q and k rotate inside
    the kernel (K2; self-attention, Nk = N). Returns (o in q's layout and
    type, lse [B, H, N] fp32). bf16 and fp32, head dim in `HEAD_DIMS` (32 or
    64 with `rope`); in bf16 the
    base pointers (the table's too) and batch and row strides must be
    multiples of 16 bytes (the tensor-core kernel reads rows in 16-byte
    pieces). CPU tensors take the plain version; CUDA tensors launch the
    Hopper kernel or raise.
    """
    if q.device.type == "cpu":
        return fused_attention_packed_ref(q, k, v, is_causal=is_causal, heads=heads, rope=rope)
    q3, k3, v3, h, d = _split(q, k, v, heads)
    _check_kernel_inputs("fused_attention_packed", (q3, k3, v3), d)
    b, n, hd = q3.shape
    nk = k3.shape[1]
    if rope is not None:
        _check_kernel_table("fused_attention_packed", rope, q3, nk, d)
    if q3.dtype == torch.bfloat16:  # rows and table rows read in 16-byte pieces
        tables = () if rope is None else (rope[None],)
        check_rows_aligned_16("fused_attention_packed", (q3, k3, v3, *tables))
    o = torch.empty((b, n, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return o.reshape(q.shape), lse
    if nk == 0:
        raise ValueError("attention over zero keys")
    strides = (q3.stride(0), q3.stride(1), k3.stride(0), k3.stride(1), v3.stride(0), v3.stride(1))
    tail = (*strides, 1.0 / math.sqrt(d), int(is_causal))
    is_bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rope is None:
            err = load_kernel()(
                q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
                is_bf16, b, n, nk, h, d, *tail, stream,
            )
        else:
            err = load_rope_kernel()(
                q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), rope.data_ptr(), o.data_ptr(),
                lse.data_ptr(), is_bf16, b, n, h, d, *tail, stream,
            )
    entry = "packed_attn_fwd" if rope is None else "packed_attn_rope_fwd"
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    _count("launches" if rope is None else "rope_launches", d,
           fwd_route("packed_attn_fwd", is_bf16, d, rope is not None, nk, 1, is_causal))
    return o.reshape(q.shape), lse


def fused_attention_packed_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *, is_causal: bool = False,
    heads: int | None = None, rope: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels K3 and (with `rope`)
    K3r: (dq, dk, dv) in q's layout and type, in the TPU kernel's rounding
    order: q and k rotated as the forward rotates them; P = exp(S - lse) in
    fp32, cast to the input type before P^T dO; delta = rowsum(dO * O) in
    fp32; dS = P (dP - delta) scale cast to the input type before dS K and
    dS^T Q; every product summed in fp32; dq and dk un-rotated with g * sin
    rounded to the input type; each gradient cast once."""
    q3, k3, v3, h, d = _split(q, k, v, heads)
    o3, _, _ = _as_packed(o, h)
    do3, _, _ = _as_packed(do, h)
    b, n, _ = q3.shape
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)  # fp32 (fp64 stays fp64)

    def heads_first(t):  # [B, L, H*D] -> [B, H, L, D] in acc
        return t.reshape(b, t.shape[1], h, d).transpose(1, 2).to(acc)

    qf, kf, vf, dof = (heads_first(t) for t in (q3, k3, v3, do3))
    if rope is not None:
        _check_table(rope, n, k3.shape[1], d, dt)
        sin, cos = rope.to(acc).chunk(2, dim=-1)
        qf, kf = _rope_rotate(qf, sin, cos, dt), _rope_rotate(kf, sin, cos, dt)
    p = torch.exp(_scores(qf, kf, d, is_causal) - lse[..., None])
    dv = p.to(dt).to(acc).transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * heads_first(o3)).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * (1.0 / math.sqrt(d))).to(dt).to(acc)
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    if rope is not None:
        dq, dk = _rope_unrotate_grad(dq, sin, cos, dt), _rope_unrotate_grad(dk, sin, cos, dt)

    def back(t, like):  # [B, H, L, D] -> like's layout and q's type
        return t.to(dt).transpose(1, 2).reshape(like.shape)

    return back(dq, q), back(dk, k), back(dv, v)


@functools.lru_cache(maxsize=None)
def load_bwd_kernel():
    """Build (at first use) and bind the backward kernel's C entry point."""
    fn = build.load_library("packed_attn_bwd").packed_attn_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def load_rope_bwd_kernel():
    """Bind K3r, the rope backward (`packed_attn_rope_bwd`, same library)."""
    fn = build.load_library("packed_attn_bwd").packed_attn_rope_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def fused_attention_packed_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *, is_causal: bool = False,
    heads: int | None = None, rope: torch.Tensor | None = None, out=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of `fused_attention_packed` for the output
    gradient `do`, from the forward's o and lse (and its `rope` table: K3r).

    Layouts and types as the forward takes them; `do` has o's shape. `out`,
    if given, is a (dq, dk, dv) triple of tensors with q's, k's and v's
    shapes and type and any row stride (for example the column slices of one
    `[B, N, 3*H*D]` buffer), which receive the result. In bf16 the base
    pointers (the table's too) and batch and row strides of all eight views
    must be multiples of 16 bytes (the tensor-core kernels read and write
    rows in 16-byte and 32-bit pieces). CPU tensors take the plain version;
    CUDA tensors launch the Hopper kernel or raise.
    """
    if q.device.type == "cpu":
        grads = fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=is_causal,
                                               heads=heads, rope=rope)
        if out is None:
            return grads
        for dst, g in zip(out, grads):
            dst.copy_(g)
        return tuple(out)
    q3, k3, v3, h, d = _split(q, k, v, heads)
    o3, do3 = _as_packed(o, h)[0], _as_packed(do, h)[0]
    if o3.shape != q3.shape or do3.shape != q3.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    _check_kernel_inputs("fused_attention_packed_bwd", (q3, k3, v3, o3, do3), d)
    b, n, hd = q3.shape
    nk = k3.shape[1]
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {(b, h, n)}; got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if lse.device != q.device:
        raise ValueError(f"lse on {lse.device}, q on {q.device}")
    if rope is not None:
        _check_kernel_table("fused_attention_packed_bwd", rope, q3, nk, d)
    if out is None:
        out = (torch.empty_like(q3, memory_format=torch.contiguous_format),
               torch.empty_like(k3, memory_format=torch.contiguous_format),
               torch.empty_like(v3, memory_format=torch.contiguous_format))
    dq3, dk3, dv3 = (_as_packed(t, h)[0] for t in out)
    if dq3.shape != q3.shape or dk3.shape != k3.shape or dv3.shape != v3.shape:
        raise ValueError(f"out shapes {[tuple(t.shape) for t in out]} differ from q/k/v's")
    _check_kernel_inputs("fused_attention_packed_bwd", (q3, dq3, dk3, dv3), d)
    if q3.dtype == torch.bfloat16:  # 16-byte copies, 32-bit fragment loads and stores
        tables = () if rope is None else (rope[None],)
        check_rows_aligned_16("fused_attention_packed_bwd",
                              (q3, k3, v3, o3, do3, dq3, dk3, dv3, *tables))
    if b and n and nk:
        delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 16)(*(
            s for t in (q3, k3, v3, o3, do3, dq3, dk3, dv3) for s in (t.stride(0), t.stride(1))
        ))
        tail = (strides, 1.0 / math.sqrt(d), int(is_causal))
        is_bf16 = int(q.dtype == torch.bfloat16)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            if rope is None:
                err = load_bwd_kernel()(
                    q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o3.data_ptr(), do3.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq3.data_ptr(), dk3.data_ptr(),
                    dv3.data_ptr(), is_bf16, b, n, nk, h, d, *tail, stream,
                )
            else:
                err = load_rope_bwd_kernel()(
                    q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), rope.data_ptr(), o3.data_ptr(),
                    do3.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq3.data_ptr(),
                    dk3.data_ptr(), dv3.data_ptr(), is_bf16, b, n, h, d, *tail, stream,
                )
        entry = "packed_attn_bwd" if rope is None else "packed_attn_rope_bwd"
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")
        _count("bwd_launches" if rope is None else "rope_bwd_launches", d,
               bwd_route("packed_attn_bwd", is_bf16, d, rope is not None, n, nk, is_causal))
    elif nk == 0 and n:
        raise ValueError("attention over zero keys")
    return tuple(t.reshape(like.shape) for t, like in zip(out, (q, k, v)))


class FusedAttentionPacked(torch.autograd.Function):
    """Self-attention over one packed `[B, N, 3*H*D]` qkv tensor (the
    in_proj output): the forward launches K1 (K2 with a `rope` table) and
    keeps (q, k, v, o, lse), the JAX package's residuals, with q and k
    unrotated; the backward launches K3 (K3r), which writes dq, dk and dv
    straight into the column slices of one `[B, N, 3*H*D]` gradient, so the
    in_proj backward reads it with no concatenation. The table, a position
    constant, gets no gradient (JAX returns zeros for it). On CPU tensors
    both directions run the plain versions. Returns o `[B, N, H*D]`."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, is_causal: bool,
                rope: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = qkv.chunk(3, dim=-1)
        o, lse = fused_attention_packed(q, k, v, is_causal=is_causal, heads=heads, rope=rope)
        ctx.save_for_backward(qkv, o, lse, rope)
        ctx.heads, ctx.is_causal = heads, is_causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do: torch.Tensor):
        qkv, o, lse, rope = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        fused_attention_packed_bwd(
            *qkv.chunk(3, dim=-1), o, do.to(qkv.dtype).contiguous(), lse,
            is_causal=ctx.is_causal, heads=ctx.heads, rope=rope, out=dqkv.chunk(3, dim=-1),
        )
        return dqkv, None, None, None


def fused_attention_qkv(qkv: torch.Tensor, *, heads: int, is_causal: bool = False,
                        rope: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) [+ causal]) v over the three column slices of
    a packed qkv `[B, N, 3*H*D]`, q and k rotated by the `rope` table if
    given, differentiable through the K1/K3 (K2/K3r) kernels
    (`FusedAttentionPacked`)."""
    return FusedAttentionPacked.apply(qkv, heads, is_causal, rope)


def fused_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        is_causal: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 (`_fwd_kernel`) on the grouped layout:
    q `[G, N, D]`, k and v `[G, Nk, D]` -> (o `[G, N, D]` in q's type, lse
    `[G, N]` fp32), the TPU's rounding order (P normalised, then cast before
    P V). The math is the packed plain version's with one head per group."""
    o, lse = fused_attention_packed_ref(q, k, v, is_causal=is_causal, heads=1)
    return o, lse[:, 0]


def fused_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *, is_causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 (`_bwd_kernel`) on the grouped layout:
    (dq, dk, dv) in q's type, the TPU's rounding order (P and dS cast
    before their products, delta = rowsum(dO * O) in fp32)."""
    return fused_attention_packed_bwd_ref(q, k, v, o, do, lse[:, None], is_causal=is_causal,
                                          heads=1)


@functools.lru_cache(maxsize=None)
def load_grouped_kernels():
    """Build (at first use) and bind K4 and K5, `grouped_attn_fwd` of
    `csrc/grouped_attn.cu` and `grouped_attn_bwd` of
    `csrc/grouped_attn_bwd.cu` (two libraries, built in parallel)."""
    libs = build.load_libraries(("grouped_attn", "grouped_attn_bwd"))
    fwd, bwd = libs["grouped_attn"].grouped_attn_fwd, libs["grouped_attn_bwd"].grouped_attn_bwd
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_grouped(name, ts, n, nk, d):
    """Refuse what K4/K5 cannot take: contiguous, 16-byte aligned `[G, L,
    D]` tiles on one CUDA device (so the row and group strides are
    multiples of 16 bytes: K4 copies rows in 16-byte pieces), fp32 or bf16
    of one type, a head dim of `HEAD_DIMS`; q-like tensors with N rows,
    k-like with Nk."""
    first = ts[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    if any(t.device != first.device for t in ts):
        raise ValueError(f"{name}: tensors on different devices: {[t.device for t in ts]}")
    if first.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != first.dtype for t in ts):
        raise TypeError(f"{name}: kernel takes fp32 or bf16 tensors of one type; got "
                        f"{[t.dtype for t in ts]}")
    check_head_dim(name, d)
    if any(t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the grouped tiles must be contiguous [G, L, D] tensors "
                         "whose base pointer is a multiple of 16 bytes")
    g = first.shape[0]
    for i, t in enumerate(ts):
        rows = n if i in (0, 3, 4) else nk  # q, o, dO have N rows; k, v have Nk
        if tuple(t.shape) != (g, rows, d):
            raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]} do not agree")


def fused_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            is_causal: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: softmax(q k^T / sqrt(D) [+ causal]) v per group of the grouped
    layout, q `[G, N, D]`, k and v `[G, Nk, D]` (Nk may differ from N), all
    contiguous. Returns (o `[G, N, D]` in q's type, lse `[G, N]` fp32). CPU
    tensors take the plain version; CUDA tensors launch the Hopper kernel or
    raise."""
    if q.device.type == "cpu":
        return fused_attention_ref(q, k, v, is_causal=is_causal)
    g, n, d = q.shape
    nk = k.shape[1]
    _check_grouped("fused_attention_grouped", (q, k, v), n, nk, d)
    o = torch.empty_like(q)
    lse = torch.empty((g, n), dtype=torch.float32, device=q.device)
    if g == 0 or n == 0:
        return o, lse
    if nk == 0:
        raise ValueError("attention over zero keys")
    with torch.cuda.device(q.device):
        err = load_grouped_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), g, n, nk, d, 1.0 / math.sqrt(d), int(is_causal),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_attn_fwd launch failed: cudaError {err}")
    _count("grouped_launches", d,
           fwd_route("grouped_attn", q.dtype == torch.bfloat16, d, False, nk, 1, is_causal))
    return o, lse


def fused_attention_grouped_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *, is_causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: the gradients (dq, dk, dv) of `fused_attention_grouped` for the
    output gradient `do` (o's shape), from its o and lse; grouped layouts as
    the forward takes them. CPU tensors take the plain version; CUDA tensors
    launch the Hopper kernel or raise."""
    if q.device.type == "cpu":
        return fused_attention_bwd_ref(q, k, v, o, do, lse, is_causal=is_causal)
    g, n, d = q.shape
    nk = k.shape[1]
    _check_grouped("fused_attention_grouped_bwd", (q, k, v, o, do), n, nk, d)
    if lse.shape != (g, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {(g, n)}; got {tuple(lse.shape)} {lse.dtype}")
    if lse.device != q.device:
        raise ValueError(f"lse on {lse.device}, q on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if g and n and nk:
        delta = torch.empty((g, n), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            err = load_grouped_kernels()[1](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                int(q.dtype == torch.bfloat16), g, n, nk, d, 1.0 / math.sqrt(d),
                int(is_causal), torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"grouped_attn_bwd launch failed: cudaError {err}")
        _count("grouped_bwd_launches", d,
               bwd_route("grouped_attn_bwd", q.dtype == torch.bfloat16, d, False, n, nk,
                         is_causal))
    elif nk == 0 and n:
        raise ValueError("attention over zero keys")
    return dq, dk, dv


def group_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> contiguous [B*H, L, D] (the JAX package's `prep`)."""
    b, n, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, n, d).contiguous()


def ungroup_heads(t: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, L, D] -> contiguous [B, L, H, D]."""
    return t.reshape(b, h, *t.shape[1:]).transpose(1, 2).contiguous()


class FusedAttention(torch.autograd.Function):
    """attn_impl='fused': q, k, v `[B, N|Nk, H, D]` go to the grouped layout,
    K4 runs forward and keeps the grouped (q, k, v, o, lse), the JAX
    package's `_core_fwd` residuals; the backward casts dO to q's type,
    groups it, launches K5 and ungroups dq, dk and dv. On CPU tensors both
    directions run the plain versions."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                is_causal: bool) -> torch.Tensor:
        qg, kg, vg = group_heads(q), group_heads(k), group_heads(v)
        og, lse = fused_attention_grouped(qg, kg, vg, is_causal=is_causal)
        ctx.save_for_backward(qg, kg, vg, og, lse)
        ctx.is_causal = is_causal
        return ungroup_heads(og, q.shape[0], q.shape[2])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do: torch.Tensor):
        qg, kg, vg, og, lse = ctx.saved_tensors
        b, h = do.shape[0], do.shape[2]
        grads = fused_attention_grouped_bwd(qg, kg, vg, og, group_heads(do.to(qg.dtype)), lse,
                                            is_causal=ctx.is_causal)
        return (*(ungroup_heads(t, b, h) for t in grads), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    is_causal: bool = False) -> torch.Tensor:
    """The port of the JAX package's `fused_attention`: q, k, v `[B, N|Nk, H,
    D]` -> `[B, N, H, D]`, scale 1/sqrt(D), differentiable through K4/K5
    (`FusedAttention`)."""
    return FusedAttention.apply(q, k, v, is_causal)
