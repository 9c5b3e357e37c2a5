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
without the TPU version's block fitting. How a launch cuts its work (the
logit tile, the splits of the walk and their merge, the copy width and the
scratch) is decided here, by `plan`, so the CPU tests check that it covers
every row and key once; `merge_stats_ref` and `supcon_stats_split_ref` /
`supcon_grad_split_ref` are the plain versions of a split call.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from ..losses.contrastive import single_device
from . import build

__all__ = [
    "MultipositiveLoss",
    "Plan",
    "merge_stats_ref",
    "pallas_multipositive_clip_loss",
    "pallas_multipositive_loss",
    "supcon_grad_k",
    "supcon_grad_k_ref",
    "supcon_grad_q",
    "supcon_grad_q_ref",
    "supcon_grad_split_ref",
    "supcon_stats",
    "supcon_stats_ref",
    "supcon_stats_split_ref",
    "launches",
    "plan",
    "reset_launches",
    "load_kernels",
]

_EPS = 1e-12

# Columns of D a gradient block accumulates (csrc/supcon_loss.cu's kDS).
DS = 512
# the logit tiles (own rows, walk rows) each kernel is built for, largest first
TILES = {"stats": ((128, 128), (32, 32)),
         "grad_q": ((64, 128), (32, 32)), "grad_k": ((64, 128), (32, 32))}
# blocks of a tile an SM holds (ptxas's registers: the 128-row statistics
# block and the gradient blocks, with their dq/dk accumulators, one each)
BLOCKS_PER_SM = {("stats", 128): 1, ("stats", 32): 2,
                 ("grad_q", 64): 1, ("grad_q", 32): 1, ("grad_k", 64): 1, ("grad_k", 32): 1}
H100_SMS = 132

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


# The C entries' arguments: tensors, then ints (sizes and the plan), then
# the stream.
_ptr, _int = ctypes.c_void_p, ctypes.c_int
KERNEL_ARGTYPES = {
    "supcon_stats": [_ptr] * 10 + [_int] * 8 + [_ptr],
    "supcon_grad_q": [_ptr] * 13 + [_int] * 10 + [_ptr],
    "supcon_grad_k": [_ptr] * 11 + [_int] * 10 + [_ptr],
}


@functools.lru_cache(maxsize=None)
def load_kernels():
    """Build (at first use) and bind the three C entry points."""
    lib = build.load_library("supcon_loss")
    out = {}
    for name, argtypes in KERNEL_ARGTYPES.items():
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


def _tiles(n: int, t: int) -> int:
    return -(-n // t)


@dataclass(frozen=True)
class Plan:
    """How one K6 or K7 launch cuts its work, as the kernels run it. A block
    owns `tm` rows of its side (query rows for 'stats' and 'grad_q', keys
    for 'grad_k') and walks tiles of `tn` rows of the other side; the grid
    is `own_tiles` x `splits` x `dslices`. Split s walks tiles [s *
    per_split, (s + 1) * per_split) of the `walk_tiles` (the last maybe
    fewer; none empty). `dslices`: 512-wide slices of D of the gradients (1
    for 'stats'). `resident`: a gradient block holds its own rows, all of D
    (D <= 512), in shared memory for its whole walk, and streams only the
    walk rows. `wide`: 16-byte copies. `scratch` (`scratch_ds`): fp32
    elements of the partials (of grad_q's ds partials) that a split call
    writes and its merge reads; 0 with one split. The kernels size their
    own shared memory from the tile."""

    kind: str
    tm: int
    tn: int
    own_tiles: int
    walk_tiles: int
    splits: int
    per_split: int
    dslices: int
    resident: bool
    wide: bool
    scratch: int
    scratch_ds: int

    @property
    def blocks(self) -> int:
        return self.own_tiles * self.splits * self.dslices

    def walk_ranges(self, n_walk: int) -> list[tuple[int, int]]:
        """[start, stop) of the walk rows of each split, in split order."""
        step = self.per_split * self.tn
        return [(s * step, min((s + 1) * step, n_walk)) for s in range(self.splits)]


@functools.lru_cache(maxsize=4096)
def plan(nq: int, nk: int, d: int, kind: str, aligned: bool = True, sms: int = H100_SMS, *,
         tile: Optional[tuple[int, int]] = None, splits: Optional[int] = None,
         resident: Optional[bool] = None) -> Plan:
    """The tile, walk splits, copy width and scratch of one call of `kind`
    ('stats', 'grad_q' or 'grad_k') on a card of `sms` SMs. The tile is
    the first of TILES[kind] whose (own tiles) x (walk tiles) reaches
    `sms`, else the last. The walk is split so that the grid fills the
    card's blocks (sms x BLOCKS_PER_SM) at most, into `splits`
    runs of equal tiles (the last maybe shorter), each a partial merged in
    split order (no atomics: two runs give the same bits). 16-byte copies
    (`wide`) need d % 4 == 0 and q and k 16-byte aligned (`aligned`);
    otherwise the kernels stage element by element. A gradient block keeps
    its own rows resident where D <= 512. `tile`, `splits` and `resident`
    (False) override the choice (tools/supcon_variants.py)."""
    if kind not in TILES:
        raise ValueError(f"plan: kind must be one of {sorted(TILES)}; got {kind!r}")
    own, walk = (nk, nq) if kind == "grad_k" else (nq, nk)
    if tile is None:
        tile = next((t for t in TILES[kind] if _tiles(own, t[0]) * _tiles(walk, t[1]) >= sms),
                    TILES[kind][-1])
    elif tile not in TILES[kind]:
        raise ValueError(f"plan: {kind} is built for tiles {TILES[kind]}; got {tile}")
    tm, tn = tile
    own_tiles, walk_tiles = _tiles(own, tm), _tiles(walk, tn)
    dslices = 1 if kind == "stats" else _tiles(d, DS)
    if splits is None:
        slots = sms * BLOCKS_PER_SM[kind, tm]
        splits = slots // (own_tiles * dslices)
    splits = max(1, min(splits, walk_tiles))
    per_split = _tiles(walk_tiles, splits)
    splits = _tiles(walk_tiles, per_split)
    if splits == 1:
        scratch = scratch_ds = 0
    elif kind == "stats":
        scratch, scratch_ds = 4 * splits * nq, 0
    else:
        scratch = splits * own * d
        scratch_ds = splits * nq if kind == "grad_q" else 0
    resident = kind != "stats" and d <= DS and resident is not False
    return Plan(kind, tm, tn, own_tiles, walk_tiles, splits, per_split, dslices, resident,
                aligned and d % 4 == 0, scratch, scratch_ds)


def merge_stats_ref(parts):
    """Plain version of K6's merge: `parts` [4, splits, Nq] (m, s, pos_sum,
    pos_cnt of each split) -> (m, s, pos_sum, pos_cnt) [Nq]; m = max m_k,
    s = sum_k s_k exp(m_k - m), the rest summed, in split order."""
    pm, pss, pps, ppc = parts
    m = pm.amax(dim=0)
    s, ps, pc = (torch.zeros_like(m) for _ in range(3))
    for sp in range(pm.shape[0]):
        s = s + pss[sp] * torch.exp(pm[sp] - m)
        ps = ps + pps[sp]
        pc = pc + ppc[sp]
    return m, s, ps, pc


def supcon_stats_split_ref(q, k, labels_q, labels_k, scale, p: Plan):
    """K6 as plan `p` cuts it, in plain PyTorch: `supcon_stats_ref` over
    each split's keys, then `merge_stats_ref`."""
    parts = [torch.stack(supcon_stats_ref(q, k[a:b], labels_q, labels_k[a:b], scale))
             for a, b in p.walk_ranges(k.shape[0])]
    return merge_stats_ref(torch.stack(parts, dim=1))


def supcon_grad_split_ref(q, k, labels_q, labels_k, scale, m, s, cnt, gbar, p: Plan):
    """K7 as plan `p` cuts it, in plain PyTorch: grad_q's (dq, ds_rows) as
    the sums in split order of `supcon_grad_q_ref` over each split's keys;
    grad_k's dk as those of `supcon_grad_k_ref` over each split's rows."""
    ranges = p.walk_ranges(q.shape[0] if p.kind == "grad_k" else k.shape[0])
    if p.kind == "grad_k":
        parts = [supcon_grad_k_ref(q[a:b], k, labels_q[a:b], labels_k, scale, m[a:b], s[a:b],
                                   cnt[a:b], gbar) for a, b in ranges]
        return functools.reduce(torch.add, parts)
    parts = [supcon_grad_q_ref(q, k[a:b], labels_q, labels_k[a:b], scale, m, s, cnt, gbar)
             for a, b in ranges]
    return (functools.reduce(torch.add, [dq for dq, _ in parts]),
            functools.reduce(torch.add, [ds for _, ds in parts]))


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(kind, q, k, **overrides) -> Plan:
    aligned = q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0
    return plan(q.shape[0], k.shape[0], q.shape[1], kind, aligned, _sm_count(q.device.index),
                **overrides)


def _scratch(n, like):
    return torch.empty(n, dtype=torch.float32, device=like.device) if n else None


def _launch(name, fn, *args):
    fn = fn or load_kernels()[name]
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _count_launch(name)


def _run_stats(q, k, lq, lk, sc, p: Plan, fn=None):
    """Launch K6 (and its merge) as plan `p` cuts it, through `fn` (the bound
    `supcon_stats`; the package's by default); counted once."""
    outs = [torch.empty(q.shape[0], dtype=torch.float32, device=q.device) for _ in range(4)]
    _launch("supcon_stats", fn, q, k, lq, lk, sc, *outs, _scratch(p.scratch, q), q.shape[0],
            k.shape[0], q.shape[1], p.tm, p.tn, p.splits, p.per_split, int(p.wide))
    return tuple(outs)


def _run_grad_q(q, k, lq, lk, sc, gb, m, s, cnt, p: Plan, fn=None):
    """Launch K7's grad_q (and its sums) as plan `p` cuts it, through `fn`
    as `_run_stats`; counted once."""
    dq = torch.empty_like(q)
    ds_rows = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    _launch("supcon_grad_q", fn, q, k, lq, lk, m, s, cnt, sc, gb, dq, ds_rows,
            _scratch(p.scratch, q), _scratch(p.scratch_ds, q), q.shape[0], k.shape[0],
            q.shape[1], p.tm, p.tn, p.splits, p.per_split, p.dslices, int(p.resident),
            int(p.wide))
    return dq, ds_rows


def _run_grad_k(q, k, lq, lk, sc, gb, m, s, cnt, p: Plan, fn=None):
    """Launch K7's grad_k (and its sum) as plan `p` cuts it, through `fn`
    as `_run_stats`; counted once."""
    dk = torch.empty_like(k)
    _launch("supcon_grad_k", fn, q, k, lq, lk, m, s, cnt, sc, gb, dk, _scratch(p.scratch, q),
            q.shape[0], k.shape[0], q.shape[1], p.tm, p.tn, p.splits, p.per_split, p.dslices,
            int(p.resident), int(p.wide))
    return dk


def supcon_stats(q, k, labels_q, labels_k, scale):
    """K6: per-row (m, s, pos_sum, pos_cnt) of z = scale * q k^T, fp32 [Nq]
    each. q [Nq, D] and k [Nk, D] fp32, int32 labels, `scale` a one-element
    fp32 tensor. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return supcon_stats_ref(q, k, labels_q, labels_k, scale)
    q, k, lq, lk, sc = _kernel_args("supcon_stats", q, k, labels_q, labels_k, (scale,))
    return _run_stats(q, k, lq, lk, sc, _plan_for("stats", q, k))


def supcon_grad_q(q, k, labels_q, labels_k, scale, m, s, cnt, gbar):
    """K7 `grad_q`: (dq fp32 [Nq, D], ds_rows fp32 [Nq]) from the forward's
    m, s and clamped count; `gbar` (= g / Nq) and `scale` are one-element
    fp32 tensors. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return supcon_grad_q_ref(q, k, labels_q, labels_k, scale, m, s, cnt, gbar)
    q, k, lq, lk, sc, gb, m, s, cnt = _kernel_args(
        "supcon_grad_q", q, k, labels_q, labels_k, (scale, gbar), (m, s, cnt))
    return _run_grad_q(q, k, lq, lk, sc, gb, m, s, cnt, _plan_for("grad_q", q, k))


def supcon_grad_k(q, k, labels_q, labels_k, scale, m, s, cnt, gbar):
    """K7 `grad_k`: dk fp32 [Nk, D]. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return supcon_grad_k_ref(q, k, labels_q, labels_k, scale, m, s, cnt, gbar)
    q, k, lq, lk, sc, gb, m, s, cnt = _kernel_args(
        "supcon_grad_k", q, k, labels_q, labels_k, (scale, gbar), (m, s, cnt))
    return _run_grad_k(q, k, lq, lk, sc, gb, m, s, cnt, _plan_for("grad_k", q, k))


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
