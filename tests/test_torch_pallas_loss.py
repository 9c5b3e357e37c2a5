"""The port's fused SupCon loss (K6, K7: mrclip_tpu_torch/ops/pallas_loss.py)
against the JAX package's Pallas kernels (`_stats`, `_bwd`, interpret mode
on the CPU) and against the dense loss.

On the CPU the wrappers run their plain versions; the Hopper kernels are
held against those by tests/test_torch_cuda.py and chip_smoke.py on the
card. All fp32: tolerances are summation order (1e-5 relative, as the JAX
package's own pallas-vs-dense tests use).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.ops import pallas_loss as jpl
from mrclip_tpu_torch.losses import multipositive_clip_loss
from mrclip_tpu_torch.ops import pallas_loss as pl

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# (Nq, Nk, D, labels, JAX blocks): test_pallas_loss.py's shapes, including
# its non-divisible batch of 12 at block 8, and one with distinct labels
CASES = [
    (32, 64, 128, 5, (16, 32)),
    (12, 12, 16, 3, (8, 8)),
    (20, 20, 32, None, (20, 20)),
]


def _inputs(nq, nk, d, n_labels, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(nq, d).astype(np.float32)
    k = rng.randn(nk, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    if n_labels is None:
        lq, lk = np.arange(nq, dtype=np.int32), np.arange(nk, dtype=np.int32)
    else:
        lq = rng.randint(0, n_labels, nq).astype(np.int32)
        lk = rng.randint(0, n_labels, nk).astype(np.int32)
    return q, k, lq, lk


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("nq,nk,d,n_labels,blocks", CASES)
def test_plain_stats_match_jax_kernel(nq, nk, d, n_labels, blocks):
    q, k, lq, lk = _inputs(nq, nk, d, n_labels)
    scale = np.float32(20.0)
    # the JAX kernel needs blocks that divide the batch (its _fit_block)
    bq, bk = jpl._fit_block(nq, blocks[0]), jpl._fit_block(nk, blocks[1])
    want = jpl._stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(lq), jnp.asarray(lk),
                      scale, bq, bk, True)
    got = pl.supcon_stats(*(torch.from_numpy(x) for x in (q, k, lq, lk)), torch.tensor([scale]))
    for g, w in zip(got, want):
        assert g.shape == (nq,) and g.dtype == torch.float32
        assert _rel(g.numpy(), np.asarray(w)[:, 0]) <= 1e-5


@pytest.mark.parametrize("nq,nk,d,n_labels,blocks", CASES)
def test_plain_gradients_match_jax_kernels(nq, nk, d, n_labels, blocks):
    """dq, dk and d(scale) of the plain K7 against the JAX `_bwd`, from the
    same forward residuals and an upstream gradient of 0.7."""
    q, k, lq, lk = _inputs(nq, nk, d, n_labels, seed=1)
    scale = np.float32(14.0)
    bq, bk = jpl._fit_block(nq, blocks[0]), jpl._fit_block(nk, blocks[1])
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(lq), jnp.asarray(lk), jnp.float32(scale))
    _, residuals = jpl._fwd(*jargs, bq, bk, True)
    jdq, jdk, _, _, jds = jpl._bwd(bq, bk, True, residuals, jnp.float32(0.7))
    _, _, _, _, _, m, s, cnt = residuals
    tq, tk, tlq, tlk = (torch.from_numpy(x) for x in (q, k, lq, lk))
    targs = (tq, tk, tlq, tlk, torch.tensor([scale]), *(torch.from_numpy(np.array(x))
                                                         for x in (m, s, cnt)),
             torch.tensor([0.7 / nq], dtype=torch.float32))
    dq, ds_rows = pl.supcon_grad_q(*targs)
    dk = pl.supcon_grad_k(*targs)
    assert dq.shape == (nq, d) and dk.shape == (nk, d) and ds_rows.shape == (nq,)
    assert _rel(dq.numpy(), jdq) <= 1e-5
    assert _rel(dk.numpy(), jdk) <= 1e-5
    np.testing.assert_allclose(ds_rows.sum().item(), float(jds), rtol=1e-5)


@pytest.mark.parametrize("nq,nk,d,n_labels,blocks", CASES)
def test_function_gradients_match_dense_loss(nq, nk, d, n_labels, blocks):
    """The autograd binding gives the dense loss's value and gradients for
    q, k and the logit scale."""
    q, k, lq, lk = _inputs(nq, nk, d, n_labels, seed=2)
    tq, tk, ts = (torch.from_numpy(x).requires_grad_() for x in (q, k, np.array(10.0, np.float32)))
    loss = pl.pallas_multipositive_loss(tq, tk, torch.from_numpy(lq), torch.from_numpy(lk), ts)
    loss.backward()
    dq, dk, ds = (x.grad.clone() for x in (tq, tk, ts))
    for x in (tq, tk, ts):
        x.grad = None
    from mrclip_tpu_torch.losses.functional import (multi_positive_cross_entropy_loss,
                                                    pos_mask_from_labels)
    dense = multi_positive_cross_entropy_loss(
        ts * tq @ tk.T, pos_mask_from_labels(torch.from_numpy(lq), torch.from_numpy(lk)))
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-5)
    dense.backward()
    assert abs(ts.grad.item()) > 1e-6  # the scale comparison is not trivial
    assert _rel(dq.numpy(), tq.grad.numpy()) <= 1e-5
    assert _rel(dk.numpy(), tk.grad.numpy()) <= 1e-5
    np.testing.assert_allclose(ds.item(), ts.grad.item(), rtol=1e-4)


def test_clip_loss_matches_dense_and_jax():
    """The delta-weighted two-direction loss and its gradients against the
    dense port loss, and its value against the JAX pallas loss."""
    q, k, lq, _ = _inputs(12, 12, 16, 3, seed=4)
    scale = np.array(10.0, np.float32)
    img, txt, ts = (torch.from_numpy(x).requires_grad_() for x in (q, k, scale))
    labels = torch.from_numpy(lq)
    got = pl.pallas_multipositive_clip_loss(img, txt, labels, ts, delta=0.3)
    got["loss"].backward()
    grads = [x.grad.clone() for x in (img, txt, ts)]
    for x in (img, txt, ts):
        x.grad = None
    want = multipositive_clip_loss(img, txt, labels, ts, delta=0.3)
    want["loss"].backward()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), want[key].item(), rtol=1e-5)
    for g, x in zip(grads, (img, txt, ts)):
        assert _rel(g.numpy(), x.grad.numpy()) <= 1e-5
    jax_loss = jpl.pallas_multipositive_clip_loss(jnp.asarray(q), jnp.asarray(k), jnp.asarray(lq),
                                                  jnp.float32(scale), delta=0.3, block_q=8,
                                                  block_k=8)["loss"]
    np.testing.assert_allclose(got["loss"].item(), float(jax.device_get(jax_loss)), rtol=1e-5)


def test_cpu_tensors_take_the_plain_path_without_counting():
    q, k, lq, lk = (torch.from_numpy(x) for x in _inputs(8, 8, 16, 2))
    pl.reset_launches()
    pl.pallas_multipositive_loss(q.requires_grad_(), k, lq, lk,
                                 torch.tensor(5.0, requires_grad=True)).backward()
    assert all(n == 0 for n in pl.launches.values())


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.empty(4, 8, device="meta")
    lab = torch.empty(4, dtype=torch.int32, device="meta")
    one = torch.empty(1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pl.supcon_stats(meta, meta, lab, lab, one)
    with pytest.raises(ValueError, match="unsupported device"):
        pl.supcon_grad_q(meta, meta, lab, lab, one, *(torch.empty(4, device="meta"),) * 3, one)
    with pytest.raises(ValueError, match="unsupported device"):
        pl.supcon_grad_k(meta, meta, lab, lab, one, *(torch.empty(4, device="meta"),) * 3, one)


# plan(): every row of the owning side in exactly one tile, every row of the
# walk in exactly one split, at the batches the loss is used at (train b256,
# 8k-32k global) and the edges; D below, at and past the 512 columns a
# gradient block accumulates, and one not a multiple of 4
PLAN_ROWS = (1, 12, 100, 256, 333, 8192, 32768)
PLAN_DS = (16, 30, 512, 1280)


def _check_plan(nq, nk, d, kind, p):
    own, walk = (nk, nq) if kind == "grad_k" else (nq, nk)
    assert (p.tm, p.tn) in pl.TILES[kind]
    assert p.own_tiles == -(-own // p.tm) and p.walk_tiles == -(-walk // p.tn)
    assert p.splits >= 1 and p.per_split >= 1
    ranges = p.walk_ranges(walk)
    assert len(ranges) == p.splits
    covered = np.zeros(walk, np.int32)
    for a, b in ranges:
        assert a < b and a % p.tn == 0  # no empty split; each starts on a tile
        covered[a:b] += 1
    assert (covered == 1).all()
    assert p.dslices * pl.DS >= d > (p.dslices - 1) * pl.DS if kind != "stats" else p.dslices == 1
    assert not p.resident or (kind != "stats" and d <= pl.DS)
    assert p.wide == (d % 4 == 0)
    if p.splits == 1:
        assert p.scratch == p.scratch_ds == 0
    elif kind == "stats":
        assert (p.scratch, p.scratch_ds) == (4 * p.splits * nq, 0)
    else:
        assert p.scratch == p.splits * own * d
        assert p.scratch_ds == (p.splits * nq if kind == "grad_q" else 0)
    assert p.blocks == p.own_tiles * p.splits * p.dslices


@pytest.mark.parametrize("d", PLAN_DS)
@pytest.mark.parametrize("n", PLAN_ROWS)
def test_plan_covers_each_row_and_key_once(n, d):
    for nq, nk in ((n, n), (n, 2 * n + 1)):
        for kind in pl.TILES:
            p = pl.plan(nq, nk, d, kind)
            _check_plan(nq, nk, d, kind, p)
            assert p.resident == (kind != "stats" and d <= pl.DS)


def test_plan_fills_the_card_at_the_train_batch():
    """B = 256, D = 512 (the b256 step): each kernel at least 32 blocks
    (split over its walk); B = 8192: the 128-row statistics tile and the
    64 x 128 gradient tile, a block an SM, the gradients unsplit with their
    own rows resident; D = 512 is never cut into slices (each logit once)."""
    for kind in pl.TILES:
        p = pl.plan(256, 256, 512, kind)
        assert p.blocks >= 32 and p.splits > 1 and p.dslices == 1, p
        big = pl.plan(8192, 8192, 512, kind)
        assert (big.tm, big.tn) == ((128, 128) if kind == "stats" else (64, 128)), big
        assert pl.H100_SMS // 2 < big.blocks <= pl.H100_SMS, big
        assert big.dslices == 1 and big.resident == (kind != "stats")
    assert pl.plan(8192, 8192, 512, "stats").splits == 2
    assert not pl.plan(256, 256, 512, "stats", aligned=False).wide


def test_plan_overrides_and_refusals():
    p = pl.plan(8192, 8192, 512, "grad_q", tile=(32, 32), splits=3, resident=False)
    assert (p.tm, p.tn, p.splits, p.resident) == (32, 32, 3, False)
    _check_plan(8192, 8192, 512, "grad_q", p)
    assert pl.plan(100, 100, 512, "stats", splits=1000).splits == 4  # at most one a walk tile
    with pytest.raises(ValueError, match="built for tiles"):
        pl.plan(256, 256, 512, "stats", tile=(64, 128))
    with pytest.raises(ValueError, match="kind"):
        pl.plan(256, 256, 512, "grad")


# (Nq, Nk, D, labels, SMs): plans whose split widths divide the batch, as the
# JAX kernels' blocks must
SPLIT_CASES = [(64, 96, 16, 5, pl.H100_SMS), (256, 256, 64, 7, 8)]


def _jnp(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("nq,nk,d,n_labels,sms", SPLIT_CASES)
def test_split_stats_match_jax_kernel(nq, nk, d, n_labels, sms):
    """K6 as plan() splits it (partials of the plain version over each
    split's keys, merged in split order) against the JAX `_stats` with
    block_k the split width: the TPU kernel's online sum over key blocks."""
    q, k, lq, lk = _inputs(nq, nk, d, n_labels, seed=5)
    scale = np.float32(16.0)
    p = pl.plan(nq, nk, d, "stats", sms=sms)
    width = p.per_split * p.tn
    assert p.splits > 1 and nk % width == 0
    want = jpl._stats(*_jnp(q, k, lq, lk), scale, p.tm, width, True)
    got = pl.supcon_stats_split_ref(*(torch.from_numpy(x) for x in (q, k, lq, lk)),
                                    torch.tensor([scale]), p)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)[:, 0]) <= 1e-5


@pytest.mark.parametrize("nq,nk,d,n_labels,sms", SPLIT_CASES)
def test_split_gradients_match_jax_kernels(nq, nk, d, n_labels, sms):
    """K7 as plan() splits it: dq and ds summed in split order over grad_q's
    key splits, dk over grad_k's row splits, against the JAX `_bwd` with
    block_k (block_q) the grad_q (grad_k) split width."""
    q, k, lq, lk = _inputs(nq, nk, d, n_labels, seed=6)
    scale = np.float32(12.0)
    pq = pl.plan(nq, nk, d, "grad_q", sms=sms)
    pk = pl.plan(nq, nk, d, "grad_k", sms=sms)
    bk, bq = pq.per_split * pq.tn, pk.per_split * pk.tn
    assert pq.splits > 1 and pk.splits > 1 and nk % bk == 0 and nq % bq == 0
    jargs = (*_jnp(q, k, lq, lk), jnp.float32(scale))
    _, residuals = jpl._fwd(*jargs, bq, bk, True)
    jdq, jdk, _, _, jds = jpl._bwd(bq, bk, True, residuals, jnp.float32(0.7))
    _, _, _, _, _, m, s, cnt = residuals
    targs = (*(torch.from_numpy(x) for x in (q, k, lq, lk)), torch.tensor([scale]),
             *(torch.from_numpy(np.array(x)) for x in (m, s, cnt)),
             torch.tensor([0.7 / nq], dtype=torch.float32))
    dq, ds_rows = pl.supcon_grad_split_ref(*targs, pq)
    dk = pl.supcon_grad_split_ref(*targs, pk)
    assert _rel(dq.numpy(), jdq) <= 1e-5
    assert _rel(dk.numpy(), jdk) <= 1e-5
    np.testing.assert_allclose(ds_rows.sum().item(), float(jds), rtol=1e-5)


def test_merge_stats_of_one_split_is_the_identity_and_of_two_the_whole():
    q, k, lq, lk = (torch.from_numpy(x) for x in _inputs(20, 40, 16, 3, seed=7))
    scale = torch.tensor([9.0])
    whole = pl.supcon_stats_ref(q, k, lq, lk, scale)
    one = pl.merge_stats_ref(torch.stack(whole)[:, None])
    assert all(torch.equal(a, b) for a, b in zip(one, whole))
    halves = [torch.stack(pl.supcon_stats_ref(q, k[a:b], lq, lk[a:b], scale))
              for a, b in ((0, 32), (32, 40))]
    merged = pl.merge_stats_ref(torch.stack(halves, dim=1))
    for g, w in zip(merged, whole):
        assert _rel(g.numpy(), w.numpy()) <= 1e-6


def test_plan_tiles_and_arguments_are_those_of_the_kernels():
    """TILES lists exactly the tiles csrc/supcon_loss.cu instantiates, and
    the bound argument lists are as long as its C entries'."""
    src = (Path(pl.__file__).parents[1] / "csrc" / "supcon_loss.cu").read_text()
    stats = {tuple(map(int, t)) for t in re.findall(r"launch_stats<(\d+), (\d+)>\(", src)}
    grads = {tuple(map(int, t)) for t in re.findall(r"MRCLIP_GRAD\((\d+), (\d+), ", src)}
    assert stats == set(pl.TILES["stats"])
    assert grads == set(pl.TILES["grad_q"]) == set(pl.TILES["grad_k"])
    for name, argtypes in pl.KERNEL_ARGTYPES.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
        assert len(params.split(",")) == len(argtypes), name
