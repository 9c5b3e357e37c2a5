"""The port's fused SupCon loss (K6, K7: mrclip_tpu_torch/ops/pallas_loss.py)
against the JAX package's Pallas kernels (`_stats`, `_bwd`, interpret mode
on the CPU) and against the dense loss.

On the CPU the wrappers run their plain versions; the Hopper kernels are
held against those by tests/test_torch_cuda.py and chip_smoke.py on the
card. All fp32: tolerances are summation order (1e-5 relative, as the JAX
package's own pallas-vs-dense tests use).
"""

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
