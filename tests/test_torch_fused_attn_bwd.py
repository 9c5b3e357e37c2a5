"""Backward of the port's packed fused attention (K3,
mrclip_tpu_torch/ops/fused_attn.py) against the JAX package's packed backward
kernel (`_pbwd_impl`, Pallas interpret mode on the CPU), and the autograd
binding `FusedAttentionPacked` against autograd of the plain forward.

On the CPU the wrappers run their plain versions; the Hopper kernel is held
against those by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.ops.fused_attn import _pbwd_impl, _pfwd_impl
from mrclip_tpu_torch.ops import fused_attn as fa

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# tests/test_torch_fused_attn.py's SHAPES: (B, N, Nk, H, causal)
SHAPES = [
    (2, 197, 197, 4, False),
    (2, 98, 98, 4, True),
    (1, 76, 255, 2, False),
    (3, 257, 257, 2, False),
    (1, 64, 64, 5, True),
    (2, 197, 197, 12, False),
]


def _packed(b, n, nk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, m, h * d).astype(np.float32) for m in (n, nk, nk))
    do = rng.randn(b, n, h * d).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("b,n,nk,h,causal", SHAPES)
def test_plain_backward_matches_jax_kernel(b, n, nk, h, causal, d):
    """fp32: the same math in another summation order, to 1e-4."""
    q, k, v, do = _packed(b, n, nk, h, d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jlse = _pfwd_impl(jq, jk, jv, d, causal, True)
    want = _pbwd_impl(jq, jk, jv, jo, jdo, jlse, d, causal, True)
    got = fa.fused_attention_packed_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(np.array(jo)),
        torch.from_numpy(do), torch.from_numpy(np.array(jlse)), is_causal=causal, heads=h)
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.shape == like.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-4


# The long vision sequences past 272 rows, where bf16 K3 and K5 run
# wgmma_long_bwd_*: (N, D) of ViT-L-14-336 (577, 64), ViT-SO400M-14-SigLIP-
# 378/384 (729, 72), ViT-H-14-378 (730, 80), ViT-bigG-14-CLIPA-336 (577,
# 104) and ViT-B-16-SigLIP-512 (1024, 64); B = 1, two heads at 729, else one
LONG = [(577, 64, 1), (729, 72, 2), (730, 80, 1), (577, 104, 1), (1024, 64, 1)]


@pytest.mark.parametrize("n,d,h", LONG)
def test_plain_backward_matches_jax_kernel_at_long_sequences(n, d, h):
    """fp32: the plain K3 against JAX's `_pbwd_impl` (interpret mode) at the
    long towers' lengths, dq, dk and dv each to 1e-4."""
    q, k, v, do = _packed(1, n, n, h, d, seed=n + d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jlse = _pfwd_impl(jq, jk, jv, d, False, True)
    want = _pbwd_impl(jq, jk, jv, jo, jdo, jlse, d, False, True)
    got = fa.fused_attention_packed_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(np.array(jo)),
        torch.from_numpy(do), torch.from_numpy(np.array(jlse)), heads=h)
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.shape == like.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-4


@pytest.mark.parametrize("b,n,nk,h,causal,d", [
    (2, 197, 197, 4, False, 64),
    (2, 98, 98, 4, True, 32),
    (1, 76, 255, 2, False, 64),
    (1, 64, 64, 5, True, 64),
])
def test_plain_backward_follows_tpu_rounding_in_bf16(b, n, nk, h, causal, d):
    """bf16: P and dS are cast to bf16 where the TPU kernel casts them, so
    the two differ by at most one bf16 ulp at each gradient's largest
    magnitude (2**-7 of its power of two; fp32 sums in another order can
    flip one rounding)."""
    q, k, v, do = _packed(b, n, nk, h, d, seed=3)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jo, jlse = _pfwd_impl(jq, jk, jv, d, causal, True)
    want = _pbwd_impl(jq, jk, jv, jo, jdo, jlse, d, causal, True)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = fa.fused_attention_packed_bwd_ref(
        t(jq), t(jk), t(jv), t(jo), t(jdo), torch.from_numpy(np.array(jlse)),
        is_causal=causal, heads=h)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(g.float().numpy() - w).max() <= ulp


# The bf16 kernel's tile edges (16-row fragments, 32-key dq steps, 16-query
# dkv steps, 64-row sub-tiles): N, causal, head dim (ViT-SO400M-SigLIP's 72,
# ViT-H/g/bigG-14's 80, 88, 104 and EVA02-E-14's 112 too: 72, 88 and 104
# padded to 80, 96 and 112 in the kernels); B = 1, H = 2
TILE_EDGES = [(n, c, d) for n in (1, 15, 17, 65) for c in (False, True)
              for d in (32, 64, 72, 80, 88, 104, 112)]


def bf16_bars(got, want):
    """One bf16 ulp at the call's largest |gradient| (2**-7 of its power of
    two: at N = 1 and on a causal first row dq and dk are fp32 cancellation
    noise with no scale of their own), and the share of the elements of
    each gradient at least that ulp in size whose bits differ (on the
    noise, two summation orders differ everywhere)."""
    w = [np.asarray(x, np.float32) for x in want]
    ulp = 2.0 ** (np.floor(np.log2(max(np.abs(x).max() for x in w))) - 7)
    errs, shares = [], []
    for g, x in zip(got, w):
        g = g.float().numpy()
        errs.append(np.abs(g - x).max() / ulp)
        big = np.abs(x) >= ulp
        shares.append((g[big] != x[big]).mean() if big.any() else 0.0)
    return errs, shares


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,causal,d", TILE_EDGES)
def test_plain_backward_matches_jax_kernel_at_tile_edges(n, causal, d, dtype):
    """The plain K3 that chip_smoke.py holds the tensor-core kernel against
    at its tile edges, against JAX's `_pbwd_impl` in interpret mode at the
    same shapes: fp32 within 1e-4; bf16 within one bf16 ulp at the call's
    largest gradient, in under 1% of each gradient's elements (P and dS
    rounded at the same points; fp32 sums in another order can flip one
    rounding)."""
    q, k, v, do = _packed(1, n, n, 2, d, seed=11)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jo, jlse = _pfwd_impl(jq, jk, jv, d, causal, True)
    want = _pbwd_impl(jq, jk, jv, jo, jdo, jlse, d, causal, True)
    t = lambda x: torch.from_numpy(np.array(x, np.float32)).to(dtype)  # noqa: E731
    got = fa.fused_attention_packed_bwd_ref(t(jq), t(jk), t(jv), t(jo), t(jdo),
                                            torch.from_numpy(np.array(jlse)), is_causal=causal,
                                            heads=2)
    assert all(g.shape == (1, n, 2 * d) and g.dtype == dtype for g in got)
    if dtype == torch.float32:
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-4
        return
    errs, shares = bf16_bars(got, want)
    assert max(errs) <= 1 and max(shares) < 0.01


@pytest.mark.parametrize("b,n,h,d,causal", [(2, 50, 2, 32, False), (1, 98, 4, 64, True),
                                            (2, 13, 3, 32, True)])
def test_function_gradients_match_autograd_of_plain_forward(b, n, h, d, causal):
    """FusedAttentionPacked (plain forward + plain K3 on the CPU) against
    torch autograd through the plain forward, fp32, on one packed qkv."""
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32)).requires_grad_()
    do = torch.from_numpy(rng.randn(b, n, h * d).astype(np.float32))
    o = fa.fused_attention_qkv(qkv, heads=h, is_causal=causal)
    (got,) = torch.autograd.grad(o, qkv, do)
    q, k, v = qkv.chunk(3, dim=-1)
    o_ref, _ = fa.fused_attention_packed_ref(q, k, v, is_causal=causal, heads=h)
    (want,) = torch.autograd.grad(o_ref, qkv, do)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    assert got.shape == qkv.shape and got.is_contiguous()
    assert (got - want).abs().max().item() < 1e-5  # fp32 summation order


def test_function_passes_gradcheck_in_float64():
    qkv = torch.from_numpy(np.random.RandomState(2).randn(2, 9, 3 * 2 * 8)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: fa.fused_attention_qkv(x, heads=2, is_causal=True), (qkv,))


def test_backward_writes_into_column_slices_without_counting():
    """`out=` takes the column slices of one [B, N, 3W] buffer; CPU tensors
    take the plain version and launch nothing."""
    b, n, h, d = 2, 20, 2, 32
    q, k, v, do = (torch.from_numpy(x) for x in _packed(b, n, n, h, d, seed=7))
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=True, heads=h)
    buf = torch.zeros(b, n, 3 * h * d)
    fa.reset_launches()
    got = fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=True, heads=h,
                                        out=buf.chunk(3, dim=-1))
    want = fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=True, heads=h)
    for g, w, part in zip(got, want, buf.chunk(3, dim=-1)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(part, w, rtol=0, atol=0)
    assert fa.launches == 0 and fa.bwd_launches == 0


def test_backward_refuses_other_devices():
    """Only a CPU tensor reaches the plain version."""
    meta = torch.empty(1, 4, 128, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.fused_attention_packed_bwd(meta, meta, meta, meta, meta, lse, heads=2)
