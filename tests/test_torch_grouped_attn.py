"""The port's grouped-layout fused attention (K4 forward, K5 backward;
attn_impl='fused', mrclip_tpu_torch/ops/fused_attn.py) against the JAX
package's `fused_attention`, whose Pallas kernels `_fwd_kernel` and
`_bwd_kernel` run in interpret mode on the CPU (its custom VJP runs K5, as
tests/test_fused_attn.py runs it).

On the CPU the wrappers run their plain versions; the Hopper kernels are
held against those by tests/test_torch_cuda.py and chip_smoke.py on the
card. The same numpy-seeded inputs go to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.ops.fused_attn import _pad_to, _run_fwd
from mrclip_tpu.ops.fused_attn import fused_attention as jax_fused_attention
from mrclip_tpu_torch.ops import fused_attn as fa

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# (N, Nk, causal): ViT-B/16's 197, text 98 causal, CoCa's cross-attention
# 76 -> 255, ViT-L/14's 257 (pads to 384), and 50 causal
SHAPES = [(197, 197, False), (98, 98, True), (76, 255, False), (257, 257, False),
          (50, 50, True)]
B, H = 2, 2


def _inputs(n, nk, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, m, H, d).astype(np.float32) for m in (n, nk, nk))
    do = rng.randn(B, n, H, d).astype(np.float32)
    return q, k, v, do


def _jax_lse(q, k, v, causal):
    """The TPU kernel's lse of the real rows: `_run_fwd` on the padded
    grouped layout `fused_attention` builds, sliced."""
    b, n, h, d = q.shape
    nk = k.shape[1]

    def prep(t, rows):
        t = jnp.asarray(t).transpose(0, 2, 1, 3).reshape(b * h, rows, d)
        return jnp.pad(t, ((0, 0), (0, _pad_to(rows) - rows), (0, 0)))

    _, lse = _run_fwd(prep(q, n), prep(k, nk), prep(v, nk), nk, causal, True)
    return np.asarray(lse)[:, :n]


@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("n,nk,causal", SHAPES)
def test_plain_forward_matches_jax_kernel(n, nk, causal, d):
    """fp32: o and lse to 1e-4 (the same math in another summation order)."""
    q, k, v, _ = _inputs(n, nk, d)
    want = np.asarray(jax_fused_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                          is_causal=causal, interpret=True))
    got = fa.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), is_causal=causal)
    assert got.shape == want.shape == (B, n, H, d) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 1e-4
    grouped = [torch.from_numpy(x).transpose(1, 2).reshape(B * H, -1, d).contiguous()
               for x in (q, k, v)]
    _, lse = fa.fused_attention_ref(*grouped, is_causal=causal)
    assert lse.shape == (B * H, n) and lse.dtype == torch.float32
    assert np.abs(lse.numpy() - _jax_lse(q, k, v, causal)).max() < 1e-4


@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("n,nk,causal", SHAPES)
def test_gradients_match_jax_custom_vjp(n, nk, causal, d):
    """fp32: dq, dk, dv through `FusedAttention` (plain K4 then plain K5)
    against jax.grad through `fused_attention` (interpret-mode `_bwd_kernel`),
    each to 1e-4."""
    q, k, v, do = _inputs(n, nk, d, seed=1)

    def loss(q_, k_, v_):
        return (jax_fused_attention(q_, k_, v_, is_causal=causal, interpret=True)
                * jnp.asarray(do)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(fa.fused_attention(tq, tk, tv, is_causal=causal), (tq, tk, tv),
                              torch.from_numpy(do))
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.shape == like.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-4


@pytest.mark.parametrize("n,nk,causal", [(197, 197, False), (98, 98, True), (76, 255, False)])
def test_plain_forward_follows_tpu_rounding_in_bf16(n, nk, causal):
    """bf16: P is normalised, then cast to bf16 before P V, where the TPU
    kernel casts it, so o differs from the interpret-mode kernel's by at most
    one bf16 ulp at its largest magnitude (fp32 sums in another order can
    flip one rounding)."""
    q, k, v, _ = _inputs(n, nk, 64, seed=2)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_fused_attention(jq, jk, jv, is_causal=causal, interpret=True),
                      np.float32)
    got = fa.fused_attention(*(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                               for x in (jq, jk, jv)), is_causal=causal)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def _unrounded_grads(q, k, v, do, causal):
    """dq, dk, dv of fp32 softmax attention on the same inputs, rounded to
    bf16 only at the end: no rounding of P or dS on the way."""
    t = [torch.from_numpy(np.asarray(x, np.float32)).requires_grad_() for x in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in t), is_causal=causal).transpose(1, 2)
    grads = torch.autograd.grad(o, t, torch.from_numpy(np.asarray(do, np.float32)))
    return [g.to(torch.bfloat16).float().numpy() for g in grads]


@pytest.mark.parametrize("n,nk,causal", [(197, 197, False), (98, 98, True), (257, 257, False)])
def test_plain_backward_follows_tpu_rounding_in_bf16(n, nk, causal):
    """bf16: the plain K5 casts P to bf16 before P^T dO and dS before dS K
    and dS^T Q, where the TPU kernel casts them, so dq, dk, dv through
    `FusedAttention` (plain K4, then plain K5) differ from jax.grad through
    the interpret-mode kernels by at most one bf16 ulp at their largest
    magnitude, in under 1% of the elements (measured: at most 0.3%, fp32
    sums in another order flip a rounding). fp32 attention's gradients,
    rounded to bf16 only at the end, differ in over 10% (measured: 40-43%
    of each of dq, dk, dv)."""
    q, k, v, do = _inputs(n, nk, 64, seed=3)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))

    def loss(q_, k_, v_):
        o = jax_fused_attention(q_, k_, v_, is_causal=causal, interpret=True)
        return (o.astype(jnp.float32) * jdo.astype(jnp.float32)).sum()

    want = [np.asarray(w, np.float32) for w in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    t = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_()
         for x in (jq, jk, jv)]
    got = torch.autograd.grad(fa.fused_attention(*t, is_causal=causal), t,
                              torch.from_numpy(np.asarray(jdo, np.float32)).to(torch.bfloat16))
    unrounded = _unrounded_grads(jq, jk, jv, jdo, causal)
    for g, u, w in zip(got, unrounded, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(g - w).max() <= ulp
        assert (g != w).mean() < 0.01
        assert (u != w).mean() > 0.1


def test_function_routes_whole_gradients_and_launches_nothing_on_the_cpu():
    """q, k, v as column slices of one [B, N, 3W] projection: the gradient
    arrives whole, equals autograd through the plain forward (fp32
    summation order, 1e-5), and CPU tensors count no kernel launch."""
    rng = np.random.RandomState(5)
    b, n, h, d = 2, 33, 2, 32
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32)).requires_grad_()
    do = torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32))
    fa.reset_launches()
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))
    (got,) = torch.autograd.grad(fa.fused_attention(q, k, v, is_causal=True), qkv, do)
    o_ref, _ = fa.fused_attention_packed_ref(q, k, v, is_causal=True)
    (want,) = torch.autograd.grad(o_ref, qkv, do)
    assert got.shape == qkv.shape
    assert (got - want).abs().max().item() < 1e-5
    assert fa.grouped_launches == 0 and fa.grouped_bwd_launches == 0


def test_function_passes_gradcheck_in_float64():
    qkv = torch.from_numpy(np.random.RandomState(2).randn(2, 9, 3 * 2 * 8)).requires_grad_()

    def f(x):
        q, k, v = (t.unflatten(-1, (2, 8)) for t in x.chunk(3, dim=-1))
        return fa.fused_attention(q, k, v, is_causal=True)

    assert torch.autograd.gradcheck(f, (qkv,), fast_mode=True)


def test_grouped_wrappers_refuse_other_devices():
    """Only a CPU tensor reaches the plain version."""
    meta = torch.empty(4, 16, 64, device="meta")
    lse = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.fused_attention_grouped(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.fused_attention_grouped_bwd(meta, meta, meta, meta, meta, lse)
