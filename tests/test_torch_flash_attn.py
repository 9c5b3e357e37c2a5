"""The port's flash attention (K10 forward, K10b backward; attn_impl='flash',
mrclip_tpu_torch/ops/flash_attn.py) against the JAX package's
`flash_attention_unpadded`, whose jax Pallas TPU kernels run in interpret
mode on the CPU (`pltpu.force_tpu_interpret_mode()`, as
tests/test_flash_attn.py runs them).

On the CPU the wrappers run their plain versions; the Hopper kernels are
held against those by tests/test_torch_cuda.py and chip_smoke.py on the
card. The same numpy-seeded inputs go to both sides. N = 257 (padded to
384: three key blocks of 128) and 577 (640: five) take jax's multi-block
path, the others its single block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mrclip_tpu.ops.flash_attn import flash_attention_unpadded as jax_flash
from mrclip_tpu_torch.ops import flash_attn as fl
from mrclip_tpu_torch.ops import fused_attn as fa

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

B, H = 2, 2


def _inputs(n, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, n, H, d).astype(np.float32) for _ in range(4))


@pytest.mark.parametrize("n,causal,d", [(197, False, 64), (98, True, 64), (256, False, 64),
                                        (70, True, 64), (257, False, 64), (577, False, 64),
                                        (257, True, 32)])
def test_plain_forward_matches_jax_kernel(n, causal, d):
    """fp32: o to 1e-4 (the same block walk in another summation order)."""
    q, k, v, _ = _inputs(n, d)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)), is_causal=causal))
    got = fl.flash_attention_unpadded(*(torch.from_numpy(x) for x in (q, k, v)),
                                      is_causal=causal)
    assert got.shape == want.shape == (B, n, H, d) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 1e-4


@pytest.mark.parametrize("n,causal", [(197, False), (98, True), (77, True), (256, False),
                                      (256, True), (257, False), (257, True), (577, False)])
def test_plain_gradients_match_jax_kernels(n, causal):
    """fp32: dq, dk, dv through `FlashAttention` (plain K10, di outside,
    plain K10b) against jax.grad through `flash_attention_unpadded`, each to
    1e-4: at EVA02-B-16's causal text shape (77), the top of the bf16 K10b's
    wgmma route (256, causal and not) and past it. JAX's side takes
    `save_residuals=True`: its default remat wrapper cannot be
    partial-evaluated in interpret mode (tests/test_flash_attn.py)."""
    q, k, v, do = _inputs(n, seed=1)

    def loss(q_, k_, v_):
        return (jax_flash(q_, k_, v_, is_causal=causal, save_residuals=True)
                * jnp.asarray(do)).sum()

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(fl.flash_attention_unpadded(tq, tk, tv, is_causal=causal),
                              (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        assert g.shape == (B, n, H, 64)
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-4


@pytest.mark.parametrize("n,causal", [(257, False), (577, False), (257, True)])
def test_plain_forward_follows_jax_rounding_in_bf16(n, causal):
    """bf16 on the multi-block path: the plain version rounds the
    unnormalised P before P V and scales by 1 / l after, as jax's kernel
    does, so o stays within one bf16 ulp of jax's at its largest magnitude
    and differs in under 1% of the elements (measured: 72, 165 and 18 of
    65792, 147712 and 65792). The K4 plain version, which normalises P before
    rounding it, differs in over 10% (measured 32455, 73390, 31568)."""
    q, k, v, _ = _inputs(n, seed=int(causal))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(jq, jk, jv, is_causal=causal), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    got = fl.flash_attention_unpadded(tq, tk, tv, is_causal=causal).float().numpy()
    k4 = fa.fused_attention(tq, tk, tv, is_causal=causal).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp
    assert (got != want).mean() < 0.01
    assert (k4 != want).mean() > 0.1


def _unrounded_grads(q, k, v, do, causal):
    """dq, dk, dv of fp32 softmax attention on the same inputs, rounded to
    bf16 only at the end: no rounding of P or dS on the way."""
    t = [torch.from_numpy(np.asarray(x, np.float32)).requires_grad_() for x in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in t), is_causal=causal).transpose(1, 2)
    grads = torch.autograd.grad(o, t, torch.from_numpy(np.asarray(do, np.float32)))
    return [g.to(torch.bfloat16).float().numpy() for g in grads]


@pytest.mark.parametrize("n,causal", [(197, False), (98, True), (257, False)])
def test_plain_backward_follows_jax_rounding_in_bf16(n, causal):
    """bf16: the plain K10b casts P = exp(S - m) * (1 / l) to bf16 before
    P^T dO and dS before dS K and dS^T Q, where jax's dkv and dq kernels
    cast them, and takes di = rowsum(O * dO) in fp32 outside, so dq, dk, dv
    through `FlashAttention` (plain K10, di, plain K10b) differ from
    jax.grad through the interpret-mode kernels (`save_residuals=True`, as
    test_plain_gradients_match_jax_kernels) by at most one bf16 ulp at their
    largest magnitude, in under 1% of the elements (measured: at most
    0.3%). fp32 attention's gradients, rounded to bf16 only at the end,
    differ in over 10% (measured: 40-43% of each of dq, dk, dv)."""
    q, k, v, do = _inputs(n, seed=3)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))

    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, is_causal=causal, save_residuals=True)
        return (o.astype(jnp.float32) * jdo.astype(jnp.float32)).sum()

    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(w, np.float32) for w in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    t = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_()
         for x in (jq, jk, jv)]
    got = torch.autograd.grad(fl.flash_attention_unpadded(*t, is_causal=causal), t,
                              torch.from_numpy(np.asarray(jdo, np.float32)).to(torch.bfloat16))
    unrounded = _unrounded_grads(jq, jk, jv, jdo, causal)
    for g, u, w in zip(got, unrounded, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(g - w).max() <= ulp
        assert (g != w).mean() < 0.01
        assert (u != w).mean() > 0.1


def test_save_residuals_gives_the_same_gradients():
    """The default keeps q, k, v and recomputes o, l, m in the backward; the
    other keeps them: bit-equal gradients."""
    q, k, v, do = _inputs(257, seed=3)
    grads = []
    for save in (False, True):
        t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        o = fl.flash_attention_unpadded(*t, is_causal=True, save_residuals=save)
        grads.append(torch.autograd.grad(o, t, torch.from_numpy(do)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n,blocks", [(1, (128, 128, 1)), (77, (128, 128, 1)),
                                      (197, (256, 256, 1)), (257, (128, 128, 3)),
                                      (500, (256, 256, 2)), (577, (128, 128, 5))])
def test_block_walk_is_jax_pick_block(n, blocks):
    """(query block, key block, key blocks) of the padded length, as
    `flash_attention_unpadded`'s pick_block chooses them."""
    assert fl._blocks(n, n) == blocks


def test_function_launches_nothing_on_the_cpu_and_passes_gradcheck():
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.randn(2, 9, 3 * 2 * 8)).requires_grad_()

    def f(x):
        q, k, v = (t.unflatten(-1, (2, 8)) for t in x.chunk(3, dim=-1))
        return fl.flash_attention_unpadded(q, k, v, is_causal=True)

    fl.reset_launches()
    assert torch.autograd.gradcheck(f, (qkv,), fast_mode=True)
    assert fl.launches == 0 and fl.bwd_launches == 0


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor reaches the plain version."""
    meta = torch.empty(1, 16, 2, 64, device="meta")
    stat = torch.empty(1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fl.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fl.flash_attention_bwd(meta, meta, meta, meta, stat, stat, stat)
