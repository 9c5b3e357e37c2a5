"""The rope branch of the port's packed attention (K2 forward, K3r backward,
mrclip_tpu_torch/ops/fused_attn.py with `rope=`) against the JAX package's
rope-in-kernel path: `fused_attention_packed(rope=..., interpret=True)` and
`_pfwd_impl` / `_pbwd_impl` with the `[N, 2D]` table, Pallas interpret mode
on the CPU.

The same numpy-seeded inputs go through both frameworks. On the CPU the
port's wrappers run their plain versions, which is what these tests check;
the Hopper kernels are held against those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.ops.fused_attn import _pbwd_impl, _pfwd_impl
from mrclip_tpu.ops.fused_attn import fused_attention_packed as jax_fused_attention_packed
from mrclip_tpu.ops.pos_embed import rope_cat_2d
from mrclip_tpu_torch.ops import fused_attn as fa
from test_torch_fused_attn_bwd import TILE_EDGES, bf16_bars

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# (B, N, H, D): the EVA02-B/16 layer with its 14 x 14 rope table, the top
# of the bf16 K2's and K3r's wgmma route (256 keys), and the JAX package's
# own small rope case (tests/test_fused_attn.py)
SHAPES = [(2, 197, 12, 64), (1, 256, 2, 64), (2, 19, 3, 8)]


def _inputs(b, n, h, d, prefix, seed=0):
    """q, k, v, dO [B, N, H*D] and the raw [N - prefix, 2D] sin||cos table:
    `rope_cat_2d`'s where N - prefix is its grid, else uniform in [-1, 1]."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, n, h * d).astype(np.float32) for _ in range(4))
    if n - prefix == 196:
        rope = rope_cat_2d(d, 14, 14, ref_feat_shape=(16, 16))
    else:
        rope = rng.uniform(-1, 1, (n - prefix, 2 * d)).astype(np.float32)
    return q, k, v, do, rope


def _jax_table(rope, prefix, dtype):
    """The JAX package's table build (fused_attn.py:884-888)."""
    sin, cos = jnp.split(jnp.asarray(rope), 2, axis=-1)
    sin = jnp.pad(sin, ((prefix, 0), (0, 0)))
    cos = jnp.pad(cos, ((prefix, 0), (0, 0)), constant_values=1.0)
    return jnp.concatenate([sin, cos], axis=-1).astype(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prefix", [0, 1])
def test_rope_table_matches_jax(prefix, dtype):
    _, _, _, _, rope = _inputs(1, 197, 1, 64, prefix)
    got = fa.rope_table(rope, prefix, dtype)
    want = _jax_table(rope, prefix, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    assert got.shape == (197, 128) and got.dtype == dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    if prefix:  # identity rows over the CLS prefix
        assert (got[0, :64] == 0).all() and (got[0, 64:] == 1).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("prefix", [0, 1])
@pytest.mark.parametrize("b,n,h,d", SHAPES)
def test_plain_versions_match_jax_in_fp32(b, n, h, d, prefix, causal):
    """K2's o and lse and K3r's dq, dk, dv: fp32, the same math in another
    summation order, to 1e-4."""
    q, k, v, do, rope = _inputs(b, n, h, d, prefix)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    want_o = jax_fused_attention_packed(
        jq.reshape(b, n, h, d), jk.reshape(b, n, h, d), jv.reshape(b, n, h, d),
        is_causal=causal, rope=jnp.asarray(rope), rope_prefix=prefix, interpret=True)
    jtab = _jax_table(rope, prefix, jnp.float32)
    jo, want_lse = _pfwd_impl(jq, jk, jv, d, causal, True, jtab)
    want = _pbwd_impl(jq, jk, jv, jo, jdo, want_lse, d, causal, True, tab=jtab)

    tab = fa.rope_table(rope, prefix, torch.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.fused_attention_packed_ref(tq, tk, tv, is_causal=causal, heads=h, rope=tab)
    assert o.shape == (b, n, h * d) and lse.shape == (b, h, n)
    assert np.abs(o.numpy() - np.asarray(want_o).reshape(b, n, h * d)).max() < 1e-4
    assert np.abs(lse.numpy() - np.asarray(want_lse)).max() < 1e-4
    got = fa.fused_attention_packed_bwd_ref(tq, tk, tv, torch.from_numpy(np.array(jo)), tdo,
                                            torch.from_numpy(np.array(want_lse)),
                                            is_causal=causal, heads=h, rope=tab)
    for g, w in zip(got, want):
        assert g.shape == (b, n, h * d) and g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-4


@pytest.mark.parametrize("prefix", [0, 1])
@pytest.mark.parametrize("b,n,h,d", SHAPES)
def test_plain_versions_follow_tpu_rounding_in_bf16(b, n, h, d, prefix):
    """bf16: the table in bf16, q and k rotated in fp32 and rounded once,
    P and dS rounded where the TPU kernel rounds them, g * sin rounded
    before its un-rotation: o within one bf16 ulp (2**-6 at |o| < 2), each
    gradient within one bf16 ulp at its largest magnitude."""
    q, k, v, do, rope = _inputs(b, n, h, d, prefix, seed=3)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jtab = _jax_table(rope, prefix, jnp.bfloat16)
    want_o, want_lse = _pfwd_impl(jq, jk, jv, d, False, True, jtab)
    want = _pbwd_impl(jq, jk, jv, want_o, jdo, want_lse, d, False, True, tab=jtab)

    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    tab = fa.rope_table(rope, prefix, torch.bfloat16)
    o, lse = fa.fused_attention_packed_ref(t(jq), t(jk), t(jv), heads=h, rope=tab)
    assert o.dtype == torch.bfloat16
    assert np.abs(o.float().numpy() - np.asarray(want_o, np.float32)).max() <= 2 ** -6
    assert np.abs(lse.numpy() - np.asarray(want_lse)).max() < 1e-4
    got = fa.fused_attention_packed_bwd_ref(t(jq), t(jk), t(jv), t(want_o), t(jdo),
                                            torch.from_numpy(np.array(want_lse)), heads=h,
                                            rope=tab)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert g.dtype == torch.bfloat16
        assert np.abs(g.float().numpy() - w).max() <= ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,causal,d", TILE_EDGES)
def test_plain_backward_matches_jax_kernel_at_tile_edges(n, causal, d, dtype):
    """The plain K3r that chip_smoke.py holds the tensor-core kernel against
    at its tile edges, against JAX's `_pbwd_impl` with the table in
    interpret mode at the same shapes (a CLS identity row, random table rows
    after it): fp32 within 1e-4; bf16 within one bf16 ulp at the call's
    largest gradient, in under 1% of each gradient's elements (the rotation,
    P, dS and g * sin rounded at the same points)."""
    q, k, v, do, rope = _inputs(1, n, 2, d, 1, seed=12)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jtab = _jax_table(rope, 1, jdt)
    jo, jlse = _pfwd_impl(jq, jk, jv, d, causal, True, jtab)
    want = _pbwd_impl(jq, jk, jv, jo, jdo, jlse, d, causal, True, tab=jtab)
    t = lambda x: torch.from_numpy(np.array(x, np.float32)).to(dtype)  # noqa: E731
    got = fa.fused_attention_packed_bwd_ref(t(jq), t(jk), t(jv), t(jo), t(jdo),
                                            torch.from_numpy(np.array(jlse)), is_causal=causal,
                                            heads=2, rope=fa.rope_table(rope, 1, dtype))
    assert all(g.shape == (1, n, 2 * d) and g.dtype == dtype for g in got)
    if dtype == torch.float32:
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-4
        return
    errs, shares = bf16_bars(got, want)
    assert max(errs) <= 1 and max(shares) < 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cls_row_is_bit_identical_after_rotation(dtype):
    """The identity prefix row (sin 0, cos 1) leaves the CLS row of q and k
    exactly as it was, in fp32 and in bf16."""
    q, _, _, _, rope = _inputs(2, 197, 12, 64, 1)
    x = torch.from_numpy(q).to(dtype).reshape(2, 197, 12, 64).transpose(1, 2).float()
    sin, cos = fa.rope_table(rope, 1, dtype).float().chunk(2, dim=-1)
    y = fa._rope_rotate(x, sin, cos, dtype)
    assert torch.equal(y[:, :, 0], x[:, :, 0])
    assert not torch.equal(y[:, :, 1:], x[:, :, 1:])


@pytest.mark.parametrize("b,n,h,d,causal", [(2, 17, 2, 32, False), (1, 26, 3, 64, True)])
def test_function_gradients_match_autograd_of_plain_forward(b, n, h, d, causal):
    """FusedAttentionPacked with a rope table (plain K2 + plain K3r on the
    CPU) against torch autograd through the plain K2 forward, fp32, on one
    packed qkv: the hand-written un-rotation is the rotation's VJP."""
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32)).requires_grad_()
    do = torch.from_numpy(rng.randn(b, n, h * d).astype(np.float32))
    tab = fa.rope_table(rng.uniform(-1, 1, (n - 1, 2 * d)).astype(np.float32), 1, torch.float32)
    o = fa.fused_attention_qkv(qkv, heads=h, is_causal=causal, rope=tab)
    (got,) = torch.autograd.grad(o, qkv, do)
    o_ref, _ = fa.fused_attention_packed_ref(*qkv.chunk(3, dim=-1), is_causal=causal, heads=h,
                                             rope=tab)
    (want,) = torch.autograd.grad(o_ref, qkv, do)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    assert (got - want).abs().max().item() < 1e-5  # fp32 summation order


def test_function_passes_gradcheck_in_float64():
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.randn(2, 9, 3 * 2 * 8)).requires_grad_()
    tab = fa.rope_table(torch.from_numpy(rng.uniform(-1, 1, (8, 16))), 1, torch.float64)
    assert torch.autograd.gradcheck(
        lambda x: fa.fused_attention_qkv(x, heads=2, is_causal=True, rope=tab), (qkv,),
        fast_mode=True)


def test_cpu_tensors_take_the_plain_path_without_counting():
    q, k, v, do, rope = (torch.from_numpy(x) for x in _inputs(1, 19, 3, 8, 1))
    tab = fa.rope_table(rope, 1, torch.float32)
    fa.reset_launches()
    o, lse = fa.fused_attention_packed(q, k, v, heads=3, rope=tab)
    grads = fa.fused_attention_packed_bwd(q, k, v, o, do, lse, heads=3, rope=tab)
    want_o, want_lse = fa.fused_attention_packed_ref(q, k, v, heads=3, rope=tab)
    want = fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, heads=3, rope=tab)
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (fa.launches, fa.bwd_launches, fa.rope_launches, fa.rope_bwd_launches) == (0, 0, 0, 0)


def test_no_fallback_for_other_devices_and_bad_tables():
    """Only a CPU tensor reaches the plain version; a table the kernels
    cannot take raises on either path."""
    meta = torch.empty(1, 5, 128, device="meta")
    tab = torch.empty(5, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.fused_attention_packed(meta, meta, meta, heads=2, rope=tab)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.fused_attention_packed_bwd(meta, meta, meta, meta, meta,
                                      torch.empty(1, 2, 5, device="meta"), heads=2, rope=tab)
    x = torch.zeros(1, 5, 128)
    with pytest.raises(TypeError, match="q's type"):
        fa.fused_attention_packed(x, x, x, heads=2, rope=torch.zeros(5, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="2D"):
        fa.fused_attention_packed(x, x, x, heads=2, rope=torch.zeros(4, 128))
    with pytest.raises(ValueError, match="self-attention"):
        fa.fused_attention_packed(x, x[:, :3], x[:, :3], heads=2, rope=torch.zeros(5, 128))
