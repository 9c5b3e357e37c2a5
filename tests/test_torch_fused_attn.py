"""Packed fused attention of the PyTorch port (mrclip_tpu_torch/ops/fused_attn.py)
against the JAX package's packed kernel (`_packed_fwd_kernel`, run in Pallas
interpret mode on the CPU) and `jax.nn.dot_product_attention`.

The same numpy-seeded inputs go through both frameworks. On the CPU the
port's wrapper runs its plain version, which is what these tests check; the
Hopper kernel is held against that plain version on the card by
tests/test_torch_cuda.py (and by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.ops.fused_attn import _pfwd_impl
from mrclip_tpu.ops.fused_attn import fused_attention_packed as jax_fused_attention_packed
from mrclip_tpu_torch.ops import fused_attn as fa

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# tests/test_fused_attn.py's shapes plus the ViT-B/16 layer (N=197, H=12, D=64)
SHAPES = [
    (2, 197, 197, 4, False),   # ViT-B/16 sequence
    (2, 98, 98, 4, True),      # text tower, causal
    (1, 76, 255, 2, False),    # kv length != q length
    (3, 257, 257, 2, False),   # ViT-L/14 sequence
    (1, 64, 64, 5, True),      # odd head count
    (2, 197, 197, 12, False),  # ViT-B/16 layer, all 12 heads
]


def _inputs(b, n, nk, h, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, h, d).astype(np.float32),
            rng.randn(b, nk, h, d).astype(np.float32),
            rng.randn(b, nk, h, d).astype(np.float32))


@pytest.mark.parametrize("b,n,nk,h,causal", SHAPES)
def test_plain_version_matches_jax(b, n, nk, h, causal):
    q, k, v = _inputs(b, n, nk, h)
    o, lse = fa.fused_attention_packed_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), is_causal=causal
    )
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_o = jax_fused_attention_packed(jq, jk, jv, is_causal=causal, interpret=True)
    dpa = jax.nn.dot_product_attention(jq, jk, jv, is_causal=causal)
    _, want_lse = _pfwd_impl(
        jq.reshape(b, n, h * 64), jk.reshape(b, nk, h * 64), jv.reshape(b, nk, h * 64),
        64, causal, True,
    )
    assert o.shape == (b, n, h, 64) and lse.shape == (b, h, n)
    assert np.abs(o.numpy() - np.asarray(want_o)).max() < 1e-4
    assert np.abs(o.numpy() - np.asarray(dpa)).max() < 1e-4
    assert np.abs(lse.numpy() - np.asarray(want_lse)).max() < 1e-4


def test_plain_version_follows_tpu_rounding_in_bf16():
    """bf16: P is divided by l in fp32 and cast to bf16 before P @ V, exactly
    as the TPU kernel does, so the two agree to bf16 rounding of o."""
    b, n, h = 2, 98, 4
    q, k, v = _inputs(b, n, n, h, seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = fa.fused_attention_packed_ref(tq, tk, tv, is_causal=True)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16).reshape(b, n, h * 64) for x in (q, k, v))
    want_o, want_lse = _pfwd_impl(jq, jk, jv, 64, True, True)
    assert o.dtype == torch.bfloat16
    got = o.float().reshape(b, n, h * 64).numpy()
    assert np.abs(got - np.asarray(want_o, np.float32)).max() <= 2 ** -6  # one bf16 ulp at |o| < 2
    assert np.abs(lse.numpy() - np.asarray(want_lse)).max() < 1e-4


def test_packed_strided_slices_match_4d_layout():
    """q, k, v handed over as column slices of one [B, N, 3*H*D] tensor
    (no copies) give the same result as contiguous [B, N, H, D] inputs."""
    b, n, h, d = 2, 50, 3, 32
    qkv = torch.from_numpy(np.random.RandomState(1).randn(b, n, 3 * h * d).astype(np.float32))
    q, k, v = qkv[..., : h * d], qkv[..., h * d : 2 * h * d], qkv[..., 2 * h * d :]
    assert q.stride(1) == 3 * h * d  # genuinely strided
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=True, heads=h)
    o4, lse4 = fa.fused_attention_packed_ref(
        *(t.contiguous().reshape(b, n, h, d) for t in (q, k, v)), is_causal=True
    )
    assert o.shape == (b, n, h * d)
    torch.testing.assert_close(o, o4.reshape(b, n, h * d), rtol=0, atol=0)
    torch.testing.assert_close(lse, lse4, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 20, 20, 2))
    fa.reset_launches()
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=True)
    want_o, want_lse = fa.fused_attention_packed_ref(q, k, v, is_causal=True)
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    assert fa.launches == 0


def test_no_fallback_for_other_devices_and_bad_layouts():
    """Only a CPU tensor reaches the plain version: any other device goes to
    the kernel path, which raises on what the kernel cannot take."""
    meta = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.fused_attention_packed(meta, meta, meta)
    x = torch.zeros(1, 4, 128)
    with pytest.raises(ValueError, match="heads"):
        fa.fused_attention_packed(x, x, x)  # packed layout needs heads=
    with pytest.raises(ValueError, match="whole number"):
        fa.fused_attention_packed(x, x, x, heads=3)


# (base pointer, stepped batch and row strides in elements, element bytes):
# the packed column slices of ViT-B-16's [B, N, 3*768] and of its text
# tower's [B, N, 3*512] projection in bf16, and views off 16 bytes
ALIGNMENT_CASES = [
    ((0, (197 * 2304, 2304), 2), True),
    ((1536, (197 * 2304, 2304), 2), True),   # k's slice, 768 bf16 in
    ((1024, (98 * 1536, 1536), 2), True),    # text tower's k slice
    ((2, (197 * 2304, 2304), 2), False),     # base pointer one bf16 off
    ((0, (16 * 385, 385), 2), False),        # row stride 3*128 + 1 bf16
    ((0, (1028, 8), 2), False),              # batch stride off, row stride fine
    ((0, (), 2), True),                      # one row of one sample
    ((4, (), 4), False),                     # fp32, one element off
    ((16, (100, 4), 4), True),               # fp32, 16-byte strides
    # the backward's gradient: dk and dv, the column slices of one
    # [B, N, 3*768] bf16 buffer, and of one [B, N, 3*768 + 1] (odd rows)
    ((1536, (197 * 2304, 2304), 2), True),
    ((3072, (197 * 2304, 2304), 2), True),
    ((3072, (197 * 2305, 2305), 2), False),
    ((0, (128,), 2), True),                  # K3r's [N, 2D] table at D = 64
]


@pytest.mark.parametrize("args,aligned", ALIGNMENT_CASES)
def test_rows_aligned_16_predicate(args, aligned):
    """The 16-byte rule of the bf16 tensor-core kernels (K1, K2, K4, K10 and
    K3, K3r, K5, K10b), one predicate on (pointer, strides, element size)
    for every wrapper."""
    assert fa.rows_aligned_16(*args) is aligned


def test_check_rows_aligned_16_refuses_views_off_16_bytes():
    """The shared check reads a view's pointer, its stepped batch and row
    strides and its element size: column slices of one packed projection
    pass, a slice one element off does not; a dimension of size 1 has no
    stride that counts."""
    h, d = 2, 64
    qkv = torch.zeros(2, 16, 3 * h * d, dtype=torch.bfloat16)
    fa.check_rows_aligned_16("k1", qkv.split(h * d, dim=-1))
    off = torch.zeros(2, 16, 3 * h * d + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.check_rows_aligned_16("k1", (off[..., :h * d],))  # row stride 385 elements
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.check_rows_aligned_16("k1", (qkv[..., 1:h * d + 1],))  # base pointer 2 bytes in
    one_row = torch.zeros(1, 1, h * d + 1, dtype=torch.bfloat16)[..., :h * d]
    fa.check_rows_aligned_16("k1", (one_row,))
