"""Card-only tests of the PyTorch port: the Hopper kernel against its plain
version, its refusals, and a small CLIP through it.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs where only the port is
installed; on the card, from the repo root:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest.py sets up JAX.)
"""

import numpy as np
import pytest
import torch

from mrclip_tpu_torch.factory import create_model
from mrclip_tpu_torch.ops import fused_attn as fa

pytestmark = pytest.mark.cuda

SHAPES = [  # (B, N, Nk, H, causal) of tests/test_torch_fused_attn.py
    (2, 197, 197, 4, False),
    (2, 98, 98, 4, True),
    (1, 76, 255, 2, False),
    (3, 257, 257, 2, False),
    (1, 64, 64, 5, True),
    (2, 197, 197, 12, False),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m cuda --noconftest tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, n, nk, h, d, device, dtype):
    rng = np.random.RandomState(0)
    return tuple(torch.from_numpy(rng.randn(b, m, h, d).astype(np.float32)).to(device, dtype)
                 for m in (n, nk, nk))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,nk,h,causal", SHAPES)
@pytest.mark.parametrize("d", [32, 64])
def test_kernel_matches_plain_version(cuda_device, b, n, nk, h, causal, d, dtype, tol):
    q, k, v = _inputs(b, n, nk, h, d, cuda_device, dtype)
    before = fa.launches
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want_o, want_lse = fa.fused_attention_packed_ref(q, k, v, is_causal=causal)
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (b, h, n)
    assert (o.float() - want_o.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-3


def test_kernel_takes_strided_slices_of_one_qkv(cuda_device):
    b, n, h, d = 4, 197, 12, 64
    qkv = torch.randn(b, n, 3 * h * d, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(h * d, dim=-1)
    o, lse = fa.fused_attention_packed(q, k, v, heads=h)
    want_o, want_lse = fa.fused_attention_packed_ref(*(t.contiguous() for t in (q, k, v)), heads=h)
    assert (o.float() - want_o.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3


def test_kernel_refuses_what_it_cannot_take(cuda_device):
    """A CUDA tensor never reaches the plain version: unsupported inputs raise."""
    q, k, v = _inputs(1, 16, 16, 2, 64, cuda_device, torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fa.fused_attention_packed(q, k, v)
    q, k, v = _inputs(1, 16, 16, 2, 128, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.fused_attention_packed(q, k, v)
    every_other = torch.randn(1, 16, 256, device=cuda_device).to(torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention_packed(every_other, every_other, every_other, heads=2)


def test_small_clip_through_the_kernel_matches_plain_attention(cuda_device):
    """ViT-B-32-mini in bf16 on the card: every attention layer launches the
    kernel, and the features agree with the same weights under plain math."""
    kernel = create_model("ViT-B-32-mini", precision="bf16", attn_impl="fusedp", rng_seed=0)
    plain = create_model("ViT-B-32-mini", precision="bf16", attn_impl="xla", rng_seed=0)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(4, 64, 64, 3).astype(np.float32)).to(cuda_device)
    tokens = torch.zeros(4, 32, dtype=torch.int64, device=cuda_device)
    tokens[:, 0], tokens[:, 1:6] = 49406, torch.arange(400, 405, device=cuda_device)
    tokens[:, 6] = 49407
    with torch.inference_mode():
        before = fa.launches
        a = kernel(images, tokens)
        assert fa.launches - before == 4  # 2 vision + 2 text layers
        b = plain(images, tokens)
    for key in ("image_features", "text_features"):
        cos = torch.nn.functional.cosine_similarity(a[key].float(), b[key].float(), dim=-1)
        assert cos.min().item() >= 0.999, key
