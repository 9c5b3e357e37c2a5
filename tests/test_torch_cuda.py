"""Card-only tests of the PyTorch port: each Hopper kernel (K1 and K3, the
packed attention forward and backward; K2 and K3r, the same with the rope
rotated inside; K4 and K5, the grouped-layout attention; K10 and K10b, the
flash attention; K6 and K7, the fused SupCon loss) against its plain
version, their refusals, a small CLIP through them, and small train steps
(ViT and EVA02) whose attention gradients come from the kernels.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs where only the port is
installed; on the card, from the repo root:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest.py sets up JAX.)
"""

import numpy as np
import pytest
import torch

from mrclip_tpu_torch.factory import create_loss, create_model, get_model_config
from mrclip_tpu_torch.ops import flash_attn as fl
from mrclip_tpu_torch.ops import fused_attn as fa
from mrclip_tpu_torch.ops.pos_embed import rope_cat_2d
from mrclip_tpu_torch.ops import pallas_loss as pl
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.parallel import create_optimizer, create_train_state, make_loss_apply
from mrclip_tpu_torch.parallel.train_step import loss_and_grads

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


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,nk,h,causal", SHAPES)
@pytest.mark.parametrize("d", [32, 64])
def test_backward_kernel_matches_plain_version(cuda_device, b, n, nk, h, causal, d, dtype, tol):
    """K3: max |err| / max |plain| per output. bf16: the two round P and dS
    the same way, but a sum taken in another order can flip one bf16
    rounding of a gradient (~1e-2 relative); fp32: summation order only."""
    q, k, v = _inputs(b, n, nk, h, d, cuda_device, dtype)
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal)
    do = torch.randn(o.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1)).to(dtype)
    before = fa.bwd_launches
    got = fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    want = fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=causal)
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.shape == like.shape and g.dtype == dtype
        rel = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert rel.item() <= tol


def test_backward_kernel_writes_column_slices_of_one_buffer(cuda_device):
    b, n, h, d = 4, 197, 12, 64
    qkv = torch.randn(b, n, 3 * h * d, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    o, lse = fa.fused_attention_packed(q, k, v, heads=h)
    do = torch.randn_like(o)
    buf = torch.zeros_like(qkv)
    fa.fused_attention_packed_bwd(q, k, v, o, do, lse, heads=h, out=buf.chunk(3, dim=-1))
    want = fa.fused_attention_packed_bwd_ref(*(t.contiguous() for t in (q, k, v)), o, do, lse,
                                             heads=h)
    for part, w in zip(buf.chunk(3, dim=-1), want):
        assert ((part.float() - w.float()).abs().max() / w.float().abs().max()).item() <= 2e-2


def test_backward_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _inputs(1, 16, 16, 2, 64, cuda_device, torch.float32)
    o, lse = fa.fused_attention_packed(q, k, v)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fa.fused_attention_packed_bwd(q, k, v, o, o.half(), lse)
    with pytest.raises(ValueError, match="lse"):
        fa.fused_attention_packed_bwd(q, k, v, o, o, lse.double())
    with pytest.raises(ValueError, match="unsupported device|different devices"):
        fa.fused_attention_packed_bwd(q, k, v, o, o.cpu(), lse)


def _supcon_inputs(n, d, n_labels, device, seed=0):
    rng = np.random.RandomState(seed)
    q, k = (rng.randn(n, d).astype(np.float32) for _ in range(2))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    labels = (np.arange(n) if n_labels is None else rng.randint(0, n_labels, n)).astype(np.int32)
    return (torch.from_numpy(q).to(device), torch.from_numpy(k).to(device),
            torch.from_numpy(labels).to(device))


@pytest.mark.parametrize("n,d,n_labels", [(32, 128, 5), (12, 16, 3), (20, 32, None),
                                          (100, 512, 32), (333, 512, 32), (256, 512, None)])
def test_supcon_kernels_match_plain_versions(cuda_device, n, d, n_labels):
    """K6 and K7 in fp32 against their plain versions: max |err| / max
    |plain| <= 1e-5 (fp32 FMA sums in another order, TF32 off)."""
    q, k, labels = _supcon_inputs(n, d, n_labels, cuda_device)
    scale = torch.tensor([14.0], device=cuda_device)
    gbar = torch.tensor([0.7 / n], device=cuda_device)
    before = dict(pl.launches)
    stats = pl.supcon_stats(q, k, labels, labels, scale)
    want = pl.supcon_stats_ref(q, k, labels, labels, scale)
    for g, w in zip(stats, want):
        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-5
    m, s, _, cnt = want
    cnt = cnt.clamp(min=1.0)
    dq, ds_rows = pl.supcon_grad_q(q, k, labels, labels, scale, m, s, cnt, gbar)
    dk = pl.supcon_grad_k(q, k, labels, labels, scale, m, s, cnt, gbar)
    torch.cuda.synchronize()
    want_dq, want_ds = pl.supcon_grad_q_ref(q, k, labels, labels, scale, m, s, cnt, gbar)
    want_dk = pl.supcon_grad_k_ref(q, k, labels, labels, scale, m, s, cnt, gbar)
    for g, w in ((dq, want_dq), (ds_rows, want_ds), (dk, want_dk)):
        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-5
    assert all(pl.launches[name] == before[name] + 1 for name in pl.launches)


def test_supcon_kernels_refuse_what_they_cannot_take(cuda_device):
    q, k, labels = _supcon_inputs(8, 16, 2, cuda_device)
    scale = torch.tensor([1.0], device=cuda_device)
    with pytest.raises(TypeError, match="fp32"):
        pl.supcon_stats(q.double(), k.double(), labels, labels, scale)
    with pytest.raises(TypeError, match="int32"):
        pl.supcon_stats(q, k, labels.long(), labels.long(), scale)
    with pytest.raises(ValueError, match="different devices"):
        pl.supcon_stats(q, k, labels.cpu(), labels, scale)


@pytest.mark.parametrize("pallas", [False, True])
def test_small_train_step_gradients_through_the_kernels(cuda_device, pallas):
    """ViT-B-32-mini bf16 on the card: with attn_impl='fusedp' every
    attention projection gets a gradient through K1/K3 (each layer launches
    both once), equal to the plain-attention step's within bf16 rounding
    through two layers (cosine >= 0.999 per tensor of 10^3 or more elements);
    under pallas_loss each K6/K7 kernel launches twice."""
    args = type("Args", (), dict(multipositiveloss=True, delta=0.5, pallas_loss=pallas))()
    apply = make_loss_apply(create_loss(args))
    rng = np.random.RandomState(0)
    batch = {
        "images": normalize_images(torch.from_numpy(
            rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)).to(cuda_device)),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (8, 32))).to(cuda_device),
        "labels": torch.from_numpy(rng.randint(0, 3, 8).astype(np.int32)).to(cuda_device),
    }
    grads = {}
    for impl in ("fusedp", "xla"):
        model = create_model("ViT-B-32-mini", precision="bf16", attn_impl=impl, rng_seed=0)
        state = create_train_state(model, create_optimizer(lr=1e-4))
        fa.reset_launches()
        pl.reset_launches()
        grads[impl], ldict = loss_and_grads(model, apply, state.params, batch)
        torch.cuda.synchronize()
        assert np.isfinite(ldict["loss"].item())
        if impl == "fusedp":
            assert fa.launches == 4 and fa.bwd_launches == 4  # 2 vision + 2 text layers
            assert all(v == (2 if pallas else 0) for v in pl.launches.values())
    for name, g in grads["fusedp"].items():
        if "in_proj" in name:
            assert g.abs().max().item() > 0, name
        if g.numel() >= 1000:
            cos = torch.nn.functional.cosine_similarity(
                g.flatten().double(), grads["xla"][name].flatten().double(), dim=0)
            assert cos.item() >= 0.999, name


ROPE_SHAPES = [  # (B, N, H, D, prefix, causal)
    (2, 197, 12, 64, 1, False),  # EVA02-B/16 layer, the real 14 x 14 table
    (2, 197, 4, 64, 0, False),
    (3, 50, 2, 32, 1, True),     # head dim 32, causal
    (2, 1, 2, 64, 1, False),     # CLS only
    (1, 257, 2, 64, 1, False),   # 16 x 16 grid
]


def _rope_inputs(b, n, h, d, prefix, device, dtype):
    """q, k, v, o-gradient as column slices of one packed buffer, and the
    kernel table of a rope_cat_2d grid (or random rows when N - prefix is
    not a square)."""
    rng = np.random.RandomState(4)
    g = int(round((n - prefix) ** 0.5))
    rope = (rope_cat_2d(d, g, g, ref_feat_shape=(16, 16)) if g * g == n - prefix
            else rng.uniform(-1, 1, (n - prefix, 2 * d)).astype(np.float32))
    tab = fa.rope_table(rope, prefix, dtype).to(device)
    buf = torch.from_numpy(rng.randn(b, n, 4 * h * d).astype(np.float32)).to(device, dtype)
    q, k, v, do = buf.chunk(4, dim=-1)
    return q, k, v, do, tab


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,h,d,prefix,causal", ROPE_SHAPES)
def test_rope_kernels_match_plain_versions(cuda_device, b, n, h, d, prefix, causal, dtype, tol):
    """K2 and K3r: o within K1's bar, lse within 1e-3, each gradient within
    tol of the call's largest |plain| gradient (K3's bar); the kernels
    rotate with the plain version's roundings, so the CLS rows of a prefix
    see exactly the unrotated q and k."""
    q, k, v, do, tab = _rope_inputs(b, n, h, d, prefix, cuda_device, dtype)
    before = (fa.rope_launches, fa.rope_bwd_launches, fa.launches, fa.bwd_launches)
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h, rope=tab)
    got = fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal, heads=h, rope=tab)
    torch.cuda.synchronize()
    assert (fa.rope_launches, fa.rope_bwd_launches, fa.launches, fa.bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    want_o, want_lse = fa.fused_attention_packed_ref(q, k, v, is_causal=causal, heads=h, rope=tab)
    assert (o.float() - want_o.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-3
    want = fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=causal, heads=h,
                                             rope=tab)
    scale = max(w.float().abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        assert (g.float() - w.float()).abs().max().item() <= tol * max(scale, 1e-30)


def test_rope_kernels_refuse_what_they_cannot_take(cuda_device):
    q, k, v, do, tab = _rope_inputs(1, 17, 2, 64, 1, cuda_device, torch.bfloat16)
    with pytest.raises(TypeError, match="q's type"):
        fa.fused_attention_packed(q, k, v, heads=2, rope=tab.float())
    with pytest.raises(ValueError, match="2D"):
        fa.fused_attention_packed(q, k, v, heads=2, rope=tab[1:])
    with pytest.raises(ValueError, match="self-attention"):
        fa.fused_attention_packed(q, k[:, :9], v[:, :9], heads=2, rope=tab)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention_packed(q, k, v, heads=2, rope=tab.t().contiguous().t())
    o, lse = fa.fused_attention_packed(q, k, v, heads=2, rope=tab)
    with pytest.raises(ValueError, match="rope table on"):
        fa.fused_attention_packed_bwd(q, k, v, o, do, lse, heads=2, rope=tab.cpu())


def test_small_eva02_train_step_gradients_through_the_kernels(cuda_device):
    """EVA02-B-16 at full width on 32 x 32 images (4 patches + CLS) with a
    2-layer text tower, bf16: under 'fusedp' each vision layer launches K2
    and K3r once and each text layer K1 and K3 once; every q/k/v projection
    gets a gradient, equal to the plain-attention step's within bf16
    rounding through 12 layers, where the kernels rotate with the bf16 table
    and the plain path in fp32 (cosine >= 0.999 over all gradients, >= 0.99
    per tensor of 10^4 or more elements, chip_smoke.py's bars)."""
    cfg = get_model_config("EVA02-B-16")
    vision = dict(cfg["vision_cfg"], image_size=32)
    text = dict(cfg["text_cfg"], width=128, heads=2, layers=2, context_length=16)
    args = type("Args", (), dict(multipositiveloss=True, delta=0.5, pallas_loss=False))()
    apply = make_loss_apply(create_loss(args))
    rng = np.random.RandomState(0)
    batch = {
        "images": normalize_images(torch.from_numpy(
            rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)).to(cuda_device)),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (8, 16))).to(cuda_device),
        "labels": torch.from_numpy(rng.randint(0, 3, 8).astype(np.int32)).to(cuda_device),
    }
    grads = {}
    for impl in ("fusedp", "xla"):
        model = create_model("EVA02-B-16", precision="bf16", attn_impl=impl, rng_seed=0,
                             vision_cfg=vision, text_cfg=text)
        state = create_train_state(model, create_optimizer(lr=1e-4))
        fa.reset_launches()
        grads[impl], ldict = loss_and_grads(model, apply, state.params, batch)
        torch.cuda.synchronize()
        assert np.isfinite(ldict["loss"].item())
        if impl == "fusedp":
            assert (fa.rope_launches, fa.rope_bwd_launches) == (12, 12)
            assert (fa.launches, fa.bwd_launches) == (2, 2)
    qkv = [n for n in grads["fusedp"] if any(p in n for p in ("q_proj.w", "k_proj.w", "v_proj.w"))]
    assert len(qkv) == 36
    for name in qkv:
        assert grads["fusedp"][name].abs().max().item() > 0, name
    flat = {impl: torch.cat([g.flatten().double() for g in grads[impl].values()])
            for impl in grads}
    cos = torch.nn.functional.cosine_similarity
    assert cos(flat["fusedp"], flat["xla"], dim=0).item() >= 0.999
    for name, g in grads["fusedp"].items():
        if g.numel() >= 10**4:
            assert cos(g.flatten().double(), grads["xla"][name].flatten().double(),
                       dim=0).item() >= 0.99, name


def _rel(got, want, scale):
    return ((got.float() - want.float()).abs().max() / max(scale, 1e-30)).item()


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,nk,h,causal", SHAPES)
@pytest.mark.parametrize("d", [32, 64])
def test_grouped_kernels_match_plain_versions(cuda_device, b, n, nk, h, causal, d, dtype, tol):
    """K4 and K5 on the grouped [B*H, N, D] layout: o within K1's bar, lse
    within 1e-3, each gradient within tol of the call's largest |plain|
    gradient (K3's bar); one launch each, none of the packed kernels."""
    q, k, v = (t.transpose(1, 2).reshape(b * h, -1, d).contiguous()
               for t in _inputs(b, n, nk, h, d, cuda_device, dtype))
    fa.reset_launches()
    o, lse = fa.fused_attention_grouped(q, k, v, is_causal=causal)
    do = torch.randn(o.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1)).to(dtype)
    got = fa.fused_attention_grouped_bwd(q, k, v, o, do, lse, is_causal=causal)
    torch.cuda.synchronize()
    assert (fa.grouped_launches, fa.grouped_bwd_launches, fa.launches, fa.bwd_launches) == (1, 1, 0, 0)
    want_o, want_lse = fa.fused_attention_ref(q, k, v, is_causal=causal)
    assert o.dtype == dtype and lse.shape == (b * h, n)
    assert (o.float() - want_o.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-3
    want = fa.fused_attention_bwd_ref(q, k, v, o, do, lse, is_causal=causal)
    scale = max(w.float().abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert _rel(g, w, scale) <= tol


FLASH_SHAPES = SHAPES + [(2, 577, 577, 2, False), (1, 257, 257, 3, True)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,nk,h,causal", FLASH_SHAPES)
@pytest.mark.parametrize("d", [32, 64])
def test_flash_kernels_match_plain_versions(cuda_device, b, n, nk, h, causal, d, dtype, tol):
    """K10 and K10b on q, k, v as column slices of one packed projection
    (N = 257 and 577 walk three and five key blocks): o within K1's bar, l
    and m within 1e-3 relative, gradients within K3's bar."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(b, n, 4 * h * d).astype(np.float32)).to(cuda_device, dtype)
    y = x if nk == n else torch.from_numpy(rng.randn(b, nk, 4 * h * d).astype(np.float32)).to(
        cuda_device, dtype)
    q, _, _, do = (t.unflatten(-1, (h, d)) for t in x.chunk(4, dim=-1))
    _, k, v, _ = (t.unflatten(-1, (h, d)) for t in y.chunk(4, dim=-1))
    fl.reset_launches()
    fa.reset_launches()
    o, l, m = fl.flash_attention(q, k, v, is_causal=causal)
    do = do.contiguous()
    di = fl.flash_di(o, do)
    got = fl.flash_attention_bwd(q, k, v, do, l, m, di, is_causal=causal)
    torch.cuda.synchronize()
    assert (fl.launches, fl.bwd_launches) == (1, 1)
    assert (fa.launches, fa.bwd_launches, fa.grouped_launches) == (0, 0, 0)
    want_o, want_l, want_m = fl.flash_attention_ref(q, k, v, is_causal=causal)
    assert o.shape == q.shape and o.dtype == dtype and l.shape == m.shape == (b, h, n)
    assert (o.float() - want_o.float()).abs().max().item() <= tol
    assert ((l - want_l).abs() / want_l).max().item() <= 1e-3
    assert (m - want_m).abs().max().item() <= 1e-3
    want = fl.flash_attention_bwd_ref(q, k, v, do, l, m, di, is_causal=causal)
    scale = max(w.float().abs().max().item() for w in want)
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.shape == like.shape and g.dtype == dtype
        assert _rel(g, w, scale) <= tol


def test_grouped_and_flash_kernels_refuse_what_they_cannot_take(cuda_device):
    q, k, v = _inputs(1, 16, 16, 2, 64, cuda_device, torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fl.flash_attention(q, k, v)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fa.fused_attention_grouped(*(t[:, :, 0].contiguous() for t in (q, k, v)))
    q, k, v = _inputs(1, 16, 16, 2, 64, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fl.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    g = q.transpose(1, 2).reshape(2, 16, 64)  # a view of the non-grouped layout
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention_grouped(g, g, g)
    o, l, m = fl.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="contiguous fp32"):
        fl.flash_attention_bwd(q, k, v, o, l.double(), m, l)


@pytest.mark.parametrize("impl", ["fused", "flash"])
def test_small_train_step_gradients_through_fused_and_flash(cuda_device, impl):
    """ViT-B-32-mini bf16 on the card: each attention layer launches K4 and
    K5 once ('fused'), or K10 twice (forward, and again in the backward) and
    K10b once ('flash'), and none of the packed kernels; every in_proj_weight
    gets a gradient, equal to the plain-attention step's within bf16
    rounding through two layers (cosine >= 0.999 per tensor of 10^3 or more
    elements)."""
    args = type("Args", (), dict(multipositiveloss=True, delta=0.5, pallas_loss=False))()
    apply = make_loss_apply(create_loss(args))
    rng = np.random.RandomState(0)
    batch = {
        "images": normalize_images(torch.from_numpy(
            rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)).to(cuda_device)),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (8, 32))).to(cuda_device),
        "labels": torch.from_numpy(rng.randint(0, 3, 8).astype(np.int32)).to(cuda_device),
    }
    grads = {}
    for name in (impl, "xla"):
        model = create_model("ViT-B-32-mini", precision="bf16", attn_impl=name, rng_seed=0)
        state = create_train_state(model, create_optimizer(lr=1e-4))
        fa.reset_launches()
        fl.reset_launches()
        grads[name], ldict = loss_and_grads(model, apply, state.params, batch)
        torch.cuda.synchronize()
        assert np.isfinite(ldict["loss"].item())
        if name == impl:  # 2 vision + 2 text layers
            want = ((4, 4, 0, 0) if impl == "fused" else (0, 0, 8, 4))
            assert (fa.grouped_launches, fa.grouped_bwd_launches, fl.launches,
                    fl.bwd_launches) == want
            assert (fa.launches, fa.bwd_launches, fa.rope_launches, fa.rope_bwd_launches) == (
                0, 0, 0, 0)
    for name, g in grads[impl].items():
        if "in_proj_weight" in name:
            assert g.abs().max().item() > 0, name
        if g.numel() >= 1000:
            cos = torch.nn.functional.cosine_similarity(
                g.flatten().double(), grads["xla"][name].flatten().double(), dim=0)
            assert cos.item() >= 0.999, name
