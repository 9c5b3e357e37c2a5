"""Card-only tests of the PyTorch port: each Hopper kernel (K1 and K3, the
packed attention forward and backward; K2 and K3r, the same with the rope
rotated inside; K4 and K5, the grouped-layout attention; K10 and K10b, the
flash attention; K6 and K7, the fused SupCon loss; K8 and K9, the depthwise
convolution) against its plain version, their refusals, a small CLIP,
MobileCLIP-S1 and a narrow SigLIP at head dim 72 through them, and small
train steps (ViT, EVA02, MobileCLIP) whose gradients come from the kernels.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs where only the port is
installed; on the card, from the repo root:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest.py sets up JAX.)
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mrclip_tpu_torch.factory import create_loss, create_model, get_model_config
from mrclip_tpu_torch.models import fastvit
from mrclip_tpu_torch.ops import dw_conv as dc
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
# the edges of the bf16 forward's tiles (16-key groups, 64-key sub-tiles,
# 16-row warps of a 64-row block), causal and not; and of the wgmma forward
# (D = 64, one key block of at most 256 keys): its 64-row sub-tile (N = 64,
# 127, 128, 129, 193), its n64 key tiles and n16 tail (48, 49, 208, 209)
# and the top of its route (256; 257 takes mma_fwd_kernel, PACKED_LONG)
TILE_EDGES = [(2, n, n, 2, c) for n in (1, 15, 16, 17, 63, 65, 255) for c in (False, True)]
TILE_EDGES += [(2, n, n, 2, c) for n in (48, 49, 64, 127, 128, 129, 193, 208, 209, 256)
               for c in (False, True)]
# K1 and K4/K5 past 256 keys: chunks of 256 rows, which K1's pass B copies
# again (N = 257 non-causal is in SHAPES)
PACKED_LONG = [(2, 257, 257, 2, True), (2, 577, 577, 2, False), (2, 577, 577, 2, True)]


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


# The wide wgmma backward (attn_mma_bwd.cuh's wgmma_wide_bwd_dq_kernel and
# wgmma_wide_bwd_dkv_kernel): K3, K5 and K10b in bf16 at D = 64 past 256
# rows and at 72-112, at the edges of its 16-row groups (15, 17, 63, 65,
# 255, 257), its 64-row sub-tiles (63, 64, 65, 256, 257) and its route (256
# rows: D = 64 stays on wgmma_bwd_*; 272: 17 groups, the most), each N
# beside Nk = N and Nk != N (the edges reversed), and group counts the
# last step rounds up to four (N = 40, 80, 100, 230: 3, 5, 7 and 15
# groups), causal (mma.sync past D = 64 and 256 rows) and not; where N and
# Nk are both at most 64 (one sub-tile a side) the route is mma.sync, so 40
# rows stand beside 80. The route test by
# the profiler's names sits with the other route tests (a profiler window
# opened first in the process made every later one lose its records), the
# cases against the plain versions last in the file.
WIDE_BWD_EDGES = (1, 15, 17, 63, 64, 65, 255, 256, 257, 272)
WIDE_BWD_CASES = [(d, n, nk) for d in (64, 72, 80, 88, 104, 112) for n, other in
                  zip(WIDE_BWD_EDGES, reversed(WIDE_BWD_EDGES)) for nk in (n, other)
                  if d != 64 or max(n, nk) > 256]
WIDE_BWD_CASES += [(d, n, nk) for d in (72, 80, 88, 104, 112)
                   for n, nk in ((40, 40), (100, 230), (230, 100), (40, 80), (80, 40))]
BWD_ROUTE_NAMES = {"wgmma": "wgmma_bwd_", "wgmma_wide": "wgmma_wide_bwd_",
                   "wgmma_long": "wgmma_long_bwd_", "mma_sync": "mma_bwd_"}


def _fwd_route_of(d, nk, nblk=1, causal=False, rope=False):
    """The forward route that attn_mma_fwd.cuh's fwd_route names, by its
    rule: wgmma at D = 64 with one key block of at most 256 keys; mma.sync
    with the rope or at D = 32; the wide kernel up to 272 keys; past them
    mma.sync when causal, else the long kernel."""
    if d == 64 and nblk == 1 and nk <= 256:
        return "wgmma"
    if rope or d == 32:
        return "mma_sync"
    if nk <= 272:
        return "wgmma_wide"
    return "mma_sync" if causal else "wgmma_long"


def _bwd_route_of(d, n, nk, causal, rope=False):
    """The backward route that attn_mma_bwd.cuh's bwd_route names, by its
    rule: wgmma at D = 64 up to 256 rows; past it mma.sync with the rope,
    causal or at D = 32; the long kernels past 272 rows on either side;
    mma.sync with n and nk each within one 64-row sub-tile; else the wide
    kernels."""
    if d == 64 and max(n, nk) <= 256:
        return "wgmma"
    if rope or causal or d == 32:
        return "mma_sync"
    if max(n, nk) > 272:
        return "wgmma_long"
    if max(n, nk) <= 64:
        return "mma_sync"
    return "wgmma_wide"


def _wide_bwd_call(kernel, q, k, v, do, causal):
    """(call, plain call, library, launch counter) of K3, K5 or K10b on [B,
    L, H, D] q, k, v and do (K5 on their grouped copies), from their
    forward's outputs."""
    if kernel == "K3":
        o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal)
        return (lambda: fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal),
                lambda: fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=causal),
                "packed_attn_bwd", ("bwd_launches", fa))
    if kernel == "K5":
        qg, kg, vg, dog = (fa.group_heads(t) for t in (q, k, v, do))
        og, lse = fa.fused_attention_grouped(qg, kg, vg, is_causal=causal)
        return (lambda: fa.fused_attention_grouped_bwd(qg, kg, vg, og, dog, lse, is_causal=causal),
                lambda: fa.fused_attention_bwd_ref(qg, kg, vg, og, dog, lse, is_causal=causal),
                "grouped_attn_bwd", ("grouped_bwd_launches", fa))
    o, l, m = fl.flash_attention(q, k, v, is_causal=causal)
    di = fl.flash_di(o, do)
    return (lambda: fl.flash_attention_bwd(q, k, v, do, l, m, di, is_causal=causal),
            lambda: fl.flash_attention_bwd_ref(q, k, v, do, l, m, di, is_causal=causal),
            "flash_attn_bwd", ("bwd_launches", fl))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,nk,h,causal", SHAPES + TILE_EDGES + PACKED_LONG)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_refuses_bf16_views_off_16_bytes(cuda_device, dtype):
    """The bf16 forward copies each row's head slice in 16-byte pieces: a
    packed view whose base pointer or row stride is off 16 bytes raises and
    reaches no plain version; the same views in fp32 run the FMA kernel."""
    h, d = 2, 64
    x = torch.randn(2, 16, 3 * h * d + 8, device=cuda_device).to(dtype)
    shifted = [x[..., 1 + i * h * d:1 + (i + 1) * h * d] for i in range(3)]  # one element in
    y = torch.randn(2, 16, 3 * h * d + 1, device=cuda_device).to(dtype)
    odd_rows = list(y[..., :3 * h * d].split(h * d, dim=-1))  # row stride 3 * H * D + 1
    for q, k, v in (shifted, odd_rows):
        before = fa.launches
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="multiples of 16 bytes"):
                fa.fused_attention_packed(q, k, v, heads=h)
            assert fa.launches == before
            continue
        o, lse = fa.fused_attention_packed(q, k, v, heads=h)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        want_o, want_lse = fa.fused_attention_packed_ref(q, k, v, heads=h)
        assert (o - want_o).abs().max().item() <= 1e-4
        assert (lse - want_lse).abs().max().item() <= 1e-3


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
@pytest.mark.parametrize("b,n,nk,h,causal", SHAPES + TILE_EDGES + PACKED_LONG)
@pytest.mark.parametrize("d", [32, 64])
def test_backward_kernel_matches_plain_version(cuda_device, b, n, nk, h, causal, d, dtype, tol):
    """K3 (bf16 on the tensor cores, at their tile edges and past 256 rows,
    where they walk chunks): max |err| / max |plain| per output. bf16: the
    two round P and dS the same way, but a sum taken in another order can
    flip one bf16 rounding of a gradient (~1e-2 relative); fp32: summation
    order only."""
    q, k, v = _inputs(b, n, nk, h, d, cuda_device, dtype)
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal)
    do = torch.randn(o.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1)).to(dtype)
    before = fa.bwd_launches
    got = fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    want = fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=causal)
    # N = 1: one key, so P = 1 and dS = 0; dq and dk are rounding noise with
    # no scale of their own and take the call's largest |plain| gradient
    scale = max(w.float().abs().max().item() for w in want)
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.shape == like.shape and g.dtype == dtype
        own = w.float().abs().max().item()
        rel = (g.float() - w.float()).abs().max().item() / (own if n > 1 else scale)
        assert rel <= tol


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernel_refuses_bf16_views_off_16_bytes(cuda_device, dtype):
    """The bf16 K3 copies rows in 16-byte pieces and reads and writes 32-bit
    fragments: an input or gradient view whose base pointer or row stride is
    off 16 bytes raises and reaches no plain version; the same views in fp32
    run the FMA kernels."""
    h, d = 2, 64
    x = torch.randn(2, 16, 3 * h * d + 8, device=cuda_device).to(dtype)
    shifted = [x[..., 1 + i * h * d:1 + (i + 1) * h * d] for i in range(3)]  # one element in
    y = torch.randn(2, 16, 3 * h * d + 1, device=cuda_device).to(dtype)
    odd_rows = list(y[..., :3 * h * d].split(h * d, dim=-1))  # row stride 3 * H * D + 1
    q, k, v = (t.contiguous() for t in shifted)
    o, lse = fa.fused_attention_packed(q, k, v, heads=h)
    do = torch.randn_like(o)
    for inputs, out in (((*shifted, o, do), None), ((*odd_rows, o, do), None),
                        ((q, k, v, o, do), torch.zeros_like(y)[..., :3 * h * d].chunk(3, dim=-1))):
        before = fa.bwd_launches
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="multiples of 16 bytes"):
                fa.fused_attention_packed_bwd(*inputs, lse, heads=h, out=out)
            assert fa.bwd_launches == before
            continue
        got = fa.fused_attention_packed_bwd(*inputs, lse, heads=h, out=out)
        torch.cuda.synchronize()
        assert fa.bwd_launches == before + 1
        want = fa.fused_attention_packed_bwd_ref(*inputs, lse, heads=h)
        scale = max(w.abs().max().item() for w in want)
        assert max((g - w).abs().max().item() for g, w in zip(got, want)) <= 1e-4 * scale


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


# the tiles' and splits' edges (32-row tiles, 64 x 128 gradient tiles at B =
# 1000 and past), D = 30 (element-by-element copies) and 1024 (two 512-wide
# slices of the gradients, own rows streamed)
SUPCON_EDGES = [(n, 512, 32) for n in (31, 33, 127, 129, 257, 1000)]
SUPCON_EDGES += [(100, 30, 32), (1000, 30, 32), (256, 1024, 32)]


@pytest.mark.parametrize("n,d,n_labels", [(32, 128, 5), (12, 16, 3), (20, 32, None),
                                          (100, 512, 32), (333, 512, 32), (256, 512, None),
                                          *SUPCON_EDGES])
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


def test_supcon_kernels_are_deterministic(cuda_device):
    """At B = 256 each kernel splits its walk and merges the partials in
    split order, without atomics: two runs give the same bits."""
    q, k, labels = _supcon_inputs(256, 512, 32, cuda_device, seed=3)
    scale = torch.tensor([14.0], device=cuda_device)
    gbar = torch.tensor([0.7 / 256], device=cuda_device)
    assert all(pl._plan_for(kind, q, k).splits > 1 for kind in pl.TILES)
    m, s, _, cnt = pl.supcon_stats_ref(q, k, labels, labels, scale)
    cnt = cnt.clamp(min=1.0)

    def run():
        return (*pl.supcon_stats(q, k, labels, labels, scale),
                *pl.supcon_grad_q(q, k, labels, labels, scale, m, s, cnt, gbar),
                pl.supcon_grad_k(q, k, labels, labels, scale, m, s, cnt, gbar))

    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
# the bf16 forward's tile edges and chunks past 256 keys, prefix 0 and 1;
# and at D = 64 the wgmma backward's (as TILE_EDGES), causal and not
ROPE_TILE_EDGES = [(2, n, 2, d, p, False) for n in (1, 15, 16, 17, 63, 65, 255, 257, 577)
                   for d in (32, 64) for p in (0, 1)]
ROPE_TILE_EDGES += [(2, n, 2, 64, 1, c) for n in (48, 49, 64, 127, 128, 129, 193, 208, 209, 256)
                    for c in (False, True)]


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
@pytest.mark.parametrize("b,n,h,d,prefix,causal", ROPE_SHAPES + ROPE_TILE_EDGES)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,d,prefix,causal", [
    (2, 197, 12, 64, 1, False),  # EVA02-B/16 layer (wgmma): K rotated once in shared memory
    (2, 256, 2, 64, 1, True),    # the top of the wgmma route, causal
    (1, 257, 2, 64, 1, False),   # mma.sync: two chunks, K rotated again in pass B
    (1, 577, 2, 64, 1, True),    # three chunks, causal
    (2, 50, 2, 32, 1, False),    # head dim 32
])
def test_rope_forward_rotates_q_and_k_bit_identically(cuda_device, b, n, h, d, prefix, causal,
                                                      dtype):
    """K2 equals, bit for bit, the same attention on q and k rotated
    beforehand by the plain version's arithmetic (`_rope_rotate`: fp32, each
    product and sum rounded once, one rounding to q's type): K2 with the
    identity table (sin 0, cos 1, which rotates exactly), and K1 where it
    runs K2's kernel without the rotation (the same route, `fwd_route`:
    bf16 wgmma_fwd_kernel at one key block of at most 256 keys and D = 64,
    K and each Q sub-tile rotated in shared memory; mma_fwd_kernel past 272
    keys and at D = 32; fp32 on the FMA kernel; from 257 to 272 keys bf16
    K1 runs the wide wgmma kernel, which rounds P in another order). So the
    kernel's rotation is the plain version's, and the CLS row, whose table
    row is the identity, stays exactly the unrotated q and k."""
    q, k, v, _, tab = _rope_inputs(b, n, h, d, prefix, cuda_device, dtype)
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h, rope=tab)
    sin, cos = (t[:, None] for t in tab.float().chunk(2, dim=-1))  # [N, 1, D]

    def rotated(x):
        x4 = x.unflatten(-1, (h, d)).float()
        return fa._rope_rotate(x4, sin, cos, dtype).to(dtype).flatten(-2)

    qr, kr = rotated(q), rotated(k)
    assert torch.equal(qr[:, :prefix], q[:, :prefix]) and torch.equal(kr[:, :prefix], k[:, :prefix])
    identity = torch.cat([torch.zeros_like(tab[:, :d]), torch.ones_like(tab[:, d:])], dim=-1)
    bf16 = dtype == torch.bfloat16
    same_kernel = (fa.fwd_route("packed_attn_fwd", bf16, d, False, n)
                   == fa.fwd_route("packed_attn_fwd", bf16, d, True, n))
    for kw in (dict(rope=identity), *([{}] if same_kernel else [])):  # K2 (identity), K1
        o1, lse1 = fa.fused_attention_packed(qr, kr, v, is_causal=causal, heads=h, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, o1) and torch.equal(lse, lse1)


@pytest.mark.parametrize("b,n,h,d,prefix,causal", [
    (2, 197, 12, 64, 1, False),  # EVA02-B/16 layer: the wgmma kernels
    (1, 577, 2, 64, 1, True),    # three chunks, causal: mma.sync
    (2, 50, 2, 32, 1, False),    # head dim 32
    (2, 17, 2, 64, 0, True),     # a ragged 16-row fragment
    (2, 128, 2, 64, 1, False),   # wgmma: a whole 64-row step, then a last one of 4 groups
    (2, 256, 2, 64, 0, True),    # the top of the wgmma route, causal
    (2, 209, 2, 64, 1, False),   # three whole steps and one group
    (1, 257, 2, 64, 1, False),   # the first shape past it: mma.sync
])
def test_rope_backward_rotates_bit_identically(cuda_device, b, n, h, d, prefix, causal):
    """bf16 K3r rotates q and k as the plain version does, bit for bit, in
    both passes (the staged operand in shared memory, the other in
    registers) and un-rotates dq and dk at the right pairs. Two exact forms
    against K3 on q and k rotated beforehand (`_rope_rotate`) with the same
    o and lse: (1) with the model's table, dV, which the dk/dv pass takes
    from P of the rotated K (registers) and Q (shared memory), is equal bit
    for bit; (2) with a table of sin = +-1 (random per element) and cos =
    0, where every rotation and un-rotation is exact (a signed swap), dV is
    equal and so are dq and dk to K3's dq and dk un-rotated by the plain
    version (`_rope_unrotate_grad`: its rounding of g * sin is exact on
    bf16 gradients)."""
    q, k, v, do, tab = _rope_inputs(b, n, h, d, prefix, cuda_device, torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    sign = torch.randint(0, 2, (n, d), device=cuda_device, generator=gen).float() * 2 - 1
    signs = torch.cat([sign, torch.zeros_like(sign)], dim=-1).to(torch.bfloat16)

    def rope(x, t, fn):
        sin, cos = (s[:, None] for s in t.float().chunk(2, dim=-1))  # [N, 1, D]
        return fn(x.unflatten(-1, (h, d)).float(), sin, cos, torch.bfloat16).to(
            torch.bfloat16).flatten(-2)

    for t in (tab, signs):
        o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h, rope=t)
        got = fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal, heads=h, rope=t)
        qr, kr = (rope(x, t, fa._rope_rotate) for x in (q, k))
        dq1, dk1, dv1 = fa.fused_attention_packed_bwd(qr, kr, v, o, do, lse, is_causal=causal,
                                                      heads=h)
        torch.cuda.synchronize()
        assert torch.equal(got[2], dv1)
        if t is signs:
            assert torch.equal(got[0], rope(dq1, t, fa._rope_unrotate_grad))
            assert torch.equal(got[1], rope(dk1, t, fa._rope_unrotate_grad))


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
@pytest.mark.parametrize("b,n,nk,h,causal", SHAPES + TILE_EDGES + PACKED_LONG)
@pytest.mark.parametrize("d", [32, 64])
def test_grouped_kernels_match_plain_versions(cuda_device, b, n, nk, h, causal, d, dtype, tol):
    """K4 and K5 on the grouped [B*H, N, D] layout (the bf16 backward's tile
    edges; past 256 rows, where it walks chunks of 256): o within K1's bar,
    lse within 1e-3, each gradient within tol of the call's largest |plain|
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


# N = 577 and 257 walk 128-key blocks (five and three), N = 400 two of 256
FLASH_SHAPES = SHAPES + [(2, 577, 577, 2, False), (1, 257, 257, 3, True), (1, 400, 400, 2, False),
                         (1, 400, 400, 2, True)] + TILE_EDGES


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,nk,h,causal", FLASH_SHAPES)
@pytest.mark.parametrize("d", [32, 64])
def test_flash_kernels_match_plain_versions(cuda_device, b, n, nk, h, causal, d, dtype, tol):
    """K10 and K10b on q, k, v as column slices of one packed projection
    (N = 257, 400 and 577 walk several key blocks): o within K1's bar, l
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


@pytest.mark.parametrize("impl", ["fused", "flash", "fusedp", "fusedp_rope"])
def test_bf16_attention_backward_is_deterministic(cuda_device, impl):
    """K5, K10b, K3 and K3r write each gradient element once, from one
    thread, with no atomics: two bf16 runs on the same inputs give the same
    bits (N = 197, 128 and 256 on the wgmma kernels; 257, and 577 where the
    passes walk chunks of 256 rows)."""
    for b, n, h in ((2, 197, 12), (2, 128, 2), (2, 256, 2), (1, 257, 2), (1, 577, 2)):
        q, k, v = _inputs(b, n, n, h, 64, cuda_device, torch.bfloat16)
        do = torch.randn(q.shape, device=cuda_device, generator=torch.Generator(
            device=cuda_device).manual_seed(2)).to(torch.bfloat16)
        if impl.startswith("fusedp"):
            tab = None
            if impl == "fusedp_rope":
                tab = _rope_inputs(b, n, h, 64, 1, cuda_device, torch.bfloat16)[-1]
            o, lse = fa.fused_attention_packed(q, k, v, rope=tab)
            runs = [fa.fused_attention_packed_bwd(q, k, v, o, do, lse, rope=tab) for _ in range(2)]
        elif impl == "fused":
            q, k, v, do = (t.transpose(1, 2).reshape(b * h, n, 64).contiguous()
                           for t in (q, k, v, do))
            o, lse = fa.fused_attention_grouped(q, k, v)
            runs = [fa.fused_attention_grouped_bwd(q, k, v, o, do, lse) for _ in range(2)]
        else:
            o, l, m = fl.flash_attention(q, k, v)
            di = fl.flash_di(o, do)
            runs = [fl.flash_attention_bwd(q, k, v, do, l, m, di) for _ in range(2)]
        assert all(torch.equal(x, y) for x, y in zip(*runs))


def _device_kernels(fn):
    """Names of the device kernels one call of fn launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("impl", ["fusedp", "fusedp_rope", "fused", "flash"])
@pytest.mark.parametrize("n,nk,wgmma", [(256, 256, True), (76, 255, True), (257, 257, False),
                                        (76, 300, False)])
def test_bf16_backward_route_by_shape(cuda_device, impl, n, nk, wgmma):
    """bf16 K3, K3r, K5 and K10b at D = 64 run the wgmma backward
    (wgmma_bwd_dq_kernel, wgmma_bwd_dkv_kernel) where n and nk are at most
    256; past that the wide wgmma kernels up to 272 rows (N = 257; K3r, the
    rope, on mma.sync) and the long wgmma kernels past 272 (Nk = 300), by
    the profiler's kernel names."""
    if impl == "fusedp_rope" and n != nk:
        pytest.skip("K3r is self-attention")
    q, k, v = _inputs(1, n, nk, 2, 64, cuda_device, torch.bfloat16)
    if impl == "flash":
        o, l, m = fl.flash_attention(q, k, v)
        di = fl.flash_di(o, o)
        names = _device_kernels(lambda: fl.flash_attention_bwd(q, k, v, o, l, m, di))
    elif impl == "fused":
        q, k, v = (t.transpose(1, 2).reshape(2, -1, 64).contiguous() for t in (q, k, v))
        o, lse = fa.fused_attention_grouped(q, k, v)
        names = _device_kernels(lambda: fa.fused_attention_grouped_bwd(q, k, v, o, o, lse))
    elif impl == "fusedp":
        o, lse = fa.fused_attention_packed(q, k, v)
        names = _device_kernels(lambda: fa.fused_attention_packed_bwd(q, k, v, o, o, lse))
    else:
        q, k, v, _, tab = _rope_inputs(1, n, 2, 64, 1, cuda_device, torch.bfloat16)
        o, lse = fa.fused_attention_packed(q, k, v, heads=2, rope=tab)
        names = _device_kernels(
            lambda: fa.fused_attention_packed_bwd(q, k, v, o, o, lse, heads=2, rope=tab))
    route = _bwd_route_of(64, n, nk, False, rope=impl == "fusedp_rope")
    assert (route == "wgmma") == wgmma
    assert len(names) == 2
    for name in names:
        assert ("wgmma_bwd_" in name) == wgmma and BWD_ROUTE_NAMES[route] in name
        assert route != "mma_sync" or "wgmma" not in name


@pytest.mark.parametrize("n,wgmma", [(197, True), (256, True), (257, False)])
def test_bf16_rope_forward_route_by_shape(cuda_device, n, wgmma):
    """bf16 K2 at D = 64 runs wgmma_fwd_kernel's ROPE form with one key
    block of at most 256 keys, and mma_fwd_kernel's past that (N = 257), by
    the profiler's kernel names."""
    q, k, v, _, tab = _rope_inputs(1, n, 2, 64, 1, cuda_device, torch.bfloat16)
    names = _device_kernels(lambda: fa.fused_attention_packed(q, k, v, heads=2, rope=tab))
    assert len(names) == 1
    name = names.pop()
    if wgmma:
        assert "wgmma_fwd_kernel<false, true, " in name
    else:
        assert "mma_fwd_kernel<64, false, false, true>" in name and "wgmma" not in name


# The wide wgmma forward (attn_mma_fwd.cuh's wgmma_wide_fwd_kernel): K1, K4
# and K10 in bf16 at every width it takes (D = 64 past 256 keys; 72, 80, 88,
# 104, 112 up to 272) at the edges of its 16-key groups (15, 17, 63, 65,
# 255, 257), its 64-row sub-tiles (63, 64, 65, 256, 257) and its route (256
# keys: D = 64 stays on wgmma_fwd_kernel; 272: 17 groups, the most), causal
# and not; K10 past 256 keys walks jax's three key blocks of 128
WIDE_FWD_DIMS = (64, 72, 80, 88, 104, 112)
WIDE_FWD_EDGES = (1, 15, 17, 63, 64, 65, 255, 256, 257, 272)


def _kernels_seen(fn):
    """`_device_kernels(fn)`, a window that recorded no device kernel tried
    again (up to three): CUPTI can lose a short window's records."""
    for _ in range(3):
        names = _device_kernels(fn)
        if names:
            break
    return names


def _wide_fwd_call(kernel, q, k, v, causal):
    """(call, plain call, library, launch counter, nblk) of K1, K4 or K10
    on [B, L, H, D] q, k and v (K4 on their grouped copies)."""
    if kernel == "K1":
        return (lambda: fa.fused_attention_packed(q, k, v, is_causal=causal),
                lambda: fa.fused_attention_packed_ref(q, k, v, is_causal=causal),
                "packed_attn_fwd", ("launches", fa), 1)
    if kernel == "K4":
        qg, kg, vg = (fa.group_heads(t) for t in (q, k, v))
        return (lambda: fa.fused_attention_grouped(qg, kg, vg, is_causal=causal),
                lambda: fa.fused_attention_ref(qg, kg, vg, is_causal=causal),
                "grouped_attn", ("grouped_launches", fa), 1)
    return (lambda: fl.flash_attention(q, k, v, is_causal=causal),
            lambda: fl.flash_attention_ref(q, k, v, is_causal=causal),
            "flash_attn", ("launches", fl), fl._blocks(q.shape[1], k.shape[1])[2])


@pytest.mark.parametrize("d,n,causal,route", [
    (64, 273, False, "wgmma_long"), (80, 273, False, "wgmma_long"),
    (112, 577, False, "wgmma_long"), (72, 729, False, "wgmma_long"),
    (64, 577, True, "mma_sync"), (104, 577, True, "mma_sync"), (32, 200, False, "mma_sync"),
    (104, 257, False, "wgmma_wide"), (72, 64, False, "wgmma_wide"),
    (64, 257, False, "wgmma_wide"), (64, 200, False, "wgmma")])
def test_forward_route_by_shape(cuda_device, d, n, causal, route):
    """Past the wide route's 272 keys the non-causal bf16 forward takes
    wgmma_long_fwd_kernel, the causal one mma_fwd_kernel (as D = 32 does);
    each kernel's library names the same route, and the profiler sees that
    route's kernel (K10 in its several-block form past 256 keys); fp32
    takes the FMA kernels."""
    q, k, v = _inputs(1, n, n, 2, d, cuda_device, torch.bfloat16)
    for kernel in ("K1", "K4", "K10"):
        call, _, library, _, nblk = _wide_fwd_call(kernel, q, k, v, causal)
        assert _fwd_route_of(d, n, nblk, causal) == route
        assert fa.fwd_route(library, True, d, False, n, nblk, causal) == route
        assert fa.fwd_route(library, False, d, False, n, nblk, causal) == "fma"
        names = _kernels_seen(call)
        assert len(names) == 1
        name = names.pop()
        flash = "true" if kernel == "K10" else "false"
        multi = "true" if nblk > 1 else "false"
        assert {"mma_sync": f"mma_fwd_kernel<{d}, {flash}, {multi}, false>",
                "wgmma": f"wgmma_fwd_kernel<{flash}, false, ",
                "wgmma_wide": f"wgmma_wide_fwd_kernel<{d}, {flash}, {multi}, ",
                "wgmma_long": f"wgmma_long_fwd_kernel<{d}, {flash}, "}[route] in name
        if route == "mma_sync":
            assert "wgmma" not in name


@pytest.mark.parametrize("d,n,nk,causal", [(64, 273, 273, False), (80, 273, 100, False),
                                           (112, 257, 257, True), (32, 200, 200, False),
                                           (104, 257, 257, False), (72, 64, 64, False),
                                           (64, 257, 257, False), (64, 257, 257, True),
                                           (64, 100, 272, False), (64, 200, 200, True)])
def test_wide_backward_route_by_shape(cuda_device, d, n, nk, causal):
    """Each backward's library names the route of the shape (`bwd_route`),
    and the profiler sees that route's two kernels: past 272 rows the long
    wgmma kernels, causal past the D = 64 wgmma route and at D = 32 the
    mma.sync kernels; fp32 takes the FMA kernels."""
    route = _bwd_route_of(d, n, nk, causal)
    q, k, v = _inputs(1, n, nk, 2, d, cuda_device, torch.bfloat16)
    for kernel in ("K3", "K5", "K10b"):
        call, _, library, _ = _wide_bwd_call(kernel, q, k, v, q, causal)
        assert fa.bwd_route(library, True, d, False, n, nk, causal) == route
        assert fa.bwd_route(library, False, d, False, n, nk, causal) == "fma"
        names = _kernels_seen(call)
        assert len(names) == 2
        for name in names:
            assert BWD_ROUTE_NAMES[route] in name
            assert route != "mma_sync" or "wgmma" not in name
            assert route != "wgmma" or "wgmma_wide" not in name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", WIDE_FWD_EDGES)
@pytest.mark.parametrize("d", WIDE_FWD_DIMS)
@pytest.mark.parametrize("kernel", ["K1", "K4", "K10"])
def test_wide_wgmma_forward_matches_plain_version(cuda_device, kernel, d, n, causal):
    """bf16 K1, K4 and K10 on the route the library names (`fwd_route`:
    wgmma_wide past D = 64 or 256 keys, else wgmma): o within 2e-2 of the
    plain version, lse (K1, K4) and m (K10) within 1e-3, l within 1e-3
    relative; two runs bit-equal; one launch counted on that route (the
    profiler's kernel names: test_forward_route_by_shape)."""
    q, k, v = _inputs(2, n, n, 2, d, cuda_device, torch.bfloat16)
    call, plain, library, (counter, module), nblk = _wide_fwd_call(kernel, q, k, v, causal)
    route = "wgmma" if d == 64 and n <= 256 else "wgmma_wide"
    assert fa.fwd_route(library, True, d, False, n, nblk) == route
    module.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert module.route_launches == {(counter, d, route): 1}
    want = plain()
    o, stats = got[0], got[1:]
    assert o.shape == want[0].shape and o.dtype == torch.bfloat16
    assert (o.float() - want[0].float()).abs().max().item() <= 2e-2
    if kernel == "K10":
        (l, m), (want_l, want_m) = stats, want[1:]
        assert ((l - want_l).abs() / want_l).max().item() <= 1e-3
        assert (m - want_m).abs().max().item() <= 1e-3
    else:
        assert (stats[0] - want[1]).abs().max().item() <= 1e-3
    again = call()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The long wgmma forward (attn_mma_fwd.cuh's wgmma_long_fwd_kernel): K1, K4
# and K10 in bf16, not causal, past 272 keys at every width it takes, at the
# edges of its 64-key ring tiles and 128-row blocks (273, 320, 511) and the
# long towers' lengths (577, 729, 730, 1024), each N beside another Nk (the
# lengths reversed) and a short query side (N 100) over the longest keys;
# K10 walks jax's key blocks (128 up to 384 padded keys, then 256)
LONG_FWD_N = (273, 320, 511, 577, 729, 730, 1024)
LONG_FWD_PAIRS = [(n, nk) for n, other in zip(LONG_FWD_N, reversed(LONG_FWD_N))
                  for nk in (n, other)] + [(100, 1024), (1, 577)]


@pytest.mark.parametrize("n,nk", LONG_FWD_PAIRS)
@pytest.mark.parametrize("d", WIDE_FWD_DIMS)
@pytest.mark.parametrize("kernel", ["K1", "K4", "K10"])
def test_long_wgmma_forward_matches_plain_version(cuda_device, kernel, d, n, nk):
    """bf16 K1, K4 and K10 past 272 keys on wgmma_long (`fwd_route`): o
    within 2e-2 of the plain version, lse (K1, K4) and m (K10) within 1e-3,
    l within 1e-3 relative; two runs bit-equal; one launch counted on that
    route."""
    q, k, v = _inputs(2, n, nk, 2, d, cuda_device, torch.bfloat16)
    call, plain, library, (counter, module), nblk = _wide_fwd_call(kernel, q, k, v, False)
    assert _fwd_route_of(d, nk, nblk) == "wgmma_long"
    assert fa.fwd_route(library, True, d, False, nk, nblk) == "wgmma_long"
    module.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert module.route_launches == {(counter, d, "wgmma_long"): 1}
    want = plain()
    o, stats = got[0], got[1:]
    assert o.shape == want[0].shape and o.dtype == torch.bfloat16
    assert (o.float() - want[0].float()).abs().max().item() <= 2e-2
    if kernel == "K10":
        (l, m), (want_l, want_m) = stats, want[1:]
        assert ((l - want_l).abs() / want_l).max().item() <= 1e-3
        assert (m - want_m).abs().max().item() <= 1e-3
    else:
        assert (stats[0] - want[1]).abs().max().item() <= 1e-3
    again = call()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n,nk", [(729, 729), (1024, 577), (577, 1024)])
@pytest.mark.parametrize("d", [64, 72, 104])
@pytest.mark.parametrize("kernel", ["K1", "K4", "K10"])
def test_long_wgmma_forward_walks_row_blocks(cuda_device, kernel, d, n, nk):
    """At 8 samples of 16 heads a block of wgmma_long_fwd_kernel walks two
    or more row blocks of its head in turn, K kept in shared memory: o,
    lse, l and m against the plain version with the bars above, two runs
    bit-equal."""
    q, k, v = _inputs(8, n, nk, 16, d, cuda_device, torch.bfloat16)
    call, plain, library, _, nblk = _wide_fwd_call(kernel, q, k, v, False)
    assert fa.fwd_route(library, True, d, False, nk, nblk) == "wgmma_long"
    got = call()
    torch.cuda.synchronize()
    want = plain()
    assert (got[0].float() - want[0].float()).abs().max().item() <= 2e-2
    if kernel == "K10":
        assert ((got[1] - want[1]).abs() / want[1]).max().item() <= 1e-3
        assert (got[2] - want[2]).abs().max().item() <= 1e-3
    else:
        assert (got[1] - want[1]).abs().max().item() <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(got, call()))


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


# ViT-SO400M-SigLIP's, ViT-H-14's, ViT-g-14's, ViT-bigG-14's and
# EVA02-E-14's head dims (72, 88 and 104 padded to 80, 96 and 112 columns
# inside the kernels; 112 unpadded) at
# the tensor-core tiles' edges,
# past 256 rows (the chunked walk; K10's three key blocks), at their vision
# towers' 16 heads and at N = 400 (K10's two key blocks of 256, each staged
# in two chunks past D = 80)
WIDE_DIMS = (72, 80, 88, 104, 112)
WIDE_SHAPES = [(2, n, n, 2, c) for n in (1, 15, 17, 65, 257) for c in (False, True)]
WIDE_SHAPES += [(2, 257, 257, 16, False), (1, 400, 400, 2, False), (1, 400, 400, 2, True)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,nk,h,causal", WIDE_SHAPES)
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("kernels", ["K1", "K3", "K4/K5", "K10/K10b"])
def test_kernels_match_plain_versions_at_wide_head_dims(cuda_device, kernels, d, b, n, nk, h,
                                                        causal, dtype, tol):
    """The tests above, with their bars, at head dims 72, 80, 88, 104 and 112."""
    test = {"K1": test_kernel_matches_plain_version,
            "K3": test_backward_kernel_matches_plain_version,
            "K4/K5": test_grouped_kernels_match_plain_versions,
            "K10/K10b": test_flash_kernels_match_plain_versions}[kernels]
    test(cuda_device, b, n, nk, h, causal, d, dtype, tol)


# SO400M-SigLIP's own shapes at D = 72: its vision tower at 224 px (N =
# 256, no CLS) and at 378/384 px (N = 729: three 256-key chunks, not a
# multiple of 64), and its non-causal text (N = 64), at 16 heads
SIGLIP_SHAPES = [(4, 256, 256, 16, False), (2, 729, 729, 16, False), (8, 64, 64, 16, False)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,nk,h,causal", SIGLIP_SHAPES)
@pytest.mark.parametrize("kernels", ["K1", "K3", "K4/K5", "K10/K10b"])
def test_kernels_match_plain_versions_at_siglip_shapes(cuda_device, kernels, b, n, nk, h,
                                                       causal, dtype, tol):
    """The tests above, with their bars, at SO400M-SigLIP's shapes."""
    test_kernels_match_plain_versions_at_wide_head_dims(cuda_device, kernels, 72, b, n, nk, h,
                                                        causal, dtype, tol)


@pytest.mark.parametrize("impl", ["fusedp", "fused", "flash"])
def test_narrow_siglip_through_the_kernels_at_72_matches_plain_attention(cuda_device, impl,
                                                                        monkeypatch):
    """A narrow ViT-SO400M-14-SigLIP (vision and text 144 wide, 2 heads of
    72, 2 layers; 224 px: N = 256, no CLS; non-causal text N = 64) in bf16
    on the card: every attention layer launches the kernel at D = 72 in
    each direction, the features and the loss's gradients agree with the
    same weights under plain attention (cosine >= 0.999)."""
    from mrclip_tpu_torch.models import clip

    monkeypatch.setitem(clip._TIMM_VIT_DIMS, "so400m", (144, 2, 2))
    name = "ViT-SO400M-14-SigLIP"
    text = dict(get_model_config(name)["text_cfg"], width=144, heads=2, layers=2)
    kw = dict(precision="bf16", rng_seed=0, text_cfg=text, embed_dim=144)
    kernel = create_model(name, attn_impl=impl, **kw)
    plain = create_model(name, attn_impl="xla", **kw)
    rng = np.random.RandomState(72)
    images = torch.from_numpy(rng.randn(4, 224, 224, 3).astype(np.float32)).to(cuda_device)
    tokens = torch.from_numpy(rng.randint(1, 32000, (4, 64))).to(cuda_device)
    fa.reset_launches()
    fl.reset_launches()
    with torch.inference_mode():
        a = kernel(images, tokens)
        b = plain(images, tokens)
    want = {"fusedp": ("launches", fa), "fused": ("grouped_launches", fa),
            "flash": ("launches", fl)}[impl]
    assert want[1].width_launches == {(want[0], 72): 4}  # 2 vision + 2 text layers
    for key in ("image_features", "text_features"):
        cos = torch.nn.functional.cosine_similarity(a[key].float(), b[key].float(), dim=-1)
        assert cos.min().item() >= 0.999, key
    assert a["logit_bias"].item() == -10.0
    loss = make_loss_apply(create_loss(SimpleNamespace(siglip=True, loss_dist_impl="bidir")))
    batch = {"images": images, "tokens": tokens}
    grads = [loss_and_grads(m, loss, dict(m.named_parameters()), batch)[0] for m in (kernel, plain)]
    for key in ("visual.trunk.blocks.0.attn.qkv.weight", "transformer.resblocks.1.attn.in_proj_weight"):
        g, w = grads[0][key].float().flatten(), grads[1][key].float().flatten()
        assert g.abs().max().item() > 0, key
        assert torch.nn.functional.cosine_similarity(g, w, dim=0).item() >= 0.999, key


@pytest.mark.parametrize("impl", ["fusedp", "fused", "flash"])
def test_narrow_eva02_e_through_the_kernels_at_112_matches_plain_attention(cuda_device, impl,
                                                                           monkeypatch):
    """A narrow EVA02-E-14 (vision 224 wide, 2 heads of 112, 2 post-norm
    layers with the fused qkv; text 224 wide, 2 heads of 112, causal, ctx
    77) in bf16 on the card: every attention layer launches the kernel at D
    = 112 in each direction, the features and the loss's gradients agree
    with the same weights under plain attention (cosine >= 0.999)."""
    from mrclip_tpu_torch.models import clip

    monkeypatch.setitem(clip._EVA_DIMS, "enormous", (224, 2, 2))
    name = "EVA02-E-14"
    text = dict(get_model_config(name)["text_cfg"], width=224, heads=2, layers=2)
    kw = dict(precision="bf16", rng_seed=0, text_cfg=text, embed_dim=64)
    kernel = create_model(name, attn_impl=impl, **kw)
    plain = create_model(name, attn_impl="xla", **kw)
    rng = np.random.RandomState(112)
    images = torch.from_numpy(rng.randn(4, 224, 224, 3).astype(np.float32)).to(cuda_device)
    tokens = torch.from_numpy(rng.randint(1, 49408, (4, 77))).to(cuda_device)
    fa.reset_launches()
    fl.reset_launches()
    with torch.inference_mode():
        a = kernel(images, tokens)
        b = plain(images, tokens)
    want = {"fusedp": ("launches", fa), "fused": ("grouped_launches", fa),
            "flash": ("launches", fl)}[impl]
    assert want[1].width_launches == {(want[0], 112): 4}  # 2 vision + 2 text layers
    for key in ("image_features", "text_features"):
        cos = torch.nn.functional.cosine_similarity(a[key].float(), b[key].float(), dim=-1)
        assert cos.min().item() >= 0.999, key
    loss = make_loss_apply(create_loss(SimpleNamespace(
        multipositiveloss=True, delta=0.5, model=name, gather_with_grad=True, pallas_loss=False)))
    batch = {"images": images, "tokens": tokens,
             "labels": torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=cuda_device)}
    grads = [loss_and_grads(m, loss, dict(m.named_parameters()), batch)[0] for m in (kernel, plain)]
    for key in ("visual.trunk.blocks.0.attn.qkv.weight", "visual.trunk.blocks.1.attn.q_bias",
                "transformer.resblocks.1.attn.in_proj_weight"):
        g, w = grads[0][key].float().flatten(), grads[1][key].float().flatten()
        assert g.abs().max().item() > 0, key
        assert torch.nn.functional.cosine_similarity(g, w, dim=0).item() >= 0.999, key


@pytest.mark.parametrize("d", [96, 120])
def test_kernels_refuse_head_dims_they_do_not_take(cuda_device, d):
    """D = 96 and 120 (no config has either) are not built: each wrapper
    raises before a launch, naming the width; the rope kernels take 32 and
    64 only."""
    q, k, v = _inputs(1, 16, 16, 2, d, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match=f"head dim .*; got {d}$"):
        fa.fused_attention_packed(q, k, v)
    with pytest.raises(ValueError, match=f"head dim .*; got {d}$"):
        fa.fused_attention_grouped(*(t[:, :, 0].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match=f"head dim .*; got {d}$"):
        fl.flash_attention(q, k, v)
    q, k, v = _inputs(1, 16, 16, 2, 80, cuda_device, torch.bfloat16)
    table = torch.zeros(16, 160, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="with rope; got 80"):
        fa.fused_attention_packed(q, k, v, rope=table)


def test_flash_kernel_refuses_views_off_16_bytes(cuda_device):
    """K10 copies each row's head slice in 16-byte pieces: a view whose row
    stride or base pointer is not a multiple of 16 bytes is refused, and
    the same view copied to a contiguous tensor is taken."""
    h, d = 2, 64
    x = torch.randn(2, 16, 3 * h * d + 1, device=cuda_device).to(torch.bfloat16)
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fl.flash_attention(q, k, v)  # row stride 2 * (3 * H * D + 1) bytes
    y = torch.zeros(2, 16, h * d + 8, device=cuda_device, dtype=torch.bfloat16)
    q1 = y[..., 1:1 + h * d].unflatten(-1, (h, d))  # row stride fine, base pointer 2 bytes off
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fl.flash_attention(q1, *(t.contiguous() for t in (k, v)))
    o, _, _ = fl.flash_attention(*(t.contiguous() for t in (q, k, v)))
    assert o.shape == q.shape


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


DW_SHAPES = [  # (B, H, W, C, K): ragged maps, C not a multiple of 32, a map under K//2
    (2, 9, 13, 8, 3), (1, 9, 13, 80, 5), (3, 16, 16, 100, 7), (2, 2, 2, 16, 7), (4, 32, 32, 128, 7),
    # the kernels' tiles (`dc.plan`: 16 x 16 output pixels at maps of 16 and
    # wider in bf16, 4 or 8 rows in fp32, 8 wide on the 8 x 8 map; 64
    # channels) one pixel short and one past, at K = 3, 5 and 7, in H and in
    # W, an odd C, C not a multiple of 64
    (2, 7, 31, 64, 7), (2, 9, 33, 64, 3), (2, 9, 33, 33, 7), (2, 15, 15, 128, 7),
    (2, 17, 17, 100, 3), (2, 8, 8, 96, 5), (1, 9, 33, 33, 3), (2, 15, 33, 64, 7),
    (2, 17, 17, 64, 7), (2, 33, 31, 64, 5),
    # every MobileCLIP-S1 stage shape at b2, 3 x 3 and 7 x 7
    *[(2, hw, hw, c, k) for hw, c in ((64, 64), (32, 128), (16, 256), (8, 512)) for k in (3, 7)],
]


def _dw_inputs(b, h, w, c, k, device, dtype, seed=0, offset=0):
    """x, the [K*K, C] table and dy; with `offset`, x and dy are contiguous
    views that many elements into their storage."""
    rng = np.random.RandomState(seed)

    def image():
        flat = torch.from_numpy(rng.randn(offset + b * h * w * c).astype(np.float32))
        return flat.to(device, dtype)[offset:].view(b, h, w, c)

    x = image()
    w2 = torch.from_numpy((rng.randn(k * k, c) * 0.2).astype(np.float32)).to(device)
    return x, w2, image()


def _dw_check(x, w2, dy, dtype):
    """K8's y and K9's dx bit-equal to the plain versions, K9's dw within 1e-3
    of its largest plain value, two K9 runs bit-equal, one launch a call."""
    dc.reset_launches()
    y = dc.dw_conv_fwd(x, w2)
    dx, dw = dc.dw_conv_bwd(x, w2, dy)
    dx2, dw2 = dc.dw_conv_bwd(x, w2, dy)
    torch.cuda.synchronize()
    assert dc.launches == {"dw_conv_fwd": 1, "dw_conv_bwd": 2}
    want_dx, want_dw = dc.dw_conv_bwd_ref(x, w2, dy)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    torch.testing.assert_close(y, dc.dw_conv_fwd_ref(x, w2), rtol=0, atol=0)
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    assert _rel(dw, want_dw, want_dw.abs().max().item()) <= 1e-3
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,k", DW_SHAPES)
def test_dw_conv_kernels_match_plain_versions(cuda_device, b, h, w, c, k, dtype):
    """K8's y and K9's dx take the plain versions' fp32 products and sums in
    the same order and round once: equal bits; K9's dw within 1e-3 of its
    largest plain value (fp32 sums in another order), the same bits on a
    second run."""
    _dw_check(*_dw_inputs(b, h, w, c, k, cuda_device, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,k", [(2, 9, 33, 64, 7), (2, 16, 16, 128, 3)])
def test_dw_conv_kernels_take_misaligned_views(cuda_device, b, h, w, c, k, dtype):
    """Contiguous x and dy one element into their storage (not 16-byte
    aligned, as an autograd dy may be): the element-wise copies, the same
    bars."""
    x, w2, dy = _dw_inputs(b, h, w, c, k, cuda_device, dtype, offset=1)
    assert x.storage_offset() == 1 and x.data_ptr() % 16 != 0
    assert not dc._plan_for(x, k, dy).wide
    _dw_check(x, w2, dy, dtype)


def test_dw_conv_backward_is_deterministic(cuda_device):
    """K9's dw is a two-pass reduction without atomics: two runs on the same
    input give the same bits."""
    x, w2, dy = _dw_inputs(8, 64, 64, 64, 7, cuda_device, torch.bfloat16, seed=1)
    first = dc.dw_conv_bwd(x, w2, dy)
    second = dc.dw_conv_bwd(x, w2, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_dw_conv_kernels_refuse_what_they_cannot_take(cuda_device):
    x, w2, dy = _dw_inputs(1, 8, 8, 16, 3, cuda_device, torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        dc.dw_conv_fwd(x, w2)
    x, w2, dy = _dw_inputs(1, 12, 12, 16, 9, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="not built"):
        dc.dw_conv_fwd(x, w2)
    x, w2, dy = _dw_inputs(1, 8, 8, 16, 3, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        dc.dw_conv_fwd(x.transpose(1, 2), w2)
    with pytest.raises(ValueError, match="fp32"):
        dc.dw_conv_fwd(x, w2.double())


def test_mobileclip_s1_encode_image_launches_k8_73_times(cuda_device, monkeypatch):
    """Full-width MobileCLIP-S1 in bf16 under MRCLIP_DW_IMPL=pallas and
    'fusedp': one image call launches K8 73 times and K1 4 times; its
    features agree with the same weights on cuDNN's convolution."""
    monkeypatch.setenv("MRCLIP_DW_IMPL", "pallas")
    kernel = create_model("MobileCLIP-S1", precision="bf16", attn_impl="fusedp", rng_seed=0)
    monkeypatch.setenv("MRCLIP_DW_IMPL", "xla")
    plain = create_model("MobileCLIP-S1", precision="bf16", attn_impl="fusedp", rng_seed=0)
    images = torch.from_numpy(np.random.RandomState(0).randn(2, 256, 256, 3).astype(np.float32))
    with torch.inference_mode():
        dc.reset_launches()
        fa.reset_launches()
        a = kernel.encode_image(images.to(cuda_device), normalize=True)
        torch.cuda.synchronize()
        assert dc.launches == {"dw_conv_fwd": 73, "dw_conv_bwd": 0} and fa.launches == 4
        b = plain.encode_image(images.to(cuda_device), normalize=True)
    cos = torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1)
    assert cos.min().item() >= 0.999


def test_small_mobileclip_train_step_gradients_through_the_kernels(cuda_device, monkeypatch):
    """A MobileCLIP-S1 cut to one block per stage (widths 32 to 128, 7
    depthwise convolutions) in bf16 at 128 px, attention 'bf16': each
    convolution launches K8 once and K9 once, every depthwise weight gets a
    gradient, and the gradients agree with cuDNN's convolution within bf16
    rounding (cosine >= 0.999 whole, >= 0.99 per tensor of 10^4 or more
    elements)."""
    monkeypatch.setitem(fastvit.FASTVIT_DIMS, "fastvit_mci1", ((1, 1, 1, 1), (32, 64, 96, 128), 3.0))
    vision = dict(get_model_config("MobileCLIP-S1")["vision_cfg"], image_size=128)
    args = type("Args", (), dict(multipositiveloss=True, delta=0.5, pallas_loss=False))()
    apply = make_loss_apply(create_loss(args))
    rng = np.random.RandomState(0)
    batch = {
        "images": normalize_images(torch.from_numpy(
            rng.randint(0, 256, (8, 128, 128, 3)).astype(np.uint8)).to(cuda_device)),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (8, 77))).to(cuda_device),
        "labels": torch.from_numpy(rng.randint(0, 3, 8).astype(np.int32)).to(cuda_device),
    }
    grads = {}
    for impl in ("pallas", "xla"):
        monkeypatch.setenv("MRCLIP_DW_IMPL", impl)
        model = create_model("MobileCLIP-S1", precision="bf16", attn_impl="bf16", rng_seed=0,
                             vision_cfg=vision)
        state = create_train_state(model, create_optimizer(lr=1e-4))
        dc.reset_launches()
        grads[impl], ldict = loss_and_grads(model, apply, state.params, batch)
        torch.cuda.synchronize()
        assert np.isfinite(ldict["loss"].item())
        want = 7 if impl == "pallas" else 0
        assert dc.launches == {"dw_conv_fwd": want, "dw_conv_bwd": want}
    dw_names = [n for n in grads["pallas"]
                if n.endswith(("mixer_dw.weight", "ffn.conv_dw.weight", "pos_emb_dw.weight"))]
    assert len(dw_names) == 7
    assert all(grads["pallas"][n].abs().max().item() > 0 for n in dw_names)
    flat = [torch.cat([g[n].flatten().double() for n in grads["xla"]]) for g in (grads["pallas"],
                                                                                grads["xla"])]
    assert torch.nn.functional.cosine_similarity(*flat, dim=0).item() >= 0.999
    for name, g in grads["pallas"].items():
        if g.numel() >= 10**4:
            cos = torch.nn.functional.cosine_similarity(
                g.flatten().double(), grads["xla"][name].flatten().double(), dim=0)
            assert cos.item() >= 0.99, name


def test_chunked_loss_matches_the_dense_loss_at_b2048(cuda_device):
    """The streamed multipositive loss (ops/fused_loss.py, torch ops with a
    recomputing backward) against the dense one on the card, fp32 with TF32
    off, B = 2048, D = 512, 1024-key chunks: loss to 1e-5 relative and the
    gradients of the features and the scale to 1e-4 of their largest
    element; its peak memory below the dense loss's."""
    from mrclip_tpu_torch.losses import multipositive_clip_loss
    from mrclip_tpu_torch.ops.fused_loss import chunked_multipositive_clip_loss

    gen = torch.Generator(device="cuda").manual_seed(0)
    img, txt = (torch.nn.functional.normalize(
        torch.randn(2048, 512, device="cuda", generator=gen), dim=-1) for _ in range(2))
    labels = torch.randint(0, 32, (2048,), device="cuda", generator=gen)
    results = {}
    for key, fn in (("chunked", chunked_multipositive_clip_loss), ("dense", multipositive_clip_loss)):
        a, b = img.clone().requires_grad_(), txt.clone().requires_grad_()
        s = torch.tensor(14.0, device="cuda", requires_grad=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = fn(a, b, labels, s)["loss"]
        loss.backward()
        torch.cuda.synchronize()
        results[key] = (loss.item(), [a.grad, b.grad, s.grad],
                        torch.cuda.max_memory_allocated() - base)
    (lc, gc, mc), (ld, gd, md) = results["chunked"], results["dense"]
    assert abs(lc - ld) <= 1e-5 * abs(ld)
    for x, y in zip(gc, gd):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-4 * y.abs().max().item())
    assert mc < md


def test_text_dropout_draws_from_a_cuda_generator(cuda_device):
    """Text dropout on the card: the masks come from the step's CUDA
    generator (the same seed, the same features; another seed, others)."""
    model = create_model("ViT-B-32-mini", device="cuda", text_dropout=0.25).train()
    tokens = torch.randint(1, 49408, (4, 32), device="cuda")
    runs = [model.encode_text(tokens, generator=torch.Generator(device="cuda").manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_png_decode_through_the_compiled_unfilter(cuda_device, tmp_path):
    """Where nvcc is (the card's machine), the PNG reader unfilters in the
    host C function built from csrc/png_unfilter.cu; it gives the numpy
    unfilter's bytes for every filter type and the pixels written."""
    from mrclip_tpu_torch.data import png

    assert png.unfilter_backend() == "compiled"
    rng = np.random.RandomState(0)
    for bpp in (1, 2, 3, 4):
        rows = rng.randint(0, 256, (40, 33 * bpp + 1)).astype(np.uint8)
        rows[:, 0] = np.arange(40) % 5
        raw = rows.tobytes()
        np.testing.assert_array_equal(png.unfilter(raw, 40, 33 * bpp, bpp),
                                      png._unfilter_numpy(rows.reshape(-1), 40, 33 * bpp, bpp))
        img = (rng.rand(37, 29, bpp) * 50 + np.arange(29)[None, :, None] * 6).astype(np.uint8)
        img = img[..., 0] if bpp == 1 else img
        png.write_png(tmp_path / f"x{bpp}.png", img)
        np.testing.assert_array_equal(png.read_png(str(tmp_path / f"x{bpp}.png")), img)


def _cli_study(tmp_path):
    """A small synthetic study through the preprocessing CLI: 40 train rows
    (4 volumes of 10 slices, 64 x 60), 20 val rows."""
    from mrclip_tpu_torch.preprocessing import __main__ as pre_cli
    from mrclip_tpu_torch.preprocessing.synthetic import write_study

    write_study(str(tmp_path / "raw"), 8, shape=(64, 60, 224), slices=range(122, 142, 2), seed=1)
    pre_cli.main(["slices", "--input", str(tmp_path / "raw"), "--output", str(tmp_path / "s")])
    pre_cli.main(["captions", "--input", str(tmp_path / "s"), "--rawdata", str(tmp_path / "raw"),
                  "--output", str(tmp_path / "cap" / "c.csv")])
    pre_cli.main(["label", "--input", str(tmp_path / "cap" / "*.csv"), "--output",
                  str(tmp_path / "lab")])
    (tmp_path / "split").mkdir()
    pre_cli.main(["split", "--input", str(tmp_path / "lab"), "--output", str(tmp_path / "split"),
                  "--train-ratio", "0.5", "--val-ratio", "0.25"])
    return ["--train-data", str(tmp_path / "split" / "train.csv"),
            "--val-data", str(tmp_path / "split" / "val.csv"), "--csv-caption-key", "text",
            "--model", "ViT-B-32-mini", "--attn-impl", "fusedp", "--pallas-loss",
            "--multipositiveloss", "--batch-size", "16", "--epochs", "1", "--precision", "amp",
            "--workers", "2", "--logs", str(tmp_path / "logs"), "--name", "r"]


def test_training_cli_one_epoch_on_the_card(cuda_device, tmp_path):
    """The preprocessing CLI on a small synthetic study, then the training
    CLI on the card for one epoch with a val pass (ViT-B-32-mini, fusedp,
    the pallas loss): K1/K3/K6/K7 launched per step as the model's layers
    say, finite results, a checkpoint that loads back bit-equal."""
    import json

    from mrclip_tpu_torch import checkpoint as ckpt
    from mrclip_tpu_torch.ops import launch_counts, launches_since
    from mrclip_tpu_torch.train import main as train_main

    flags = _cli_study(tmp_path)
    before = launch_counts()
    state = train_main.main(flags)
    launched = launches_since(before)
    steps = 40 // 16  # 4 volumes x 10 slices, drop_last
    layers = get_model_config("ViT-B-32-mini")
    per_pass = layers["vision_cfg"]["layers"] + layers["text_cfg"]["layers"]
    assert state.step == steps
    assert launched == {"packed_attn_fwd": per_pass * (steps + 2), "packed_attn_bwd": per_pass * steps,
                        "supcon_stats": 2 * steps, "supcon_grad_q": 2 * steps,
                        "supcon_grad_k": 2 * steps}  # the val pass: 20 rows, 2 batches of K1
    res = json.loads((tmp_path / "logs" / "r" / "checkpoints" / "results.jsonl").read_text())
    assert all(np.isfinite(v) for v in res.values() if isinstance(v, float))
    saved = ckpt.load_checkpoint(str(tmp_path / "logs" / "r" / "checkpoints"))
    for k, v in state.params.items():
        assert v.is_cuda and torch.equal(v.detach().cpu(), saved["params"][k])


def _mini_batch(device, n=8, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "images": normalize_images(torch.from_numpy(
            rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)).to(device)),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (n, 32))).to(device),
        "labels": torch.from_numpy(rng.randint(0, 3, n).astype(np.int32)).to(device),
    }


@pytest.mark.parametrize("policy", ["full", "dots", "mlp_only"])
def test_remat_vit_mini_step_matches_no_remat(cuda_device, policy):
    """ViT-B-32-mini, fp32, 'fusedp', text dropout 0.1 from a CUDA
    generator: the remat'd step's loss and gradients against the step
    without remat from the same weights and seed (1e-5 of each tensor's
    largest element: the kernels recompute the same values), K1 launched
    twice per layer (forward and recompute) and K3 once."""
    args = type("Args", (), dict(multipositiveloss=True, delta=0.5, pallas_loss=False))()
    apply = make_loss_apply(create_loss(args))
    batch = _mini_batch(cuda_device)
    runs = {}
    for remat in (False, True):
        model = create_model("ViT-B-32-mini", attn_impl="fusedp", rng_seed=0, text_dropout=0.1,
                             grad_checkpointing=remat, remat_policy=policy)
        layers = len(model.transformer.resblocks) + len(model.visual.transformer.resblocks)
        fa.reset_launches()
        grads, ldict = loss_and_grads(model, apply, dict(model.named_parameters()), batch,
                                      torch.Generator(device="cuda").manual_seed(4))
        torch.cuda.synchronize()
        runs[remat] = (grads, ldict["loss"].item(), fa.launches, fa.bwd_launches)
    (g1, l1, f1, b1), (g0, l0, f0, b0) = runs[True], runs[False]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert (f0, b0, f1, b1) == (layers, layers, 2 * layers, layers)
    for name, g in g1.items():
        assert (g - g0[name]).abs().max().item() <= 1e-5 * (g0[name].abs().max().item() + 1e-12), name


def test_cached_accumulation_step_matches_the_unsplit_step(cuda_device):
    """ViT-B-32-mini, fp32, 'fusedp' + the pallas loss (K6/K7): the cached
    mode at A = 2 against one step on the same 16 rows: loss to 1e-5
    relative, the summed gradients to 1e-4 of each tensor's largest element
    (the temperature's twice the unsplit one: each pass's loss reaches it in
    full), and each pass launching K6 and K7 twice over all 16 rows."""
    from mrclip_tpu_torch.parallel import build_train_step

    args = type("Args", (), dict(multipositiveloss=True, delta=0.5, pallas_loss=True))()
    apply = make_loss_apply(create_loss(args))
    batch = _mini_batch(cuda_device, n=16)

    class Recorder:
        def init(self, params):
            return type("S", (), {"count": 0})()

        def update(self, grads, state, params, grad_norm=None):
            self.grads = {k: v.clone() for k, v in grads.items()}
            return state

    out = {}
    for accum in (1, 2):
        model = create_model("ViT-B-32-mini", attn_impl="fusedp", rng_seed=0)
        rec = Recorder()
        step = build_train_step(model, apply, rec, accum_freq=accum, cached_features_accum=True)
        pl.reset_launches()
        _, metrics = step(create_train_state(model, rec), batch)
        torch.cuda.synchronize()
        out[accum] = (metrics["loss"].item(), rec.grads, dict(pl.launches))
    (l1, g1, c1), (l2, g2, c2) = out[1], out[2]
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    assert c1 == {k: 2 for k in c1} and c2 == {k: 4 for k in c2}
    for name, g in g1.items():
        want = g * (2 if name == "logit_scale" else 1)
        assert (g2[name] - want).abs().max().item() <= 1e-4 * (want.abs().max().item() + 1e-12), name


def test_augment_apply_on_the_card_matches_the_cpu(cuda_device):
    """The MR-CLIP augmentation's deterministic apply (warp past the image,
    blur, colour jitter, greyscale, normalise) and the eval preprocessing
    on the card against the CPU on the same draws and canvases, 1e-4; the
    draws themselves from a CUDA generator."""
    from mrclip_tpu_torch.ops import image_ops

    rng = np.random.RandomState(0)
    jitter = dict(color_jitter=(0.4, 0.4, 0.4, 0.1), color_jitter_prob=0.8, gray_scale_prob=0.3)
    for x in (torch.from_numpy(rng.randint(0, 256, (12, 72, 80, 3)).astype(np.uint8)),
              torch.from_numpy(rng.uniform(-2, 2, (12, 72, 80, 3)).astype(np.float32))):
        draws = image_ops.draw_augment(12, (72, 80), torch.Generator().manual_seed(1),
                                       out_size=(64, 64), translate=(0.5, 0.5), **jitter)
        kw = dict(out_size=(64, 64), color_jitter=jitter["color_jitter"])
        card = image_ops.apply_augment(x.to(cuda_device), draws, **kw)
        assert card.is_cuda and card.dtype == torch.float32
        np.testing.assert_allclose(card.cpu().numpy(),
                                   image_ops.apply_augment(x, draws, **kw).numpy(), atol=1e-4,
                                   rtol=0)
        ev = image_ops.eval_preprocess_batch(x.to(cuda_device), out_size=(64, 64))
        np.testing.assert_allclose(ev.cpu().numpy(), image_ops.eval_preprocess_batch(
            x, out_size=(64, 64)).numpy(), atol=1e-4, rtol=0)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    out = image_ops.random_augment_batch(x.to(cuda_device), gen, out_size=(64, 64), **jitter)
    assert out.is_cuda and out.shape == (12, 64, 64, 3) and torch.isfinite(out).all()


def test_native_loader_hands_out_pinned_batches(cuda_device, tmp_path):
    """With pin_memory the native loader's batches are page-locked tensors,
    the source of asynchronous copies to the card, equal to the unpinned
    ones."""
    from mrclip_tpu_torch.data import NativeBatchLoader
    from mrclip_tpu_torch.data.png import write_png

    paths = []
    for i in range(8):
        write_png(tmp_path / f"{i}.png", np.random.RandomState(i).randint(
            0, 256, (40, 36)).astype(np.uint8))
        paths.append(str(tmp_path / f"{i}.png"))

    class Set:
        images, captions, labels = paths, [f"c{i % 3}" for i in range(8)], [i % 3 for i in range(8)]

        def __len__(self):
            return 8

    def tok(texts):
        return np.ones((len(texts), 4), np.int32)

    for augment in (True, False):
        kw = dict(batch_size=4, canvas_size=(32, 32), tokenizer=tok, num_threads=2,
                  augment=augment, seed=1)
        pinned = list(NativeBatchLoader(Set(), pin_memory=True, **kw))
        plain = list(NativeBatchLoader(Set(), **kw))
        assert len(pinned) == len(plain) == 2
        for p, q in zip(pinned, plain):
            for k in ("images", "labels", "tokens"):
                assert torch.is_tensor(p[k]) and p[k].is_pinned()
                on_card = p[k].to(cuda_device, non_blocking=True)
                torch.cuda.synchronize()
                np.testing.assert_array_equal(on_card.cpu().numpy(), q[k])
            assert p["images"].dtype == torch.uint8


@pytest.mark.parametrize("flags", [["--native-loader"], ["--device-augment"],
                                   ["--native-loader", "--device-augment"]])
def test_training_cli_fast_input_on_the_card(cuda_device, tmp_path, flags):
    """The training CLI on the card under the fast input options: the same
    K1/K3/K6/K7 launches as without them, finite losses and metrics."""
    import json

    from mrclip_tpu_torch.ops import launch_counts, launches_since
    from mrclip_tpu_torch.train import main as train_main

    args = _cli_study(tmp_path)
    before = launch_counts()
    state = train_main.main([*args, *flags])
    launched = launches_since(before)
    steps = 40 // 16
    layers = get_model_config("ViT-B-32-mini")
    per_pass = layers["vision_cfg"]["layers"] + layers["text_cfg"]["layers"]
    assert state.step == steps
    assert launched == {"packed_attn_fwd": per_pass * (steps + 2), "packed_attn_bwd": per_pass * steps,
                        "supcon_stats": 2 * steps, "supcon_grad_q": 2 * steps,
                        "supcon_grad_k": 2 * steps}
    res = json.loads((tmp_path / "logs" / "r" / "checkpoints" / "results.jsonl").read_text())
    assert all(np.isfinite(v) for v in res.values() if isinstance(v, float))
    log = (tmp_path / "logs" / "r" / "out.log").read_text()
    assert "Train Epoch: 0 [32/32 (100%)]" in log


# Last in the file: its 700 cases launch many kernels, and the profiler's
# route tests above read their windows before that (CUPTI loses records
# late in a long process).
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,n,nk", WIDE_BWD_CASES)
@pytest.mark.parametrize("kernel", ["K3", "K5", "K10b"])
def test_wide_wgmma_backward_matches_plain_version(cuda_device, kernel, d, n, nk, causal):
    """bf16 K3, K5 and K10b on the route the library names (`bwd_route`):
    max |dq, dk, dv - plain| within 2e-2 of the call's largest max |plain|
    (phase 3's bar), finite, two runs bit-equal, one launch counted on that
    route (the profiler's kernel names: test_bf16_backward_route_by_shape
    and test_wide_backward_route_by_shape)."""
    q, k, v = _inputs(2, n, nk, 2, d, cuda_device, torch.bfloat16)
    do = torch.from_numpy(np.random.RandomState(1).randn(2, n, 2, d).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    call, plain, library, (counter, module) = _wide_bwd_call(kernel, q, k, v, do, causal)
    route = _bwd_route_of(d, n, nk, causal)
    assert fa.bwd_route(library, True, d, False, n, nk, causal) == route
    assert fa.bwd_route(library, False, d, False, n, nk, causal) == "fma"
    module.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert module.route_launches == {(counter, d, route): 1}
    want = plain()
    scale = max(w.float().abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all())
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale
    again = call()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The long wgmma backward (attn_mma_bwd.cuh's wgmma_long_bwd_*): K3, K5 and
# K10b in bf16, not causal, past 272 rows on either side, at every width it
# takes, at the edges of its 64-row ring tiles and 128-row blocks (273, 320)
# and the long towers' lengths (577, 729, 730, 1024), each N beside another
# Nk (the lengths reversed) and short sides against long ones. After the
# profiler's tests: these read no profiler window.
LONG_BWD_N = (273, 320, 577, 729, 730, 1024)
LONG_BWD_PAIRS = [(n, nk) for n, other in zip(LONG_BWD_N, reversed(LONG_BWD_N))
                  for nk in (n, other)] + [(100, 1024), (1024, 100), (1, 577)]


def _long_bwd_check(kernel, b, n, nk, h, d, device):
    q, k, v = _inputs(b, n, nk, h, d, device, torch.bfloat16)
    do = torch.from_numpy(np.random.RandomState(2).randn(b, n, h, d).astype(np.float32)).to(
        device, torch.bfloat16)
    call, plain, library, (counter, module) = _wide_bwd_call(kernel, q, k, v, do, False)
    assert _bwd_route_of(d, n, nk, False) == "wgmma_long"
    assert fa.bwd_route(library, True, d, False, n, nk, False) == "wgmma_long"
    module.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert module.route_launches == {(counter, d, "wgmma_long"): 1}
    want = plain()
    scale = max(w.float().abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all())
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale
    assert all(torch.equal(a, b) for a, b in zip(got, call()))


@pytest.mark.parametrize("n,nk", LONG_BWD_PAIRS)
@pytest.mark.parametrize("d", WIDE_FWD_DIMS)
@pytest.mark.parametrize("kernel", ["K3", "K5", "K10b"])
def test_long_wgmma_bwd_matches_plain_version(cuda_device, kernel, d, n, nk):
    """bf16 K3, K5 and K10b past 272 rows on wgmma_long (`bwd_route`):
    max |dq, dk, dv - plain| within 2e-2 of the call's largest max |plain|
    (phase 3's bar), finite, two runs bit-equal, one launch counted on that
    route."""
    _long_bwd_check(kernel, 2, n, nk, 2, d, cuda_device)


@pytest.mark.parametrize("n,nk,d", [(729, 729, 72), (1024, 577, 64), (577, 1024, 104)])
@pytest.mark.parametrize("kernel", ["K3", "K5", "K10b"])
def test_long_wgmma_bwd_at_many_heads(cuda_device, kernel, n, nk, d):
    """The same at 4 samples of 16 heads: hundreds of blocks a pass, a
    head's row and key blocks side by side."""
    _long_bwd_check(kernel, 4, n, nk, 16, d, cuda_device)
