"""The port's losses (mrclip_tpu_torch/losses, `create_loss`) and image
normalisation against the JAX package's and the reference goldens
(tests/golden_losses.npz, from tests/gen_golden_losses.py).

Inputs are numpy arrays fed to both frameworks; everything is fp32 on the
CPU, so the tolerances are fp32 summation order (rtol 1e-6 where the JAX
package's own golden tests use it, 1e-5 otherwise).
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.losses import contrastive as jc
from mrclip_tpu.losses import functional as jf
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu_torch.factory import create_loss
from mrclip_tpu_torch.losses import (
    arange_cross_entropy,
    clip_loss,
    distill_clip_loss,
    multi_positive_cross_entropy_loss,
    multipositive_clip_loss,
    multipositive_clip_loss_vision_only,
    multipositive_clip_loss_with_distance,
    multipositive_clip_loss_with_vision,
    pos_mask_from_labels,
    siglip_loss,
)
from mrclip_tpu_torch.ops.fused_loss import chunked_multipositive_clip_loss
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.ops.pallas_loss import pallas_multipositive_clip_loss

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_losses.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_multi_positive_ce_matches_golden_and_jax(g):
    got = multi_positive_cross_entropy_loss(t(g["logits"]), t(g["pos_mask"]))
    np.testing.assert_allclose(got.numpy(), g["mp_ce"], rtol=1e-6)
    want = jf.multi_positive_cross_entropy_loss(jnp.asarray(g["logits"]), jnp.asarray(g["pos_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_pos_mask_matches_jax(g):
    got = pos_mask_from_labels(t(g["labels_row"]), t(g["labels_col"]))
    np.testing.assert_array_equal(got.numpy(), g["pos_mask"])
    square = pos_mask_from_labels(t(g["labels_row"]))
    want = jf.pos_mask_from_labels(jnp.asarray(g["labels_row"]))
    np.testing.assert_array_equal(square.numpy(), np.asarray(want))


@pytest.mark.parametrize("offset", [0, 3])
def test_arange_cross_entropy_matches_jax(offset):
    logits = np.random.RandomState(1).randn(5, 9).astype(np.float32) * 4
    got = arange_cross_entropy(t(logits), offset)
    want = jf.arange_cross_entropy(jnp.asarray(logits), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_clip_loss_matches_golden(g):
    got = clip_loss(t(g["img"]), t(g["txt"]), t(g["scale"]))
    np.testing.assert_allclose(got["loss"].numpy(), g["clip_loss"], rtol=1e-5)
    assert got["contrastive_loss"] is got["loss"]


def test_multipositive_clip_loss_matches_golden_and_jax(g):
    args = (g["img"], g["txt"], g["labels_row"], g["scale"])
    got = multipositive_clip_loss(*(t(x) for x in args), delta=0.3)
    np.testing.assert_allclose(got["loss"].numpy(), g["mp_clip_loss"], rtol=1e-5)
    want = jc.multipositive_clip_loss(*(jnp.asarray(x) for x in args), delta=0.3)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5)


def test_losses_of_bf16_features_promote_like_jax():
    """An fp32 scale times bf16 features is fp32 in JAX; the port casts
    the features up before the logits, so both see the same products."""
    rng = np.random.RandomState(2)
    img, txt = (rng.randn(6, 8).astype(np.float32) for _ in range(2))
    labels = np.array([0, 1, 0, 2, 1, 0], np.int32)
    scale = np.float32(14.0)
    got = multipositive_clip_loss(t(img).to(torch.bfloat16), t(txt).to(torch.bfloat16),
                                  t(labels), t(scale))["loss"]
    want = jc.multipositive_clip_loss(jnp.asarray(img, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16),
                                      jnp.asarray(labels), jnp.asarray(scale))["loss"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_multipositive_gradients_match_jax():
    import jax

    rng = np.random.RandomState(3)
    img, txt = (rng.randn(10, 16).astype(np.float32) for _ in range(2))
    labels = rng.randint(0, 4, 10).astype(np.int32)
    scale = np.float32(12.0)
    ti, tt, ts = (t(x).clone().requires_grad_() for x in (img, txt, scale))
    multipositive_clip_loss(ti, tt, t(labels), ts, delta=0.4)["loss"].backward()
    want = jax.grad(lambda a, b, s: jc.multipositive_clip_loss(a, b, jnp.asarray(labels), s,
                                                               delta=0.4)["loss"],
                    argnums=(0, 1, 2))(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale))
    for got, w in zip((ti.grad, tt.grad, ts.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_images_matches_jax(dtype):
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (2, 8, 8, 3))
    images = raw.astype(dtype) if dtype == np.uint8 else (raw / 255.0).astype(dtype)
    got = normalize_images(t(images))
    want = jax_normalize(jnp.asarray(images))
    assert got.dtype == torch.float32 and got.shape == images.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _args(**kw):
    base = dict(multipositiveloss=False, pallas_loss=False, chunked_loss=False, delta=0.5,
                distance=False, visiononly=False, siglip=False, distill=False, lam=None,
                model="ViT-B-16", gather_with_grad=True)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("flags,fn,keywords", [
    (dict(multipositiveloss=True, delta=0.3), multipositive_clip_loss, dict(delta=0.3)),
    (dict(multipositiveloss=True, pallas_loss=True), pallas_multipositive_clip_loss,
     dict(delta=0.5)),
    (dict(), clip_loss, dict()),
    (dict(distill=True), distill_clip_loss, dict()),
    (dict(siglip=True, loss_dist_impl="shift"), siglip_loss, dict(impl="shift")),
    (dict(multipositiveloss=True, visiononly=True), multipositive_clip_loss_vision_only, dict()),
    (dict(multipositiveloss=True, distance=True, delta=0.2), multipositive_clip_loss_with_distance,
     dict(delta=0.2)),
    (dict(multipositiveloss=True, chunked_loss=True, loss_chunk_size=256),
     chunked_multipositive_clip_loss, dict(delta=0.5, chunk_size=256)),
    (dict(lam=0.5), multipositive_clip_loss_with_vision, dict(lam=0.5)),
])
def test_create_loss_dispatches_this_slices_losses(flags, fn, keywords):
    """The JAX package's dispatch order: distill, CoCa, siglip, then the
    multipositive forms (visiononly, distance, pallas, chunked, dense),
    lam, clip_loss; each with its flags bound."""
    loss = create_loss(_args(**flags))
    assert loss.func is fn
    for key, value in keywords.items():
        assert loss.keywords[key] == value, key
    assert "delta" in keywords or "delta" not in loss.keywords


def test_create_loss_chunk_size_defaults_to_1024():
    loss = create_loss(_args(multipositiveloss=True, chunked_loss=True))
    assert loss.func is chunked_multipositive_clip_loss and loss.keywords["chunk_size"] == 1024


@pytest.mark.parametrize("flags", [dict(model="coca_ViT-B-32")])
def test_create_loss_refuses_other_slices(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_loss(_args(**flags))


@pytest.mark.parametrize("fn", [clip_loss, multipositive_clip_loss, pallas_multipositive_clip_loss])
def test_losses_refuse_a_device_axis(fn):
    x = torch.zeros(2, 4)
    args = (x, x, torch.zeros(2, dtype=torch.int32), torch.tensor(1.0))
    if fn is clip_loss:
        args = (x, x, torch.tensor(1.0))
    with pytest.raises(NotImplementedError, match="item 6, multi-GPU"):
        fn(*args, axis_name="data")
