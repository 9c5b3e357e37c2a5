"""The port's image operations on the card's path (`mrclip_tpu_torch/ops/
image_ops.py`) against the JAX package's (`mrclip_tpu/ops/image_ops.py`) on
the same numpy inputs, fp32 on the CPU.

`random_augment_batch` draws from a torch generator and JAX from its key,
so the comparison reproduces JAX's draws from its own key splits
(`jax_augment_draws`, the splits of JAX's `random_augment_batch`) and feeds
them to the port's deterministic `apply_augment`; the drawn values also go
through the port's `warp_matrices`, against the matrices JAX builds from
them. Tolerances: 1e-4 absolute on normalised values (fp32 summation order
and fused multiply-adds; the values are O(1)), 1e-5 relative on the warp
matrices, exact for the masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src.image import scale as jax_scale
from mrclip_tpu.ops import image_ops as J
from mrclip_tpu_torch.ops import image_ops as T

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TOL = 1e-4
MEAN, STD = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def jax_augment_draws(key, n, in_hw, *, out_size=(224, 224), crop_scale=(0.9, 1.0),
                      ratio=(3.0 / 4.0, 4.0 / 3.0), degrees=(-20.0, 20.0), translate=(0.3, 0.3),
                      affine_scale=(0.8, 1.2), blur_sigma=(0.1, 2.0), hflip_prob=0.5,
                      color_jitter=None, color_jitter_prob=0.0, gray_scale_prob=0.0):
    """What JAX's `random_augment_batch(images, key, ...)` draws, from its
    own key splits: (the port's `AugmentDraws` of it, the raw values
    {crop [n, 4], affine [n, 4], flip [n]} the matrices come from)."""
    k_crop, k_aff, k_flip, k_blur, k_jit, k_gray = jax.random.split(key, 6)
    crop, affine = [], []
    for k in jax.random.split(k_crop, n):
        kh, kw, ky, kx = jax.random.split(k, 4)
        crop.append([jax.random.uniform(kh, minval=crop_scale[0], maxval=crop_scale[1]),
                     jax.random.uniform(kw, minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])),
                     jax.random.uniform(ky), jax.random.uniform(kx)])
    for k in jax.random.split(k_aff, n):
        ka, ktx, kty, ks = jax.random.split(k, 4)
        affine.append([jax.random.uniform(ka, minval=degrees[0], maxval=degrees[1]),
                       jax.random.uniform(ktx, minval=-translate[0], maxval=translate[0]),
                       jax.random.uniform(kty, minval=-translate[1], maxval=translate[1]),
                       jax.random.uniform(ks, minval=affine_scale[0], maxval=affine_scale[1])])
    flip = jax.random.bernoulli(k_flip, hflip_prob, (n,))
    crop_m = jax.vmap(lambda k: J._random_resized_crop_matrix(
        k, in_hw, out_size, crop_scale, ratio))(jax.random.split(k_crop, n))
    aff_m = jax.vmap(lambda k: J._random_affine_matrix(
        k, out_size, degrees, translate, affine_scale))(jax.random.split(k_aff, n))
    ow = out_size[1]
    flip_m = jnp.where(flip[:, None, None], jnp.array([[-1.0, 0.0, ow - 1.0], [0.0, 1.0, 0.0]]),
                       jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    matrices = jax.vmap(J._compose)(jax.vmap(J._compose)(crop_m, aff_m), flip_m)
    draws = T.AugmentDraws(t(matrices), t(jax.random.uniform(
        k_blur, (n,), minval=blur_sigma[0], maxval=blur_sigma[1])))
    if color_jitter_prob and color_jitter is not None:
        kb, kc, ks, kh, kp = jax.random.split(k_jit, 5)
        factors = [jax.random.uniform(k, (n, 1, 1, 1), minval=max(0.0, 1.0 - s),
                                      maxval=1.0 + s).reshape(n)
                   for k, s in zip((kb, kc, ks), color_jitter[:3])]
        hue = jax.random.uniform(kh, (n, 1, 1), minval=-color_jitter[3],
                                 maxval=color_jitter[3]).reshape(n)
        draws.jitter = t(jnp.stack([*factors, hue], 1))
        draws.jitter_apply = t(jax.random.bernoulli(kp, color_jitter_prob, (n, 1, 1, 1))
                               .reshape(n))
    if gray_scale_prob:
        draws.gray = t(jax.random.bernoulli(k_gray, gray_scale_prob, (n, 1, 1, 1)).reshape(n))
    raw = {"crop": t(jnp.asarray(crop, jnp.float32)), "affine": t(jnp.asarray(affine, jnp.float32)),
           "flip": t(flip)}
    return draws, raw


def _images(shape, seed=0, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.uniform(-2.0, 2.0, shape).astype(np.float32)  # the scale of normalised images


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_matches_jax(dtype):
    x = _images((2, 9, 7, 3), 1, dtype)
    close(T.normalize_images(t(x), MEAN, STD), J.normalize_images(jnp.asarray(x), MEAN, STD))


@pytest.mark.parametrize("src,size", [((40, 30), (20, 25)), ((20, 25), (40, 33)),
                                      ((32, 32), (32, 32)), ((33, 17), (33, 40))])
def test_resize_bilinear_matches_jax(src, size):
    """Down, up, the same size (left as it is) and one axis only; uint8
    values (0..255), so 1e-4 relative to the largest."""
    x = _images((2, *src, 3), 2)
    got = T.resize_bilinear(t(x), size)
    want = J.resize_bilinear(jnp.asarray(x), size)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want, TOL * 255)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("sizes", [(300, 373), (180, 224), (256, 224), (50, 224), (230, 224)])
def test_resize_weights_match_jax(sizes, method):
    """The per-axis weights against jax.image's `compute_weight_mat`
    (upsampling, downsampling, edges renormalised)."""
    i, o = sizes
    want = jax_scale.compute_weight_mat(i, o, o / i, 0.0, jax_scale._kernels[
        jax_scale.ResizeMethod.from_string(method)], True)
    np.testing.assert_allclose(T._weight_mat(i, o, method, "cpu").numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def _eval_f64(x, out_size, mean, std):
    """eval_preprocess_batch in float64 on jax.image's weights."""
    _, h, w, _ = x.shape
    scale = float(np.float32(max(out_size[0] / h, out_size[1] / w)))
    rh, rw = round(h * scale), round(w * scale)
    y = x.astype(np.float64)
    kern = jax_scale._fill_keys_cubic_kernel
    if rh != h:
        y = np.einsum("bhwc,hy->bywc", y, np.asarray(
            jax_scale.compute_weight_mat(h, rh, rh / h, 0.0, kern, True), np.float64))
    if rw != w:
        y = np.einsum("bhwc,wx->bhxc", y, np.asarray(
            jax_scale.compute_weight_mat(w, rw, rw / w, 0.0, kern, True), np.float64))
    top, left = (rh - out_size[0]) // 2, (rw - out_size[1]) // 2
    y = y[:, top: top + out_size[0], left: left + out_size[1]]
    if x.dtype == np.uint8:
        y = y / 255.0
    return (y - np.asarray(mean)) / np.asarray(std)


@pytest.mark.parametrize("src", [(256, 256), (224, 224), (200, 300), (300, 180), (100, 50),
                                 (224, 230)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_eval_preprocess_matches_jax(src, dtype):
    """Shortest edge to 224 (down and up, antialiased Keys cubic), the
    centre crop and normalise; 224 x 224 is the same-size case the native
    loader's canvases meet. Against JAX within 1e-4, plus, for float
    inputs (which the loops never feed it), JAX's own distance from the
    same function in float64: XLA's product on the CPU strays from it by up
    to 1.4e-4 on unit-scale values, the port's by 2e-6 (held at 1e-5)."""
    x = _images((2, *src, 3), 3, dtype)
    got = T.eval_preprocess_batch(t(x), out_size=(224, 224), mean=MEAN, std=STD)
    want = np.asarray(J.eval_preprocess_batch(jnp.asarray(x), out_size=(224, 224), mean=MEAN,
                                              std=STD))
    ref = _eval_f64(x, (224, 224), MEAN, STD)
    assert got.shape == want.shape == (2, 224, 224, 3)
    close(got, ref, 1e-5)
    close(got, want, TOL + (np.abs(want - ref).max() if dtype == np.float32 else 0.0))


def test_eval_preprocess_same_size_is_normalise_and_bilinear():
    x = _images((2, 48, 48, 3), 4)
    close(T.eval_preprocess_batch(t(x), out_size=(48, 48)), T.normalize_images(t(x)), 0)
    got = T.eval_preprocess_batch(t(x), out_size=(32, 40), method="bilinear")
    want = J.eval_preprocess_batch(jnp.asarray(x), out_size=(32, 40), method="bilinear")
    close(got, want)


@pytest.mark.parametrize("fill", [0.0, 7.5])
def test_affine_sample_matches_jax_outside_the_image(fill):
    """Warps that shift, scale up and rotate so that rows and columns of
    the output fall partly and wholly outside the input: each outside tap
    takes `fill` before the weights apply."""
    x = _images((4, 20, 24, 3), 5).astype(np.float32)
    mats = np.array([[[1.0, 0.0, -8.5], [0.0, 1.0, 6.25]],
                     [[1.7, 0.3, -3.0], [-0.2, 1.9, -4.0]],
                     [[0.6, -0.8, 12.0], [0.8, 0.6, -7.0]],
                     [[-1.0, 0.0, 30.0], [0.0, 1.0, 40.0]]], np.float32)
    got = T.affine_sample(t(x), t(mats), (18, 26), fill=fill)
    want = J.affine_sample(jnp.asarray(x), jnp.asarray(mats), (18, 26), fill=fill)
    assert (got == fill).any() and got.shape == (4, 18, 26, 3)
    close(got, want, TOL * 255)


def test_gaussian_blur_matches_jax():
    x = _images((3, 11, 9, 3), 6).astype(np.float32)
    sigma = np.array([0.1, 0.9, 2.0], np.float32)
    close(T._gaussian_blur3(t(x), t(sigma)), J._gaussian_blur3(jnp.asarray(x), jnp.asarray(sigma)),
          TOL * 255)


def test_hsv_round_trip_matches_jax():
    x = np.random.RandomState(7).rand(500, 3).astype(np.float32)
    x[:20] = x[:20, :1]  # grey: no hue, no saturation
    x[20:30] = 0.0
    hsv = T._rgb_to_hsv(t(x))
    close(hsv, J._rgb_to_hsv(jnp.asarray(x)), 1e-6)
    close(T._hsv_to_rgb(hsv), J._hsv_to_rgb(jnp.asarray(hsv.numpy())), 1e-6)


@pytest.mark.parametrize("jitter", [(0.4, 0.4, 0.4, 0.1), (0.0, 0.5, 0.0, 0.2),
                                    (0.3, 0.0, 0.3, 0.0)])
def test_color_jitter_matches_jax(jitter):
    """JAX's factors and mask from its key splits through the port's
    deterministic jitter; only the ops of non-zero strength run."""
    n = 6
    x = np.random.RandomState(8).rand(n, 10, 12, 3).astype(np.float32)
    key = jax.random.key(3)
    kb, kc, ks, kh, kp = jax.random.split(key, 5)
    factors = [jax.random.uniform(k, (n, 1, 1, 1), minval=max(0.0, 1.0 - s),
                                  maxval=1.0 + s).reshape(n) for k, s in zip((kb, kc, ks), jitter)]
    hue = jax.random.uniform(kh, (n, 1, 1), minval=-jitter[3], maxval=jitter[3]).reshape(n)
    apply = jax.random.bernoulli(kp, 0.7, (n, 1, 1, 1)).reshape(n)
    got = T._jitter_apply(t(x), t(jnp.stack([*factors, hue], 1)), t(apply), jitter)
    want = J.color_jitter_batch(jnp.asarray(x), key, jitter, 0.7)
    close(got, want, 1e-5)
    assert 0 < int(apply.sum()) < n


def test_grayscale_matches_jax():
    n = 8
    x = np.random.RandomState(9).rand(n, 5, 6, 3).astype(np.float32)
    key = jax.random.key(4)
    apply = jax.random.bernoulli(key, 0.5, (n, 1, 1, 1)).reshape(n)
    close(T._gray_apply(t(x), t(apply)), J.grayscale_batch(jnp.asarray(x), key, 0.5), 1e-6)
    g = torch.Generator().manual_seed(0)
    out = T.grayscale_batch(t(x), g, 1.0)
    assert torch.equal(out[..., 0], out[..., 1]) and torch.equal(out[..., 1], out[..., 2])


@pytest.mark.parametrize("in_hw,out_size", [((256, 256), (224, 224)), ((48, 40), (32, 32)),
                                            ((224, 224), (224, 224))])
def test_warp_matrices_match_jax(in_hw, out_size):
    """The port's matrices from the values JAX draws, against JAX's."""
    kw = dict(out_size=out_size, crop_scale=(0.5, 1.0), ratio=(0.6, 1.5))
    draws, raw = jax_augment_draws(jax.random.key(5), 16, in_hw, **kw)
    got = T.warp_matrices(raw["crop"], raw["affine"], raw["flip"], in_hw, out_size)
    np.testing.assert_allclose(got.numpy(), draws.matrices.numpy(), rtol=1e-5, atol=1e-5)
    assert 0 < int(raw["flip"].sum()) < 16


CASES = {
    "mrclip": dict(),
    "colour": dict(color_jitter=(0.4, 0.4, 0.4, 0.1), color_jitter_prob=0.8,
                   gray_scale_prob=0.3),
    "scale": dict(crop_scale=(0.3, 0.6), ratio=(0.5, 2.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_random_augment_matches_jax_on_its_draws(case, dtype):
    """The whole chain: JAX's draws from its key through the port's apply,
    against JAX's `random_augment_batch` with that key; uint8 canvases (the
    native loader's) and normalised floats (what the CSV loader hands
    `--device-augment`). The affine's shifts reach outside the image."""
    kw = dict(CASES[case], out_size=(32, 28))
    x = _images((6, 40, 36, 3), 10, dtype)
    if dtype == np.uint8 and case == "colour":
        x[:2] = x[:2, ..., :1]  # grey images as the MRI slices are
    key = jax.random.key(11)
    draws, _ = jax_augment_draws(key, 6, (40, 36), **kw)
    want = J.random_augment_batch(jnp.asarray(x), key, mean=MEAN, std=STD, **kw)
    got = T.apply_augment(t(x), draws, out_size=(32, 28), color_jitter=kw.get("color_jitter"),
                          mean=MEAN, std=STD)
    assert got.shape == want.shape == (6, 32, 28, 3) and got.dtype == torch.float32
    close(got, want)


def test_random_augment_draws_follow_the_generator():
    x = t(_images((4, 40, 36, 3), 12))
    kw = dict(out_size=(32, 32), **CASES["colour"])
    a = T.random_augment_batch(x, torch.Generator().manual_seed(1), **kw)
    b = T.random_augment_batch(x, torch.Generator().manual_seed(1), **kw)
    c = T.random_augment_batch(x, torch.Generator().manual_seed(2), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (4, 32, 32, 3) and torch.isfinite(a).all()
    draws = T.draw_augment(4, (40, 36), torch.Generator().manual_seed(1), **kw)
    assert torch.equal(T.apply_augment(x, draws, out_size=(32, 32),
                                       color_jitter=kw["color_jitter"]), a)
    d = T.draw_augment(4000, (40, 36), torch.Generator().manual_seed(3), **kw)
    assert 0.45 < d.matrices[:, 0, 0].lt(0).float().mean() < 0.55  # the flips
    assert d.sigma.min() >= 0.1 and d.sigma.max() <= 2.0
    assert 0.75 < d.jitter_apply.float().mean() < 0.85 and 0.25 < d.gray.float().mean() < 0.35
