"""Image operations on the card (counterpart of `mrclip_tpu/ops/image_ops.py`,
XLA code in the JAX package and ordinary torch ops here, on the tensor's
device). Images are batched `[B, H, W, C]`, uint8 or float32.

- `normalize_images`: ToTensor + Normalize.
- `resize_bilinear` and `eval_preprocess_batch` (resize the shortest edge,
  crop the centre, normalise): `jax.image.resize(..., antialias=True)`'s
  arithmetic, its `scale_and_translate` weights (the Keys cubic, a = -0.5,
  or the triangle, widened by 1/scale when downsampling, renormalised at
  the edges) built as one weight matrix per axis and applied as two
  products; an axis whose size does not change is left as it is.
- `affine_sample`: a bilinear warp by output->input matrices in pixel
  coordinates; each of the four taps that falls outside the image takes
  `fill` before the weights apply.
- `color_jitter_batch` (brightness, contrast, saturation, hue in that fixed
  order, through `_rgb_to_hsv` / `_hsv_to_rgb`) and `grayscale_batch`.
- `random_augment_batch`: the MR-CLIP train chain (resized crop, affine and
  flip as one warp; a 3x3 Gaussian blur; the colour extras; normalise) in
  two parts: `draw_augment` draws each image's parameters from an explicit
  `torch.Generator`, `apply_augment` applies given parameters and draws
  nothing, so the same parameters give the same images on any device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

__all__ = [
    "normalize_images",
    "resize_bilinear",
    "affine_sample",
    "color_jitter_batch",
    "grayscale_batch",
    "AugmentDraws",
    "warp_matrices",
    "draw_augment",
    "apply_augment",
    "random_augment_batch",
    "eval_preprocess_batch",
]


def normalize_images(
    images: torch.Tensor,
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
    std: Tuple[float, ...] = OPENAI_DATASET_STD,
) -> torch.Tensor:
    """uint8 or float [B, H, W, C] -> normalised fp32 on the tensor's device:
    uint8 is scaled to [0, 1] first, then (x - mean) / std per channel."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    return (x - _const(mean, images.device)) / _const(std, images.device)


def _const(values, device) -> torch.Tensor:
    """A small fp32 constant made on `device` by fill kernels: no copy from
    the host, so the host does not wait for the card's queued work."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in values])


# --- antialiased resize (jax.image's scale_and_translate) -------------------

def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


_KERNELS = {"bicubic": _keys_cubic, "cubic": _keys_cubic, "bilinear": _triangle,
            "linear": _triangle}


def _weight_mat(in_size: int, out_size: int, method: str, device) -> torch.Tensor:
    """[in_size, out_size] fp32 weights resampling one axis by out/in (no
    translation), antialiased: jax.image's `compute_weight_mat`."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = float(np.float32(max(inv_scale, 1.0)))
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
                * np.float32(inv_scale) - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32,
                                                   device=device)[:, None]) / kernel_scale
    weights = _KERNELS[method](x)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """fp32 [B, H, W, C] -> [B, size[0], size[1], C], antialiased."""
    b, h, w, c = x.shape
    oh, ow = size
    if oh != h:
        wh = _weight_mat(h, oh, method, x.device)  # [H, oh]
        x = torch.matmul(wh.t(), x.reshape(b, h, w * c)).reshape(b, oh, w, c)
    if ow != w:
        ww = _weight_mat(w, ow, method, x.device)  # [W, ow]
        x = torch.matmul(x.permute(0, 1, 3, 2), ww).permute(0, 1, 3, 2).contiguous()
    return x


def resize_bilinear(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Batched resize, bilinear, antialiased when downsampling; fp32 out."""
    return _resize(images.float(), tuple(size), "bilinear")


def eval_preprocess_batch(
    images: torch.Tensor,
    *,
    out_size: Tuple[int, int] = (224, 224),
    method: str = "bicubic",
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
    std: Tuple[float, ...] = OPENAI_DATASET_STD,
) -> torch.Tensor:
    """The deterministic eval path on the card: resize the shortest edge
    (antialiased, bicubic by default), crop the centre, normalise (uint8
    scaled to [0, 1] first). fp32 [B, oh, ow, C] out."""
    _, h, w, _ = images.shape
    oh, ow = out_size
    scale = float(np.float32(max(oh / h, ow / w)))  # the JAX package takes it in fp32
    rh, rw = int(round(h * scale)), int(round(w * scale))
    x = _resize(images.float(), (rh, rw), method)
    top, left = (rh - oh) // 2, (rw - ow) // 2
    x = x[:, top: top + oh, left: left + ow]
    if images.dtype == torch.uint8:
        x = x / 255.0
    return normalize_images(x, mean, std)


# --- the warp -----------------------------------------------------------------

def affine_sample(images: torch.Tensor, matrices: torch.Tensor, out_size: Tuple[int, int],
                  fill: float = 0.0) -> torch.Tensor:
    """Warp each image by its 2x3 output->input matrix: output pixel
    (x, y, 1) samples the input at `matrices[i] @ (x, y, 1)`, bilinear, in
    pixel coordinates; a tap outside the image takes `fill`. fp32 out."""
    x = images.float()
    b, h, w, c = x.shape
    oh, ow = out_size
    dev = x.device
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(1, oh * ow, 3)
    src = torch.matmul(coords, matrices.to(dev, torch.float32).transpose(1, 2))  # [B, oh*ow, 2]
    xs, ys = src[..., 0], src[..., 1]
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0f)[..., None], (xs - x0f)[..., None]
    y0, x0 = y0f.to(torch.int32), x0f.to(torch.int32)
    flat = x.reshape(b, h * w, c)

    def tap(yi, xi):
        inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return torch.where(inside, v, torch.full_like(v, fill))

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).reshape(b, oh, ow, c)


def _gaussian_blur3(images: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 3x3 Gaussian blur, one sigma per image, edges replicated."""
    offs = torch.arange(-1, 2, dtype=torch.float32, device=images.device)
    k = torch.exp(-0.5 * (offs[None, :] / sigma[:, None]) ** 2)
    k = k / torch.sum(k, dim=1, keepdim=True)  # [B, 3]
    k0, k1, k2 = (k[:, j, None, None, None] for j in range(3))
    p = torch.cat([images[:, :1], images, images[:, -1:]], dim=1)
    x = p[:, :-2] * k0 + p[:, 1:-1] * k1 + p[:, 2:] * k2
    p = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
    return p[:, :, :-2] * k0 + p[:, :, 1:-1] * k1 + p[:, :, 2:] * k2


# --- colour ---------------------------------------------------------------------

def _luminance(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, torchvision's rgb_to_grayscale weights: [..., 3] -> [..., 1]."""
    return torch.sum(x * _const((0.2989, 0.587, 0.114), x.device), dim=-1, keepdim=True)


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0, 1] -> HSV, h in turns."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    d = mx - mn
    one = torch.ones_like(d)
    safe_d = torch.where(d > 0, d, one)
    h = torch.where(mx == r, (g - b) / safe_d,
                    torch.where(mx == g, 2.0 + (b - r) / safe_d, 4.0 + (r - g) / safe_d))
    h = torch.where(d > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, one), torch.zeros_like(d))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    sector = torch.remainder(i.to(torch.int32), 6).long()[..., None]
    r = torch.gather(torch.stack([v, q, p, p, t, v], dim=-1), -1, sector)
    g = torch.gather(torch.stack([t, v, v, q, p, p], dim=-1), -1, sector)
    b = torch.gather(torch.stack([p, p, t, v, v, q], dim=-1), -1, sector)
    return torch.cat([r, g, b], dim=-1)


def _jitter_apply(x: torch.Tensor, factors: torch.Tensor, apply: torch.Tensor,
                  jitter: Tuple[float, float, float, float]) -> torch.Tensor:
    """Colour jitter on [B, H, W, 3] in [0, 1] with per-image `factors`
    [B, 4] (brightness, contrast, saturation factors, hue shift in turns),
    the ops whose `jitter` strength is non-zero, kept where `apply` [B]."""
    bright, contrast, sat, hue = jitter
    f = factors.to(x.device, torch.float32)[:, None, None, :]
    orig = x
    if bright:
        x = torch.clamp(x * f[..., 0:1], 0.0, 1.0)
    if contrast:
        mean_gray = torch.mean(_luminance(x), dim=(1, 2), keepdim=True)
        x = torch.clamp(mean_gray + f[..., 1:2] * (x - mean_gray), 0.0, 1.0)
    if sat:
        gray = _luminance(x)
        x = torch.clamp(gray + f[..., 2:3] * (x - gray), 0.0, 1.0)
    if hue:
        hsv = _rgb_to_hsv(x)
        hsv = torch.cat([torch.remainder(hsv[..., :1] + f[..., 3:4], 1.0), hsv[..., 1:]], dim=-1)
        x = _hsv_to_rgb(hsv)
    return torch.where(apply.to(x.device)[:, None, None, None], x, orig)


def _gray_apply(x: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    return torch.where(apply.to(x.device)[:, None, None, None], _luminance(x).expand_as(x), x)


def _uniform(n: int, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=generator.device)


def _draw_jitter(n: int, generator: torch.Generator, jitter, p: float):
    """Per-image jitter factors [n, 4] and the apply mask [n]:
    torchvision's draws, f ~ U[max(0, 1 - s), 1 + s], hue ~ U[-h, h]."""
    bright, contrast, sat, hue = jitter
    factors = torch.stack([_uniform(n, max(0.0, 1.0 - s), 1.0 + s, generator)
                           for s in (bright, contrast, sat)] + [_uniform(n, -hue, hue, generator)],
                          dim=1)
    return factors, torch.rand(n, generator=generator, device=generator.device) < p


def color_jitter_batch(x: torch.Tensor, generator: torch.Generator,
                       jitter: Tuple[float, float, float, float], p: float) -> torch.Tensor:
    """Batched colour jitter on [B, H, W, 3] floats in [0, 1], per-image
    factors and apply mask drawn from `generator`, in the fixed order
    brightness, contrast, saturation, hue."""
    factors, apply = _draw_jitter(x.shape[0], generator, tuple(jitter), p)
    return _jitter_apply(x, factors, apply, tuple(jitter))


def grayscale_batch(x: torch.Tensor, generator: torch.Generator, p: float) -> torch.Tensor:
    """Random greyscale (three-channel luma), per-image probability p."""
    apply = torch.rand(x.shape[0], generator=generator, device=generator.device) < p
    return _gray_apply(x, apply)


# --- the MR-CLIP train chain ------------------------------------------------------

@dataclass
class AugmentDraws:
    """One batch's augmentation parameters. `matrices` [B, 2, 3]: output
    pixel -> input pixel (crop . affine . flip); `sigma` [B]: the blur's;
    `jitter` [B, 4] with `jitter_apply` [B]: colour jitter factors
    (brightness, contrast, saturation, hue shift) and where they apply
    (None: no jitter); `gray` [B]: where the image turns grey (None: never)."""

    matrices: torch.Tensor
    sigma: torch.Tensor
    jitter: Optional[torch.Tensor] = None
    jitter_apply: Optional[torch.Tensor] = None
    gray: Optional[torch.Tensor] = None

    def to(self, device) -> "AugmentDraws":
        return replace(self, **{k: v.to(device) for k, v in vars(self).items() if v is not None})


def _crop_matrices(area: torch.Tensor, log_ratio: torch.Tensor, fy: torch.Tensor,
                   fx: torch.Tensor, in_hw, out_hw) -> torch.Tensor:
    """[B, 2, 3] output->input matrices of torchvision's RandomResizedCrop
    in one shot: the drawn area fraction and log aspect, the box clamped
    inside the image, its corner at (fx, fy) of the room left."""
    h, w = in_hw
    oh, ow = out_hw
    target_area = (h * w) * area
    aspect = torch.exp(log_ratio)
    cw = torch.clamp(torch.sqrt(target_area * aspect), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(target_area / aspect), 1.0, float(h))
    y0 = fy * (h - ch)
    x0 = fx * (w - cw)
    zero = torch.zeros_like(cw)
    return torch.stack([torch.stack([cw / ow, zero, x0], -1),
                        torch.stack([zero, ch / oh, y0], -1)], 1)


def _affine_matrices(degrees: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor, s: torch.Tensor,
                     out_hw) -> torch.Tensor:
    """[B, 2, 3] inverse (output->input) matrices of MR-CLIP's RandomAffine:
    rotation by `degrees` and scale `s` about the centre after a shift of
    (tx, ty) of the image size."""
    oh, ow = out_hw
    angle = torch.deg2rad(degrees)
    tx, ty = tx * ow, ty * oh
    cx, cy = ow * 0.5, oh * 0.5
    cos, sin = torch.cos(angle), torch.sin(angle)
    inv_s = 1.0 / s
    m00, m01 = cos * inv_s, sin * inv_s
    m10, m11 = -sin * inv_s, cos * inv_s
    # x_in = m @ (x_out - c - t) + c
    vx, vy = cx + tx, cy + ty
    off_x = cx - (m00 * vx + m01 * vy)
    off_y = cy - (m10 * vx + m11 * vy)
    return torch.stack([torch.stack([m00, m01, off_x], -1),
                        torch.stack([m10, m11, off_y], -1)], 1)


def _flip_matrices(flip: torch.Tensor, ow: int) -> torch.Tensor:
    """[B, 2, 3]: x -> (ow - 1) - x where `flip`, else the identity."""
    yes = _const((-1.0, 0.0, ow - 1.0, 0.0, 1.0, 0.0), flip.device).reshape(1, 2, 3)
    no = _const((1.0, 0.0, 0.0, 0.0, 1.0, 0.0), flip.device).reshape(1, 2, 3)
    return torch.where(flip[:, None, None], yes, no)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 2x3 affines: result(x) = a(b(x))."""
    last = _const((0.0, 0.0, 1.0), a.device).expand(a.shape[0], 1, 3)
    return torch.matmul(torch.cat([a, last], 1), torch.cat([b, last], 1))[:, :2]


def warp_matrices(crop: torch.Tensor, affine: torch.Tensor, flip: torch.Tensor, in_hw,
                  out_hw) -> torch.Tensor:
    """The composed [B, 2, 3] warps from the drawn values: `crop` [B, 4]
    (area fraction, log aspect, fy, fx), `affine` [B, 4] (degrees, tx, ty,
    scale), `flip` [B] bool."""
    crop_m = _crop_matrices(*crop.unbind(1), in_hw, out_hw)
    aff_m = _affine_matrices(*affine.unbind(1), out_hw)
    return _compose(_compose(crop_m, aff_m), _flip_matrices(flip, out_hw[1]))


def draw_augment(
    n: int,
    in_hw: Tuple[int, int],
    generator: torch.Generator,
    *,
    out_size: Tuple[int, int] = (224, 224),
    crop_scale: Tuple[float, float] = (0.9, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    degrees: Tuple[float, float] = (-20.0, 20.0),
    translate: Tuple[float, float] = (0.3, 0.3),
    affine_scale: Tuple[float, float] = (0.8, 1.2),
    blur_sigma: Tuple[float, float] = (0.1, 2.0),
    hflip_prob: float = 0.5,
    color_jitter: Optional[Tuple[float, float, float, float]] = None,
    color_jitter_prob: float = 0.0,
    gray_scale_prob: float = 0.0,
) -> AugmentDraws:
    """Draw one batch's augmentation parameters from `generator`, on its
    device: the resized crop (area fraction in `crop_scale`, log aspect in
    log `ratio`, the corner), the affine (angle in `degrees`, shift within
    `translate`, scale in `affine_scale`), the flip, the blur sigma and the
    colour extras."""
    g = generator

    def u(lo, hi):
        return _uniform(n, lo, hi, g)

    crop = torch.stack([u(*crop_scale), u(float(np.log(ratio[0])), float(np.log(ratio[1]))),
                        u(0.0, 1.0), u(0.0, 1.0)], 1)
    affine = torch.stack([u(*degrees), u(-translate[0], translate[0]),
                          u(-translate[1], translate[1]), u(*affine_scale)], 1)
    flip = torch.rand(n, generator=g, device=g.device) < hflip_prob
    draws = AugmentDraws(warp_matrices(crop, affine, flip, in_hw, out_size), u(*blur_sigma))
    if color_jitter_prob and color_jitter is not None:
        draws.jitter, draws.jitter_apply = _draw_jitter(n, g, tuple(color_jitter),
                                                        color_jitter_prob)
    if gray_scale_prob:
        draws.gray = torch.rand(n, generator=g, device=g.device) < gray_scale_prob
    return draws


def apply_augment(
    images: torch.Tensor,
    draws: AugmentDraws,
    *,
    out_size: Tuple[int, int] = (224, 224),
    color_jitter: Optional[Tuple[float, float, float, float]] = None,
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
    std: Tuple[float, ...] = OPENAI_DATASET_STD,
) -> torch.Tensor:
    """Apply drawn parameters: [B, H, W, C] uint8 or float -> [B, oh, ow, C]
    normalised fp32. One warp, the blur, uint8 scaled to [0, 1], the colour
    jitter (the ops of non-zero `color_jitter` strength) and greyscale where
    drawn, then (x - mean) / std. Draws nothing."""
    draws = draws.to(images.device)
    x = affine_sample(images, draws.matrices, out_size)
    x = _gaussian_blur3(x, draws.sigma)
    if images.dtype == torch.uint8:
        x = x / 255.0
    if draws.jitter is not None:
        x = _jitter_apply(x, draws.jitter, draws.jitter_apply, tuple(color_jitter))
    if draws.gray is not None:
        x = _gray_apply(x, draws.gray)
    return normalize_images(x, mean, std)


def random_augment_batch(
    images: torch.Tensor,
    generator: torch.Generator,
    *,
    out_size: Tuple[int, int] = (224, 224),
    crop_scale: Tuple[float, float] = (0.9, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    degrees: Tuple[float, float] = (-20.0, 20.0),
    translate: Tuple[float, float] = (0.3, 0.3),
    affine_scale: Tuple[float, float] = (0.8, 1.2),
    blur_sigma: Tuple[float, float] = (0.1, 2.0),
    hflip_prob: float = 0.5,
    color_jitter: Optional[Tuple[float, float, float, float]] = None,
    color_jitter_prob: float = 0.0,
    gray_scale_prob: float = 0.0,
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
    std: Tuple[float, ...] = OPENAI_DATASET_STD,
) -> torch.Tensor:
    """The MR-CLIP train augmentation on the card: [B, H, W, C] uint8 (or
    float) -> [B, oh, ow, C] normalised fp32, `draw_augment` from
    `generator`, then `apply_augment`."""
    draws = draw_augment(
        images.shape[0], tuple(images.shape[1:3]), generator, out_size=out_size,
        crop_scale=crop_scale, ratio=ratio, degrees=degrees, translate=translate,
        affine_scale=affine_scale, blur_sigma=blur_sigma, hflip_prob=hflip_prob,
        color_jitter=color_jitter, color_jitter_prob=color_jitter_prob,
        gray_scale_prob=gray_scale_prob)
    return apply_augment(images, draws, out_size=out_size, color_jitter=color_jitter,
                         mean=mean, std=std)
