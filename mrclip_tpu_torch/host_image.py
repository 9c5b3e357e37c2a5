"""Host image operations on uint8 numpy arrays, with PIL's arithmetic and no
PIL: the resampling, affine warp, 3 x 3 kernel filter, blends and colour
conversions that the JAX package's transforms call on PIL images
(`mrclip_tpu/transforms.py`). Each is the algorithm of PIL's C code
(`Resample.c`, `Geometry.c`, `Filter.c`, `Blend.c`, `Convert.c`) written
anew in numpy, operation by operation in the same types (float64 where PIL
computes in double, float32 where it computes in float, int64 sums of its
fixed-point products), so that the pixels come out bit-equal.

An image is uint8 [H, W] (grey) or [H, W, C]; every operation but the
colour conversions acts on each channel alone, so a grey image stays
[H, W] until `to_rgb`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "resize", "affine", "filter3x3", "blend", "to_rgb", "to_grey", "rgb_to_hsv", "hsv_to_rgb",
    "flip_left_right", "pad_crop", "mean_grey",
]

BILINEAR, BICUBIC = "bilinear", "bicubic"

# Resample.c: 8 bits of pixel, 2 of headroom, the rest for the coefficients
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's bicubic_filter (a = -0.5), in double."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {BICUBIC: (_bicubic, 2.0), BILINEAR: (_bilinear, 1.0)}


def _coefficients(in_size: int, in0: float, in1: float, out_size: int, kind: str):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc: per output
    position the first input index, the tap count and ksize fixed-point
    weights (int64 [out, ksize], zero past the taps)."""
    fn, support = _FILTERS[kind]
    scale = float(np.float32(in1) - np.float32(in0)) / out_size  # box is float in C
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = float(np.float32(in0)) + (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # the C sums the taps one after another
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, xmax, fixed


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.right_shift(np.clip(acc, 0, (1 << _PRECISION_BITS << 8) - 1),
                          _PRECISION_BITS).astype(np.uint8)


def _pass(img: np.ndarray, axis: int, xmin, fixed) -> np.ndarray:
    """One 8-bit pass along `axis` (0 rows, 1 columns) with the rounding
    constant and the clip of ImagingResample{Horizontal,Vertical}_8bpc; the
    int32 sums of the C, tap by tap."""
    n = img.shape[axis]
    fixed = fixed.astype(np.int32)
    shape = (-1,) + (1,) * (img.ndim - 1) if axis == 0 else (1, -1) + (1,) * (img.ndim - 2)
    acc = None
    for k in range(fixed.shape[1]):
        idx = np.minimum(xmin + k, n - 1)
        term = np.take(img, idx, axis=axis).astype(np.int32) * fixed[:, k].reshape(shape)
        acc = term if acc is None else acc + term
    return _clip8(acc + (1 << (_PRECISION_BITS - 1)))


def resize(img: np.ndarray, size: Tuple[int, int], kind: str = BICUBIC,
           box: Optional[Sequence[float]] = None) -> np.ndarray:
    """`PIL.Image.resize((w, h), kind, box=box)` on uint8 [H, W(, C)]:
    the horizontal pass first (only over the rows the vertical pass reads),
    then the vertical, each rounded to 8 bits."""
    if kind not in _FILTERS:
        raise NotImplementedError(
            f"resize with {kind!r}: the port reproduces PIL's bicubic and bilinear resampling")
    h, w = img.shape[:2]
    xsize, ysize = size
    box = (0.0, 0.0, float(w), float(h)) if box is None else tuple(float(b) for b in box)
    if (xsize, ysize) == (w, h) and box == (0.0, 0.0, float(w), float(h)):
        return img.copy()
    need_h = xsize != w or box[0] != 0 or box[2] != xsize
    need_v = ysize != h or box[1] != 0 or box[3] != ysize
    xmin_h, _, fixed_h = _coefficients(w, box[0], box[2], xsize, kind)
    ymin, ymax, fixed_v = _coefficients(h, box[1], box[3], ysize, kind)
    out = img
    if need_h:
        first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
        out = _pass(img[first:last], 1, xmin_h, fixed_h)
        ymin = ymin - first
    if need_v:
        out = _pass(out, 0, ymin, fixed_v)
    return out.copy() if out is img else out


def _geometry_cubic(v1, v2, v3, v4, d):
    """Geometry.c's BICUBIC macro (a = -1), in double."""
    p1 = v2
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return p1 + d * (p2 + d * (p3 + d * p4))


def affine(img: np.ndarray, coeffs: Sequence[float], kind: str = BICUBIC) -> np.ndarray:
    """`PIL.Image.transform(img.size, Image.AFFINE, coeffs, kind)`: output
    pixel (x, y) samples the input at (a x' + b y' + c, d x' + e y' + f),
    x' = x + 0.5, with Geometry.c's bicubic (a = -1) or bilinear filter,
    edge rows and columns repeated, 0 outside the input, and the result
    truncated to 8 bits."""
    if kind not in (BICUBIC, BILINEAR):
        raise NotImplementedError(
            f"affine with {kind!r}: the port reproduces PIL's bicubic and bilinear transforms")
    a0, a1, a2, a3, a4, a5 = (float(c) for c in coeffs[:6])
    h, w = img.shape[:2]
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    xin = a0 * xs + a1 * ys + a2
    yin = a3 * xs + a4 * ys + a5
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin = xin - 0.5
    yin = yin - 0.5
    x = np.floor(xin).astype(np.int64)  # FLOOR: int() of a positive, floor of a negative
    y = np.floor(yin).astype(np.int64)
    dx = xin - x
    dy = yin - y
    dx, dy = dx.ravel(), dy.ravel()
    # edge-clamped reads: the C's XCLIP/YCLIP and its copies of the last row read
    taps = 4 if kind == BICUBIC else 2
    first = -1 if kind == BICUBIC else 0
    cols = [np.clip(x.ravel() + first + i, 0, w - 1) for i in range(taps)]
    rows = [np.clip(y.ravel() + first + j, 0, h - 1) * w for j in range(taps)]
    where = [[r + c for c in cols] for r in rows]
    chans = img.reshape(h * w, -1)
    out = np.zeros((h * w, chans.shape[1]), np.uint8)
    keep = inside.ravel()
    for ch in range(chans.shape[1]):
        flat = chans[:, ch].astype(np.int32)
        if kind == BICUBIC:
            lines = []
            for line in where:
                v1, v2, v3, v4 = (flat[i] for i in line)
                # p2..p4 are int sums in the C; p1 + d (p2 + d (p3 + d p4)) in double
                lines.append(v2 + dx * ((v3 - v1) + dx * ((2 * (v1 - v2) + v3 - v4)
                                                          + dx * (v2 - v1 - v3 + v4))))
            res = np.clip(_geometry_cubic(*lines, dy), 0.0, 255.0)
        else:
            (i00, i01), (i10, i11) = where
            top = flat[i00] + (flat[i01] - flat[i00]) * dx
            bottom = flat[i10] + (flat[i11] - flat[i10]) * dx
            res = top + (bottom - top) * dy
        out[keep, ch] = res[keep].astype(np.uint8)  # truncation of [0, 255]
    return out.reshape(img.shape)


def filter3x3(img: np.ndarray, kernel: Sequence[float]) -> np.ndarray:
    """`img.filter(ImageFilter.Kernel((3, 3), kernel, scale=1.0))`: float32
    sums in Filter.c's order (row below with the kernel's first row, then
    the centre row, then the row above, each left to right), + 0.5, truncated
    to 8 bits; the border rows and columns are copied, and an image under
    3 x 3 is returned as it is."""
    k = np.asarray(kernel, np.float64).astype(np.float32)
    h, w = img.shape[:2]
    if h < 3 or w < 3:
        return img.copy()
    src = img.astype(np.float32)

    def row(r, k3):  # KERNEL1x3 over the interior columns of the rows r
        return ((r[:, :-2] * k3[0] + r[:, 1:-1] * k3[1]) + r[:, 2:] * k3[2])

    ss = np.float32(0.5) + row(src[2:], k[0:3])
    ss = ss + row(src[1:-1], k[3:6])
    ss = ss + row(src[:-2], k[6:9])
    out = img.copy()
    out[1:-1, 1:-1] = np.where(ss <= 0.0, 0, np.where(ss >= 255.0, 255, np.trunc(ss))).astype(np.uint8)
    return out


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(im1, im2, alpha)`: im1 + alpha (im2 - im1) in float32
    (alpha is a float in Blend.c), truncated; clipped when alpha is outside
    [0, 1]."""
    a = np.float32(alpha)
    v = im1.astype(np.float32) + a * (im2.astype(np.int32) - im1.astype(np.int32)).astype(np.float32)
    if 0 <= a <= 1.0:
        return np.trunc(v).astype(np.uint8)
    return np.where(v <= 0.0, 0, np.where(v >= 255.0, 255, np.trunc(v))).astype(np.uint8)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """`convert('RGB')`: grey replicated, an alpha channel dropped."""
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[2] in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def to_grey(img: np.ndarray) -> np.ndarray:
    """`convert('L')`: ITU-R 601-2 luma in Convert.c's fixed point,
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    if img.ndim == 2:
        return img.copy()
    if img.shape[2] in (1, 2):
        return img[:, :, 0].copy()
    c = img[:, :, :3].astype(np.int64)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def mean_grey(img: np.ndarray) -> int:
    """`int(ImageStat.Stat(img.convert('L')).mean[0] + 0.5)`."""
    g = to_grey(img)
    return int(int(g.astype(np.int64).sum()) / g.size + 0.5)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """`convert('HSV')` of uint8 RGB [H, W, 3] (Convert.c's rgb2hsv_row:
    float ratios, double hue arithmetic, truncation to 8 bits)."""
    c = img[:, :, :3]
    r, g, b = (c[..., i].astype(np.int32) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(np.float32)
    s = cr / np.where(maxc == 0, 1, maxc).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / cr
    gc = (maxc - g).astype(np.float32) / cr
    bc = (maxc - b).astype(np.float32) / cr
    # bc - gc in float; 2.0 + rc - bc and 4.0 + gc - rc in double, stored as float
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, (2.0 + rc.astype(np.float64) - bc).astype(np.float32),
                          (4.0 + gc.astype(np.float64) - rc).astype(np.float32)))
    hd = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip(np.trunc(hd.astype(np.float64) * 255.0), 0, 255)
    us = np.clip(np.trunc(s.astype(np.float64) * 255.0), 0, 255)
    out = np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc], axis=-1)
    return out.astype(np.uint8)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """`convert('RGB')` of uint8 HSV [H, W, 3] (Convert.c's hsv2rgb)."""
    h, s, v = (img[..., i].astype(np.float32) for i in range(3))
    hf = h.astype(np.float64) * 6.0 / 255.0
    i = np.floor(hf).astype(np.int64)
    f = (hf - i.astype(np.float32)).astype(np.float32)
    fs = s.astype(np.float64) / 255.0
    fs = fs.astype(np.float32)
    vd = v.astype(np.float64)
    p = np.clip(np.round(vd * (1.0 - fs.astype(np.float64))), 0, 255)
    q = np.clip(np.round(vd * (1.0 - (fs * f).astype(np.float64))), 0, 255)
    t = np.clip(np.round(vd * (1.0 - fs.astype(np.float64) * (1.0 - f.astype(np.float64)))), 0, 255)
    vv = img[..., 2].astype(np.float64)
    sel = i % 6
    choices = [(vv, t, p), (q, vv, p), (p, vv, t), (p, q, vv), (t, p, vv), (vv, p, q)]
    out = np.zeros(img.shape[:2] + (3,))
    for k, (cr, cg, cb) in enumerate(choices):
        m = sel == k
        out[m, 0], out[m, 1], out[m, 2] = cr[m], cg[m], cb[m]
    grey = img[..., 1] == 0
    out[grey] = vv[grey][:, None]
    return out.astype(np.uint8)


def flip_left_right(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def pad_crop(img: np.ndarray, size: Tuple[int, int], fill: int = 0) -> np.ndarray:
    """Centre crop to (h, w), padding first with `fill` when the image is
    smaller (the JAX package's `_center_crop`: PIL's `new`, `paste` and
    `crop`). As in PIL, an int fill of a multi-channel image is a packed
    pixel: channel c gets byte c of it."""
    th, tw = size
    h, w = img.shape[:2]
    if w < tw or h < th:
        if img.ndim == 3:
            fill = [(int(fill) >> (8 * c)) & 255 for c in range(img.shape[2])]
        canvas = np.empty((max(h, th), max(w, tw)) + img.shape[2:], np.uint8)
        canvas[...] = fill
        top, left = (canvas.shape[0] - h) // 2, (canvas.shape[1] - w) // 2
        canvas[top:top + h, left:left + w] = img
        img, (h, w) = canvas, canvas.shape[:2]
    left = (w - tw) // 2
    top = (h - th) // 2
    return np.ascontiguousarray(img[top:top + th, left:left + tw])
