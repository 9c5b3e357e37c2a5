"""Host-side image preprocessing + transform config surface of the port
(counterpart of `mrclip_tpu/transforms.py`), with no PIL.

- `PreprocessCfg` / `AugmentationCfg`, their merge helpers,
  `validate_aug_cfg`, `image_transform` and `image_transform_v2` as in the
  JAX package;
- `EvalTransform`: resize (`shortest`, `longest` or `squash`), the
  pad-then-crop centre crop with `fill_color`, to RGB, normalise;
- `TrainTransform`: the MR-CLIP chain, random resized crop (a `box=` resize)
  -> to RGB -> random affine (the inverse warp) -> 3 x 3 Gaussian kernel ->
  horizontal flip -> optional colour jitter and greyscale -> normalise,
  drawing from Python's global `random` in the JAX package's order and
  number, so a seeded run sees the same boxes, angles and flips.

Images come in as uint8 numpy arrays [H, W] or [H, W, C] (or CPU uint8
tensors), as `data/png.read_png` gives them, and go out as float32 [H, W, 3]
(NHWC). The pixel operations are `host_image`'s, PIL's arithmetic written
anew: on the same uint8 input both transforms give the JAX package's bits.
An alpha channel is dropped before resizing, where PIL premultiplies it:
the same pixels wherever alpha is 255. 'nearest' interpolation raises.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from . import host_image as hi
from .constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

@dataclass
class PreprocessCfg:
    """Preprocessing config (reference transform.py:16-58)."""

    size: Union[int, Tuple[int, int]] = 224
    mode: str = "RGB"
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0

    @property
    def num_channels(self) -> int:
        return 3

    @property
    def input_size(self) -> Tuple[int, int, int]:
        if isinstance(self.size, (tuple, list)):
            return (self.num_channels,) + tuple(self.size)
        return (self.num_channels, self.size, self.size)


_PREPROCESS_KEYS = {f.name for f in dataclasses.fields(PreprocessCfg)}


def merge_preprocess_dict(base: Union[PreprocessCfg, Dict], overlay: Dict) -> Dict:
    """Merge overlay into base, keeping only valid keys (reference :44-58)."""
    if isinstance(base, PreprocessCfg):
        base_clean = asdict(base)
    else:
        base_clean = {k: v for k, v in base.items() if k in _PREPROCESS_KEYS}
    if overlay:
        overlay_clean = {k: v for k, v in overlay.items() if k in _PREPROCESS_KEYS and v is not None}
        base_clean.update(overlay_clean)
    return base_clean


def merge_preprocess_kwargs(base: PreprocessCfg, **kwargs) -> PreprocessCfg:
    return PreprocessCfg(**merge_preprocess_dict(base, kwargs))


@dataclass
class AugmentationCfg:
    """Train-time augmentation knobs (reference transform.py:61-72)."""

    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[Union[float, Tuple[float, float, float], Tuple[float, float, float, float]]] = None
    re_prob: Optional[float] = None
    re_count: Optional[int] = None
    use_timm: bool = False
    color_jitter_prob: Optional[float] = None
    gray_scale_prob: Optional[float] = None


def _to_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


_INTERP = {"bicubic": hi.BICUBIC, "bilinear": hi.BILINEAR, "random": hi.BICUBIC}


def _interp(name: str) -> str:
    if name == "nearest":
        raise NotImplementedError(
            "interpolation 'nearest' is not ported: the port reproduces PIL's bicubic and "
            "bilinear resampling (ROADMAP: modules item 3, data and the training CLI)")
    return _INTERP.get(name, hi.BICUBIC)


def _as_array(img) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] (grey or RGB; alpha dropped)."""
    a = img.numpy() if hasattr(img, "numpy") else np.asarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"transforms take uint8 images, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] in (1, 2):
        return a[:, :, 0]
    if a.ndim == 3 and a.shape[2] == 4:
        return a[:, :, :3]
    return a


def _size(img: np.ndarray) -> Tuple[int, int]:
    """(width, height), as PIL's `img.size`."""
    return img.shape[1], img.shape[0]


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    arr = arr.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _resize_shortest(img: np.ndarray, size: Tuple[int, int], interp) -> np.ndarray:
    """torchvision Resize(int) semantics: shortest edge to `size`."""
    target = size[0]
    w, h = _size(img)
    short, long = (w, h) if w <= h else (h, w)
    if short == target:
        return img
    new_short = target
    new_long = int(round(target * long / short))
    nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
    return hi.resize(img, (nw, nh), interp)


def _resize_longest(img: np.ndarray, size: Tuple[int, int], interp) -> np.ndarray:
    """ResizeKeepRatio(longest=1): longest edge to target."""
    w, h = _size(img)
    scale = min(size[1] / w, size[0] / h)
    return hi.resize(img, (int(round(w * scale)), int(round(h * scale))), interp)


class EvalTransform:
    """Deterministic eval preprocessing."""

    def __init__(self, cfg: PreprocessCfg):
        self.cfg = cfg
        self.size = _to_2tuple(cfg.size)
        self.interp = _interp(cfg.interpolation)

    def __call__(self, img) -> np.ndarray:
        cfg = self.cfg
        img = _as_array(img)
        if cfg.resize_mode == "longest":
            img = _resize_longest(img, self.size, self.interp)
            img = hi.pad_crop(img, self.size, cfg.fill_color)
        elif cfg.resize_mode == "squash":
            img = hi.resize(img, (self.size[1], self.size[0]), self.interp)
        else:  # shortest
            img = _resize_shortest(img, self.size, self.interp)
            img = hi.pad_crop(img, self.size, cfg.fill_color)
        return _normalize(hi.to_rgb(img), cfg.mean, cfg.std)


def _adjust_hue(img: np.ndarray, hue_factor: float) -> np.ndarray:
    """torchvision F.adjust_hue PIL semantics: shift H in HSV space by
    hue_factor (in turns, |h| <= 0.5), uint8 wraparound; grey is unchanged."""
    if abs(hue_factor) > 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    if img.ndim == 2:
        return img
    hsv = hi.rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(round(hue_factor * 255))).astype(np.uint8)
    return hi.hsv_to_rgb(hsv)


class ColorJitter:
    """torchvision ColorJitter with PIL's ImageEnhance arithmetic:
    brightness/contrast/saturation: scalar b -> factor ~ U[max(0,1-b), 1+b];
    hue: scalar h -> shift ~ U[-h, h]. The four ops run in a random order per
    call, like torchvision's randperm(4); each draws its factor whether or not
    it changes a grey image."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0, p=0.8):
        assert 0.0 <= p <= 1.0
        self.p = p
        self.brightness = self._range(brightness, "brightness")
        self.contrast = self._range(contrast, "contrast")
        self.saturation = self._range(saturation, "saturation")
        self.hue = self._range(hue, "hue", center=0.0, bound=0.5)

    @staticmethod
    def _range(value, name, center=1.0, bound=float("inf")):
        if value is None:
            return None
        if isinstance(value, (tuple, list)):
            lo, hi_ = float(value[0]), float(value[1])
        else:
            value = float(value)
            lo, hi_ = center - value, center + value
            lo = max(lo, 0.0 if center == 1.0 else -bound)
        if lo == hi_ == center:
            return None
        return (max(lo, -bound), min(hi_, bound))

    def _jitter(self, img: np.ndarray) -> np.ndarray:
        ops = list(range(4))
        random.shuffle(ops)
        for idx in ops:
            if idx == 0 and self.brightness:
                img = hi.blend(np.zeros_like(img), img, random.uniform(*self.brightness))
            elif idx == 1 and self.contrast:
                img = hi.blend(np.full_like(img, hi.mean_grey(img)), img,
                               random.uniform(*self.contrast))
            elif idx == 2 and self.saturation:
                factor = random.uniform(*self.saturation)
                if img.ndim == 3:  # a grey image's own grey: unchanged
                    img = hi.blend(hi.to_rgb(hi.to_grey(img)), img, factor)
            elif idx == 3 and self.hue:
                img = _adjust_hue(img, random.uniform(*self.hue))
        return img

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if random.random() < self.p:
            return self._jitter(img)
        return img


def _gaussian_blur3(img: np.ndarray, sigma: float) -> np.ndarray:
    """torchvision GaussianBlur(kernel_size=3, sigma) as the JAX package
    applies it: PIL's Kernel filter with the exact 3-tap weights
    (w = exp(-0.5/sigma^2), normalized), PIL's border rule (the outer rows
    and columns copied)."""
    w = float(np.exp(-0.5 / (sigma * sigma)))
    k1 = np.array([w, 1.0, w]) / (1.0 + 2.0 * w)
    k2 = np.outer(k1, k1).reshape(-1)
    return hi.filter3x3(img, tuple(k2))


def validate_aug_cfg(aug: AugmentationCfg, backend: str = "host") -> None:
    """Reject unusable augmentation requests loudly instead of silently
    dropping them (reference warns for non-timm leftovers, transform.py:363).

    backend: 'host' (TrainTransform), 'device' (random_augment_batch),
    'native' (C++ loader — geometry/blur only, no color extras).
    """
    if aug.use_timm:
        raise NotImplementedError(
            "aug_cfg use_timm=True requests the timm training pipeline "
            "(reference transform.py:310-332); timm is not available in this "
            "build — use the native MR-CLIP chain (drop use_timm)."
        )
    if aug.re_prob or aug.re_count:
        raise NotImplementedError(
            "aug_cfg re_prob/re_count (random erasing) are timm-pipeline-only "
            "knobs in the reference (transform.py:61-72) and are not applied "
            "by the MR-CLIP chain; remove them or implement random erasing."
        )
    if aug.color_jitter_prob:
        if aug.color_jitter is None or (
            isinstance(aug.color_jitter, (tuple, list)) and len(aug.color_jitter) != 4
        ) or not isinstance(aug.color_jitter, (tuple, list)):
            raise ValueError(
                "color_jitter_prob requires color_jitter=(brightness, contrast, "
                "saturation, hue) 4-tuple (reference transform.py:349-352)"
            )
    elif aug.color_jitter is not None:
        raise ValueError(
            "aug_cfg color_jitter without color_jitter_prob is only consumed "
            "by the timm pipeline (unavailable); set color_jitter_prob to "
            "apply jitter in the MR-CLIP chain (reference transform.py:349-352)"
        )
    # All three backends (host, device XLA, native C++) implement the
    # color extras; nothing further to gate per-backend.


class TrainTransform:
    """MR-CLIP train augmentation chain, host backend. Per-sample numpy ops;
    a grey image stays one channel until the end (every op acts on each
    channel alone, and saturation, hue and greyscale leave grey as it is)."""

    def __init__(self, cfg: PreprocessCfg, aug: Optional[AugmentationCfg] = None):
        self.cfg = cfg
        self.aug = aug or AugmentationCfg()
        validate_aug_cfg(self.aug, backend="host")
        self.size = _to_2tuple(cfg.size)
        self.interp = _interp(cfg.interpolation)
        self.color_jitter = None
        if self.aug.color_jitter_prob:
            self.color_jitter = ColorJitter(
                *self.aug.color_jitter, p=self.aug.color_jitter_prob
            )

    def _random_resized_crop(self, img: np.ndarray) -> np.ndarray:
        scale = self.aug.scale or (0.9, 1.0)
        ratio = self.aug.ratio or (3.0 / 4.0, 4.0 / 3.0)
        w, h = _size(img)
        area = w * h
        for _ in range(10):
            target_area = area * random.uniform(*scale)
            aspect = np.exp(random.uniform(np.log(ratio[0]), np.log(ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = random.randint(0, w - cw)
                y0 = random.randint(0, h - ch)
                box = (x0, y0, x0 + cw, y0 + ch)
                return hi.resize(img, (self.size[1], self.size[0]), self.interp, box=box)
        # fallback: center crop to in-range aspect
        img = hi.pad_crop(img, (min(h, w), min(h, w)))
        return hi.resize(img, (self.size[1], self.size[0]), self.interp)

    def _random_affine(self, img: np.ndarray) -> np.ndarray:
        width, height = _size(img)
        angle = random.uniform(-20.0, 20.0)
        tx = random.uniform(-0.3, 0.3) * width
        ty = random.uniform(-0.3, 0.3) * height
        s = random.uniform(0.8, 1.2)
        cx, cy = width * 0.5, height * 0.5
        a = np.deg2rad(angle)
        cos, sin = np.cos(a) / s, np.sin(a) / s
        # the inverse (output -> input) 6-tuple
        ox = cx - cos * (cx + tx) - sin * (cy + ty)
        oy = cy + sin * (cx + tx) - cos * (cy + ty)
        return hi.affine(img, (cos, sin, ox, -sin, cos, oy), self.interp)

    def __call__(self, img) -> np.ndarray:
        img = self._random_resized_crop(_as_array(img))
        img = self._random_affine(img)
        img = _gaussian_blur3(img, random.uniform(0.1, 2.0))
        if random.random() < 0.5:
            img = hi.flip_left_right(img)
        # Optional extras AFTER flip, in the reference's order.
        if self.color_jitter is not None:
            img = self.color_jitter(img)
        if self.aug.gray_scale_prob and random.random() < self.aug.gray_scale_prob:
            img = hi.to_grey(img)
        return _normalize(hi.to_rgb(img), self.cfg.mean, self.cfg.std)


def image_transform(
    image_size: Union[int, Tuple[int, int]],
    is_train: bool,
    mean: Optional[Tuple[float, ...]] = None,
    std: Optional[Tuple[float, ...]] = None,
    resize_mode: Optional[str] = None,
    interpolation: Optional[str] = None,
    fill_color: int = 0,
    aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
):
    """Reference `image_transform` API (transform.py:274-397)."""
    cfg = PreprocessCfg(
        size=image_size,
        mean=mean or OPENAI_DATASET_MEAN,
        std=std or OPENAI_DATASET_STD,
        interpolation=interpolation or "bicubic",
        resize_mode=resize_mode or "shortest",
        fill_color=fill_color,
    )
    if is_train:
        if isinstance(aug_cfg, dict):
            aug_cfg = AugmentationCfg(**aug_cfg)
        return TrainTransform(cfg, aug_cfg)
    return EvalTransform(cfg)


def image_transform_v2(
    cfg: PreprocessCfg,
    is_train: bool,
    aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
):
    """Reference `image_transform_v2` (transform.py:400-414)."""
    return image_transform(
        image_size=cfg.size,
        is_train=is_train,
        mean=cfg.mean,
        std=cfg.std,
        interpolation=cfg.interpolation,
        resize_mode=cfg.resize_mode,
        fill_color=cfg.fill_color,
        aug_cfg=aug_cfg,
    )
