"""The native data-path library of the port (counterpart of
`mrclip_tpu/native.py`): threaded PNG decode, PIL-equivalent antialiased
resize, and the MR-CLIP train warp, 3x3 blur and colour jitter, in C++ with
no GIL and no Python per image.

The C++ is the port's own copy of `native/png_decode.cc` and
`native/loader.cc` (`native_src/`, byte-identical), built at first use by
`ops/build.load_host_library` with the system C++ compiler (`-O3`, no
`-march=native`), zlib and pthreads into the kernels' build directory. There
is no fallback: when the library cannot be built or loaded,
`native_available()` is False and every function that needs it raises the
build's error. `augment_matrices` and `color_jitter_params` are the JAX
package's numpy code on a `np.random.RandomState`, so one seed gives the
same matrices and colour parameters bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["native_available", "load_batch", "decode_png", "augment_batch", "augment_matrices",
           "color_jitter_params", "png_size", "library"]

_SOURCES = ("png_decode.cc", "loader.cc")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[BaseException] = None

_P_U8 = ctypes.POINTER(ctypes.c_uint8)
_P_INT = ctypes.POINTER(ctypes.c_int)
_P_F32 = ctypes.POINTER(ctypes.c_float)


def library() -> ctypes.CDLL:
    """The built and loaded library (built once per process; a failed build
    raises again on every call, never falls back)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            from .ops import build

            try:
                lib = build.load_host_library(
                    "mrclip_native", [build.NATIVE_SRC / s for s in _SOURCES])
            except (RuntimeError, OSError) as e:
                _error = e
            else:
                lib.mrclip_png_decode.argtypes = [_P_U8, ctypes.c_long, _P_U8, ctypes.c_long,
                                                  ctypes.c_int, _P_INT, _P_INT]
                lib.mrclip_png_decode.restype = ctypes.c_int
                lib.mrclip_load_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _P_U8, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P_INT]
                lib.mrclip_load_batch.restype = None
                lib.mrclip_augment_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _P_U8, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, _P_F32, _P_F32, _P_F32, ctypes.c_int, _P_INT]
                lib.mrclip_augment_batch.restype = None
                _lib = lib
        if _error is not None:
            raise RuntimeError(f"the native data-path library is not available: {_error}")
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def _check_channels(channels: int) -> None:
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")


def decode_png(data: bytes, channels: int = 3) -> Optional[np.ndarray]:
    """Decode PNG bytes (8-bit grey, grey + alpha, RGB or RGBA) into
    [H, W, channels] uint8; None when the bytes do not decode."""
    lib = library()
    _check_channels(channels)
    buf = np.frombuffer(data, np.uint8)
    # the output holds the IHDR's size, at most 8192 x 8192 pixels as the
    # loaders allow (the decoder refuses a header that claims more than the
    # capacity)
    w = int.from_bytes(data[16:20], "big") if len(data) >= 24 else 0
    h = int.from_bytes(data[20:24], "big") if len(data) >= 24 else 0
    out = np.empty((min(w * h, 8192 * 8192) * channels,), np.uint8)
    cw, ch = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.mrclip_png_decode(buf.ctypes.data_as(_P_U8), len(data), out.ctypes.data_as(_P_U8),
                               out.size, channels, ctypes.byref(cw), ctypes.byref(ch))
    if rc != 0:
        return None
    return out[: ch.value * cw.value * channels].reshape(ch.value, cw.value, channels)


# transforms.EvalTransform's resize_mode -> the C enum
_RESIZE_MODES = {"squash": 0, "cover": 1, "shortest": 1, "contain": 2, "longest": 2}
_INTERP = {"bilinear": 0, "bicubic": 1}


def _c_paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def load_batch(
    paths: List[str],
    out_size: Tuple[int, int],
    channels: int = 3,
    num_threads: int = 0,
    resize_mode: str = "squash",
    interpolation: str = "bicubic",
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode and resize PNGs into [N, H, W, C] uint8 on `num_threads`
    threads (0: every core).

    `resize_mode`: 'squash' stretches to the canvas; 'shortest'/'cover'
    resizes the shortest edge and crops the centre (EvalTransform's
    geometry); 'longest'/'contain' fits and zero-pads. `interpolation`:
    'bicubic' or 'bilinear', PIL's antialiased resamplers.

    Returns (batch, status): status[i] is 0 on success, else the decoder's
    error code, and that row is zero.
    """
    lib = library()
    _check_channels(channels)
    n = len(paths)
    oh, ow = out_size
    out = np.zeros((n, oh, ow, channels), np.uint8)
    status = np.zeros((n,), np.int32)
    if n:
        lib.mrclip_load_batch(_c_paths(paths), n, out.ctypes.data_as(_P_U8), oh, ow, channels,
                              _RESIZE_MODES[resize_mode], _INTERP[interpolation], num_threads,
                              status.ctypes.data_as(_P_INT))
    return out, status


def png_size(path) -> Optional[tuple]:
    """(width, height) from a PNG's IHDR without decoding, or None. Lets
    the resized crop be sampled in pixel space for non-square sources."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
    except OSError:
        return None
    if len(head) == 24 and head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        w = int.from_bytes(head[16:20], "big")
        h = int.from_bytes(head[20:24], "big")
        if w > 0 and h > 0:
            return (w, h)
    return None


def augment_matrices(
    rng: np.random.RandomState,
    n: int,
    crop_scale=(0.9, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
    degrees=(-20.0, 20.0),
    translate=(0.3, 0.3),
    affine_scale=(0.8, 1.2),
    hflip_prob: float = 0.5,
    src_sizes: Optional[list] = None,
) -> np.ndarray:
    """Per-image output->input affine matrices in normalized [0,1] coords.

    Composes the MR-CLIP chain (RandomResizedCrop -> RandomAffine -> flip)
    into one 2x3 matrix per image, consumed by the native warp
    (`mrclip_augment_batch`). Rows: (a, b, tx, c, d, ty) with
    src_x = a*x + b*y + tx, src_y = c*x + d*y + ty.

    `src_sizes`: optional per-image (width, height) of the DECODED source
    (``png_size``). When given, the resized-crop box is sampled in pixel
    space with torchvision's 10-attempt loop, as the host TrainTransform
    samples it, so the aspect-ratio range is absolute. Without it the box
    is sampled in [0,1] coords, where `ratio` is relative to the source's
    own aspect.
    """
    out = np.empty((n, 6), np.float32)
    for i in range(n):
        # RandomAffine (output->crop space), rotation about center
        theta = np.deg2rad(rng.uniform(*degrees))
        s = rng.uniform(*affine_scale)
        tx = rng.uniform(-translate[0], translate[0])
        ty = rng.uniform(-translate[1], translate[1])
        cos, sin = np.cos(theta) / s, np.sin(theta) / s
        m_aff = np.array([[cos, sin], [-sin, cos]], np.float64)
        c = np.array([0.5, 0.5])
        off_aff = c - m_aff @ (c + np.array([tx, ty]))

        # flip in output space
        if rng.rand() < hflip_prob:
            m_flip = np.array([[-1.0, 0.0], [0.0, 1.0]])
            off_flip = np.array([1.0, 0.0])
        else:
            m_flip = np.eye(2)
            off_flip = np.zeros(2)

        # RandomResizedCrop (crop space -> input space)
        size = src_sizes[i] if src_sizes is not None else None
        if size is not None:
            # pixel-space sampling (torchvision RandomResizedCrop, as
            # transforms.TrainTransform._random_resized_crop samples it)
            sw, sh = size
            for _ in range(10):
                target_area = sw * sh * rng.uniform(*crop_scale)
                aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
                cw_px = int(round(np.sqrt(target_area * aspect)))
                ch_px = int(round(np.sqrt(target_area / aspect)))
                if 0 < cw_px <= sw and 0 < ch_px <= sh:
                    x0_px = rng.randint(0, sw - cw_px + 1)
                    y0_px = rng.randint(0, sh - ch_px + 1)
                    break
            else:  # fallback: centered min-square (host fallback semantics)
                cw_px = ch_px = min(sw, sh)
                x0_px, y0_px = (sw - cw_px) // 2, (sh - ch_px) // 2
            cw, ch = cw_px / sw, ch_px / sh
            x0, y0 = x0_px / sw, y0_px / sh
        else:
            # normalized box (source size unknown; ratio is source-relative)
            area = rng.uniform(*crop_scale)
            aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
            cw = min(1.0, np.sqrt(area * aspect))
            ch = min(1.0, np.sqrt(area / aspect))
            x0 = rng.uniform(0.0, 1.0 - cw) if cw < 1.0 else 0.0
            y0 = rng.uniform(0.0, 1.0 - ch) if ch < 1.0 else 0.0
        m_crop = np.diag([cw, ch])
        off_crop = np.array([x0, y0])

        # total: p_in = crop(aff(flip(p_out)))
        m = m_crop @ m_aff @ m_flip
        off = m_crop @ (m_aff @ off_flip + off_aff) + off_crop
        out[i] = [m[0, 0], m[0, 1], off[0], m[1, 0], m[1, 1], off[1]]
    return out


def color_jitter_params(
    rng: np.random.RandomState,
    n: int,
    color_jitter=None,
    color_jitter_prob: float = 0.0,
    gray_scale_prob: float = 0.0,
) -> Optional[np.ndarray]:
    """Per-image color params [n, 6] for the native warp:
    (brightness, contrast, saturation, hue_shift, apply_jitter, apply_gray).
    torchvision factor draws: f ~ U[max(0,1-s), 1+s]; hue ~ U[-h, h].
    Returns None when no color extras are requested."""
    if not color_jitter_prob and not gray_scale_prob:
        return None
    out = np.zeros((n, 6), np.float32)
    out[:, :3] = 1.0
    if color_jitter_prob and color_jitter is not None:
        b, c, s, h = color_jitter
        for j, strength in enumerate((b, c, s)):
            out[:, j] = rng.uniform(max(0.0, 1.0 - strength), 1.0 + strength, n)
        out[:, 3] = rng.uniform(-h, h, n)
        out[:, 4] = rng.rand(n) < color_jitter_prob
    if gray_scale_prob:
        out[:, 5] = rng.rand(n) < gray_scale_prob
    return out


def augment_batch(
    paths: List[str],
    out_size: Tuple[int, int],
    matrices: np.ndarray,
    blur_sigmas: Optional[np.ndarray] = None,
    color_params: Optional[np.ndarray] = None,
    channels: int = 3,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, warp by `matrices` [N, 6] (`augment_matrices`), blur by
    `blur_sigmas` [N] (0: none) and, given `color_params` [N, 6]
    (`color_jitter_params`), jitter colours and turn grey, into
    [N, H, W, C] uint8 on `num_threads` threads (0: every core). Returns
    (batch, status) as `load_batch` does."""
    lib = library()
    _check_channels(channels)
    n = len(paths)
    oh, ow = out_size
    out = np.zeros((n, oh, ow, channels), np.uint8)
    status = np.zeros((n,), np.int32)
    matrices = np.ascontiguousarray(matrices, np.float32)
    if blur_sigmas is None:
        blur_sigmas = np.zeros((n,), np.float32)
    blur_sigmas = np.ascontiguousarray(blur_sigmas, np.float32)
    if matrices.shape != (n, 6) or blur_sigmas.shape != (n,):
        raise ValueError(f"{n} paths need matrices [{n}, 6] and blur_sigmas [{n}], got "
                         f"{matrices.shape} and {blur_sigmas.shape}")
    cp_ptr = None
    if color_params is not None:
        color_params = np.ascontiguousarray(color_params, np.float32)
        if color_params.shape != (n, 6):
            raise ValueError(f"color_params must be [{n}, 6], got {color_params.shape}")
        cp_ptr = color_params.ctypes.data_as(_P_F32)
    if n:
        lib.mrclip_augment_batch(_c_paths(paths), n, out.ctypes.data_as(_P_U8), oh, ow, channels,
                                 matrices.ctypes.data_as(_P_F32),
                                 blur_sigmas.ctypes.data_as(_P_F32), cp_ptr, num_threads,
                                 status.ctypes.data_as(_P_INT))
    return out, status
