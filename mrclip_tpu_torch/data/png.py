"""The port's PNG codec: 8-bit grey, grey + alpha, RGB and RGBA, not
interlaced (what MRI slices and their pipeline use), with no PIL.

`read_png` inflates with Python's `zlib` and undoes the five row filters.
None, Sub and Up are vectorised in numpy; Average and Paeth read the pixel
to the left after its reconstruction, so a row is a sequential scan. Where
`nvcc` is found (the card's machine) the whole unfilter runs in a small host
C function built from `csrc/png_unfilter.cu` into the kernels' build
directory; elsewhere those two filters run row by row in Python.
`unfilter_backend()` says which. Both give the same bytes.

`write_png` filters each row with the filter whose output has the least sum
of absolute values (libpng's heuristic; PIL's encoder picks per row as
well) and deflates at level 6. The bytes differ from PIL's; the pixels
read back are the array written.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional, Union

import numpy as np

__all__ = ["read_png", "write_png", "parse_png", "unfilter", "unfilter_backend"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}

_lib_lock = threading.Lock()
_lib: Optional[object] = None
_backend: Optional[str] = None


def _load_unfilter():
    """The compiled unfilter when `nvcc` is found, else None (numpy)."""
    global _lib, _backend
    with _lib_lock:
        if _backend is None:
            from ..ops import build

            try:
                build._find_nvcc()
            except RuntimeError:
                _backend = "numpy"
            else:
                lib = build.load_library("png_unfilter")
                fn = lib.png_unfilter
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int]
                fn.restype = ctypes.c_int
                _lib, _backend = fn, "compiled"
    return _lib


def unfilter_backend() -> str:
    """'compiled' (the host C unfilter) or 'numpy'."""
    _load_unfilter()
    return _backend


def _unfilter_numpy(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, rowbytes + 1)
    types = rows[:, 0]
    data = rows[:, 1:]
    out = np.empty((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        t, f = int(types[y]), data[y]
        if t == 0:
            out[y] = f
        elif t == 1:  # Sub: a running sum per channel, mod 256
            out[y] = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif t == 2:
            out[y] = f + prev
        elif t in (3, 4):
            out[y] = _scan_row(f.tolist(), prev.tolist(), bpp, t)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {t}")
        prev = out[y]
    return out


def _scan_row(f: list, b: list, bpp: int, t: int) -> list:
    o = [0] * len(f)
    if t == 3:  # Average
        for i in range(len(f)):
            a = o[i - bpp] if i >= bpp else 0
            o[i] = (f[i] + ((a + b[i]) >> 1)) & 255
        return o
    for i in range(len(f)):  # Paeth
        if i >= bpp:
            a, c = o[i - bpp], b[i - bpp]
        else:
            a = c = 0
        up = b[i]
        pa = abs(up - c)
        pb = abs(a - c)
        pc = abs(a + up - 2 * c)
        pred = a if (pa <= pb and pa <= pc) else (up if pb <= pc else c)
        o[i] = (f[i] + pred) & 255
    return o


def unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Reconstructed [height, rowbytes] bytes of filtered rows `raw`."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size != height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {buf.size} bytes, expected "
                         f"{height * (rowbytes + 1)}")
    fn = _load_unfilter()
    if fn is None:
        return _unfilter_numpy(buf, height, rowbytes, bpp)
    buf = np.ascontiguousarray(buf)
    out = np.empty((height, rowbytes), np.uint8)
    bad = fn(buf.ctypes.data, out.ctypes.data, height, rowbytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has unknown filter type {buf[(bad - 1) * (rowbytes + 1)]}")
    return out


def parse_png(data: bytes):
    """(filtered image bytes, height, width, samples per pixel) of a PNG's
    bytes, checked to be a format `read_png` takes."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG bit depth {depth}, colour type {colour}, interlace {interlace}: the port reads "
            "8-bit grey, grey + alpha, RGB and RGBA without interlacing")
    return zlib.decompress(b"".join(idat)), height, width, _CHANNELS[colour]


def read_png(src: Union[str, os.PathLike, bytes]) -> np.ndarray:
    """uint8 [H, W] (grey) or [H, W, C] (grey + alpha, RGB, RGBA), as
    `np.asarray(PIL.Image.open(src))` gives them."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    raw, height, width, ch = parse_png(data)
    out = unfilter(raw, height, width * ch, ch)
    return out.reshape(height, width) if ch == 1 else out.reshape(height, width, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(x: np.ndarray, bpp: int) -> np.ndarray:
    """Each row of uint8 [H, R] under the filter (0-4) with the least sum of
    absolute values (bytes read as signed), type byte first: [H, 1 + R]."""
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]).astype(np.uint8)
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)  # [5, H]
    best = cost.argmin(axis=0)
    rows = cands[best, np.arange(x.shape[0])]
    return np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1)


def write_png(path: Union[str, os.PathLike], array: np.ndarray, compress_level: int = 6) -> None:
    """Write uint8 [H, W] (grey) or [H, W, C] with C in 1-4 as a PNG."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in _COLOUR_TYPE or 0 in a.shape:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4], got {array.shape}")
    h, w, ch = a.shape
    rows = _filter_rows(np.ascontiguousarray(a).reshape(h, w * ch), ch)
    png = (_SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), compress_level))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
