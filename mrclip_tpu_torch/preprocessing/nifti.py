"""NIfTI-1 volume reading + slice extraction (pure numpy, no nibabel).

Capability parity with reference `preprocessing.py` step 1:
- `determine_plane` (:52-80): argmax over pixdim[1:4] -> sagittal/coronal/axial,
- `process_nifti` (:83-114): min-max normalize the volume to uint8, transpose
  per plane, save nonzero slices (>40 px sides) as
  `{name}_{plane}_slice{i}.png`.

The NIfTI-1 format (348-byte header + Fortran-ordered voxels, optional gzip)
is parsed directly, and `write_nifti` writes it. This is the port's copy of
`mrclip_tpu/preprocessing/nifti.py`: slices go out through the port's own
PNG writer (`data/png.write_png`) in place of PIL; the pixels are the same,
the PNG bytes are not.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from ..data.png import write_png

__all__ = ["read_nifti", "write_nifti", "nifti_pixdim", "determine_plane", "volume_to_slices",
           "process_nifti"]

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _parse_header(raw: bytes) -> Tuple[dict, str]:
    """Parse the NIfTI-1 348-byte header; returns (fields, endianness)."""
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    endian = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1 file (sizeof_hdr != 348)")
        endian = ">"

    dim = struct.unpack_from(endian + "8h", raw, 40)
    (datatype,) = struct.unpack_from(endian + "h", raw, 70)
    (bitpix,) = struct.unpack_from(endian + "h", raw, 72)
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", raw, 108)
    (scl_slope,) = struct.unpack_from(endian + "f", raw, 112)
    (scl_inter,) = struct.unpack_from(endian + "f", raw, 116)
    magic = raw[344:348]
    if not (magic.startswith(b"n+1") or magic.startswith(b"ni1")):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    return (
        {
            "dim": dim,
            "datatype": datatype,
            "bitpix": bitpix,
            "pixdim": pixdim,
            "vox_offset": int(vox_offset) or 352,
            "scl_slope": scl_slope,
            "scl_inter": scl_inter,
        },
        endian,
    )


def read_nifti(path: str) -> Tuple[np.ndarray, dict]:
    """Load a .nii/.nii.gz volume -> (float data [X,Y,Z,...], header dict)."""
    raw = _read_bytes(path)
    hdr, endian = _parse_header(raw)
    ndim = hdr["dim"][0]
    shape = tuple(max(1, d) for d in hdr["dim"][1 : 1 + ndim])
    dtype = np.dtype(_DTYPES.get(hdr["datatype"], np.float32)).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=hdr["vox_offset"])
    data = data.reshape(shape, order="F").astype(np.float64)
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        if slope == 0.0:
            slope = 1.0
        data = data * slope + inter
    return data, hdr


_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_nifti(path: str, data: np.ndarray, pixdim=(1.0, 1.0, 1.0)) -> None:
    """Write `data` (up to 7 dimensions, a dtype of the table above) as a
    single-file NIfTI-1 (`n+1`, little-endian, voxels at offset 352), gzipped
    when `path` ends in `.gz`."""
    data = np.asarray(data)
    code = _CODES.get(data.dtype.newbyteorder("="))
    if code is None:
        raise TypeError(f"write_nifti: no NIfTI-1 datatype for {data.dtype}")
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, data.ndim, *data.shape, *[1] * (7 - data.ndim))
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *pixdim, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope: stored values as they are
    hdr[344:348] = b"n+1\x00"
    blob = bytes(hdr) + data.astype(data.dtype.newbyteorder("<")).tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(blob)


def nifti_pixdim(path: str) -> Tuple[float, float, float]:
    raw = _read_bytes(path)[:352]
    hdr, _ = _parse_header(raw)
    return hdr["pixdim"][1:4]


def determine_plane(nifti_path: str) -> str:
    """Plane from the largest voxel dimension (reference :52-80)."""
    try:
        px = nifti_pixdim(nifti_path)
        index = int(np.argmax([0.0, px[0], px[1], px[2]]))
        return {1: "sagittal", 2: "coronal", 3: "axial"}.get(index, "axial")
    except Exception as e:
        print(f"Error reading {nifti_path}: {e}")
        return "axial"


def volume_to_slices(data: np.ndarray, plane: str) -> np.ndarray:
    """Min-max -> uint8, transpose so slices stack on the last axis
    (reference :97-106)."""
    span = data.max() - data.min()
    norm = (data - data.min()) / (span if span else 1.0) * 255
    norm = norm.astype(np.uint8)
    if norm.ndim > 3:
        norm = norm[..., 0]
    if plane == "coronal":
        norm = np.transpose(norm, (0, 2, 1))
    elif plane == "sagittal":
        norm = np.transpose(norm, (1, 2, 0))
    return norm


def process_nifti(nifti_path: str, output_dir: str, plane: Optional[str] = None) -> int:
    """Volume -> per-slice PNGs; returns the number of slices written."""
    plane = plane or determine_plane(nifti_path)
    data, _ = read_nifti(nifti_path)
    volume = volume_to_slices(data, plane)
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.basename(nifti_path).replace(".nii", "").replace(".gz", "")
    written = 0
    if volume.shape[0] <= 40 or volume.shape[1] <= 40:
        return 0
    for idx in range(volume.shape[2]):
        sl = volume[:, :, idx]
        if np.any(sl):
            write_png(os.path.join(output_dir, f"{base}_{plane}_slice{idx}.png"), sl)
            written += 1
    return written
