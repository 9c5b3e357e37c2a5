"""A synthetic MRI study on disk for smoke runs and tests: NIfTI-1 volumes
(`ur_*` series, as the slices step takes them) with BIDS JSON sidecars whose
acquisition parameters cycle through several protocols, so that the label
step finds several TE/TR/TI bins.

Each volume holds nonzero slices only at `slices` along its last axis (the
slices step skips empty ones), each a protocol-specific stripe pattern plus
noise, so that the labels are learnable from the pixels.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from .nifti import write_nifti

__all__ = ["PROTOCOLS", "write_study"]

PROTOCOLS = [
    {"EchoTime": 0.015, "RepetitionTime": 0.6, "SeriesDescription": "t1_mprage",
     "ScanningSequence": "GR", "SequenceVariant": "SP", "FlipAngle": 9},
    {"EchoTime": 0.095, "RepetitionTime": 6.0, "SeriesDescription": "t2_tse",
     "ScanningSequence": "SE", "SequenceVariant": "SK", "FlipAngle": 150},
    {"EchoTime": 0.090, "RepetitionTime": 9.0, "InversionTime": 2.5,
     "SeriesDescription": "flair", "ScanningSequence": "IR", "SequenceVariant": "MP",
     "FlipAngle": 150},
    {"EchoTime": 0.004, "RepetitionTime": 2.3, "InversionTime": 0.9,
     "SeriesDescription": "mprage", "ScanningSequence": "GR_IR", "SequenceVariant": "SP_MP",
     "FlipAngle": 8},
    {"EchoTime": 0.120, "RepetitionTime": 3.5, "SeriesDescription": "dwi",
     "ScanningSequence": "EP", "SequenceVariant": "SK_SP", "FlipAngle": 90},
]


def write_study(raw_dir: str, n_volumes: int, shape: Sequence[int] = (64, 64, 224),
                slices: Sequence[int] = range(120, 222, 2), seed: int = 0,
                dtype=np.float32, gz: bool = False, pixdim=(1.0, 1.0, 3.0)) -> list:
    """Write `n_volumes` volumes `ur_sub<i>` and their sidecars into
    `raw_dir`, protocol i % len(PROTOCOLS); returns the volume paths."""
    os.makedirs(raw_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    y = np.arange(ny)[None, :]
    paths = []
    zs = [z for z in slices if z < nz]
    for i in range(n_volumes):
        p = i % len(PROTOCOLS)
        pattern = 0.5 + 0.5 * np.sin(2 * np.pi * (1 + 3 * p) * y / ny)
        values = (pattern + 0.15 * rng.rand(len(zs), nx, ny)).astype(np.float32)
        if np.issubdtype(np.dtype(dtype), np.integer):
            values = np.round(values * 1000)
        vol = np.zeros(shape, dtype)
        vol[:, :, zs] = values.transpose(1, 2, 0)
        name = f"ur_sub{i:03d}"
        path = os.path.join(raw_dir, name + (".nii.gz" if gz else ".nii"))
        write_nifti(path, vol, pixdim)
        sidecar = {"MagneticFieldStrength": 3, "Manufacturer": "SIEMENS",
                   "ManufacturersModelName": "Prisma_fit", "MRAcquisitionType": "2D",
                   "SliceThickness": 3, **PROTOCOLS[p]}
        with open(os.path.join(raw_dir, name + ".json"), "w") as f:
            json.dump(sidecar, f)
        paths.append(path)
    return paths
