"""Caption generation from BIDS-style JSON sidecars.

Capability parity with reference `preprocessing.py` step 2:
- `generate_text_from_json` (:220-267): raw caption from 12 DICOM keys,
- `simplify_text` (:172-217): restructure into the canonical 4-part caption
  "A brain MRI, plane {p}, Scanner (...): (...), Acquisition (...): (...),
  Imaging Parameters (...): (...)",
- plane-specific slice ranges for pairing (:300-315: axial/coronal 121-220,
  sagittal 40-160).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "generate_text_from_json",
    "simplify_text",
    "slice_range_for_plane",
    "extract_slice_number",
    "build_caption_rows",
]

RAW_CAPTION_KEYS = [
    "MagneticFieldStrength",
    "Manufacturer",
    "ManufacturersModelName",
    "SeriesDescription",
    "MRAcquisitionType",
    "ScanningSequence",
    "SequenceVariant",
    "SliceThickness",
    "EchoTime",
    "RepetitionTime",
    "InversionTime",
    "FlipAngle",
]


def generate_text_from_json(json_path: str, plane: str) -> Optional[str]:
    """Raw caption from the sidecar's DICOM keys (reference :220-267)."""
    try:
        with open(json_path) as f:
            meta = json.load(f)
    except Exception as e:
        print(f"Error reading JSON {json_path}: {e}")
        return None

    parts = [f"a photo of brain MRI, plane {plane},"]
    for key in RAW_CAPTION_KEYS:
        if key in meta:
            value = meta[key]
            readable = re.sub(r"(?<!^)(?=[A-Z])", " ", key)
            if isinstance(value, (int, float, str)):
                parts.append(f"{readable} {value}")
            elif isinstance(value, list):
                parts.append(f"{readable} {', '.join(map(str, value))}")
    return ", ".join(parts)


_CATEGORIES = {
    "Plane": ["Plane"],
    "Scanner": ["Manufacturer", "Manufacturers Model Name", "Magnetic Field Strength"],
    "Protocol": ["Series Description", "Scanning Sequence", "Sequence Variant"],
    "Parameters": ["Echo Time", "Repetition Time", "Inversion Time", "Flip Angle"],
}


def simplify_text(input_str: str) -> str:
    """Canonical structured caption (reference :172-217)."""
    tags = {tag: "NONE" for group in _CATEGORIES.values() for tag in group}

    plane_match = re.search(r"plane (\w+)", input_str, re.IGNORECASE)
    tags["Plane"] = plane_match.group(1) if plane_match else "NONE"

    pattern = re.compile(r"(\b" + r"\b|\b".join(tags.keys()) + r"\b)\s+([^,]+)")
    for tag, value in pattern.findall(input_str):
        tags[tag] = value.strip()

    scanner = ", ".join(tags[t] for t in _CATEGORIES["Scanner"])
    protocol = ", ".join(tags[t] for t in _CATEGORIES["Protocol"])
    params = ", ".join(tags[t] for t in _CATEGORIES["Parameters"])
    return (
        f"A brain MRI, plane {tags['Plane']}, "
        f"Scanner (Manufacturer, Model, Field Strength): ({scanner}), "
        f"Acquisition (Description, Sequence, Variant): ({protocol}), "
        f"Imaging Parameters (Echo Time, Repetition Time, Inversion Time, Flip Angle): ({params})"
    )


def slice_range_for_plane(filename: str) -> Tuple[str, range]:
    """Plane + admissible slice range from the filename (reference :300-315)."""
    lower = filename.lower()
    if "sagittal" in lower:
        return "sagittal", range(40, 161)
    if "coronal" in lower:
        return "coronal", range(121, 221)
    if "axial" in lower:
        return "axial", range(121, 221)
    return "unknown", range(121, 221)


_SLICE_NUM_RE = re.compile(r"_slice(\d+)")


def extract_slice_number(path: str) -> Optional[int]:
    m = _SLICE_NUM_RE.search(os.path.basename(str(path)))
    return int(m.group(1)) if m else None


def build_caption_rows(
    png_paths: Iterable[str],
    json_for_png,
) -> List[Dict[str, str]]:
    """Pair slice PNGs with sidecar JSONs -> (filepath, text) rows.

    `json_for_png(png_path) -> json_path` encapsulates the directory layout
    (reference pairs via relative path + `file.split('_slice')[0]`).
    Slices outside the plane's admissible range are skipped.
    """
    rows = []
    for png in png_paths:
        name = os.path.basename(png)
        plane, valid = slice_range_for_plane(name)
        n = extract_slice_number(name)
        if n is None or n not in valid:
            continue
        json_path = json_for_png(png)
        if not json_path or not os.path.exists(json_path):
            continue
        raw = generate_text_from_json(json_path, plane)
        if raw is None:
            continue
        rows.append({"filepath": png, "text": simplify_text(raw)})
    return rows
