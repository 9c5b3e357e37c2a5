"""Acquisition-parameter binning + label assignment.

Capability parity with reference `preprocessing.py` step 3:
- `get_bin_label` (:380-405): interval lookup against
  `bin_intervals_et_20_rt_20.json` (TE: 20 x 0.010s bins over 0-0.200;
  TR: 20 x 0.5s over 0-10; TI: 8 bins with an open `> 3.000` tail),
- `parse_dicom_metadata` (:408-439): regex-parse the structured caption back
  into fields,
- `label_data` (:442-491): label string = plane + manufacturer +
  normalized-model + acquisition-type + sequence + variant + field-strength +
  flip-angle + binned TE/TR/TI -> global integer label ids,
- flip-angle filter {15, 30, 120} (:529).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

__all__ = [
    "load_bin_intervals",
    "get_bin_label",
    "parse_dicom_metadata",
    "make_label_string",
    "label_rows",
    "DROP_FLIP_ANGLES",
    "MODEL_NAME_MAPPING",
]

DEFAULT_BIN_INTERVALS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "bin_intervals_et_20_rt_20.json",
)

DROP_FLIP_ANGLES = {15.0, 30.0, 120.0}

MODEL_NAME_MAPPING = {
    "SIGNA_HDx": "Signa_HDxt",
    "DISCOVERY_MR450": "DISCOVERY_MR",
    "DISCOVERY_MR750": "DISCOVERY_MR",
}


def load_bin_intervals(path: Optional[str] = None) -> dict:
    with open(path or DEFAULT_BIN_INTERVALS) as f:
        return json.load(f)


def get_bin_label(value, bins: List[dict]) -> Optional[str]:
    """Interval lookup with (lower, upper] semantics + open `> x` tail
    (reference :380-405)."""
    if value is None:
        return None
    value = float(value)
    for bin_info in bins:
        bin_range = bin_info["range"].split(" - ")
        if len(bin_range) == 2:
            if float(bin_range[0]) < value <= float(bin_range[1]):
                return bin_info["bin"]
        else:
            if value >= float(bin_range[0].replace(">", "")):
                return bin_info["bin"]
    return None


_PATTERNS = {
    "plane": r"(?:plane|Plane)\s+(\S+)",
    "Magnetic Field Strength": r"Magnetic Field Strength\s+([\d\.]+)",
    "Manufacturer": r"Manufacturer\s+(\S+)",
    "Manufacturers Model Name": r"Manufacturers Model Name\s+([^,]+)",
    "Series Description": r"Series Description\s+([^,]+)",
    "Acquisition Type": r"Acquisition Type\s+(\S+)",
    "Scanning Sequence": r"Scanning Sequence\s+(\S+)",
    "Sequence Variant": r"Sequence Variant\s+(\S+)",
    "Slice Thickness": r"Slice Thickness\s+([\d\.]+)",
    "Echo Time": r"Echo Time\s+([\d\.]+)",
    "Repetition Time": r"Repetition Time\s+([\d\.]+)",
    "Flip Angle": r"Flip Angle\s+([\d\.]+)",
    "Inversion Time": r"Inversion Time\s+([\d\.]+)",
}


_STRUCTURED_RE = re.compile(
    r"plane\s+(?P<plane>\w+).*?"
    r"Scanner \(Manufacturer, Model, Field Strength\): \((?P<scanner>[^)]*)\).*?"
    r"Acquisition \(Description, Sequence, Variant\): \((?P<protocol>[^)]*)\).*?"
    r"Imaging Parameters \(Echo Time, Repetition Time, Inversion Time, Flip Angle\): "
    r"\((?P<params>[^)]*)\)",
    re.IGNORECASE | re.DOTALL,
)


def parse_dicom_metadata(text: str) -> Dict[str, Optional[str]]:
    """Extract acquisition fields from a caption (reference :408-439).

    The reference's raw regexes silently return None on its own *canonical*
    captions (everything but plane — a latent bug in the snapshot); rebuilt
    working: structured captions are parsed positionally from the 4-part
    format, raw captions keep the reference's field regexes.
    """
    m = _STRUCTURED_RE.search(text)
    if m:
        def split3(group, n):
            parts = [p.strip() for p in m.group(group).split(",")]
            parts += ["NONE"] * (n - len(parts))
            return [None if p in ("NONE", "nan", "") else p for p in parts[:n]]

        manufacturer, model, field = split3("scanner", 3)
        desc, seq, variant = split3("protocol", 3)
        te, tr, ti, fa = split3("params", 4)
        return {
            "plane": m.group("plane"),
            "Magnetic Field Strength": field,
            "Manufacturer": manufacturer,
            "Manufacturers Model Name": model,
            "Series Description": desc,
            "Acquisition Type": None,  # not carried by the canonical caption
            "Scanning Sequence": seq,
            "Sequence Variant": variant,
            "Slice Thickness": None,
            "Echo Time": te,
            "Repetition Time": tr,
            "Flip Angle": fa,
            "Inversion Time": ti,
        }
    out = {}
    for key, pattern in _PATTERNS.items():
        mm = re.search(pattern, text)
        out[key] = mm.group(1).strip() if mm else None
    return out


def make_label_string(meta: Dict[str, Optional[str]], bin_intervals: dict) -> str:
    """Categoricals + binned TE/TR/TI -> the label key (reference :442-480)."""
    model = meta.get("Manufacturers Model Name")
    model = MODEL_NAME_MAPPING.get(model, model)
    label = (
        f"{meta.get('plane')}{meta.get('Manufacturer')}_{model}_"
        f"{meta.get('Acquisition Type')}_{meta.get('Scanning Sequence')}_"
        f"{meta.get('Sequence Variant')}_{meta.get('Magnetic Field Strength')}_"
        f"{meta.get('Flip Angle')}"
    )
    te_bin = get_bin_label(meta.get("Echo Time"), bin_intervals["Echo Time"])
    tr_bin = get_bin_label(meta.get("Repetition Time"), bin_intervals["Repetition Time"])
    ti_bin = get_bin_label(meta.get("Inversion Time"), bin_intervals["Inversion Time"])
    return label + f"_{te_bin}_{tr_bin}_{ti_bin}"


def label_rows(
    rows: List[dict],
    bin_intervals: Optional[dict] = None,
    label_dict: Optional[Dict[str, int]] = None,
) -> Tuple[List[dict], Dict[str, int]]:
    """Assign integer labels; drops flip angles {15, 30, 120} (reference :529).

    Rows need a 'text' caption; returns (labeled rows, label dictionary).
    """
    bin_intervals = bin_intervals or load_bin_intervals()
    label_dict = {} if label_dict is None else label_dict
    out = []
    for row in rows:
        meta = parse_dicom_metadata(row["text"])
        fa = meta.get("Flip Angle")
        if fa is not None and float(fa) in DROP_FLIP_ANGLES:
            continue
        key = make_label_string(meta, bin_intervals)
        if key not in label_dict:
            label_dict[key] = len(label_dict)
        out.append({**row, "label": label_dict[key], "label_key": key})
    return out, label_dict
