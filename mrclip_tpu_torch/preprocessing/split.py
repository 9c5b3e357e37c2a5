"""Slice filtering + volume-grouped shuffle/split (the port's copy of
`mrclip_tpu/preprocessing/split.py`, on lists of row dicts and the stdlib
`csv` module in place of pandas frames).

- `filter_slices`: keep even slices in [120, 220] (sagittal [50, 150]);
- `merge_and_shuffle_split`: group rows by 3D `image_id` (slices of one
  volume never straddle splits), `np.random.RandomState(seed).permutation`
  over the volume ids in order of first appearance (as pandas `unique()`
  gives them), 60/10/30 train/val/test, each split's rows in merged order.
  A folder's `labeled_*.csv` files are taken in `glob.glob` order, unsorted,
  as the JAX package takes them: the order the file system lists them.
  The CSVs written are those pandas writes (`data/table.py`).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from ..data.table import columns_of, read_table, write_table
from .captions import extract_slice_number

__all__ = ["extract_image_id", "filter_slices", "merge_and_shuffle_split"]

Rows = List[Dict[str, object]]

_SLICE_SUFFIX_RE = re.compile(r"_slice\d+.*$")


def extract_image_id(path: str) -> str:
    base = os.path.splitext(os.path.basename(str(path)))[0]
    return _SLICE_SUFFIX_RE.sub("", base)


def filter_slices(rows: Rows, col: str = "filepath", min_slice: int = 120,
                  max_slice: int = 220) -> Rows:
    """Even slices within the plane-specific window."""

    def keep(row) -> bool:
        n = extract_slice_number(row[col])
        if n is None:
            return False
        if "sagittal" in str(row[col]):
            return 50 <= n <= 150 and n % 2 == 0
        return min_slice <= n <= max_slice and n % 2 == 0

    return [r for r in rows if keep(r)]


def merge_and_shuffle_split(
    input_folder_or_tables,
    train_file: str,
    val_file: str,
    test_file: str,
    train_ratio: float = 0.6,
    val_ratio: float = 0.1,
    seed: int = 42,
    apply_slice_filter: bool = True,
) -> Tuple[Rows, Rows, Rows]:
    """Merge labeled CSVs (`labeled_*.csv` of a folder) or lists of row
    dicts, split by 3D volume; returns the train, val and test rows and
    writes each to its file when one is given."""
    if isinstance(input_folder_or_tables, str):
        files = glob.glob(os.path.join(input_folder_or_tables, "labeled_*.csv"))
        tables = [read_table(f)[1] for f in files]
    else:
        tables = [list(t) for t in input_folder_or_tables]
    if apply_slice_filter:
        tables = [filter_slices(t) for t in tables]
    merged = [r for t in tables for r in t]
    cols = columns_of(merged)
    keep_cols = [c for c in ("filepath", "text", "label") if c in cols]
    ids = [extract_image_id(r["filepath"]) for r in merged]

    rng = np.random.RandomState(seed)
    unique_ids = list(dict.fromkeys(ids))
    order = rng.permutation(len(unique_ids))
    unique_ids = [unique_ids[i] for i in order]

    train_end = int(len(unique_ids) * train_ratio)
    val_end = train_end + int(len(unique_ids) * val_ratio)
    splits = (set(unique_ids[:train_end]), set(unique_ids[train_end:val_end]),
              set(unique_ids[val_end:]))
    out = tuple([{c: r.get(c) for c in keep_cols} for r, i in zip(merged, ids) if i in s]
                for s in splits)
    for rows, path in zip(out, (train_file, val_file, test_file)):
        if path:
            write_table(path, rows, keep_cols)
    return out
