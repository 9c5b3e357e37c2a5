"""CSV tables as lists of row dicts, read and written with the stdlib `csv`
module in the layout pandas gives them (`pd.read_csv` / `to_csv(index=False)`):
a header, `QUOTE_MINIMAL` with doubled quotes, `\\n` line ends, None or NaN
written as an empty field, and a table without columns written as one empty
line. Cells read back as strings; written, an int is its digits and a float
its shortest repr, as pandas writes them."""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["read_table", "write_table", "columns_of"]

Row = Dict[str, object]


def read_table(path: Union[str, os.PathLike], sep: str = ",") -> Tuple[List[str], List[Row]]:
    """(columns, rows) of a CSV with a header. A file without columns (one
    empty line, as an empty table is written) raises, as pandas does."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=sep)
        header = next(reader, None)
        if not header:
            raise ValueError(f"{path}: no columns to parse from file")
        rows = [dict(zip(header, r)) for r in reader if r]
    return header, rows


def columns_of(rows: Sequence[Row]) -> List[str]:
    """The union of the rows' keys in order of first appearance."""
    cols: Dict[str, None] = {}
    for r in rows:
        cols.update(dict.fromkeys(r))
    return list(cols)


def _cell(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_table(path: Union[str, os.PathLike], rows: Sequence[Row],
                columns: Optional[Sequence[str]] = None) -> None:
    """Write `rows` under `columns` (default: `columns_of(rows)`); a missing
    key is an empty field."""
    columns = list(columns_of(rows) if columns is None else columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow(columns)
        for r in rows:
            w.writerow([_cell(r.get(c)) for c in columns])
