"""CSV dataset + MR-CLIP samplers of the port (counterpart of
`mrclip_tpu/data/csv_dataset.py`), on the stdlib `csv` module and the port's
PNG reader, with no pandas and no PIL.

- `CsvDataset`: filepath/title/label columns read as pandas reads them
  (`label` as int, `[0] * n` without the column, the caption as `str(...)`
  of the cell: an empty or NA cell is "nan"); the image read by
  `data/png.read_png` (uint8 numpy) and transformed; the tokenized caption;
  optional TE/TR from the caption's last parenthesis group
  (`extract_times`); 3D volume grouping by the `_sliceNNN` suffix;
- `DistributedSampler`, `UniqueLabelSampler` (<= 1 sample per label per
  batch) and `Unique3DSampler` (<= 1 slice per 3D volume per batch): the JAX
  package's code, `random.Random(seed + epoch)`, so each emits the same
  indices for each epoch, rank and world size;
- `CsvTabularDataset` (`--tabular`) is not ported and raises.
"""

from __future__ import annotations

import os
import random
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .png import read_png
from .table import read_table

__all__ = [
    "CsvDataset",
    "CsvTabularDataset",
    "UniqueLabelSampler",
    "Unique3DSampler",
    "DistributedSampler",
    "extract_times",
    "extract_3d_image_id",
]

# the strings pandas' read_csv reads as NaN by default
_PANDAS_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
              "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}

_TIMES_RE = re.compile(r"\(([^()]*)\)\s*$")


def extract_times(caption: str):
    """Parse (TE, TR) from the caption's last parenthesis group
    (reference data.py:50-60): "... (Echo Time, Repetition Time, ...):
    (0.093, 9.0, nan, 150)" -> (0.093, 9.0). Returns (0.0, 0.0) on failure."""
    m = _TIMES_RE.search(caption.strip())
    if not m:
        return 0.0, 0.0
    parts = [p.strip() for p in m.group(1).split(",")]
    try:
        te = float(parts[0])
    except (ValueError, IndexError):
        te = 0.0
    try:
        tr = float(parts[1])
    except (ValueError, IndexError):
        tr = 0.0
    if np.isnan(te):
        te = 0.0
    if np.isnan(tr):
        tr = 0.0
    return te, tr


_SLICE_RE = re.compile(r"_slice\d+", re.IGNORECASE)


def extract_3d_image_id(filepath: str) -> str:
    """Strip the `_sliceNNN` suffix to group 2D slices into their 3D volume
    (reference data.py:44-49 / train.py:987-993)."""
    base = os.path.basename(str(filepath))
    base = os.path.splitext(base)[0]
    return _SLICE_RE.sub("", base)


class CsvDataset:
    """Image-caption(-label) dataset backed by a CSV file.

    Returns per-item dicts: image [H,W,C] float32 (transformed) or the
    uint8 array as read, tokens [L] int32, label int32, the caption string,
    optional echo_time/repetition_time floats.
    """

    def __init__(
        self,
        input_filename: str,
        transforms: Optional[Callable] = None,
        img_key: str = "filepath",
        caption_key: str = "title",
        label_key: str = "label",
        sep: str = ",",
        tokenizer: Optional[Callable] = None,
        with_times: bool = False,
    ):
        columns, rows = read_table(input_filename, sep=sep)
        self.images = [r[img_key] for r in rows]
        self.captions = ["nan" if r[caption_key] in _PANDAS_NA else r[caption_key] for r in rows]
        self.labels = [int(r[label_key]) for r in rows] if label_key in columns else [0] * len(rows)
        self.transforms = transforms
        self.tokenize = tokenizer
        self.with_times = with_times
        self.volume_ids = [extract_3d_image_id(p) for p in self.images]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict:
        img = read_png(str(self.images[idx]))
        if self.transforms is not None:
            img = self.transforms(img)
        caption = str(self.captions[idx])
        item = {
            "images": img,
            "labels": np.int32(self.labels[idx]),
        }
        if self.tokenize is not None:
            item["tokens"] = self.tokenize([caption])[0]
        # Exact-caption identity is the 'unique' eval ground truth; always
        # carry the string.
        item["caption"] = caption
        if self.with_times:
            te, tr = extract_times(caption)
            item["echo_time"] = np.float32(te)
            item["repetition_time"] = np.float32(tr)
        return item


class CsvTabularDataset(CsvDataset):
    """Image + tabular acquisition-metadata dataset (`--tabular`): not
    ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CsvTabularDataset (--tabular) is not ported (ROADMAP: modules item 3, data and "
            "the training CLI: CsvTabularDataset)")


class DistributedSampler:
    """Epoch-seeded shuffled rank-strided index sampler (the torch
    DistributedSampler semantics used at reference data.py:484-494)."""

    def __init__(
        self,
        num_samples: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.num_samples = num_samples
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.world_size
        return (self.num_samples + self.world_size - 1) // self.world_size

    def __iter__(self):
        order = np.arange(self.num_samples)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.drop_last:
            usable = (self.num_samples // self.world_size) * self.world_size
            order = order[:usable]
        return iter(order[self.rank :: self.world_size].tolist())


class UniqueLabelSampler:
    """<= 1 sample per label per batch (reference data.py:599-677).

    Per epoch: shuffle within-label orders and label order with the epoch
    seed; emit batches by taking the next unused sample of each of
    `batch_size` distinct labels. Distributed via rank-strided slicing of the
    emitted index stream (reference :669-671).
    """

    def __init__(
        self,
        labels: Sequence[int],
        batch_size: int,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 0,
    ):
        self.labels = list(labels)
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _group_key(self, idx: int):
        return self.labels[idx]

    def _ordered_indices(self) -> List[int]:
        rng = random.Random(self.seed + self.epoch)
        groups: Dict = {}
        for i in range(len(self.labels)):
            groups.setdefault(self._group_key(i), []).append(i)
        for g in groups.values():
            rng.shuffle(g)
        queues = {k: list(v) for k, v in groups.items()}

        out: List[int] = []
        # NOTE: like the reference sampler (data.py:640-673), the uniqueness
        # guarantee weakens at the TAIL of an epoch: when fewer distinct
        # groups remain than batch_size, the loader's fixed-size chunking
        # stitches short rounds together and a late batch can repeat a
        # group (the reference's partial sweep tails concatenate the same
        # way). Mid-epoch batches are always group-unique.
        while queues:
            keys = list(queues.keys())
            rng.shuffle(keys)
            batch_keys = keys[: self.batch_size]
            for k in batch_keys:
                out.append(queues[k].pop())
                if not queues[k]:
                    del queues[k]
        return out

    def __iter__(self):
        order = self._ordered_indices()
        return iter(order[self.rank :: self.world_size])

    def __len__(self):
        return len(self.labels) // self.world_size


class Unique3DSampler(UniqueLabelSampler):
    """<= 1 slice per 3D volume per batch (reference data.py:678-757)."""

    def __init__(
        self,
        labels: Sequence[int],
        volume_ids: Sequence[str],
        batch_size: int,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 0,
    ):
        super().__init__(labels, batch_size, rank, world_size, seed)
        self.volume_ids = list(volume_ids)

    def _group_key(self, idx: int):
        return self.volume_ids[idx]
