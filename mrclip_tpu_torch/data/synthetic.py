"""Synthetic smoke/perf dataset of the port (counterpart of
`mrclip_tpu/data/synthetic.py`): a constant blank RGB image (a uint8 array)
and a constant caption, exercising transform, tokenizer, loader, model and
loss end to end with no real data (`--dataset-type synthetic`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["SyntheticDataset"]


class SyntheticDataset:
    def __init__(
        self,
        transform: Optional[Callable] = None,
        image_size: tuple = (224, 224),
        caption: str = "Dummy caption",
        dataset_size: int = 100,
        tokenizer: Optional[Callable] = None,
        num_labels: int = 8,
        vocab_size: Optional[int] = None,
    ):
        self.transform = transform
        self.image_size = image_size
        self.caption = caption
        self.dataset_size = dataset_size
        self.tokenize = tokenizer
        self.num_labels = num_labels
        # mini-vocab configs (test/smoke models): clamp placeholder caption
        # ids into the model's embedding range — OOB gathers fill NaN on XLA
        self.vocab_size = vocab_size
        self.image = np.zeros((image_size[0], image_size[1], 3), np.uint8)
        self.labels = list(np.arange(dataset_size) % num_labels)
        self.volume_ids = [f"vol{i // 4}" for i in range(dataset_size)]

    def __len__(self):
        return self.dataset_size

    def __getitem__(self, idx: int):
        img = self.image
        if self.transform is not None:
            img = self.transform(img)
        item = {"images": img, "labels": np.int32(self.labels[idx])}
        # Dummy per-label acquisition times so `--distance` is smoke-testable
        # on synthetic data (the CSV path parses these from captions).
        item["echo_time"] = np.float32(0.01 * (self.labels[idx] + 1))
        item["repetition_time"] = np.float32(0.5 * (self.labels[idx] + 1))
        if self.tokenize is not None:
            tokens = np.asarray(self.tokenize([self.caption])[0])
            if self.vocab_size is not None:
                # keep 0 (pad) fixed; fold everything else into [1, vocab)
                tokens = np.where(
                    tokens == 0, tokens, 1 + (tokens - 1) % (self.vocab_size - 1)
                ).astype(tokens.dtype)
            item["tokens"] = tokens
        else:
            item["caption"] = self.caption
        return item
