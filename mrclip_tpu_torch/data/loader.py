"""Multi-worker prefetching data loader of the port (counterpart of
`mrclip_tpu/data/loader.py`'s random-access path; tar-shard streaming waits
for the webdataset item of ROADMAP.md).

A thread pool decodes and transforms samples while the card steps, with a
bounded prefetch queue of fully collated numpy batches, handed over in
sampler order whatever `num_workers` is. With `pin_memory`, a worker also
copies its batch into page-locked tensors, so the train loop's copies to the
card are asynchronous (`non_blocking`). Threads, not processes: numpy
releases the GIL for the heavy parts of the decode and the transforms.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

__all__ = ["DataLoader", "default_collate"]


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], (str, bytes)):
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


def _pinned(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch's arrays as page-locked CPU tensors, the source of
    `non_blocking` copies to the card (strings stay lists)."""
    import torch

    return {k: v if isinstance(v, list) else torch.from_numpy(v).pin_memory()
            for k, v in batch.items()}


class DataLoader:
    """Iterate batches of collated numpy arrays with background workers.

    `dataset` is random-access (`__getitem__`, `__len__`). `sampler` yields
    indices (re-iterated each epoch; call `set_epoch` to reshuffle
    deterministically). With `sampler=None`, iterates sequentially. An error
    in a worker is raised in the consumer.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[Iterable[int]] = None,
        num_workers: int = 4,
        drop_last: bool = True,
        collate_fn: Callable = default_collate,
        prefetch_batches: int = 4,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch_batches = prefetch_batches
        self.pin_memory = pin_memory

    def set_epoch(self, epoch: int):
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _batches(self) -> List[List[int]]:
        if self.sampler is not None:
            order = list(iter(self.sampler))
        else:
            order = list(range(len(self.dataset)))
        batches = [
            order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        batches = self._batches()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def load_batch(idxs):
            batch = self.collate_fn([self.dataset[i] for i in idxs])
            return _pinned(batch) if self.pin_memory else batch

        def put(item) -> bool:
            """Hand `item` over unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    futures = []
                    for idxs in batches:
                        futures.append(pool.submit(load_batch, idxs))
                        # Backpressure: hand over completed batches in order.
                        while len(futures) >= self.num_workers:
                            if not put(futures.pop(0).result()):
                                return
                    for f in futures:
                        if not put(f.result()):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join()
