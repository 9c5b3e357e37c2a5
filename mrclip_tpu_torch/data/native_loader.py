"""The native-path batch loader of the port (counterpart of
`mrclip_tpu/data/native_loader.py`): the C++ library (`native.py`) decodes
and resizes PNGs onto a fixed canvas on its own thread pool, with no GIL.

Train batches (`augment=True`) come already warped, blurred and, with the
colour extras of an `AugmentationCfg`, jittered by the C++ path, each batch
from a `np.random.RandomState` seeded by `(seed * 1_000_003 + epoch * 131 +
batch_counter) % 2**31`, the crops sampled in pixel space from the PNG
headers' sizes; eval batches are resized by the model's eval mode and
interpolation. Images stay uint8 `[B, H, W, 3]`: the train loop normalises
them on the card (or augments them there under `--device-augment`), the eval
loops resize and normalise them there (`ops.image_ops.eval_preprocess_batch`).
Tokens are cached per caption (MRI captions repeat). With `pin_memory` the
batches are page-locked tensors, the source of asynchronous copies.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from ..native import augment_batch, augment_matrices, color_jitter_params, load_batch, png_size
from .csv_dataset import extract_times
from .loader import _pinned

__all__ = ["NativeBatchLoader"]


class NativeBatchLoader:
    """Batches of {'images' uint8 [B, H, W, 3], 'labels', 'tokens', and with
    `with_times` 'echo_time' and 'repetition_time'} from a CsvDataset-like
    dataset (`.images`, `.captions`, `.labels`). One producer thread makes
    the batches in sampler order into a bounded queue; an error it meets is
    raised in the consumer."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[Iterable[int]] = None,
        canvas_size: Tuple[int, int] = (256, 256),
        tokenizer: Optional[Callable] = None,
        with_times: bool = False,
        num_threads: int = 0,
        prefetch_batches: int = 4,
        drop_last: bool = True,
        augment: bool = False,
        aug_cfg=None,  # AugmentationCfg: scale, ratio and the colour extras
        eval_resize_mode: str = "cover",
        eval_interpolation: str = "bicubic",
        seed: int = 0,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.canvas_size = canvas_size
        self.tokenize = tokenizer
        self.with_times = with_times
        self.num_threads = num_threads
        self.prefetch_batches = prefetch_batches
        self.drop_last = drop_last
        self.augment = augment
        self.aug_cfg = aug_cfg
        self.eval_resize_mode = eval_resize_mode
        self.eval_interpolation = eval_interpolation
        self.seed = seed
        self.pin_memory = pin_memory
        self._epoch = 0
        self._batch_counter = 0
        self._token_cache: Dict[str, np.ndarray] = {}

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _tokens_for(self, caption: str) -> np.ndarray:
        cached = self._token_cache.get(caption)
        if cached is None:
            cached = self.tokenize([caption])[0]
            self._token_cache[caption] = cached
        return cached

    def _make_batch(self, idxs) -> dict:
        ds = self.dataset
        paths = [str(ds.images[i]) for i in idxs]
        if self.augment:
            # the whole MR-CLIP chain in the C++ warp, a seed per batch
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + self._epoch * 131 + self._batch_counter) % (2**31))
            self._batch_counter += 1
            aug = self.aug_cfg
            matrices = augment_matrices(
                rng, len(paths),
                crop_scale=tuple(aug.scale) if aug and aug.scale else (0.9, 1.0),
                ratio=tuple(aug.ratio) if aug and aug.ratio else (3.0 / 4.0, 4.0 / 3.0),
                # the sources' sizes from the PNG headers: crops are sampled
                # in pixel space, an absolute aspect range
                src_sizes=[png_size(p) for p in paths],
            )
            sigmas = rng.uniform(0.1, 2.0, len(paths)).astype(np.float32)
            colors = color_jitter_params(
                rng, len(paths),
                color_jitter=aug.color_jitter,
                color_jitter_prob=aug.color_jitter_prob or 0.0,
                gray_scale_prob=aug.gray_scale_prob or 0.0,
            ) if aug else None
            images, status = augment_batch(paths, self.canvas_size, matrices, sigmas,
                                           color_params=colors, num_threads=self.num_threads)
        else:
            images, status = load_batch(paths, self.canvas_size, num_threads=self.num_threads,
                                        resize_mode=self.eval_resize_mode,
                                        interpolation=self.eval_interpolation)
        batch = {"images": images,
                 "labels": np.asarray([ds.labels[i] for i in idxs], np.int32)}
        if self.tokenize is not None:
            batch["tokens"] = np.stack([self._tokens_for(str(ds.captions[i])) for i in idxs])
        if self.with_times:
            te_tr = np.asarray([extract_times(str(ds.captions[i])) for i in idxs], np.float32)
            batch["echo_time"] = te_tr[:, 0]
            batch["repetition_time"] = te_tr[:, 1]
        return _pinned(batch) if self.pin_memory else batch

    def __iter__(self):
        order = (list(iter(self.sampler)) if self.sampler is not None
                 else list(range(len(self.dataset))))
        batches = [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        error: list = []  # the producer's exception, raised in the consumer

        def put_or_stop(item) -> bool:
            """Hand `item` over unless the consumer has stopped (an abandoned
            iterator never leaves the producer blocked on a full queue)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # the C++ call runs its own threads, so one producer keeps the
            # batches in order while the decode fills the cores
            try:
                for idxs in batches:
                    if stop.is_set() or not put_or_stop(self._make_batch(idxs)):
                        break
            except Exception as e:  # noqa: BLE001 - raised in the consumer
                error.append(e)
            finally:
                put_or_stop(None)  # the sentinel, after an error too

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if error:
                        raise error[0]
                    break
                yield batch
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            # the producer may be inside one C++ call; wait for it so that
            # the next epoch's iterator does not race its thread pool
            thread.join(timeout=10.0)
