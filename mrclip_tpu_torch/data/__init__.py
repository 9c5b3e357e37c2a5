"""Data pipelines of the port (counterpart of `mrclip_tpu/data`): the CSV
and synthetic datasets, the samplers, the threaded loader and `get_data`,
which builds the train/val `DataInfo`s from the CLI flags.

Dataset types `csv`, `csv-unique-sampler` (`--unique3d` too), `synthetic`
and `auto` on a `.csv`/`.tsv` path are ported, and with `--native-loader`
the CSV sets load through the C++ library (`NativeBatchLoader`: uint8
canvases, the train ones augmented there). Webdataset shards (and `auto` on
`.tar`), `--tabular` and the ImageNet zero-shot sets raise
`NotImplementedError` before any loader is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..utils import to_2tuple
from .csv_dataset import (
    CsvDataset,
    CsvTabularDataset,
    DistributedSampler,
    Unique3DSampler,
    UniqueLabelSampler,
    extract_3d_image_id,
    extract_times,
)
from .loader import DataLoader, default_collate
from .native_loader import NativeBatchLoader
from .png import read_png, write_png
from .synthetic import SyntheticDataset

__all__ = [
    "CsvDataset",
    "CsvTabularDataset",
    "DistributedSampler",
    "UniqueLabelSampler",
    "Unique3DSampler",
    "SyntheticDataset",
    "DataLoader",
    "NativeBatchLoader",
    "DataInfo",
    "default_collate",
    "get_data",
    "extract_times",
    "extract_3d_image_id",
    "read_png",
    "write_png",
]

_ROADMAP = "ROADMAP: modules item 3, data and the training CLI"


def _loader_batch(args, is_train: bool) -> int:
    """Rows per loader batch: the train loader chunks at accum_freq *
    batch_size (one loader batch is one optimizer step), except on the
    vision-only path, which has no accumulation."""
    accum = max(getattr(args, "accum_freq", 1), 1) if is_train else 1
    if getattr(args, "visiononly", False) and getattr(args, "multipositiveloss", False):
        accum = 1
    return args.batch_size * accum


@dataclass
class DataInfo:
    """Loader + sampler bundle."""

    dataloader: DataLoader
    sampler: Any = None

    def set_epoch(self, epoch: int):
        self.dataloader.set_epoch(epoch)
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)


def _infer_dataset_type(data_path: str) -> str:
    """Auto dispatch by extension."""
    ext = data_path.split(".")[-1]
    if ext in ("csv", "tsv"):
        return "csv"
    if ext in ("tar",) or "{" in data_path:
        return "webdataset"
    raise ValueError(f"Cannot infer dataset type from {data_path}")


def _pin(args) -> bool:
    return str(getattr(args, "device", "") or "").startswith("cuda")


def _build_csv(args, path, transform, tokenizer, is_train: bool):
    dataset = CsvDataset(
        path,
        transform,
        img_key=getattr(args, "csv_img_key", "filepath"),
        caption_key=getattr(args, "csv_caption_key", "title"),
        sep=getattr(args, "csv_separator", ","),
        tokenizer=tokenizer,
        with_times=bool(getattr(args, "distance", False)),
    )
    rank = getattr(args, "rank", 0)
    world_size = getattr(args, "world_size", 1)
    seed = getattr(args, "seed", 0)
    batch_size = args.batch_size
    if is_train and getattr(args, "dataset_type", "csv") == "csv-unique-sampler":
        if getattr(args, "unique3d", False):
            sampler = Unique3DSampler(
                dataset.labels, dataset.volume_ids, batch_size, rank, world_size, seed
            )
        else:
            sampler = UniqueLabelSampler(dataset.labels, batch_size, rank, world_size, seed)
    elif is_train:
        sampler = DistributedSampler(len(dataset), rank, world_size, shuffle=True, seed=seed)
    else:
        sampler = DistributedSampler(len(dataset), 0, 1, shuffle=False)
    if getattr(args, "native_loader", False):
        return DataInfo(_native_loader(args, dataset, sampler, transform, tokenizer, is_train),
                        sampler)
    loader = DataLoader(
        dataset,
        batch_size=_loader_batch(args, is_train),
        sampler=sampler,
        num_workers=getattr(args, "workers", 4),
        drop_last=is_train,
        pin_memory=_pin(args),
    )
    return DataInfo(loader, sampler)


def _native_loader(args, dataset, sampler, transform, tokenizer, is_train: bool):
    """`--native-loader`: the C++ loader with the model's preprocess config
    (the transform's `cfg`): canvases of `--image-size`, train batches
    augmented by the C++ warp under the validated `--aug-cfg`, eval batches
    resized by `--image-resize-mode` or the config's mode ('cover' when
    neither says) and its interpolation (bicubic unless 'bilinear'); the
    loader carries the config, whose mean and std normalise on the card."""
    from ..transforms import AugmentationCfg, validate_aug_cfg

    aug = None
    if is_train and getattr(args, "aug_cfg", None):
        raw = args.aug_cfg
        aug = AugmentationCfg(**raw) if isinstance(raw, dict) else raw
        validate_aug_cfg(aug, backend="native")
    pp = getattr(transform, "cfg", None)
    eval_interp = getattr(pp, "interpolation", None) or "bicubic"
    if eval_interp not in ("bicubic", "bilinear"):
        eval_interp = "bicubic"  # 'random' is a train-time choice
    loader = NativeBatchLoader(
        dataset,
        batch_size=_loader_batch(args, is_train),
        sampler=sampler,
        canvas_size=to_2tuple(getattr(args, "image_size", 224)),
        tokenizer=tokenizer,
        with_times=bool(getattr(args, "distance", False)),
        num_threads=getattr(args, "workers", 0),
        drop_last=is_train,
        augment=is_train,
        aug_cfg=aug,
        eval_resize_mode=getattr(args, "image_resize_mode", None)
        or getattr(pp, "resize_mode", None) or "cover",
        eval_interpolation=eval_interp,
        seed=getattr(args, "seed", 0),
        pin_memory=_pin(args),
    )
    loader.preprocess_cfg = pp
    return loader


def _build_synthetic(args, transform, tokenizer, is_train: bool):
    image_size = getattr(args, "image_size", 224)
    if isinstance(image_size, int):
        image_size = (image_size, image_size)
    dataset = SyntheticDataset(
        transform=transform,
        image_size=image_size,
        dataset_size=getattr(args, "train_num_samples", 256),
        tokenizer=tokenizer,
        vocab_size=getattr(args, "_model_vocab_size", None),
    )
    sampler = DistributedSampler(
        len(dataset),
        getattr(args, "rank", 0),
        getattr(args, "world_size", 1),
        shuffle=is_train,
        seed=getattr(args, "seed", 0),
    )
    loader = DataLoader(
        dataset,
        batch_size=_loader_batch(args, is_train),
        sampler=sampler,
        num_workers=getattr(args, "workers", 4),
        drop_last=is_train,
        pin_memory=_pin(args),
    )
    return DataInfo(loader, sampler)


def _refuse_unported(args, paths) -> None:
    """Raise for every requested data path the port does not have, before
    any loader is built."""
    dataset_type = getattr(args, "dataset_type", "auto")
    for path in paths:
        dtype = _infer_dataset_type(path) if dataset_type == "auto" else dataset_type
        if dtype == "webdataset":
            raise NotImplementedError(
                f"webdataset shards ({path}) are not ported ({_ROADMAP}: data/shards.py)")
    if paths and getattr(args, "tabular", False):
        raise NotImplementedError(f"--tabular is not ported ({_ROADMAP}: CsvTabularDataset)")
    for flag in ("imagenet_val", "imagenet_v2"):
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported ({_ROADMAP}: data/image_folder.py "
                "and train/zero_shot.py)")


def get_data(args, preprocess_fns, epoch: int = 0, tokenizer: Optional[Callable] = None) -> dict:
    """Assemble the train/val DataInfos from the CLI flags. With a CUDA
    `args.device` the loaders pin their batches."""
    preprocess_train, preprocess_val = preprocess_fns
    data = {}
    train_path = getattr(args, "train_data", None)
    val_path = getattr(args, "val_data", None)
    dataset_type = getattr(args, "dataset_type", "auto")
    _refuse_unported(args, [] if dataset_type == "synthetic" else
                     [p for p in (train_path, val_path) if p])

    def dispatch(path, transform, is_train):
        if dataset_type == "synthetic":
            return _build_synthetic(args, transform, tokenizer, is_train)
        return _build_csv(args, path, transform, tokenizer, is_train)

    if train_path or dataset_type == "synthetic":
        data["train"] = dispatch(train_path, preprocess_train, True)
    if val_path:
        data["val"] = dispatch(val_path, preprocess_val, False)
    return data
