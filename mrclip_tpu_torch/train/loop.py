"""Epoch train/eval loops of the port (counterpart of
`mrclip_tpu/train/loop.py`).

- `train_one_epoch`: per-step schedule, the batch copied to the card from
  pinned memory (`non_blocking`), then `augment_fn` (`--device-augment`) on
  the images as the loader made them, or, without it, uint8 images (the
  native loader's) normalised with the loader's mean and std; samples/s
  and loss meters, the metrics of
  each step read one step late so the host does not wait for the card, the
  log line of the JAX package, an optional `torch.profiler` window
  (`--profile-dir`: a Chrome trace of epoch 0, always stopped once
  started), and the kernels launched in the epoch;
- `evaluate`: uint8 batches (the native loader's canvases) resized,
  cropped and normalised on the card (`_maybe_preprocess_images`); the val
  loss (multipositive from the labels, else CLIP's),
  i2t/t2i losses, the retrieval metrics of `get_clip_metrics` (capped at
  10k features unless `--metrics`), the `--tracepreds` dump and
  `results.jsonl`;
- `test_metrics` (`--test`): full-dataset eval with caption dedup, ranks
  against all unique texts and 3D volume voting;
- `get_features`. `linear_probe` (`--linear`) and the ImageNet zero-shot
  branch raise.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..losses import clip_loss, multipositive_clip_loss
from ..ops import launch_counts, launches_since
from ..ops.image_ops import eval_preprocess_batch, normalize_images
from ..parallel import build_eval_step
from ..utils import to_2tuple
from .metrics import get_clip_metrics, volume_voting_metrics

__all__ = [
    "AverageMeter",
    "append_results_jsonl",
    "train_one_epoch",
    "evaluate",
    "test_metrics",
    "get_features",
    "linear_probe",
]

_ROADMAP = "ROADMAP: modules item 3, data and the training CLI"


def append_results_jsonl(args, metrics: dict) -> None:
    """Append eval metrics to checkpoints/results.jsonl."""
    log_dir = getattr(args, "checkpoint_path", None)
    if not log_dir:
        return
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "results.jsonl"), "a+") as f:
        f.write(json.dumps({
            k: float(v) if isinstance(v, (int, float, np.floating)) else v
            for k, v in metrics.items()
        }))
        f.write("\n")


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def _device_of(state) -> torch.device:
    return next(iter(state.params.values())).device


def _to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays as tensors on `device` (strings dropped): from
    pinned memory the copies are asynchronous."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            continue
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        out[k] = t.to(device, non_blocking=True)
    return out


def _mean_std(pp) -> dict:
    """{'mean', 'std'} of a loader's PreprocessCfg, or {} (the defaults)."""
    if pp is None or getattr(pp, "mean", None) is None:
        return {}
    return {"mean": tuple(pp.mean), "std": tuple(pp.std)}


def _maybe_preprocess_images(batch: dict, args, pp=None) -> dict:
    """uint8 images (the native loader's canvases) through the eval
    preprocessing on the card: resized to `--image-size`, cropped and
    normalised with the loader's mean and std (`pp`, its PreprocessCfg)."""
    images = batch.get("images")
    if images is not None and images.dtype == torch.uint8:
        size = to_2tuple(getattr(args, "image_size", 224))
        batch = dict(batch, images=eval_preprocess_batch(images, out_size=size,
                                                         **_mean_std(pp)))
    return batch


def _augment_seed(seed: int, epoch: int, i: int) -> int:
    """The seed of step `i`'s augmentation draws: --seed, the epoch and
    2 i + 1, as the JAX package folds them into its key."""
    return ((seed * 1_000_003 + epoch) * 1_000_003 + 2 * i + 1) % 2**63


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_one_epoch(
    step_fn,
    state,
    data,
    epoch: int,
    args,
    schedule: Optional[Callable] = None,
    writer=None,
    generator: Optional[torch.Generator] = None,
    augment_fn: Optional[Callable] = None,
):
    """One epoch of train steps. Returns (state, epoch_metrics). `generator`
    is the text dropout's source of masks; it is seeded here from --seed and
    the epoch, so a resumed run draws what an uninterrupted one drew.
    `augment_fn(images, generator)` (`--device-augment`) runs on the card on
    the loader's images, its generator seeded from --seed, the epoch and the
    step; without it uint8 images are normalised with the loader's mean and
    std."""
    data["train"].set_epoch(epoch)
    loader = data["train"].dataloader
    device = _device_of(state)
    if generator is not None:
        generator.manual_seed(args.seed + epoch)
    aug_generator = torch.Generator(device=device) if augment_fn is not None else None
    mean_std = _mean_std(getattr(loader, "preprocess_cfg", None))
    num_batches = len(loader)
    epoch_samples = num_batches * args.batch_size * args.accum_freq
    sample_digits = math.ceil(math.log(max(epoch_samples, 10), 10))

    losses_m: Dict[str, AverageMeter] = defaultdict(AverageMeter)
    batch_time_m, data_time_m = AverageMeter(), AverageMeter()
    counts0 = launch_counts()

    end = time.time()
    prev_metrics = None
    world_size = getattr(args, "world_size", 1)
    profile_dir = getattr(args, "profile_dir", None)
    # a short window of epoch 0, adapted to short epochs so that a started
    # trace is always stopped
    trace_start = min(10, max(num_batches - 2, 0))
    trace_stop = min(trace_start + 5, num_batches - 1)
    prof = None
    try:
        for i, batch in enumerate(loader):
            if profile_dir and epoch == 0 and trace_start < trace_stop:
                if i == trace_start and prof is None:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=activities)
                    prof.start()
                elif i == trace_stop and prof is not None:
                    _stop_trace(prof, profile_dir, epoch)
                    prof = None
            step = num_batches * epoch + i
            batch = _to_device(batch, device)
            if augment_fn is not None:
                aug_generator.manual_seed(_augment_seed(args.seed, epoch, i))
                batch["images"] = augment_fn(batch["images"], aug_generator)
            elif batch["images"].dtype == torch.uint8:
                batch["images"] = normalize_images(batch["images"], **mean_std)
            data_time_m.update(time.time() - end)

            state, metrics = step_fn(state, batch, generator=generator)

            # Read the *previous* step's metrics so the host runs ahead.
            if prev_metrics is not None:
                for k, v in prev_metrics.items():
                    losses_m[k].update(float(v), args.batch_size)
            prev_metrics = metrics

            # At a log step, wait for the card before the clock is read, so
            # its step lands in this batch's time and never in the next
            # batch's data time, which then is only the wait for the loader
            # and the copies' launch.
            log_now = i % args.log_every_n_steps == 0 or i == num_batches - 1
            if log_now:
                _sync(device)
            batch_time_m.update(time.time() - end)
            end = time.time()

            if log_now:
                num_samples = (i + 1) * args.batch_size * args.accum_freq
                pct = 100.0 * (i + 1) / num_batches
                samples_per_s = args.accum_freq * args.batch_size * world_size / max(batch_time_m.val, 1e-9)
                samples_per_s_per_dev = samples_per_s
                loss_val = losses_m["loss"].val if losses_m else float(metrics["loss"])
                lr = float(schedule(step)) if schedule is not None else args.lr
                logging.info(
                    f"Train Epoch: {epoch} [{num_samples:>{sample_digits}}/{epoch_samples} ({pct:.0f}%)] "
                    f"Loss: {loss_val:#.5g} "
                    f"Data (t): {data_time_m.avg:.3f} Batch (t): {batch_time_m.avg:.3f}, "
                    f"{samples_per_s:#g}/s, {samples_per_s_per_dev:#g}/s/dev LR: {lr:5f}"
                )
                if writer is not None:
                    log_data = {
                        "loss": loss_val,
                        "data_time": data_time_m.val,
                        "batch_time": batch_time_m.val,
                        "samples_per_second": samples_per_s,
                        "samples_per_second_per_device": samples_per_s_per_dev,
                        "lr": lr,
                    }
                    for name, val in log_data.items():
                        writer.add_scalar("train/" + name, val, step)
                batch_time_m.reset()
                data_time_m.reset()
    finally:
        if prof is not None:  # a started trace is always stopped
            _stop_trace(prof, profile_dir, epoch)
    logging.info(f"Train Epoch: {epoch} kernel launches: {json.dumps(launches_since(counts0))}")
    epoch_metrics = {k: m.avg for k, m in losses_m.items()}
    return state, epoch_metrics


def _stop_trace(prof, profile_dir: str, epoch: int) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_epoch{epoch}.json")
    prof.export_chrome_trace(path)
    logging.info(f"wrote a profiler trace to {path}")


def _refuse_zero_shot(data, args) -> None:
    zs_freq = getattr(args, "zeroshot_frequency", 0)
    if ("imagenet-val" in data or "imagenet-v2" in data) and zs_freq:
        raise NotImplementedError(
            f"ImageNet zero-shot eval is not ported ({_ROADMAP}: train/zero_shot.py)")


def evaluate(model, state, data, epoch: int, args, eval_step=None, writer=None,
             tokenizer=None) -> dict:
    """Validation loop: val loss, retrieval metrics, results.jsonl."""
    metrics: Dict[str, float] = {}
    _refuse_zero_shot(data, args)
    if "val" not in data:
        return metrics
    if eval_step is None:
        eval_step = build_eval_step(model)

    loader = data["val"].dataloader
    device = _device_of(state)
    cap = None if getattr(args, "metrics", False) else 10_000
    counts0 = launch_counts()

    all_img, all_txt, all_labels, all_captions = [], [], [], []
    cum_loss, cum_i2t, cum_t2i, num_samples = 0.0, 0.0, 0.0, 0
    scale = None

    for batch in loader:
        captions = batch.pop("caption", None)
        device_batch = _maybe_preprocess_images(
            _to_device(batch, device), args, getattr(loader, "preprocess_cfg", None))
        out = eval_step(device_batch)
        img_f, txt_f = out["image_features"], out["text_features"]
        scale = float(out["logit_scale"])
        b = img_f.shape[0]

        with torch.no_grad():
            if getattr(args, "multipositiveloss", False) and "labels" in batch:
                ldict = multipositive_clip_loss(
                    img_f, txt_f, device_batch["labels"], out["logit_scale"], delta=args.delta
                )
                cum_i2t += float(ldict["image_to_text_loss"]) * b
                cum_t2i += float(ldict["text_to_image_loss"]) * b
            else:
                ldict = clip_loss(img_f, txt_f, out["logit_scale"])
        cum_loss += float(ldict["loss"]) * b
        num_samples += b

        if cap is None or sum(a.shape[0] for a in all_img) < cap:
            all_img.append(img_f.float().cpu().numpy())
            all_txt.append(txt_f.float().cpu().numpy())
            if "labels" in batch:
                all_labels.append(np.asarray(batch["labels"]))
            if captions is not None:
                all_captions.extend(captions)

    if num_samples == 0:
        return metrics

    metrics["clip_val_loss"] = cum_loss / num_samples
    if cum_i2t:
        metrics["image_to_text_loss"] = cum_i2t / num_samples
        metrics["text_to_image_loss"] = cum_t2i / num_samples

    if all_img and all_labels:
        img = np.concatenate(all_img)
        txt = np.concatenate(all_txt)
        labels = np.concatenate(all_labels)
        gt_unique = None
        if getattr(args, "unique", False):
            # exact-caption identity ground truth
            if all_captions:
                uniq = {c: i for i, c in enumerate(dict.fromkeys(all_captions))}
                gt_unique = np.array([uniq[c] for c in all_captions])
            else:
                gt_unique = np.arange(len(labels))
        trace = getattr(args, "tracepreds", False)
        res = get_clip_metrics(img, txt, scale, labels, gt_unique, trace=trace)
        if trace:
            res, vocabulary = res
            _dump_traced(vocabulary, loader, getattr(args, "checkpoint_path", "."))
        metrics.update(res)

    metrics["epoch"] = epoch
    metrics["num_samples"] = num_samples
    logging.info(
        f"Eval Epoch: {epoch} "
        + "\t".join([f"{k}: {round(v, 4):.4f}" for k, v in metrics.items() if isinstance(v, float)])
    )
    logging.info(f"Eval Epoch: {epoch} kernel launches: {json.dumps(launches_since(counts0))}")

    append_results_jsonl(args, metrics)
    if writer is not None:
        for name, val in metrics.items():
            if isinstance(val, (int, float, np.floating)):
                writer.add_scalar("val/" + name, val, epoch)
    return metrics


def _dump_traced(vocabulary: dict, loader, out_dir: str) -> None:
    """--tracepreds: the top-10 vocabulary and the first anchors' images
    with their top-3 retrievals."""
    import shutil

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocabulary.json"), "w") as f:
        json.dump(dict(vocabulary), f, default=str)
    paths = getattr(getattr(loader, "dataset", None), "images", None)
    if paths is None:
        return
    traced_dir = os.path.join(out_dir, "traced_images")
    os.makedirs(traced_dir, exist_ok=True)
    vocab = vocabulary.get("image_to_text_general", {})
    for anchor_idx in list(vocab)[:20]:
        entry = vocab[anchor_idx]
        try:
            shutil.copy(paths[entry["anchor"]],
                        os.path.join(traced_dir, f"anchor_{entry['anchor']}.png"))
            for rank_pos, j in enumerate(entry["indices"][:3]):
                shutil.copy(paths[j], os.path.join(
                    traced_dir, f"anchor_{entry['anchor']}_top{rank_pos}_idx{j}.png"))
        except (OSError, IndexError) as e:
            logging.warning(f"tracepreds image export failed: {e}")
            break


def _logit_scale(state) -> float:
    ls = state.params.get("logit_scale", (getattr(state, "constants", None) or {}).get("logit_scale"))
    return float(torch.exp(ls.detach().float()).item()) if ls is not None else 1.0


@torch.no_grad()
def test_metrics(model, state, data, args, tokenizer=None) -> dict:
    """Full-dataset test eval with 3D voting. The loader's dataset must
    expose `.captions`, `.labels` and `.volume_ids` (CsvDataset does)."""
    split = "val" if "val" in data else "train"
    loader = data[split].dataloader
    dataset = loader.dataset
    device = _device_of(state)
    model.eval()

    captions = [str(c) for c in dataset.captions]
    labels = np.asarray(dataset.labels)
    volume_ids = list(dataset.volume_ids)

    # 1. dedup captions, encode the unique texts
    unique_captions = list(dict.fromkeys(captions))
    cap_to_unique = {c: i for i, c in enumerate(unique_captions)}
    assert tokenizer is not None, "test_metrics needs a tokenizer"
    txt_chunks = []
    bs = args.batch_size
    for s in range(0, len(unique_captions), bs):
        toks = torch.from_numpy(np.asarray(tokenizer(unique_captions[s:s + bs]))).to(device)
        txt_chunks.append(model(None, toks)["text_features"].float().cpu().numpy())
    unique_txt = np.concatenate(txt_chunks)  # [U, D]
    first_idx: Dict[str, int] = {}
    for i, c in enumerate(captions):
        first_idx.setdefault(c, i)
    unique_labels = np.array([labels[first_idx[c]] for c in unique_captions])

    # 2. encode the images; per-image ranks against all unique texts
    img_feats, img_labels = [], []
    for batch in loader:
        images = _maybe_preprocess_images(
            _to_device({"images": batch["images"]}, device), args,
            getattr(loader, "preprocess_cfg", None))["images"]
        img_feats.append(model(images, None)["image_features"].float().cpu().numpy())
        img_labels.append(np.asarray(batch["labels"]))
    img = np.concatenate(img_feats)
    img_labels = np.concatenate(img_labels)[: len(img)]

    scale = _logit_scale(state)
    sims = scale * img @ unique_txt.T  # [N, U]
    order = np.argsort(-sims, axis=1, kind="stable")

    # best same-label rank per image ("general" ground truth)
    same = unique_labels[order] == img_labels[: len(order), None]
    i2t_ranks = np.argmax(same, axis=1)
    i2t_ranks[~same.any(axis=1)] = len(unique_captions)

    metrics = {
        "i2t_mean_rank": float(i2t_ranks.mean() + 1),
        "i2t_median_rank": float(np.floor(np.median(i2t_ranks)) + 1),
    }
    for k in (1, 5, 10):
        metrics[f"i2t_R@{k}"] = float(np.mean(i2t_ranks < k))

    # "unique" ground truth: the image's own caption must rank high
    own_unique = np.array([cap_to_unique[c] for c in captions])[: len(order)]
    i2t_unique_ranks = np.argmax(order == own_unique[:, None], axis=1)
    metrics["i2t_unique_mean_rank"] = float(i2t_unique_ranks.mean() + 1)
    metrics["i2t_unique_median_rank"] = float(np.floor(np.median(i2t_unique_ranks)) + 1)
    for k in (1, 5, 10):
        metrics[f"i2t_unique_R@{k}"] = float(np.mean(i2t_unique_ranks < k))

    # 3. 3D volume voting
    top10_labels = unique_labels[order[:, :10]]
    slice_votes: Dict[str, list] = defaultdict(list)
    vol_true: Dict[str, list] = defaultdict(list)
    for i in range(len(order)):
        vol = volume_ids[i] if i < len(volume_ids) else f"v{i}"
        slice_votes[vol].append(top10_labels[i].tolist())
        vol_true[vol].append(int(img_labels[i]))
    metrics.update(volume_voting_metrics(slice_votes, vol_true))

    # 4. t2i: per-unique-text best same-label image rank
    sims_t = sims.T  # [U, N]
    order_t = np.argsort(-sims_t, axis=1, kind="stable")
    same_t = img_labels[order_t] == unique_labels[:, None]
    t2i_ranks = np.argmax(same_t, axis=1)
    t2i_ranks[~same_t.any(axis=1)] = len(img_labels)
    metrics["t2i_mean_rank"] = float(t2i_ranks.mean() + 1)
    metrics["t2i_median_rank"] = float(np.floor(np.median(t2i_ranks)) + 1)
    for k in (1, 5, 10):
        metrics[f"t2i_R@{k}"] = float(np.mean(t2i_ranks < k))

    out_dir = getattr(args, "checkpoint_path", ".")
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "i2t_ranks.npy"), i2t_ranks)
    np.save(os.path.join(out_dir, "t2i_ranks.npy"), t2i_ranks)

    if getattr(args, "tracepreds", False):
        # the anchor images and their top predicted captions
        import shutil

        traced_dir = os.path.join(out_dir, "test_traced")
        os.makedirs(traced_dir, exist_ok=True)
        paths = getattr(dataset, "images", None)
        preds = {}
        for i in range(min(20, len(order))):
            preds[str(i)] = {
                "true_caption": captions[i],
                "true_label": int(img_labels[i]),
                "predicted": [
                    {"caption": unique_captions[j], "label": int(unique_labels[j])}
                    for j in order[i, :10]
                ],
                "general_rank": int(i2t_ranks[i]),
                "unique_rank": int(i2t_unique_ranks[i]),
            }
            if paths is not None:
                try:
                    shutil.copy(str(paths[i]), os.path.join(traced_dir, f"anchor_{i}.png"))
                except OSError as e:
                    logging.warning(f"tracepreds image export failed: {e}")
        with open(os.path.join(traced_dir, "predictions.json"), "w") as f:
            json.dump(preds, f, indent=1)
    grouped = {
        vol: {"true": vol_true[vol][0], "votes": slice_votes[vol]} for vol in slice_votes
    }
    with open(os.path.join(out_dir, "grouped_3d_analysis.json"), "w") as f:
        json.dump(grouped, f)
    logging.info("test_metrics: " + json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    return metrics


@torch.no_grad()
def get_features(model, state, loader) -> tuple:
    """Frozen image features + labels, as numpy; uint8 images through the
    eval preprocessing at their own size."""
    device = _device_of(state)
    model.eval()
    feats, labels = [], []
    for batch in loader:
        images = _to_device({"images": batch["images"]}, device)["images"]
        if images.dtype == torch.uint8:
            images = eval_preprocess_batch(images, out_size=tuple(images.shape[1:3]),
                                           **_mean_std(getattr(loader, "preprocess_cfg", None)))
        feats.append(model(images, None)["image_features"].float().cpu().numpy())
        labels.append(np.asarray(batch["labels"]))
    return np.concatenate(feats), np.concatenate(labels)


def linear_probe(model, state, data, args) -> dict:
    """The linear probe on frozen features (`--linear`): not ported."""
    raise NotImplementedError(f"--linear (linear_probe) is not ported ({_ROADMAP}: linear_probe)")
