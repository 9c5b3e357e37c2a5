"""Training entry point of the port: `python -m mrclip_tpu_torch.train.main <flags>`
(counterpart of `mrclip_tpu/train/main.py`).

The JAX package's flags (`train/params.py`) plus `--device`: the run trains
on the CUDA card unless `--device cpu` is given, and raises without a card.
It does: experiment naming, `out.log`, `params.txt`, `checkpoints/`,
`--copy-codebase`; the model (remat under `--grad-checkpointing
--remat-policy`) and its transforms; the tokenizer/vocabulary check; the
data; the schedule, the optimizer (`--opt adamw|sgd|lion|adafactor`), the
update mask of `--lock-image*`, `--lock-text*`, `--freeze` and
`--freezelast`, and the train state; `--resume latest|path`; `--test`; the
loss and the train step (`--accum-freq`, `--cached-features-accum`; the
text dropout's masks from a generator on the model's device, seeded from
`--seed` and the epoch), or the image-only step, epoch loop and eval of
`--visiononly --multipositiveloss`; the epochs with `--save-frequency`,
`--save-most-recent`, `--delete-previous-checkpoint` and
`--val-frequency`; `--native-loader` (the C++ loader, `data.get_data`) and
`--device-augment` (the MR-CLIP augmentation on the card on whatever the
loader made, `ops.image_ops.random_augment_batch` at `--image-size` with
`--force-image-size` folded in, its draws seeded from `--seed`, the epoch
and the step; as in the JAX package it augments the CSV loader's
transformed images, or the native loader's warped canvases, a second
time). Tensorboard and wandb warn and carry on when they are not
installed.

What the port does not have yet raises `NotImplementedError` naming its
ROADMAP item, before anything is written: the device mesh (`--mesh-fsdp`,
`--mesh-tp` > 1), `--remote-sync`, `--linear`, and the data options
`data.get_data` refuses. `--accum-freq` > 1 with the
vision-only path raises `ValueError`, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import sys
from datetime import datetime
from functools import partial

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..data import get_data
from ..factory import (create_loss, create_model, create_model_and_transforms, get_model_config,
                       get_tokenizer)
from ..parallel import (
    build_eval_step,
    build_train_step,
    create_optimizer,
    create_train_state,
    make_loss_apply,
)
from ..ops.image_ops import random_augment_batch
from ..parallel.freeze import build_trainable_mask, chain_with_mask
from ..transforms import AugmentationCfg, validate_aug_cfg
from ..utils import resolve_device, to_2tuple
from .logger import setup_logging
from .loop import evaluate, linear_probe, test_metrics, train_one_epoch
from .params import parse_args
from .scheduler import create_scheduler
from .vision_only import build_vision_only_step, evaluate_vision_only, train_one_epoch_vision_only

def random_seed(seed=42, rank=0):
    np.random.seed(seed + rank)
    random.seed(seed + rank)


def _refuse_unported(args) -> None:
    """Raise for every flag whose part is not ported, naming its ROADMAP
    item, before any side effect."""
    def no(what, item):
        raise NotImplementedError(f"{what} is not ported (ROADMAP: {item})")

    if args.mesh_fsdp > 1 or args.mesh_tp > 1:
        no("a device mesh (--mesh-fsdp/--mesh-tp > 1)", "modules item 6, multi-GPU")
    if args.remote_sync:
        no("--remote-sync", "modules item 3, train/file_utils.py")
    if args.linear:
        no("--linear", "modules item 3, linear_probe")
    if args.visiononly and args.multipositiveloss and args.accum_freq > 1:
        raise ValueError(
            "--accum-freq > 1 is not supported with --visiononly: the vision-only step has no "
            "microbatch accumulation (drop the flag or use the image-text path)")


def _device_augment(args):
    """`--device-augment`: `random_augment_batch(images, generator)` at
    `args.image_size` (which folds in --force-image-size) with the
    validated `--aug-cfg`'s scale, ratio and colour extras."""
    aug = (AugmentationCfg(**args.aug_cfg) if isinstance(args.aug_cfg, dict)
           else args.aug_cfg or AugmentationCfg())
    validate_aug_cfg(aug, backend="device")
    return partial(random_augment_batch, out_size=to_2tuple(args.image_size),
                   crop_scale=tuple(aug.scale or (0.9, 1.0)),
                   ratio=tuple(aug.ratio or (3.0 / 4.0, 4.0 / 3.0)),
                   color_jitter=tuple(aug.color_jitter) if aug.color_jitter else None,
                   color_jitter_prob=aug.color_jitter_prob or 0.0,
                   gray_scale_prob=aug.gray_scale_prob or 0.0)


def main(args=None):
    args = parse_args(args)
    device = resolve_device(args.device)  # no card and no --device: RuntimeError
    args.device = str(device)
    _refuse_unported(args)
    rank = 0
    args.rank, args.world_size, args.distributed = rank, 1, False

    # experiment naming
    if args.name is None:
        model_name_safe = args.model.replace("/", "-")
        date_str = datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
        args.name = "-".join([
            date_str,
            f"model_{model_name_safe}",
            f"lr_{args.lr}",
            f"b_{args.batch_size}",
            f"p_{args.precision}",
        ])

    log_base_path = os.path.join(args.logs, args.name)
    os.makedirs(log_base_path, exist_ok=True)
    args.log_path = os.path.join(log_base_path, "out.log")
    args.log_level = logging.DEBUG if args.debug else logging.INFO
    setup_logging(args.log_path, args.log_level)

    args.checkpoint_path = os.path.join(log_base_path, "checkpoints")
    os.makedirs(args.checkpoint_path, exist_ok=True)

    if args.precision in ("fp16", "amp", "amp_fp16"):
        logging.info(f"precision {args.precision}: bf16 compute, fp32 parameters (no GradScaler)")

    if args.copy_codebase:
        code_dir = os.path.join(log_base_path, "code")
        package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if not os.path.exists(code_dir):
            shutil.copytree(package, os.path.join(code_dir, os.path.basename(package)),
                            ignore=shutil.ignore_patterns("__pycache__", "assets"))
            logging.info(f"Copied codebase to {code_dir}")

    random_seed(args.seed, 0)

    model, preprocess_train, preprocess_val = create_model_and_transforms(
        args.model,
        pretrained=args.pretrained or None,
        precision=args.precision,
        device=device,
        force_quick_gelu=args.force_quick_gelu,
        force_patch_dropout=args.force_patch_dropout,
        force_image_size=tuple(args.force_image_size) if args.force_image_size else None,
        logit_scale_trainable=not args.logitscaletrainable,
        grad_checkpointing=args.grad_checkpointing,
        remat_policy=args.remat_policy,
        attn_impl=args.attn_impl,
        gelu_approx=args.gelu_approx,
        text_dropout=args.textdropout,
        aug_cfg=args.aug_cfg,
        rng_seed=args.seed,
    )
    model_cfg = get_model_config(args.model) or {}
    args.image_size = (
        tuple(args.force_image_size) if args.force_image_size
        else model_cfg.get("vision_cfg", {}).get("image_size", 224)
    )
    n_params = sum(p.numel() for p in model.parameters())
    logging.info(f"Model: {args.model} ({n_params / 1e6:.1f}M params) on {device}, "
                 f"attn_impl={args.attn_impl!r}")

    with open(os.path.join(log_base_path, "params.txt"), "w") as f:
        for name in sorted(vars(args)):
            f.write(f"{name}: {getattr(args, name)}\n")

    # data. A tokenizer emitting ids past the model's vocabulary would index
    # past the embedding table; real data must match (the synthetic set
    # folds its placeholder ids into range).
    tokenizer = get_tokenizer(args.model)
    model_vocab = model_cfg.get("text_cfg", {}).get("vocab_size")
    tok_vocab = getattr(tokenizer, "vocab_size", None)
    args._model_vocab_size = model_vocab
    if model_vocab and tok_vocab and tok_vocab > model_vocab and args.dataset_type != "synthetic":
        raise ValueError(
            f"tokenizer emits ids up to {tok_vocab - 1} but model "
            f"'{args.model}' has vocab_size {model_vocab}: out-of-range ids "
            "would index past the embedding table. Use a matching tokenizer/config."
        )
    data = get_data(args, (preprocess_train, preprocess_val), epoch=0, tokenizer=tokenizer)
    assert len(data), "At least one train or val dataset must be specified."

    # optimizer + schedule; the train loader's batches hold accum_freq *
    # batch_size rows, so its length counts optimizer steps
    steps_per_epoch = len(data["train"].dataloader) if "train" in data else 0
    total_steps = steps_per_epoch * args.epochs
    schedule = None if args.skip_scheduler else create_scheduler(args, total_steps)
    tx = create_optimizer(
        lr=schedule if schedule is not None else args.lr,
        beta1=args.beta1,
        beta2=args.beta2,
        eps=args.eps,
        wd=args.wd,
        grad_clip_norm=args.grad_clip_norm,
        opt=args.opt,
        momentum=args.momentum,
        moments_dtype="bfloat16" if args.bf16_moments else None,
    )
    state = create_train_state(model, tx)
    mask = build_trainable_mask(state.params, args)
    if mask is not None:
        tx = chain_with_mask(tx, mask)
        logging.info(f"Frozen: {sum(v == 0.0 for v in mask.values())} of {len(mask)} "
                     "parameter tensors (their updates masked)")

    # resume
    start_epoch = 0
    if args.resume:
        if args.resume == "latest":
            step = ckpt.latest_step(args.checkpoint_path)
            if step is not None:
                state = ckpt.load_checkpoint(args.checkpoint_path, step, template=state)
                start_epoch = int(step)
                logging.info(f"=> resuming checkpoint (epoch {start_epoch})")
        else:
            state = ckpt.load_checkpoint(args.resume, template=state)
            logging.info(f"=> loaded checkpoint '{args.resume}'")

    # one-shot modes
    if args.linear:
        return linear_probe(model, state, data, args)
    if args.test:
        return test_metrics(model, state, data, args, tokenizer=tokenizer)

    eval_step = build_eval_step(model)
    if "train" not in data:
        evaluate(model, state, data, start_epoch, args, eval_step=eval_step, tokenizer=tokenizer)
        return state

    teacher = None
    if args.distill:
        teacher = create_model(args.distill_model, pretrained=args.distill_pretrained,
                               precision=args.precision, device=device)
        logging.info(f"Distilling from {args.distill_model} ({args.distill_pretrained})")

    vision_only = args.visiononly and args.multipositiveloss
    if vision_only:
        step_fn = build_vision_only_step(model, tx)
    else:
        step_fn = build_train_step(
            model, make_loss_apply(create_loss(args)), tx, accum_freq=args.accum_freq,
            cached_features_accum=args.cached_features_accum, teacher=teacher,
            freeze_bn_subtrees=("visual",) if args.lock_image and args.lock_image_freeze_bn_stats
            else ())
    generator = torch.Generator(device=device)
    augment_fn = _device_augment(args) if args.device_augment else None

    writer = None
    if "tensorboard" in (args.report_to or ""):
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(log_base_path, "tensorboard"))
        except ImportError:
            logging.warning("tensorboard not available; skipping")
    if "wandb" in (args.report_to or ""):
        try:
            import wandb

            wandb.init(project=args.wandb_project_name, name=args.name,
                       notes=args.wandb_notes, config=vars(args))
        except ImportError:
            logging.warning("wandb not available; skipping")

    for epoch in range(start_epoch, args.epochs):
        logging.info(f"Start epoch {epoch}")
        if vision_only:
            state, _ = train_one_epoch_vision_only(step_fn, state, data, epoch, args, schedule,
                                                   generator=generator)
        else:
            state, _ = train_one_epoch(step_fn, state, data, epoch, args, schedule, writer,
                                       generator=generator, augment_fn=augment_fn)
        completed_epoch = epoch + 1

        if (completed_epoch == args.epochs or args.save_most_recent
                or (args.save_frequency > 0 and completed_epoch % args.save_frequency == 0)):
            keep = 1 if args.delete_previous_checkpoint else None
            ckpt.save_checkpoint(args.checkpoint_path, completed_epoch, state, keep=keep)
            logging.info(f"Saved checkpoint at epoch {completed_epoch}")

        if "val" in data and (
            (args.val_frequency and completed_epoch % args.val_frequency == 0)
            or completed_epoch == args.epochs
        ):
            if vision_only:
                evaluate_vision_only(model, state, data, completed_epoch, args)
            else:
                evaluate(model, state, data, completed_epoch, args, eval_step=eval_step,
                         writer=writer, tokenizer=tokenizer)

    if writer is not None:
        writer.close()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
