"""Per-step learning-rate schedules (the port of
`mrclip_tpu/train/scheduler.py`): `const_lr`, `const_lr_cooldown`
(polynomial) and `cosine_lr`, all with the `base_lr * (step + 1) / warmup`
linear warmup, as plain step -> float functions."""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["const_lr", "const_lr_cooldown", "cosine_lr", "create_scheduler"]


def _warmup_lr(base_lr: float, warmup_length: int, step) -> float:
    return base_lr * (step + 1) / max(warmup_length, 1)


def const_lr(base_lr: float, warmup_length: int, steps: int) -> Callable[[int], float]:
    def schedule(step):
        return _warmup_lr(base_lr, warmup_length, step) if step < warmup_length else base_lr

    return schedule


def const_lr_cooldown(
    base_lr: float,
    warmup_length: int,
    steps: int,
    cooldown_steps: int,
    cooldown_power: float = 1.0,
    cooldown_end_lr: float = 0.0,
) -> Callable[[int], float]:
    """Constant LR with a polynomial cooldown over the last `cooldown_steps`."""
    start_cooldown_step = steps - cooldown_steps

    def schedule(step):
        if step < warmup_length:
            return _warmup_lr(base_lr, warmup_length, step)
        if step < start_cooldown_step:
            return base_lr
        e = step - start_cooldown_step
        es = steps - start_cooldown_step
        decay = (1 - (e / es)) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return schedule


def cosine_lr(base_lr: float, warmup_length: int, steps: int) -> Callable[[int], float]:
    def schedule(step):
        if step < warmup_length:
            return _warmup_lr(base_lr, warmup_length, step)
        e = step - warmup_length
        es = max(steps - warmup_length, 1)
        return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr

    return schedule


def create_scheduler(args, total_steps: int) -> Callable[[int], float]:
    """Schedule from the CLI flags (`lr_scheduler`, `lr`, `warmup`,
    `epochs_cooldown`, `lr_cooldown_power`, `lr_cooldown_end`)."""
    sched = getattr(args, "lr_scheduler", "cosine")
    base_lr = args.lr
    warmup = getattr(args, "warmup", 0)
    if sched == "cosine":
        return cosine_lr(base_lr, warmup, total_steps)
    if sched == "const":
        return const_lr(base_lr, warmup, total_steps)
    if sched == "const-cooldown":
        epochs_cooldown = getattr(args, "epochs_cooldown", None)
        if epochs_cooldown is None:
            raise ValueError("const-cooldown requires epochs_cooldown")
        # epochs -> steps
        steps_per_epoch = total_steps // max(getattr(args, "epochs", 1), 1)
        return const_lr_cooldown(
            base_lr,
            warmup,
            total_steps,
            steps_per_epoch * epochs_cooldown,
            getattr(args, "lr_cooldown_power", 1.0),
            getattr(args, "lr_cooldown_end", 0.0),
        )
    raise ValueError(f"Unknown scheduler {sched}")
