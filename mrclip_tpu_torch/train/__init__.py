"""Training pieces of the port (counterpart of `mrclip_tpu/train`)."""

from .scheduler import const_lr, const_lr_cooldown, cosine_lr, create_scheduler

__all__ = ["const_lr", "const_lr_cooldown", "cosine_lr", "create_scheduler"]
