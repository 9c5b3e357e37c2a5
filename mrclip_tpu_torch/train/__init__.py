"""Training pieces of the port (counterpart of `mrclip_tpu/train`)."""

from .scheduler import const_lr, const_lr_cooldown, cosine_lr, create_scheduler
from .vision_only import build_vision_only_step

__all__ = ["build_vision_only_step", "const_lr", "const_lr_cooldown", "cosine_lr",
           "create_scheduler"]
