"""Training pieces of the port (counterpart of `mrclip_tpu/train`): the
schedules, the vision-only step, the metrics, the epoch loops and the CLI
(`python -m mrclip_tpu_torch.train.main`)."""

from .loop import AverageMeter, evaluate, get_features, linear_probe, test_metrics, train_one_epoch
from .metrics import get_clip_metrics, rank_metrics, volume_voting_metrics
from .params import parse_args
from .scheduler import const_lr, const_lr_cooldown, cosine_lr, create_scheduler
from .vision_only import build_vision_only_step, evaluate_vision_only, train_one_epoch_vision_only

__all__ = ["AverageMeter", "build_vision_only_step", "const_lr", "const_lr_cooldown", "cosine_lr",
           "create_scheduler", "evaluate", "evaluate_vision_only", "get_clip_metrics",
           "get_features", "linear_probe", "parse_args", "rank_metrics", "test_metrics",
           "train_one_epoch", "train_one_epoch_vision_only", "volume_voting_metrics"]
