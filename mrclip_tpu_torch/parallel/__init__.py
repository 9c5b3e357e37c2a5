"""Train state, optimizer and train step of the port (counterpart of
`mrclip_tpu/parallel`, on one device)."""

from .train_step import (
    LOGIT_SCALE_MAX,
    TrainState,
    build_eval_step,
    build_train_step,
    create_optimizer,
    create_train_state,
    make_loss_apply,
)

__all__ = [
    "LOGIT_SCALE_MAX",
    "TrainState",
    "build_eval_step",
    "build_train_step",
    "create_optimizer",
    "create_train_state",
    "make_loss_apply",
]
