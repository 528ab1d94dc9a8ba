"""Training: losses, steps, the optimizer recipe and the epoch loops
(counterpart of ``can_tpu/train``)."""

from can_tpu_torch.train.loop import EpochStats, evaluate, train_one_epoch
from can_tpu_torch.train.loss import density_counts, masked_mse_sum
from can_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
from can_tpu_torch.train.steps import (
    NonFiniteLossError,
    batch_signature,
    make_bucketed_train_step,
    make_eval_step,
    make_train_step,
    normalize_on_device,
)

__all__ = ["EpochStats", "evaluate", "train_one_epoch", "density_counts",
           "masked_mse_sum", "TrainState", "create_train_state",
           "make_lr_schedule", "make_optimizer", "NonFiniteLossError",
           "batch_signature", "make_bucketed_train_step", "make_eval_step",
           "make_train_step", "normalize_on_device"]
