"""Training: the ``adam_onecycle`` optimizer and schedule, the train step,
the epoch loop and checkpoints (counterpart of ``pdanet_tpu/train``)."""

from .optimization import AdamOneCycle, OneCycle, build_optimizer_and_schedule
from .train_utils import (
    CheckpointError,
    checkpoint_state,
    load_checkpoint,
    make_train_step,
    restore_from_checkpoint,
    save_checkpoint,
    select_device_batch,
    train_one_epoch,
)

__all__ = [
    "AdamOneCycle", "OneCycle", "build_optimizer_and_schedule", "CheckpointError",
    "checkpoint_state", "load_checkpoint", "make_train_step",
    "restore_from_checkpoint", "save_checkpoint", "select_device_batch",
    "train_one_epoch",
]
