"""Training: the optimizers and schedules, the train step, the epoch loop
and checkpoints (counterpart of ``pdanet_tpu/train``)."""

from .optimization import (
    AdamOneCycle,
    DecaySteps,
    OneCycle,
    SGDMomentum,
    build_optimizer_and_schedule,
)
from .train_utils import (
    CheckpointError,
    checkpoint_state,
    load_checkpoint,
    load_model_state,
    load_newest_checkpoint,
    make_train_step,
    restore_from_checkpoint,
    save_checkpoint,
    select_device_batch,
    train_model,
    train_one_epoch,
)

__all__ = [
    "AdamOneCycle", "DecaySteps", "OneCycle", "SGDMomentum", "build_optimizer_and_schedule",
    "CheckpointError", "checkpoint_state", "load_checkpoint", "load_model_state",
    "load_newest_checkpoint", "make_train_step", "restore_from_checkpoint",
    "save_checkpoint", "select_device_batch", "train_model", "train_one_epoch",
]
