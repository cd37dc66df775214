"""Training: step, DSAC step, optimizer and schedule, full-state checkpoints."""
from .checkpoint import CheckpointManager, load_train_state, save_train_state
from .dsac_step import make_dsac_train_step
from .step import (
    Optimizer,
    TrainBatch,
    TrainState,
    apply_gradients,
    make_optimizer,
    multistep_lr,
    task_loss_fn,
    train_step,
)

__all__ = [
    "CheckpointManager",
    "Optimizer",
    "TrainBatch",
    "TrainState",
    "apply_gradients",
    "load_train_state",
    "make_dsac_train_step",
    "make_optimizer",
    "multistep_lr",
    "save_train_state",
    "task_loss_fn",
    "train_step",
]
