"""Training: step, optimizer and schedule, full-state checkpoints."""
from .checkpoint import CheckpointManager, load_train_state, save_train_state
from .step import (
    Optimizer,
    TrainBatch,
    TrainState,
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
    "load_train_state",
    "make_optimizer",
    "multistep_lr",
    "save_train_state",
    "task_loss_fn",
    "train_step",
]
