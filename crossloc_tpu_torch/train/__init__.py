"""Training: step, DSAC step, optimizer and schedule, full-state checkpoints."""
from .checkpoint import (
    CheckpointManager,
    load_train_state,
    load_train_state_dict,
    save_train_state,
    train_state_dict,
)
from .dsac_step import make_dsac_train_step, train_ransac_config
from .step import (
    Optimizer,
    TrainBatch,
    TrainState,
    apply_gradients,
    make_optimizer,
    multistep_lr,
    param_sum,
    task_loss_fn,
    train_step,
    update_params,
)

__all__ = [
    "CheckpointManager",
    "Optimizer",
    "TrainBatch",
    "TrainState",
    "apply_gradients",
    "load_train_state",
    "load_train_state_dict",
    "make_dsac_train_step",
    "make_optimizer",
    "multistep_lr",
    "param_sum",
    "save_train_state",
    "task_loss_fn",
    "train_state_dict",
    "train_ransac_config",
    "train_step",
    "update_params",
]
