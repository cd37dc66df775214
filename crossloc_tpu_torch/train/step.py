"""Training step: forward, task loss, backward, Adam with the reference's
epoch-milestone LR (counterpart of `crossloc_tpu/train/step.py`).

The state is a model, a `torch.optim.Adam` and the count of updates done;
the LR of update k is a pure function of k, so a resume at any step sets
it exactly (the JAX CLI's log-parse resume restarts optax's own count,
ROADMAP R5). The uncertainty channel splits off the last (channel) axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..geometry import intrinsics
from ..losses import (
    CoordLossConfig,
    DepthLossConfig,
    NormalLossConfig,
    depth_loss,
    normal_loss,
    scene_coords_loss,
    semantics_loss,
)


class TrainBatch(NamedTuple):
    """One training minibatch on the training device, NHWC."""

    images: torch.Tensor  # [B, H, W, C] normalised RGB or grayscale
    poses: torch.Tensor  # [B, 4, 4] cam-to-world
    labels: torch.Tensor  # [B, h, w, C_task] task ground truth; semantics: [B, H, W, 1] ids
    focal: torch.Tensor  # [] or [B] focal length (after augmentation)
    pp_shift: Optional[torch.Tensor] = None  # [2] principal-point offset of the
    # augmentation's crop window (data.augment_batch), or None


def task_loss_fn(task: str, predictions, batch: TrainBatch, uncertainty: Optional[str],
                 num_task_channel: int, nodata_value: float = -1.0,
                 coord_cfg: Optional[CoordLossConfig] = None,
                 depth_cfg: Optional[DepthLossConfig] = None,
                 normal_cfg: Optional[NormalLossConfig] = None, reduction: Optional[str] = "mean"):
    """Split the uncertainty channel and compute the task's loss: (loss, valid_rate)."""
    if uncertainty == "MLE":
        preds = predictions[..., :num_task_channel]
        unc = predictions[..., num_task_channel:]
    else:
        preds, unc = predictions, None
    if task == "coord":
        cfg = coord_cfg or CoordLossConfig(nodata_value=nodata_value)
        img_h, img_w = batch.images.shape[1], batch.images.shape[2]
        focal = batch.focal.reshape(-1)[0]
        cam_mat = intrinsics(focal, img_w, img_h, device=focal.device)
        if batch.pp_shift is not None:
            shift = torch.zeros_like(cam_mat)
            shift[0, 2], shift[1, 2] = batch.pp_shift[0], batch.pp_shift[1]
            cam_mat = cam_mat + shift
        return scene_coords_loss(preds, batch.labels, batch.poses, cam_mat, unc, cfg, reduction)
    if task == "depth":
        cfg = depth_cfg or DepthLossConfig(nodata_value=nodata_value)
        return depth_loss(preds, batch.labels, unc, cfg, reduction)
    if task == "normal":
        cfg = normal_cfg or NormalLossConfig(nodata_value=nodata_value)
        return normal_loss(preds, batch.labels, unc, cfg, reduction)
    if task == "semantics":
        return semantics_loss(preds, batch.labels, unc, reduction)
    raise NotImplementedError(f"task={task}")


def multistep_lr(base_lr: float, steps_per_epoch: int, milestones=(50, 100), gamma: float = 0.5,
                 enabled: bool = True) -> Callable[[int], float]:
    """LR of update k (0-based): x gamma for each milestone epoch reached,
    MultiStepLR([50, 100], 0.5) on epochs; equal to optax's
    `piecewise_constant_schedule` at milestone * steps_per_epoch. Constant
    when scheduling is off."""
    bounds = [int(m) * int(steps_per_epoch) for m in milestones]

    def lr_at(step: int) -> float:
        if not enabled:
            return base_lr
        return base_lr * gamma ** sum(step >= b for b in bounds)

    return lr_at


class Optimizer(NamedTuple):
    adam: torch.optim.Adam
    schedule: Callable[[int], float]
    grad_clip: Optional[float] = None


def make_optimizer(params, learning_rate: float, steps_per_epoch: int = 1,
                   no_lr_scheduling: bool = False, grad_clip: Optional[float] = None) -> Optimizer:
    """Adam (optax's betas and eps 1e-8) with the reference's LR schedule
    and an optional clip of the gradients' global norm."""
    schedule = multistep_lr(learning_rate, steps_per_epoch, enabled=not no_lr_scheduling)
    adam = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    return Optimizer(adam, schedule, grad_clip)


@dataclass
class TrainState:
    """Model, optimizer and the number of updates done (the LR's clock)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def _global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in float32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def apply_gradients(state: TrainState, params) -> torch.Tensor:
    """The optimizer's update of `params` from their `.grad`, in place: the
    optional global-norm clip, the step's LR, Adam; counts the update.
    Returns the gradients' global norm (before the clip)."""
    opt = state.optimizer
    grads = [p.grad for p in params if p.grad is not None]
    grad_norm = _global_norm(grads)
    if opt.grad_clip is not None:
        # optax.clip_by_global_norm: scale by clip / norm only when norm >= clip
        scale = torch.where(grad_norm < opt.grad_clip, torch.ones_like(grad_norm),
                            opt.grad_clip / grad_norm)
        torch._foreach_mul_(grads, scale)
    for group in opt.adam.param_groups:
        group["lr"] = opt.schedule(state.step)
    opt.adam.step()
    state.step += 1
    return grad_norm.detach()


def train_step(state: TrainState, batch: TrainBatch, task: str, uncertainty: Optional[str],
               nodata_value: float = -1.0, coord_cfg: Optional[CoordLossConfig] = None,
               depth_cfg: Optional[DepthLossConfig] = None,
               normal_cfg: Optional[NormalLossConfig] = None) -> dict:
    """One update in place; returns {"loss", "valid_rate", "grad_norm"} as
    0-d tensors on the device (reading them waits for the step)."""
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]
    state.optimizer.adam.zero_grad(set_to_none=True)
    preds = model(batch.images)
    loss, valid_rate = task_loss_fn(task, preds, batch, uncertainty, model.num_task_channel,
                                    nodata_value, coord_cfg, depth_cfg, normal_cfg)
    loss.backward()
    grad_norm = apply_gradients(state, params)
    return {"loss": loss.detach(), "valid_rate": valid_rate, "grad_norm": grad_norm}
