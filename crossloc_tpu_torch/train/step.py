"""Training step: forward, task loss, backward, Adam with the reference's
epoch-milestone LR (counterpart of `crossloc_tpu/train/step.py`).

The state is a model, a `torch.optim.Adam` and the count of updates done;
the LR of update k is a pure function of k, so a resume at any step sets
it exactly (the JAX CLI's log-parse resume restarts optax's own count,
ROADMAP R5). The uncertainty channel splits off the last (channel) axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..geometry import intrinsics
from ..parallel import DataParallel
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
                 normal_cfg: Optional[NormalLossConfig] = None, reduction: Optional[str] = "mean",
                 count_reduce=None, spatial: Tuple[int, int] = (0, 1)):
    """Split the uncertainty channel and compute the task's loss: (loss,
    valid_rate). `count_reduce` makes the coord loss's valid-pixel gate
    batch-global under data parallelism (`scene_coords_loss`). `spatial`
    (index, count): the batch holds block `index` of `count` equal blocks
    of each image's rows (a spatial mesh), so the camera is the whole
    image's and the coord loss's pixel grid starts at the block's row."""
    index, count = spatial
    if uncertainty == "MLE":
        preds = predictions[..., :num_task_channel]
        unc = predictions[..., num_task_channel:]
    else:
        preds, unc = predictions, None
    if task == "coord":
        cfg = coord_cfg or CoordLossConfig(nodata_value=nodata_value)
        img_h, img_w = batch.images.shape[1] * count, batch.images.shape[2]
        focal = batch.focal.reshape(-1)[0]
        cam_mat = intrinsics(focal, img_w, img_h, device=focal.device)
        if batch.pp_shift is not None:
            shift = torch.zeros_like(cam_mat)
            shift[0, 2], shift[1, 2] = batch.pp_shift[0], batch.pp_shift[1]
            cam_mat = cam_mat + shift
        return scene_coords_loss(preds, batch.labels, batch.poses, cam_mat, unc, cfg, reduction,
                                 count_reduce, row_offset=index * preds.shape[1])
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
    """Model, optimizer, the number of updates done (the LR's clock) and,
    in a multi-process run, the gradient exchange (`parallel.DataParallel`)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    parallel: Optional[DataParallel] = None


def update_params(state: TrainState) -> List[torch.Tensor]:
    """The tensors the optimizer updates: the trainable parameters, or under
    ZeRO this rank's shard and the replicated ones."""
    if state.parallel is not None:
        return state.parallel.update_params()
    return [p for p in state.model.parameters() if p.requires_grad]


def param_sum(state: TrainState, per_param: List[torch.Tensor]) -> torch.Tensor:
    """Sum of per-parameter values (in `update_params` order) over the whole
    net: under ZeRO the shards' parts are summed over the ranks."""
    if state.parallel is not None:
        return state.parallel.param_sum(per_param)
    return sum(v.float() for v in per_param)


def apply_gradients(state: TrainState, params) -> torch.Tensor:
    """The optimizer's update of `params` (`update_params(state)`) from their
    `.grad`, in place: the optional global-norm clip, the step's LR, Adam;
    counts the update. Returns the gradients' global norm (before the clip),
    in float32 over the whole net."""
    opt = state.optimizer
    grads = [p.grad for p in params if p.grad is not None]
    grad_norm = torch.sqrt(param_sum(state, [g.float().square().sum() for g in grads]))
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
    model, dp = state.model, state.parallel
    params = update_params(state)
    state.optimizer.adam.zero_grad(set_to_none=True)
    if dp is None:
        preds = model(batch.images)
        loss, valid_rate = task_loss_fn(task, preds, batch, uncertainty, model.num_task_channel,
                                        nodata_value, coord_cfg, depth_cfg, normal_cfg)
        loss.backward()
        grad_norm = apply_gradients(state, params)
        return {"loss": loss.detach(), "valid_rate": valid_rate, "grad_norm": grad_norm}
    with dp.materialized():
        preds = model(batch.images)
        loss, valid_rate = task_loss_fn(task, preds, batch, uncertainty, model.num_task_channel,
                                        nodata_value, coord_cfg, depth_cfg, normal_cfg,
                                        count_reduce=dp.all_sum, spatial=dp.spatial_block)
        loss.backward()
        dp.reduce_gradients()
    grad_norm = apply_gradients(state, params)
    # the batch's loss and valid rate: means of equal-sized rank slices
    return {"loss": dp.all_mean(loss), "valid_rate": dp.all_mean(valid_rate),
            "grad_norm": grad_norm}
