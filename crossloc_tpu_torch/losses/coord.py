"""Scene-coordinate regression loss: reprojection + 3D regression, optional
MLE uncertainty (counterpart of `crossloc_tpu/losses/coord.py`).

Channels-last: predictions and labels [B, H, W, 3]. The reference's
`num_valid_sc.sum() > 0` branch is a `where`, as in the JAX package. The
3x3 camera contractions are elementwise products summed in float32, which
no TF32 setting touches (the JAX package forces `Precision.HIGHEST` there).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..geometry import invert_se3, pixel_grid, project, transform_points
from .common import reduce_loss, valid_label_mask


class CoordLossConfig(NamedTuple):
    """Hyper-parameters, defaults of the reference's training flags."""

    min_depth: float = 0.1  # meters in front of the camera plane
    soft_clamp: float = 100.0  # px: sqrt loss above this reprojection error
    hard_clamp: float = 1000.0  # px: reprojection validity threshold
    init_tolerance: float = 50.0  # m: regression-error validity threshold
    nodata_value: float = -1.0
    subsample: int = 8


def scene_coords_loss(scene_coords, gt_coords, gt_poses, cam_mat, uncertainty_map=None,
                      config: CoordLossConfig = CoordLossConfig(),
                      reduction: Optional[str] = "mean",
                      count_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                      row_offset: int = 0):
    """(loss, valid_rate) of the coord task.

    scene_coords [B, H, W, 3] predicted world coordinates; gt_coords
    [B, H, W, 3] (nodata marked); gt_poses [B, 4, 4] cam-to-world; cam_mat
    [3, 3] shared by the batch; uncertainty_map [B, H, W, 1] positive sigma
    or None. `reduction` "mean" gives a scalar, None a [B] vector. The
    `num_valid > 0` gate holds for the whole batch: under data parallelism
    `count_reduce` sums the valid count over the ranks first (every rank,
    spatial ones included). On a block of rows of a spatial mesh,
    `row_offset` is the grid row of the block's first row and `cam_mat` the
    whole image's camera; "mean" then divides by the block's pixels, which
    is the step's share because every rank holds as many
    (`parallel.shard_batch` checks the height)."""
    B, H, W, _ = scene_coords.shape
    N = H * W
    pred = scene_coords.reshape(B, N, 3).float()
    gt = gt_coords.reshape(B, N, 3).float()

    w2c = invert_se3(gt_poses.float())[:, 0:3, :]  # [B, 3, 4]
    cam_pred = transform_points(w2c, pred)
    cam_gt = transform_points(w2c, gt)
    reg_error = torch.linalg.vector_norm(cam_pred - cam_gt, dim=-1)  # [B, N]

    grid = pixel_grid(H, W, config.subsample, device=pred.device,
                      row_offset=row_offset).reshape(N, 2)
    pix = project(cam_pred, cam_mat.float(), min_depth=config.min_depth)
    repro = torch.clamp(torch.linalg.vector_norm(pix - grid, dim=-1), min=1e-7)

    valid_gt = valid_label_mask(gt, config.nodata_value)  # [B, N]
    invalid_min_depth = cam_pred[..., 2] < config.min_depth
    invalid_repro = repro > config.hard_clamp
    invalid_gt_distance = (reg_error > config.init_tolerance) & valid_gt
    valid_sc = ~(invalid_min_depth | invalid_repro | invalid_gt_distance)

    num_valid = valid_sc.sum()
    valid_rate = num_valid / (B * N)

    masked = repro * valid_sc
    loss_l1 = torch.clamp(masked * (masked <= config.soft_clamp), min=1e-7)
    sqrt_in = torch.clamp(masked * (masked > config.soft_clamp), min=1e-7)
    loss_sqrt = torch.clamp(torch.sqrt(config.soft_clamp * sqrt_in + 1e-7), min=1e-7)
    batch_valid = num_valid if count_reduce is None else count_reduce(num_valid)
    loss_reproj = torch.where(batch_valid > 0, loss_l1 + loss_sqrt, torch.zeros_like(loss_l1))

    valid_gt_f = valid_gt.to(pred.dtype)
    if uncertainty_map is None:
        per_pixel = reg_error * valid_gt_f + loss_reproj
    else:
        sigma = torch.clamp(uncertainty_map.reshape(B, N).float(), min=1e-7)
        e2 = torch.clamp(reg_error.square(), min=1e-7)
        loss_unc = 3.0 * torch.log(sigma) + e2 / (2.0 * torch.clamp(sigma.square(), min=1e-7))
        per_pixel = loss_unc * valid_gt_f + loss_reproj

    loss = reduce_loss(per_pixel.sum(dim=1), N, reduction)
    return loss, valid_rate
