"""Depth regression loss, L1 or MLE (counterpart of
`crossloc_tpu/losses/depth.py`).

Channels-last: depth_map [B, H, W, 1], gt_depths [B, H, W, 1]. The validity
constraints feed only the reported rate, not the loss mask.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .common import reduce_loss, valid_label_mask


class DepthLossConfig(NamedTuple):
    min_depth: float = 0.1  # m: validity threshold on the prediction
    hard_clamp: float = 10.0  # m: largest |error| of a valid prediction
    nodata_value: float = -1.0


def depth_loss(depth_map, gt_depths, uncertainty_map=None,
               config: DepthLossConfig = DepthLossConfig(), reduction: Optional[str] = "mean"):
    """(loss, valid_rate) of the depth task; `uncertainty_map` [B, H, W, 1]
    positive sigma or None."""
    B = depth_map.shape[0]
    pred = depth_map.reshape(B, -1).float()
    gt = gt_depths.reshape(B, -1).float()
    N = pred.shape[1]

    err = torch.abs(pred - gt)
    valid_gt = valid_label_mask(gt[..., None], config.nodata_value)
    valid_depth = (pred >= config.min_depth) & (err <= config.hard_clamp) & valid_gt
    valid_rate = valid_depth.sum() / (B * N)

    valid_gt_f = valid_gt.to(pred.dtype)
    if uncertainty_map is None:
        per_pixel = err * valid_gt_f
    else:
        # MLE: log(sigma) + e^2 / (2 sigma^2)
        sigma = torch.clamp(uncertainty_map.reshape(B, -1).float(), min=1e-7)
        e2 = torch.clamp(err.square(), min=1e-7)
        loss_unc = torch.log(sigma) + e2 / (2.0 * torch.clamp(sigma.square(), min=1e-7))
        per_pixel = loss_unc * valid_gt_f

    loss = reduce_loss(per_pixel.sum(dim=1), N, reduction)
    return loss, valid_rate
