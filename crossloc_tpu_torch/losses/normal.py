"""Surface-normal loss in azimuth/elevation space (counterpart of
`crossloc_tpu/losses/normal.py`): a circle loss on the azimuth plus L1 on
the elevation, validity from the angle between the predicted and the true
direction, optional MLE (2 log sigma).

Channels-last: normal_logits [B, H, W, 2], gt_normals [B, H, W, 3]. The
validity angle is computed on a detached prediction: it feeds only the rate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .common import ae2xyz, logits_to_radian, reduce_loss, valid_label_mask, xyz2ae


class NormalLossConfig(NamedTuple):
    hard_clamp: float = 10.0  # degrees: angular validity threshold
    nodata_value: float = -1.0


def normal_loss(normal_logits, gt_normals, uncertainty_map=None,
                config: NormalLossConfig = NormalLossConfig(), reduction: Optional[str] = "mean"):
    """(loss, valid_rate) of the normal task; `uncertainty_map` [B, H, W, 1]
    positive sigma or None."""
    B = normal_logits.shape[0]
    logits = normal_logits.reshape(B, -1, 2).float()
    gt = gt_normals.reshape(B, -1, 3).float()
    N = logits.shape[1]

    pred_ae = logits_to_radian(logits)  # [B, N, 2] in [-pi, pi]
    gt_ae = xyz2ae(gt)

    az_l1 = torch.abs(gt_ae[..., 0] - pred_ae[..., 0])
    azimuth_loss = 2.0 * torch.abs(torch.minimum(az_l1, 2.0 * math.pi - az_l1))
    elevation_loss = torch.abs(pred_ae[..., 1] - gt_ae[..., 1])
    reg_error = torch.clamp(azimuth_loss + elevation_loss, min=1e-7)  # [B, N]

    pred_xyz = ae2xyz(pred_ae.detach())
    cos_sim = (pred_xyz * gt).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(pred_xyz, dim=-1) * torch.linalg.vector_norm(gt, dim=-1),
        min=1e-12)
    angle_deg = torch.rad2deg(torch.arccos(torch.clamp(cos_sim, -1 + 1e-7, 1 - 1e-7)))

    valid_gt = valid_label_mask(gt, config.nodata_value)
    valid_normal = (angle_deg <= config.hard_clamp) & valid_gt
    valid_rate = valid_normal.sum() / (B * N)

    valid_gt_f = valid_gt.to(logits.dtype)
    if uncertainty_map is None:
        per_pixel = reg_error * valid_gt_f
    else:
        # MLE: 2 log(sigma) + e^2 / (2 sigma^2)
        sigma = torch.clamp(uncertainty_map.reshape(B, -1).float(), min=1e-7)
        e2 = torch.clamp(reg_error.square(), min=1e-7)
        loss_unc = 2.0 * torch.log(sigma) + e2 / (2.0 * torch.clamp(sigma.square(), min=1e-7))
        per_pixel = loss_unc * valid_gt_f

    loss = reduce_loss(per_pixel.sum(dim=1), N, reduction)
    return loss, valid_rate
