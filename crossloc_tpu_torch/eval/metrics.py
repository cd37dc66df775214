"""Pose and scene-coordinate metrics (counterpart of
`crossloc_tpu/eval/metrics.py`, coord task)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..geometry import rotation_angle_deg
from ..losses import valid_label_mask


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).cpu()


def pose_err(gt_pose, est_pose) -> Tuple[float, float]:
    """(translation m, rotation deg) between 4x4 cam-to-world transforms."""
    gt, est = _f32(gt_pose), _f32(est_pose)
    t = float(np.linalg.norm(gt[0:3, 3].numpy() - est[0:3, 3].numpy()))
    r = float(rotation_angle_deg(est[0:3, 0:3], gt[0:3, 0:3]))
    return t, r


def coord_errors(scene_coords, gt_coords, nodata_value=-1.0) -> np.ndarray:
    """Per-pixel ||pred - gt|| over valid-gt pixels, flattened.
    scene_coords / gt_coords: [B, h, w, 3]."""
    pred = _f32(scene_coords).reshape(-1, 3)
    gt = _f32(gt_coords).reshape(-1, 3)
    err = torch.linalg.norm(pred - gt, dim=-1)
    return err[valid_label_mask(gt, nodata_value)].numpy()
