"""Image -> pose: network forward + RANSAC solve (counterpart of
`crossloc_tpu/inference.py`)."""
from __future__ import annotations

from typing import Optional

import torch

from .ransac import RansacConfig, solve_batch


def make_localizer(model, cfg: RansacConfig = RansacConfig()):
    """Build fn(images, focal, idx=None, generator=None) -> (scene_coords, RansacResult).

    images [B, H, W, C] on the model's device; focal scalar or [B]. The
    model's first 3 outputs must be scene coordinates (coord task).
    Hypothesis draws come from `idx` [B, H * sample_rounds, 4] or `generator`.
    """

    @torch.no_grad()
    def localize(images, focal, idx=None, generator: Optional[torch.Generator] = None):
        coords = model(images)[..., 0:3].float()
        hw = (images.shape[1], images.shape[2])
        return coords, solve_batch(coords, focal, hw, cfg, idx=idx, generator=generator)

    return localize
