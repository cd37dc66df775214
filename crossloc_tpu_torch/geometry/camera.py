"""Pinhole camera model (counterpart of `crossloc_tpu/geometry/camera.py`)."""
from __future__ import annotations

import torch


def intrinsics(focal_length, width, height, dtype=torch.float32, device=None):
    """3x3 camera matrix with the principal point at the image centre.
    `focal_length` scalar or [B] -> [3, 3] or [B, 3, 3]."""
    f = torch.as_tensor(focal_length, dtype=dtype, device=device)
    zero = torch.zeros_like(f)
    one = torch.ones_like(f)
    row0 = torch.stack([f, zero, torch.full_like(f, width / 2.0)], dim=-1)
    row1 = torch.stack([zero, f, torch.full_like(f, height / 2.0)], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def pixel_grid(out_h: int, out_w: int, subsample: int = 8, dtype=torch.float32, device=None):
    """Pixel centres of the subsampled prediction grid, [out_h, out_w, 2] (x, y),
    with the x * subsample + subsample / 2 convention."""
    xs = torch.arange(out_w, dtype=dtype, device=device) * subsample + subsample / 2.0
    ys = torch.arange(out_h, dtype=dtype, device=device) * subsample + subsample / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)
