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


def pixel_grid(out_h: int, out_w: int, subsample: int = 8, dtype=torch.float32, device=None,
               row_offset: int = 0):
    """Pixel centres of the subsampled prediction grid, [out_h, out_w, 2] (x, y),
    with the x * subsample + subsample / 2 convention. `row_offset`: the
    grid row of the first row, where the grid is a block of a taller
    image's (a shard of the mesh's "spatial" axis)."""
    xs = torch.arange(out_w, dtype=dtype, device=device) * subsample + subsample / 2.0
    ys = (torch.arange(out_h, dtype=dtype, device=device) + row_offset) * subsample + subsample / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _apply(mat, pts):
    """mat [..., 3, 3] applied to points [..., N, 3] -> [..., N, 3], as
    elementwise products and sums: no matmul, so no TF32."""
    return (mat[..., None, :, :] * pts[..., :, None, :]).sum(-1)


def project(points_cam, cam_mat, min_depth=None):
    """Camera-frame points [..., N, 3] through cam_mat [..., 3, 3] to pixels
    [..., N, 2]; with `min_depth`, z is clamped from below first."""
    proj = _apply(cam_mat, points_cam)
    z = proj[..., 2:3]
    if min_depth is not None:
        z = torch.clamp(z, min=min_depth)
    return proj[..., 0:2] / z


def backproject(pixels, depth, cam_mat_or_focal, width=None, height=None):
    """Pixels [..., N, 2] at depth [..., N] to camera-frame points
    [..., N, 3]. The camera is a 3x3 matrix, or (focal, width, height) with
    the principal point at the image centre."""
    if width is None:
        cam = cam_mat_or_focal
        fx, fy = cam[..., 0, 0, None], cam[..., 1, 1, None]
        cx, cy = cam[..., 0, 2, None], cam[..., 1, 2, None]
    else:
        fx = fy = torch.as_tensor(cam_mat_or_focal, dtype=pixels.dtype,
                                  device=pixels.device)[..., None]
        cx, cy = width / 2.0, height / 2.0
    x = (pixels[..., 0] - cx) / fx * depth
    y = (pixels[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def reprojection_errors(points_cam, pixels, cam_mat, min_depth=0.1, max_err=None):
    """Pixel distance [..., N] between the projections of points_cam
    [..., N, 3] (z clamped to `min_depth`) and pixels [..., N, 2], clamped
    to `max_err` when given."""
    err = torch.linalg.vector_norm(project(points_cam, cam_mat, min_depth) - pixels, dim=-1)
    if max_err is not None:
        err = torch.clamp(err, max=max_err)
    return err
