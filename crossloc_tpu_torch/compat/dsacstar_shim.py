"""Drop-in replacement for the reference's `dsacstar` C++ extension module
(counterpart of `crossloc_tpu/compat/dsacstar_shim.py`).

The plugin's four functions with its positional API over torch tensors:
NCHW scene coordinates in, the cam-to-world 4x4 written in place into the
caller's tensor, the gradient tensor filled by the backward calls, which
return the DSAC expected pose loss. Code written against the plugin runs
unmodified:

    import crossloc_tpu_torch.compat.dsacstar_shim as dsacstar
    dsacstar.forward_rgb(scene_coords, out_pose, 64, 10, f, cx, cy, 100, 100, 8)

The solve runs on the card unless the keyword `device="cpu"` asks otherwise,
in float32 whatever the caller's TF32 flags; the draws come from a
generator seeded with `random_seed`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..ransac import (
    PoseLossConfig,
    RansacConfig,
    expected_pose_loss,
    expected_pose_loss_rgbd,
    solve_batch,
    solve_rgbd,
)
from ..ransac.solver import solver_precision


def _nhwc(t, device) -> torch.Tensor:
    return t.detach().to(device=device, dtype=torch.float32).permute(0, 2, 3, 1).contiguous()


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _fill(out, value) -> None:
    out.copy_(value.detach().to(device=out.device, dtype=out.dtype))


def forward_rgb(scene_coordinates, out_pose, ransac_hypotheses: int, inlier_threshold: float,
                focal_length: float, ppoint_x: float, ppoint_y: float, inlier_alpha: float,
                max_reproj: float, sub_sampling: int, random_seed: int = 0, *,
                device: Optional[str] = None):
    """Pose estimation, eval mode (argmax): writes the cam-to-world 4x4 into
    `out_pose` and returns 0."""
    dev = resolve_device(device)
    cfg = RansacConfig(hypotheses=ransac_hypotheses, inlier_threshold=inlier_threshold,
                       inlier_alpha=inlier_alpha, max_pixel_error=max_reproj,
                       subsample=sub_sampling)
    # the principal point sets the effective image size (centre convention)
    with torch.no_grad():
        res = solve_batch(_nhwc(scene_coordinates, dev), focal_length,
                          (2.0 * ppoint_y, 2.0 * ppoint_x), cfg,
                          generator=_generator(random_seed, dev))
    _fill(out_pose, res.cam_to_world[0])
    return 0


def backward_rgb(scene_coordinates, out_scene_coordinates_grad, gt_pose, ransac_hypotheses: int,
                 inlier_threshold: float, focal_length: float, ppoint_x: float, ppoint_y: float,
                 w_loss_rot: float, w_loss_trans: float, soft_clamp: float, inlier_alpha: float,
                 max_reproj: float, sub_sampling: int, random_seed: int, *,
                 device: Optional[str] = None) -> float:
    """DSAC training mode: returns the expected pose loss and fills
    `out_scene_coordinates_grad` (NCHW) with its gradient."""
    dev = resolve_device(device)
    coords = _nhwc(scene_coordinates, dev).requires_grad_()
    cfg = RansacConfig(hypotheses=ransac_hypotheses, inlier_threshold=inlier_threshold,
                       inlier_alpha=inlier_alpha, max_pixel_error=max_reproj,
                       subsample=sub_sampling)
    loss_cfg = PoseLossConfig(w_rot=w_loss_rot, w_trans=w_loss_trans, soft_clamp=soft_clamp)
    gt = torch.as_tensor(gt_pose).detach().to(device=dev, dtype=torch.float32)
    with solver_precision(dev):
        loss, _ = expected_pose_loss(coords, gt[None], focal_length,
                                     (2.0 * ppoint_y, 2.0 * ppoint_x), cfg, loss_cfg,
                                     generator=_generator(random_seed, dev))
        loss.backward()
    _fill(out_scene_coordinates_grad, coords.grad.permute(0, 3, 1, 2))
    return float(loss.detach())


def _rgbd_inputs(scene_coordinates, camera_coordinates, dev):
    """NHWC scene and camera coordinates; valid pixels have a non-zero camera
    coordinate."""
    eye = _nhwc(camera_coordinates, dev)
    return _nhwc(scene_coordinates, dev), eye, (eye != 0.0).any(-1)


def forward_rgbd(scene_coordinates, camera_coordinates, out_pose, ransac_hypotheses: int,
                 inlier_threshold: float, inlier_alpha: float, max_dist_error: float,
                 random_seed: int = 0, *, device: Optional[str] = None):
    """RGB-D pose estimation from Kabsch hypotheses (distances in cm): writes
    the cam-to-world 4x4 into `out_pose` and returns 0."""
    dev = resolve_device(device)
    obj, eye, valid = _rgbd_inputs(scene_coordinates, camera_coordinates, dev)
    cfg = RansacConfig(hypotheses=ransac_hypotheses, inlier_threshold=inlier_threshold,
                       inlier_alpha=inlier_alpha, max_pixel_error=max_dist_error)
    with torch.no_grad():
        res = solve_rgbd(obj, eye, valid, cfg, generator=_generator(random_seed, dev))
    _fill(out_pose, res.cam_to_world[0])
    return 0


def backward_rgbd(scene_coordinates, camera_coordinates, out_scene_coordinates_grad, gt_pose,
                  ransac_hypotheses: int, inlier_threshold: float, w_loss_rot: float,
                  w_loss_trans: float, soft_clamp: float, inlier_alpha: float,
                  max_dist_error: float, random_seed: int, *,
                  device: Optional[str] = None) -> float:
    """RGB-D training mode: returns the expected pose loss and fills
    `out_scene_coordinates_grad` (NCHW) with its gradient through the
    Kabsch SVD."""
    dev = resolve_device(device)
    obj, eye, valid = _rgbd_inputs(scene_coordinates, camera_coordinates, dev)
    obj.requires_grad_()
    cfg = RansacConfig(hypotheses=ransac_hypotheses, inlier_threshold=inlier_threshold,
                       inlier_alpha=inlier_alpha, max_pixel_error=max_dist_error)
    loss_cfg = PoseLossConfig(w_rot=w_loss_rot, w_trans=w_loss_trans, soft_clamp=soft_clamp)
    gt = torch.as_tensor(gt_pose).detach().to(device=dev, dtype=torch.float32)
    with solver_precision(dev):
        loss = expected_pose_loss_rgbd(obj, eye, valid, gt[None], cfg, loss_cfg,
                                       generator=_generator(random_seed, dev))
        loss.backward()
    _fill(out_scene_coordinates_grad, obj.grad.permute(0, 3, 1, 2))
    return float(loss.detach())
