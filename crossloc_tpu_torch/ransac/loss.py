"""Pose loss and the DSAC expected-loss training objective (counterpart of
`crossloc_tpu/ransac/loss.py`).

The reference plugin's pose distance with its soft clamp, and the expected
loss over the hypothesis distribution of the training-mode solver. Autograd
differentiates through the soft inlier scores, the softmax, the unrolled
Gauss-Newton refinement and P3P's implicit backward, in place of the
plugin's hand-written derivatives.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..geometry import invert_se3, pose_vec_to_w2c
from .config import PoseLossConfig, RansacConfig
from .solver import (
    _project_errors,
    refine_pose,
    sample_hypotheses,
    selection_probs,
    soft_inlier_score,
    solver_inputs,
    solver_precision,
)


def pose_loss(est_c2w, gt_c2w, cfg: PoseLossConfig = PoseLossConfig()):
    """w_rot * angle in degrees + w_trans * ||dt||, square-root clamped above
    `soft_clamp` and capped at `max_loss`. Broadcasts over leading dims."""
    rot_diff = gt_c2w[..., 0:3, 0:3] @ est_c2w[..., 0:3, 0:3].transpose(-1, -2)
    trace = torch.clamp(rot_diff[..., 0, 0] + rot_diff[..., 1, 1] + rot_diff[..., 2, 2], -1.0, 3.0)
    # the exact arccos value, with the gradient taken at an interior-clamped
    # argument: arccos' is infinite at +-1, which est == gt reaches
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    ang = torch.acos(torch.clamp(cos_t, -1.0 + 1e-6, 1.0 - 1e-6))
    ang = ang + (torch.acos(cos_t) - ang).detach()
    dt = est_c2w[..., 0:3, 3] - gt_c2w[..., 0:3, 3]
    t_err = torch.sqrt((dt * dt).sum(-1) + 1e-12)
    loss = cfg.w_rot * torch.rad2deg(ang) + cfg.w_trans * t_err
    loss = torch.where(loss > cfg.soft_clamp,
                       torch.sqrt(cfg.soft_clamp * torch.clamp(loss, min=1e-12)), loss)
    return torch.clamp(loss, max=cfg.max_loss)


def expected_pose_loss(
    scene_coords,
    gt_poses,
    focal_length,
    image_hw,
    cfg: RansacConfig = RansacConfig(),
    loss_cfg: PoseLossConfig = PoseLossConfig(),
    pp_shift=None,
    idx=None,
    generator: Optional[torch.Generator] = None,
):
    """The DSAC training objective, E_h~p [ loss(refine(h), gt) ].

    scene_coords [B, Hs, Ws, 3] (differentiable), gt_poses [B, 4, 4]
    cam-to-world; `pp_shift` [2] or [B, 2] moves the solver camera's
    principal point as the augmentation's crop moved it. Every hypothesis
    is refined, with `train_refine_steps`. Hypothesis draws as in
    `solve_batch` (`idx` or `generator`).

    Returns (mean expected loss, aux): aux["per_image"] [B], and what the
    solver's decisions led to: aux["hyp_valid"] [B, H], aux["poses"]
    [B, H, 6] (the refined hypotheses, detached) and aux["inliers"] [B, H]
    (their hard inlier counts).
    """
    device = scene_coords.device
    with solver_precision(device):
        coords, grid, cams = solver_inputs(scene_coords, focal_length, image_hw, cfg, pp_shift)
        pose6, hyp_valid = sample_hypotheses(coords, grid, cams, cfg, idx, generator)
        scores = soft_inlier_score(_project_errors(pose6, coords, grid, cams,
                                                   cfg.max_pixel_error), cfg)
        probs = selection_probs(scores, hyp_valid)
        refined = refine_pose(pose6, coords, grid, cams, cfg, steps=cfg.train_refine_steps)
        losses = pose_loss(invert_se3(pose_vec_to_w2c(refined)), gt_poses[:, None], loss_cfg)
        per_image = (probs * torch.where(hyp_valid, losses, 0.0)).sum(-1)
        with torch.no_grad():
            inliers = (_project_errors(refined, coords, grid, cams, cfg.max_pixel_error)
                       < cfg.inlier_threshold).sum(-1)
    return per_image.mean(), {"per_image": per_image, "hyp_valid": hyp_valid,
                              "poses": refined.detach(), "inliers": inliers}
