"""Differentiable batched RANSAC pose solvers (RGB PnP and RGB-D Kabsch) and
the DSAC expected pose loss, on torch tensors."""
from .config import PoseLossConfig, RansacConfig
from .loss import expected_pose_loss, pose_loss
from .rgbd import RgbdResult, expected_pose_loss_rgbd, solve_rgbd
from .solver import (
    RansacResult,
    apply_pp_shift,
    refine_pose,
    sample_hypotheses,
    soft_inlier_score,
    solve_batch,
)

__all__ = [
    "PoseLossConfig",
    "RansacConfig",
    "RansacResult",
    "RgbdResult",
    "apply_pp_shift",
    "expected_pose_loss",
    "expected_pose_loss_rgbd",
    "pose_loss",
    "refine_pose",
    "sample_hypotheses",
    "soft_inlier_score",
    "solve_batch",
    "solve_rgbd",
]
