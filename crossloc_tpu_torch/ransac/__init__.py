"""Batched RANSAC PnP solver (eval mode) on torch tensors."""
from .config import RansacConfig
from .solver import (
    RansacResult,
    refine_pose,
    sample_hypotheses,
    soft_inlier_score,
    solve_batch,
)

__all__ = [
    "RansacConfig",
    "RansacResult",
    "refine_pose",
    "sample_hypotheses",
    "soft_inlier_score",
    "solve_batch",
]
