"""Metrics of every task, the results-file writers and checkpoint selection."""
from .metrics import (
    SemanticsEvaluator,
    coord_errors,
    depth_eval,
    normal_eval,
    pose_err,
    semantic_eval,
    semantic_scores,
)
from .reports import depth_report, normal_report, scene_coords_report, semantic_report
from .select_ckpt import select_checkpoint

__all__ = ["SemanticsEvaluator", "coord_errors", "depth_eval", "depth_report", "normal_eval",
           "normal_report", "pose_err", "scene_coords_report", "select_checkpoint",
           "semantic_eval", "semantic_report", "semantic_scores"]
