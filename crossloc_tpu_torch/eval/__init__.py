"""Pose / coord metrics, the results-file writer and checkpoint selection."""
from .metrics import coord_errors, pose_err
from .reports import scene_coords_report
from .select_ckpt import select_checkpoint

__all__ = ["coord_errors", "pose_err", "scene_coords_report", "select_checkpoint"]
