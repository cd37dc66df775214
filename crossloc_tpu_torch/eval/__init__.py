"""Pose / coord metrics and the results-file writer."""
from .metrics import coord_errors, pose_err
from .reports import scene_coords_report

__all__ = ["coord_errors", "pose_err", "scene_coords_report"]
