"""Camera, SE(3), small linear algebra, Kabsch and P3P on torch tensors."""
from .camera import backproject, intrinsics, pixel_grid, project, reprojection_errors
from .kabsch import kabsch
from .linalg import solve_spd
from .p3p import bearings_from_pixels, grad_firewall, p3p_from_4pts, p3p_lambdatwist
from .se3 import (
    hat,
    invert_se3,
    inverse_rodrigues,
    orthonormalize,
    pose_vec_to_w2c,
    rodrigues,
    rotation_angle_deg,
    transform_points,
    w2c_to_pose_vec,
)

__all__ = [
    "backproject",
    "bearings_from_pixels",
    "grad_firewall",
    "hat",
    "intrinsics",
    "invert_se3",
    "inverse_rodrigues",
    "kabsch",
    "orthonormalize",
    "p3p_from_4pts",
    "p3p_lambdatwist",
    "pixel_grid",
    "pose_vec_to_w2c",
    "project",
    "reprojection_errors",
    "rodrigues",
    "rotation_angle_deg",
    "solve_spd",
    "transform_points",
    "w2c_to_pose_vec",
]
