"""Camera, SE(3), small linear algebra, Kabsch and P3P on torch tensors."""
from .camera import intrinsics, pixel_grid
from .kabsch import kabsch
from .linalg import solve_spd
from .p3p import bearings_from_pixels, grad_firewall, p3p_from_4pts
from .se3 import (
    hat,
    invert_se3,
    inverse_rodrigues,
    pose_vec_to_w2c,
    rodrigues,
    rotation_angle_deg,
)

__all__ = [
    "bearings_from_pixels",
    "grad_firewall",
    "hat",
    "intrinsics",
    "invert_se3",
    "inverse_rodrigues",
    "kabsch",
    "p3p_from_4pts",
    "pixel_grid",
    "pose_vec_to_w2c",
    "rodrigues",
    "rotation_angle_deg",
    "solve_spd",
]
