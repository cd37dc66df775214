"""SE(3) / SO(3) primitives over leading batch dimensions (counterpart of
`crossloc_tpu/geometry/se3.py`).

A camera pose is a 4x4 cam-to-world matrix; a scene pose is the
world-to-cam (rvec, tvec) pair packed as a 6-vector.
"""
from __future__ import annotations

import math

import torch

from .camera import _apply

_EPS = 1e-12


def hat(w):
    """Skew-symmetric matrix of a 3-vector. [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(rvec):
    """Axis-angle -> rotation matrix, series-safe near 0. [..., 3] -> [..., 3, 3]."""
    theta2 = (rvec * rvec).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    K = hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def inverse_rodrigues(R):
    """Rotation matrix -> axis-angle, safe near 0 and near pi. [..., 3, 3] -> [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_t = 0.5 * torch.sqrt((w * w).sum(-1) + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    generic = w * (theta / torch.clamp(2.0 * sin_t, min=_EPS))[..., None]

    # near pi: axis from the diagonal of (R + I) / 2 = a a^T
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag + 1.0) * 0.5, min=1e-12)
    axis = torch.sqrt(axis2)
    amax = torch.argmax(axis2, dim=-1)
    sxy = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    sxz = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    syz = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    one = torch.ones_like(sxy)
    sx = torch.where(amax == 0, one, torch.where(amax == 1, sxy, sxz))
    sy = torch.where(amax == 0, sxy, torch.where(amax == 1, one, syz))
    sz = torch.where(amax == 0, sxz, torch.where(amax == 1, syz, one))
    axis_pi = torch.stack([sx * axis[..., 0], sy * axis[..., 1], sz * axis[..., 2]], dim=-1)
    near_pi = axis_pi * theta[..., None]

    use_pi = (sin_t < 1e-4) & (cos_t < 0.0)
    tiny = (sin_t < 1e-6) & (cos_t > 0.0)
    out = torch.where(use_pi[..., None], near_pi, generic)
    return torch.where(tiny[..., None], w * 0.5, out)


def _bottom_row(top):
    """(0, 0, 0, 1) as [..., 1, 4], made on top's device: no copy from the
    host, which a CUDA graph's capture refuses."""
    return torch.eye(4, dtype=top.dtype, device=top.device)[3:].expand(top.shape[:-2] + (1, 4))


def pose_vec_to_w2c(pose6):
    """[..., 6] scene pose (rvec, tvec) -> [..., 4, 4] world-to-cam matrix."""
    R = rodrigues(pose6[..., 0:3])
    top = torch.cat([R, pose6[..., 3:6, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def w2c_to_pose_vec(T):
    """[..., 4, 4] world-to-cam matrix -> [..., 6] scene pose (rvec, tvec)."""
    return torch.cat([inverse_rodrigues(T[..., 0:3, 0:3]), T[..., 0:3, 3]], dim=-1)


def invert_se3(T):
    """Invert a rigid 4x4 transform analytically."""
    Rt = T[..., 0:3, 0:3].transpose(-1, -2)
    t_inv = -(Rt @ T[..., 0:3, 3:4])
    top = torch.cat([Rt, t_inv], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def transform_points(T, pts):
    """[..., 4, 4] (or [..., 3, 4]) rigid transform applied to [..., N, 3]
    points, as elementwise products and sums (no TF32)."""
    return _apply(T[..., 0:3, 0:3], pts) + T[..., None, 0:3, 3]


def rotation_angle_deg(R1, R2):
    """Angle in degrees of R1^T R2, in the atan2(|skew| / 2, (trace - 1) / 2)
    form that stays precise for small angles."""
    Rrel = R1.transpose(-1, -2) @ R2
    trace = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    cos_t = (trace - 1.0) * 0.5
    sx = Rrel[..., 2, 1] - Rrel[..., 1, 2]
    sy = Rrel[..., 0, 2] - Rrel[..., 2, 0]
    sz = Rrel[..., 1, 0] - Rrel[..., 0, 1]
    sin_t = 0.5 * torch.sqrt(sx * sx + sy * sy + sz * sz)
    return torch.atan2(sin_t, cos_t) * (180.0 / math.pi)


def orthonormalize(R, iters: int = 2):
    """Newton's iteration toward SO(3), R <- 1.5 R - 0.5 R R^T R, on
    [..., 3, 3]: P3P's pose clean-up (`p3p._orthonormalize9`) on matrices."""
    from .p3p import _orthonormalize9

    out = _orthonormalize9(tuple(R[..., i, j] for i in range(3) for j in range(3)), iters)
    return torch.stack(out, dim=-1).reshape(R.shape)
