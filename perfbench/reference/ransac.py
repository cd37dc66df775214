"""CrossLoc's RANSAC pose solver in plain PyTorch, the eval path, given
its hypothesis draws: 4-point minimal sets, P3P (Lambda Twist) on three
points with the fourth selecting the root, the first of each hypothesis's
rounds whose four points reproject within tau, soft inlier scores
(alpha / N) sum sigmoid(-beta (e - tau)), the argmax of their softmax,
then a fixed number of damped Gauss-Newton refinements with inlier
recomputation and monotone acceptance, and a final polish.

A frozen copy, written for the benchmark, of the geometry and solver the
port computes the same function with; it imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_EPS = 1e-12


class RansacConfig(NamedTuple):
    hypotheses: int = 64
    inlier_threshold: float = 10.0
    inlier_alpha: float = 100.0
    max_pixel_error: float = 100.0
    subsample: int = 8
    sample_rounds: int = 16
    refine_steps: int = 8
    gn_iters: int = 3
    gn_damping: float = 1e-4
    polish_iters: int = 2


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
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
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
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def pose_vec_to_w2c(pose6):
    """[..., 6] scene pose (rvec, tvec) -> [..., 4, 4] world-to-cam matrix."""
    R = rodrigues(pose6[..., 0:3])
    top = torch.cat([R, pose6[..., 3:6, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def invert_se3(T):
    """Invert a rigid 4x4 transform analytically."""
    Rt = T[..., 0:3, 0:3].transpose(-1, -2)
    t_inv = -(Rt @ T[..., 0:3, 3:4])
    top = torch.cat([Rt, t_inv], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def intrinsics(focal_length, width, height, dtype=torch.float32, device=None):
    """3x3 camera matrix with the principal point at the image centre.
    `focal_length` scalar or [B] -> [3, 3] or [B, 3, 3]."""
    f = torch.as_tensor(focal_length, dtype=dtype, device=device)
    zero = torch.zeros_like(f)
    one = torch.ones_like(f)
    row0 = torch.stack([f, zero, torch.full_like(f, width / 2.0)], dim=-1)
    row1 = torch.stack([zero, f, torch.full_like(f, height / 2.0)], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def pixel_grid(out_h: int, out_w: int, subsample: int = 8, dtype=torch.float32, device=None):
    """Centres of the prediction cells, [out_h, out_w, 2] (x, y): x * s + s / 2."""
    xs = torch.arange(out_w, dtype=dtype, device=device) * subsample + subsample / 2.0
    ys = torch.arange(out_h, dtype=dtype, device=device) * subsample + subsample / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def solve_spd(A, b):
    """Solve A x = b for SPD A [..., n, n], b [..., n] -> [..., n].

    Diagonal pivots are floored at a tiny positive value, so a rank-deficient
    A gives a finite result."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-20))
        L[j][j] = d
        inv_d[j] = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d[j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * inv_d[i]
    return torch.stack(x, dim=-1)


def _safe_sqrt(x, eps=1e-12):
    return torch.sqrt(torch.clamp(x, min=eps))


def _safe_cbrt(x, eps=1e-12):
    return torch.sign(x) * torch.clamp(x.abs(), min=eps) ** (1.0 / 3.0)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _where3(c, a, b):
    return tuple(torch.where(c, ai, bi) for ai, bi in zip(a, b))


def _normalize3(a):
    return _scale3(a, 1.0 / _safe_sqrt(_dot3(a, a)))


def _sym_quad(D, v, w):
    """v^T D w for symmetric D."""
    d00, d01, d02, d11, d12, d22 = D
    return (
        d00 * v[0] * w[0]
        + d11 * v[1] * w[1]
        + d22 * v[2] * w[2]
        + d01 * (v[0] * w[1] + v[1] * w[0])
        + d02 * (v[0] * w[2] + v[2] * w[0])
        + d12 * (v[1] * w[2] + v[2] * w[1])
    )


def _det_sym(D):
    d00, d01, d02, d11, d12, d22 = D
    return (
        d00 * (d11 * d22 - d12 * d12)
        - d01 * (d01 * d22 - d12 * d02)
        + d02 * (d01 * d12 - d11 * d02)
    )


def _mat3_vec(R, v):
    return (
        R[0] * v[0] + R[1] * v[1] + R[2] * v[2],
        R[3] * v[0] + R[4] * v[1] + R[5] * v[2],
        R[6] * v[0] + R[7] * v[1] + R[8] * v[2],
    )


def _mat3_mul(A, B):
    return tuple(
        A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
        for i in range(3)
        for j in range(3)
    )


def _mat3_Tmul(A, B):
    """A^T @ B."""
    return tuple(
        A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j]
        for i in range(3)
        for j in range(3)
    )


def _det9(R):
    return (
        R[0] * (R[4] * R[8] - R[5] * R[7])
        - R[1] * (R[3] * R[8] - R[5] * R[6])
        + R[2] * (R[3] * R[7] - R[4] * R[6])
    )


def _orthonormalize9(R, iters=2):
    """Newton iteration toward the orthogonal factor: R <- 1.5 R - 0.5 R R^T R."""
    for _ in range(iters):
        RRtR = _mat3_mul(R, _mat3_Tmul(R, R))
        R = tuple(1.5 * r - 0.5 * s for r, s in zip(R, RRtR))
    return R


def _solve_cubic_real(c3, c2, c1, c0):
    """One real root of c3 x^3 + c2 x^2 + c1 x + c0, branch-free: the
    trigonometric form with three real roots, Cardano otherwise, then three
    Newton steps on the raw cubic."""
    c3s = torch.where(c3.abs() < _EPS, torch.where(c3 < 0, -_EPS, _EPS), c3)
    a = c2 / c3s
    b = c1 / c3s
    c = c0 / c3s
    p = b - a * a / 3.0
    q = 2.0 * a**3 / 27.0 - a * b / 3.0 + c
    disc = (q * q) / 4.0 + (p**3) / 27.0

    sq = _safe_sqrt(disc)
    t_card = _safe_cbrt(-q / 2.0 + sq) + _safe_cbrt(-q / 2.0 - sq)

    pm = torch.clamp(p, max=-_EPS)
    r = torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (2.0 * pm) * torch.sqrt(-3.0 / pm), -1.0 + 1e-7, 1.0 - 1e-7)
    t_trig = 2.0 * r * torch.cos(torch.acos(arg) / 3.0)

    t = torch.where(disc > 0.0, t_card, t_trig)
    x = t - a / 3.0
    for _ in range(3):
        f = ((c3 * x + c2) * x + c1) * x + c0
        df = (3.0 * c3 * x + 2.0 * c2) * x + c1
        df = torch.where(df.abs() < _EPS, _EPS, df)
        x = x - f / df
    return x


def _null_vec_sym(D, sigma):
    """Unit vector v with (D - sigma I) v ~= 0: the largest of the three row
    cross products."""
    d00, d01, d02, d11, d12, d22 = D
    r0 = (d00 - sigma, d01, d02)
    r1 = (d01, d11 - sigma, d12)
    r2 = (d02, d12, d22 - sigma)
    c01 = _cross3(r0, r1)
    c02 = _cross3(r0, r2)
    c12 = _cross3(r1, r2)
    n01 = _dot3(c01, c01)
    n02 = _dot3(c02, c02)
    n12 = _dot3(c12, c12)
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = ~use01 & (n02 >= n12)
    return _normalize3(_where3(use01, c01, _where3(use02, c02, c12)))


def _p3p_soa(x1, x2, x3, y1, y2, y3):
    """Lambda Twist on SoA inputs: world points x* and unit bearings y*.
    Returns 4 candidates (R mat3-tuple, t vec3-tuple, valid)."""
    b12 = _dot3(y1, y2)
    b13 = _dot3(y1, y3)
    b23 = _dot3(y2, y3)
    d12v = _sub3(x1, x2)
    d13v = _sub3(x1, x3)
    d23v = _sub3(x2, x3)
    a12 = _dot3(d12v, d12v)
    a13 = _dot3(d13v, d13v)
    a23 = _dot3(d23v, d23v)
    zeros = torch.zeros_like(b12)

    D1 = (a23, -a23 * b12, zeros, a23 - a12, a12 * b23, -a12)
    D2 = (a23, zeros, -a23 * b13, -a13, a13 * b23, a23 - a13)

    def d_at(g):
        return _det_sym(tuple(e1 + g * e2 for e1, e2 in zip(D1, D2)))

    d0 = _det_sym(D1)
    d1 = d_at(1.0)
    dm1 = d_at(-1.0)
    d2 = d_at(2.0)
    c0 = d0
    c2 = (d1 + dm1) / 2.0 - c0
    s1 = d1 - c2 - c0
    s2 = d2 - 4.0 * c2 - c0
    c3 = (s2 - 2.0 * s1) / 6.0
    c1 = s1 - c3

    gamma = _solve_cubic_real(c3, c2, c1, c0)
    D0 = tuple(e1 + gamma * e2 for e1, e2 in zip(D1, D2))

    tr = D0[0] + D0[3] + D0[5]
    minors = (
        D0[0] * D0[3] - D0[1] * D0[1] + D0[0] * D0[5] - D0[2] * D0[2] + D0[3] * D0[5]
        - D0[4] * D0[4]
    )
    disc = _safe_sqrt(tr * tr - 4.0 * minors)
    sigma1 = (tr + disc) * 0.5
    sigma2 = (tr - disc) * 0.5
    u1 = _null_vec_sym(D0, sigma1)
    u2 = _null_vec_sym(D0, sigma2)
    u3 = _null_vec_sym(D0, torch.zeros_like(sigma1))
    sig_ok = (sigma1 > _EPS) & (sigma2 < -_EPS)
    s = _safe_sqrt(-sigma2 / torch.clamp(sigma1, min=_EPS))

    A = _sym_quad(D1, u3, u3)
    Asafe = torch.where(A.abs() < _EPS, _EPS, A)

    candidates = []
    for sign, root_kind in ((1.0, 0), (1.0, 1), (-1.0, 0), (-1.0, 1)):
        w = tuple(sign * s * u1c + u2c for u1c, u2c in zip(u1, u2))
        Bq = 2.0 * _sym_quad(D1, w, u3)
        Cq = _sym_quad(D1, w, w)
        qdisc = Bq * Bq - 4.0 * A * Cq
        quad_ok = qdisc >= 0.0
        sq = _safe_sqrt(qdisc)
        sgnB = torch.where(Bq >= 0.0, 1.0, -1.0)
        qq = -(Bq + sgnB * sq) / 2.0
        qsafe = torch.where(qq.abs() < _EPS, _EPS, qq)
        tau = qq / Asafe if root_kind == 0 else Cq / qsafe

        d = tuple(wc + tau * u3c for wc, u3c in zip(w, u3))
        dMd = d[0] * d[0] + d[1] * d[1] - 2.0 * b12 * d[0] * d[1]
        scale_ok = dMd > _EPS
        lam = _scale3(d, _safe_sqrt(a12 / torch.clamp(dMd, min=_EPS)))
        lam = _scale3(lam, torch.where(lam[0] < 0.0, -1.0, 1.0))

        # sanitize degenerate candidates before the polish algebra overflows
        lam_sane = (
            torch.isfinite(lam[0]) & torch.isfinite(lam[1]) & torch.isfinite(lam[2])
            & (lam[0] > _EPS) & (lam[1] > _EPS) & (lam[2] > _EPS)
            & (lam[0] < 3e4) & (lam[1] < 3e4) & (lam[2] < 3e4)
        )
        ones = torch.ones_like(lam[0])
        lam = _where3(lam_sane, lam, (ones, ones, ones))

        # Gauss-Newton polish of the depth triplet, explicit adjugate solve
        for _ in range(3):
            l1, l2, l3 = lam
            r1 = l1 * l1 + l2 * l2 - 2.0 * b12 * l1 * l2 - a12
            r2 = l1 * l1 + l3 * l3 - 2.0 * b13 * l1 * l3 - a13
            r3 = l2 * l2 + l3 * l3 - 2.0 * b23 * l2 * l3 - a23
            J11 = 2.0 * l1 - 2.0 * b12 * l2
            J12 = 2.0 * l2 - 2.0 * b12 * l1
            J21 = 2.0 * l1 - 2.0 * b13 * l3
            J23 = 2.0 * l3 - 2.0 * b13 * l1
            J32 = 2.0 * l2 - 2.0 * b23 * l3
            J33 = 2.0 * l3 - 2.0 * b23 * l2
            damp = 1e-9 + 1e-6 * (J11 * J11 + J33 * J33)
            g00 = J11 * J11 + J21 * J21 + damp
            g01 = J11 * J12
            g02 = J21 * J23
            g11 = J12 * J12 + J32 * J32 + damp
            g12 = J32 * J33
            g22 = J23 * J23 + J33 * J33 + damp
            h0 = J11 * r1 + J21 * r2
            h1 = J12 * r1 + J32 * r3
            h2 = J23 * r2 + J33 * r3
            detG = _det_sym((g00, g01, g02, g11, g12, g22))
            solvable = detG.abs() > 1e-9
            det_s = torch.where(solvable, detG, 1.0)
            adj00 = g11 * g22 - g12 * g12
            adj01 = g02 * g12 - g01 * g22
            adj02 = g01 * g12 - g02 * g11
            adj11 = g00 * g22 - g02 * g02
            adj12 = g01 * g02 - g00 * g12
            adj22 = g00 * g11 - g01 * g01
            st0 = (adj00 * h0 + adj01 * h1 + adj02 * h2) / det_s
            st1 = (adj01 * h0 + adj11 * h1 + adj12 * h2) / det_s
            st2 = (adj02 * h0 + adj12 * h1 + adj22 * h2) / det_s
            ok = lam_sane & solvable
            lam = (
                torch.where(ok, l1 - torch.clamp(st0, -1e4, 1e4), l1),
                torch.where(ok, l2 - torch.clamp(st1, -1e4, 1e4), l2),
                torch.where(ok, l3 - torch.clamp(st2, -1e4, 1e4), l3),
            )
            lam = tuple(torch.clamp(v, -3e4, 3e4) for v in lam)

        lam_ok = lam_sane & (lam[0] > _EPS) & (lam[1] > _EPS) & (lam[2] > _EPS)

        # pose from camera-frame points z_i = lambda_i y_i
        zc1 = _scale3(y1, lam[0])
        zc2 = _scale3(y2, lam[1])
        zc3 = _scale3(y3, lam[2])
        z12 = _sub3(zc1, zc2)
        z13 = _sub3(zc1, zc3)
        zx = _cross3(z12, z13)

        xx = _cross3(d12v, d13v)
        detX = _dot3(d12v, _cross3(d13v, xx))
        geom_ok = detX.abs() > 1e-10
        inv_det = 1.0 / torch.where(geom_ok, detX, 1.0)
        adj_r1 = _cross3(d13v, xx)
        adj_r2 = _cross3(xx, d12v)
        adj_r3 = _cross3(d12v, d13v)
        R = tuple(
            (z12[i] * adj_r1[j] + z13[i] * adj_r2[j] + zx[i] * adj_r3[j]) * inv_det
            for i in range(3)
            for j in range(3)
        )
        R = tuple(torch.clamp(c, -3.0, 3.0) for c in R)
        R = _orthonormalize9(R, iters=2)
        tsum = (zeros, zeros, zeros)
        for zc, xw in ((zc1, x1), (zc2, x2), (zc3, x3)):
            Rx = _mat3_vec(R, xw)
            tsum = tuple(tc + (zcc - rxc) for tc, zcc, rxc in zip(tsum, zc, Rx))
        t = _scale3(tsum, 1.0 / 3.0)

        finite = torch.ones_like(lam[0], dtype=torch.bool)
        for comp in R + t:
            finite = finite & torch.isfinite(comp)
        rot_ok = (_det9(R) - 1.0).abs() < 0.1
        valid = sig_ok & quad_ok & scale_ok & lam_ok & geom_ok & finite & rot_ok
        candidates.append((R, t, valid))
    return candidates


def _unpack_vec3(arr, i):
    return (arr[..., i, 0], arr[..., i, 1], arr[..., i, 2])


def _p3p_from_4pts_impl(X4, pix4, cam_mat):
    """Pose from a 4-point minimal set: P3P on points 0-2, point 3 selects.
    X4 [..., 4, 3] world points, pix4 [..., 4, 2] pixels, cam_mat
    broadcastable to [..., 3, 3]. Returns (R [..., 3, 3], t [..., 3],
    max_err4 [...], valid [...]): the candidate with the smallest largest
    reprojection error of the four points."""
    fx = cam_mat[..., 0, 0]
    fy = cam_mat[..., 1, 1]
    cx = cam_mat[..., 0, 2]
    cy = cam_mat[..., 1, 2]

    def bearing(i):
        bx = (pix4[..., i, 0] - cx) / fx
        by = (pix4[..., i, 1] - cy) / fy
        inv_n = 1.0 / _safe_sqrt(bx * bx + by * by + 1.0)
        return (bx * inv_n, by * inv_n, inv_n)

    xs = [_unpack_vec3(X4, i) for i in range(4)]
    cands = _p3p_soa(xs[0], xs[1], xs[2], bearing(0), bearing(1), bearing(2))

    best_err = torch.full_like(cands[0][2], math.inf, dtype=X4.dtype)
    best_R = cands[0][0]
    best_t = cands[0][1]
    any_valid = torch.zeros_like(cands[0][2])
    for R, t, valid in cands:
        max_err = torch.zeros_like(best_err)
        infront = torch.ones_like(valid)
        for i in range(4):
            u = tuple(uc + tc for uc, tc in zip(_mat3_vec(R, xs[i]), t))
            infront = infront & (u[2] > 1e-6)
            z = torch.clamp(u[2], min=1e-6)
            ex = fx * u[0] / z + cx - pix4[..., i, 0]
            ey = fy * u[1] / z + cy - pix4[..., i, 1]
            max_err = torch.maximum(max_err, _safe_sqrt(ex * ex + ey * ey))
        valid = valid & infront
        err = torch.where(valid, max_err, math.inf)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_R = tuple(torch.where(better, rn, rb) for rn, rb in zip(R, best_R))
        best_t = tuple(torch.where(better, tn, tb) for tn, tb in zip(t, best_t))
        any_valid = any_valid | valid

    R_best = torch.stack(best_R, dim=-1).reshape(best_R[0].shape + (3, 3))
    t_best = torch.stack(best_t, dim=-1)
    return R_best, t_best, best_err, any_valid


def _project_errors(pose6, coords, grid, cam_mat, max_err):
    """Reprojection errors of every scene coordinate under each pose.

    pose6 [B, K, 6], coords [B, N, 3], grid [N, 2], cam_mat [B, 3, 3] ->
    [B, K, N], clamped to max_err; points at or behind the camera plane get
    max_err. The intrinsics are folded into the pose: K (R X + t) = (K R) X + K t.
    """
    R = rodrigues(pose6[..., 0:3])
    KR = cam_mat[:, None] @ R
    Kt = (cam_mat[:, None] @ pose6[..., 3:6, None])[..., 0]
    proj = torch.einsum("bkij,bnj->bkni", KR, coords) + Kt[:, :, None, :]
    z = proj[..., 2]
    pix = proj[..., 0:2] / torch.clamp(z, min=1e-6)[..., None]
    diff = pix - grid
    err = torch.sqrt((diff * diff).sum(-1) + 1e-12)  # a norm safe at zero
    err = torch.where(z > 1e-6, err, max_err)
    return torch.clamp(err, max=max_err)


def soft_inlier_score(errs, cfg: RansacConfig):
    """score = (alpha / N) * sum sigmoid(-beta (e - tau)), beta = 5 / tau."""
    beta = 5.0 / cfg.inlier_threshold
    s = torch.sigmoid(-beta * (errs - cfg.inlier_threshold))
    return cfg.inlier_alpha * s.mean(-1)


def _gn_refine(pose6, coords, grid, cam_mat, mask, cfg: RansacConfig):
    """`cfg.gn_iters` damped Gauss-Newton steps on mask-weighted reprojection
    residuals, parameterised by a local SE(3) perturbation on the camera
    side: u = R_delta(omega) (R X + t) + dt, so du/domega = -[u]x, du/ddt = I.

    pose6 [B, K, 6], mask [B, K, N] -> [B, K, 6].
    """
    B = cam_mat.shape[0]
    f = cam_mat[:, 0, 0].view(B, 1, 1)
    cx = cam_mat[:, 0, 2].view(B, 1, 1)
    cy = cam_mat[:, 1, 2].view(B, 1, 1)
    p6 = pose6
    for _ in range(cfg.gn_iters):
        R = rodrigues(p6[..., 0:3])
        t = p6[..., 3:6]
        u = torch.einsum("bnj,bkij->bkni", coords, R) + t[:, :, None, :]  # camera frame
        z = torch.clamp(u[..., 2], min=1e-6)
        inv_z = 1.0 / z
        ux, uy = u[..., 0], u[..., 1]
        px = f * ux * inv_z + cx
        py = f * uy * inv_z + cy
        rx = (px - grid[:, 0]) * mask
        ry = (py - grid[:, 1]) * mask
        zeros = torch.zeros_like(inv_z)
        a1 = torch.stack([inv_z, zeros, -ux * inv_z * inv_z], dim=-1)
        a2 = torch.stack([zeros, inv_z, -uy * inv_z * inv_z], dim=-1)
        a1 = f[..., None] * a1 * mask[..., None]
        a2 = f[..., None] * a2 * mask[..., None]
        # Jacobian rows [A (-[u]x) | A]; a (-[u]x) = u x a
        j1 = torch.cat([torch.linalg.cross(u, a1, dim=-1), a1], dim=-1)  # [B, K, N, 6]
        j2 = torch.cat([torch.linalg.cross(u, a2, dim=-1), a2], dim=-1)
        JtJ = j1.transpose(-1, -2) @ j1 + j2.transpose(-1, -2) @ j2  # [B, K, 6, 6]
        Jtr = (j1.transpose(-1, -2) @ rx[..., None] + j2.transpose(-1, -2) @ ry[..., None])[..., 0]
        # Marquardt per-dimension damping
        damp = cfg.gn_damping * torch.diagonal(JtJ, dim1=-2, dim2=-1) + 1e-9
        delta = solve_spd(JtJ + torch.diag_embed(damp), Jtr)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        omega, dt = -delta[..., 0:3], -delta[..., 3:6]
        Rd = rodrigues(omega)
        t_new = (Rd @ t[..., None])[..., 0] + dt
        p6 = torch.cat([inverse_rodrigues(Rd @ R), t_new], dim=-1)
    return p6


def refine_pose(pose6, coords, grid, cam_mat, cfg: RansacConfig, steps: Optional[int] = None):
    """Fixed-iteration refinement with inlier recomputation and monotone
    acceptance, then an unconditional Gauss-Newton polish on the final
    inlier set. pose6 [B, K, 6] -> [B, K, 6]."""
    steps = cfg.refine_steps if steps is None else steps
    tau = cfg.inlier_threshold
    best = torch.full(pose6.shape[:-1], 4.0, dtype=pose6.dtype, device=pose6.device)
    for _ in range(steps):
        errs = _project_errors(pose6, coords, grid, cam_mat, cfg.max_pixel_error)
        mask = (errs < tau).to(pose6.dtype)
        count = mask.sum(-1)
        grow = count > best
        new = _gn_refine(pose6, coords, grid, cam_mat, mask, cfg)
        ok = torch.isfinite(new).all(-1) & grow
        pose6 = torch.where(ok[..., None], new, pose6)
        best = torch.maximum(best, count)
    for _ in range(cfg.polish_iters):
        errs = _project_errors(pose6, coords, grid, cam_mat, cfg.max_pixel_error)
        mask = (errs < tau).to(pose6.dtype)
        new = _gn_refine(pose6, coords, grid, cam_mat, mask, cfg)
        pose6 = torch.where(torch.isfinite(new).all(-1)[..., None], new, pose6)
    return pose6


def sample_hypotheses(coords, grid, cam_mat, cfg: RansacConfig, idx):
    """`cfg.hypotheses` poses per image from the 4-point sets `idx`
    [B, H * sample_rounds, 4]: P3P on each set, the first of a hypothesis's
    rounds whose 4 points reproject within tau. (pose6 [B, H, 6], valid [B, H])."""
    B = coords.shape[0]
    H, Rr = cfg.hypotheses, cfg.sample_rounds
    idx = idx.to(device=coords.device, dtype=torch.long)
    X4 = coords[torch.arange(B, device=coords.device)[:, None, None], idx]
    P4 = grid[idx]
    Rm, tm, err4, valid = _p3p_from_4pts_impl(X4, P4, cam_mat[:, None])
    Rm = Rm.reshape(B, H, Rr, 3, 3)
    tm = tm.reshape(B, H, Rr, 3)
    good = valid.reshape(B, H, Rr) & (err4.reshape(B, H, Rr) < cfg.inlier_threshold)
    first = torch.argmax(good.to(torch.uint8), dim=2)
    hyp_valid = good.any(dim=2)
    R_sel = torch.gather(Rm, 2, first[:, :, None, None, None].expand(B, H, 1, 3, 3))[:, :, 0]
    t_sel = torch.gather(tm, 2, first[:, :, None, None].expand(B, H, 1, 3))[:, :, 0]
    return torch.cat([inverse_rodrigues(R_sel), t_sel], dim=-1), hyp_valid


def solver_inputs(scene_coords, focal_length, image_hw, cfg: RansacConfig):
    """(coords [B, N, 3], grid [N, 2], cams [B, 3, 3]) of a batch of
    scene-coordinate maps [B, Hs, Ws, 3], the principal point central."""
    B, Hs, Ws, _ = scene_coords.shape
    dtype, device = scene_coords.dtype, scene_coords.device
    grid = pixel_grid(Hs, Ws, cfg.subsample, dtype=dtype, device=device).reshape(Hs * Ws, 2)
    img_h, img_w = image_hw
    focal = torch.as_tensor(focal_length, dtype=dtype, device=device).expand(B)
    cams = intrinsics(focal, img_w, img_h, dtype=dtype, device=device)
    return scene_coords.reshape(B, Hs * Ws, 3), grid, cams


def selection_probs(scores, hyp_valid):
    """Softmax over the valid hypotheses' scores; uniform when none is valid."""
    masked = torch.where(hyp_valid, scores, -torch.inf)
    return torch.softmax(torch.where(hyp_valid.any(-1, keepdim=True), masked, 0.0), dim=-1)


def score_hypotheses(pose6, hyp_valid, coords, grid, cams, cfg: RansacConfig):
    """(soft inlier scores [B, H], hard inlier counts [B, H], -1 where the
    hypothesis is invalid) of each hypothesis."""
    errs = _project_errors(pose6, coords, grid, cams, cfg.max_pixel_error)  # [B, H, N]
    hard = torch.where(hyp_valid, (errs < cfg.inlier_threshold).sum(-1), -1)
    return soft_inlier_score(errs, cfg), hard


def solve_batch(scene_coords, focal_length, image_hw, cfg: RansacConfig, idx, tf32: bool = False):
    """Cam-to-world poses [B, 4, 4] of scene-coordinate maps [B, Hs, Ws, 3]
    from the hypothesis draws `idx`: the winner is the argmax of the
    softmax over the valid hypotheses' soft inlier scores, then refined.
    `tf32` lets the matrix products run in TF32 (the control)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        coords, grid, cams = solver_inputs(scene_coords, focal_length, image_hw, cfg)
        pose6, hyp_valid = sample_hypotheses(coords, grid, cams, cfg, idx)
        scores, _ = score_hypotheses(pose6, hyp_valid, coords, grid, cams, cfg)
        probs = selection_probs(scores, hyp_valid)
        chosen = torch.argmax(probs, dim=-1)
        rows = torch.arange(coords.shape[0], device=coords.device)
        win = refine_pose(pose6[rows, chosen][:, None], coords, grid, cams, cfg)[:, 0]
        return invert_se3(pose_vec_to_w2c(win))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
