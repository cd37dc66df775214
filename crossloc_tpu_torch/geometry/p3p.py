"""Closed-form P3P (Lambda Twist) with an implicit-function backward
(counterpart of `crossloc_tpu/geometry/p3p.py`).

Persson & Nordberg, "Lambda Twist: An Accurate Fast Robust P3P Solver"
(ECCV 2018): depths from a cubic and a constrained eigen decomposition,
Gauss-Newton polish of the depth triplet, closed-form pose assembly. Every
vector or matrix is a tuple of same-shape component tensors
(structure-of-arrays) and the four candidates are unrolled in Python, so
each step is one elementwise op over the whole batch of minimal sets.
Invalid candidates are masked, never retried. The pose of a minimal set is
differentiated implicitly (`p3p_from_4pts`), not through the algebra.
"""
from __future__ import annotations

import math

import torch

from .se3 import inverse_rodrigues, rodrigues

_EPS = 1e-12


def _sanitize(g):
    """Non-finite entries -> 0, magnitudes clipped to 1e6."""
    return torch.clamp(torch.where(torch.isfinite(g), g, 0.0), -1e6, 1e6)


class _GradFirewall(torch.autograd.Function):
    """Identity forward; the backward sanitizes the cotangent (`_sanitize`).
    Degenerate minimal sets carry no useful gradient, and the reference's
    hand-written backward zeroes unstable Jacobians the same way."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sanitize(g)


def grad_firewall(x):
    return _GradFirewall.apply(x)


def _safe_sqrt(x, eps=1e-12):
    return torch.sqrt(torch.clamp(x, min=eps))


def _safe_cbrt(x, eps=1e-12):
    return torch.sign(x) * torch.clamp(x.abs(), min=eps) ** (1.0 / 3.0)


# vec3: (x, y, z); sym3: (d00, d01, d02, d11, d12, d22); mat3: 9-tuple row-major


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


def p3p_lambdatwist(X, y):
    """All P3P poses of one minimal problem per batch entry: world points X
    [..., 3, 3] (row i is point i), unit bearings y [..., 3, 3] ->
    (R [..., 4, 3, 3], t [..., 4, 3], valid [..., 4]), the four Lambda
    Twist candidates with x_cam = R x_world + t."""
    X = grad_firewall(X)
    y = grad_firewall(y)
    cands = _p3p_soa(*(_unpack_vec3(X, i) for i in range(3)),
                     *(_unpack_vec3(y, i) for i in range(3)))
    R = torch.stack([torch.stack(c[0], dim=-1).reshape(c[0][0].shape + (3, 3)) for c in cands],
                    dim=-3)
    t = torch.stack([torch.stack(c[1], dim=-1) for c in cands], dim=-2)
    valid = torch.stack([c[2] for c in cands], dim=-1)
    return R, t, valid


def bearings_from_pixels(pixels, cam_mat):
    """Unit bearing vectors from pixel coords. [..., N, 2] -> [..., N, 3]."""
    f = cam_mat[..., 0, 0]
    cx = cam_mat[..., 0, 2]
    cy = cam_mat[..., 1, 2]
    x = (pixels[..., 0] - cx[..., None]) / f[..., None]
    y = (pixels[..., 1] - cy[..., None]) / f[..., None]
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / _safe_sqrt((v * v).sum(-1, keepdim=True))


def _p3p_from_4pts_impl(X4, pix4, cam_mat):
    """The forward of `p3p_from_4pts`."""
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


def _implicit_grad_X3(X3, pix3, cam_mat, R, t, gR, gt):
    """-B^T A^-T g_p6 over the batch: the cotangent of the first three world
    points [..., 3, 3] for cotangents gR, gt of the pose, where F(p6, X) are
    the six projection residuals of the three points, p6 = (rvec, t),
    A = dF/dp6 [6, 6] and B = dF/dX [6, 9]. Rows of F: u0 u1 u2 v0 v1 v2."""
    rvec = inverse_rodrigues(R)
    Rr = rodrigues(rvec)
    # dR/dr_k by forward mode, [..., 3(k), 3, 3]
    basis = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    dR = torch.stack([torch.func.jvp(rodrigues, (rvec,), (basis[k].expand_as(rvec),))[1]
                      for k in range(3)], dim=-3)
    Xc = X3 @ Rr.transpose(-1, -2) + t[..., None, :]  # [..., 3 points, 3]
    fx, fy = cam_mat[..., 0, 0, None], cam_mat[..., 1, 1, None]
    zpos = Xc[..., 2] > 1e-9
    inv_z = 1.0 / torch.clamp(Xc[..., 2], min=1e-9)
    zero = torch.zeros_like(inv_z)
    # dF/dXc per point: rows (u, v), [..., 3 points, 2, 3]
    ju = torch.stack([fx * inv_z, zero, torch.where(zpos, -fx * Xc[..., 0] * inv_z * inv_z, 0.0)],
                     dim=-1)
    jv = torch.stack([zero, fy * inv_z, torch.where(zpos, -fy * Xc[..., 1] * inv_z * inv_z, 0.0)],
                     dim=-1)
    J = torch.stack([ju, jv], dim=-2)
    # dXc_i/dp6 = [dR/dr X_i | I], [..., 3 points, 3, 6]
    dXc_dr = torch.einsum("...kab,...ib->...iak", dR, X3)
    eye = torch.eye(3, dtype=X3.dtype, device=X3.device).expand(dXc_dr.shape)
    A = (J @ torch.cat([dXc_dr, eye], dim=-1)).transpose(-3, -2).reshape(*X3.shape[:-2], 6, 6)
    JR = (J @ Rr[..., None, :, :]).transpose(-3, -2)  # [..., 2, 3 points, 3]
    g_p6 = torch.cat([torch.einsum("...ab,...kab->...k", gR, dR), gt], dim=-1)
    y = torch.linalg.solve_ex(A.transpose(-1, -2), g_p6)[0].reshape(*X3.shape[:-2], 2, 3)
    # B is block-diagonal in the points: gX_i = -(JR_i)^T y_i
    return -torch.einsum("...cia,...ci->...ia", JR, y)


class _P3PFrom4Pts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X4, pix4, cam_mat):
        R, t, err, valid = _p3p_from_4pts_impl(X4, pix4, cam_mat)
        ctx.save_for_backward(X4, pix4, cam_mat, R, t, valid)
        ctx.mark_non_differentiable(err, valid)
        return R, t, err, valid

    @staticmethod
    def backward(ctx, gR, gt, _gerr, _gvalid):
        X4, pix4, cam_mat, R, t, valid = ctx.saved_tensors
        cam = cam_mat.expand(X4.shape[:-2] + (3, 3))
        gX3 = _implicit_grad_X3(X4[..., :3, :], pix4[..., :3, :], cam, R, t, gR, gt)
        gX3 = _sanitize(torch.where(valid[..., None, None], gX3, 0.0))
        gX4 = torch.cat([gX3, torch.zeros_like(X4[..., 3:, :])], dim=-2)
        return (gX4, torch.zeros_like(pix4) if ctx.needs_input_grad[1] else None,
                torch.zeros_like(cam_mat) if ctx.needs_input_grad[2] else None)


def p3p_from_4pts(X4, pix4, cam_mat):
    """Pose from a 4-point minimal sample: P3P on points 0-2, point 3 selects.

    X4 [..., 4, 3] world points, pix4 [..., 4, 2] pixels, cam_mat broadcastable
    to [..., 3, 3]. Returns (R [..., 3, 3], t [..., 3], max_err4 [...], valid [...]):
    the candidate with the smallest largest reprojection error of the 4 points.

    The backward is the implicit function theorem's: (R, t) solves the three
    points' projection system F(pose, X) = 0, so d pose / dX = -A^-1 B with
    A = dF/dpose and B = dF/dX: one 6x6 solve per set (`solve_ex`, no error
    check), exact for the selected root. It replaces the reference's
    finite-difference Jacobian at the same boundary. Invalid sets get zero,
    non-finite entries 0, magnitudes are clipped to 1e6; the 4th point,
    `pix4` and `cam_mat` get zero (they feed threshold tests only).
    """
    return _P3PFrom4Pts.apply(X4, pix4, cam_mat)
