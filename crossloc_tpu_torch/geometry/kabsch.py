"""Weighted Kabsch (orthogonal Procrustes) alignment via SVD (counterpart of
`crossloc_tpu/geometry/kabsch.py`).

The SVD's backward replaces the reference's hand-written Kabsch Jacobians.
It is non-finite for repeated singular values (a minimal set with duplicate
points), so the inputs pass through the gradient firewall: those
gradients are dropped, where the reference falls back to finite
differences.
"""
from __future__ import annotations

import torch

from .p3p import grad_firewall


def kabsch(src, dst, weights=None):
    """Rigid (R, t) minimising sum_i w_i ||R src_i + t - dst_i||^2.

    src, dst [..., N, 3]; weights [..., N] (optional, non-negative).
    Returns (R [..., 3, 3], t [..., 3]), handedness fixed by sign(det).
    """
    src = grad_firewall(src)
    dst = grad_firewall(dst)
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wn = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-12)
    src_c = (wn[..., None] * src).sum(-2)
    dst_c = (wn[..., None] * dst).sum(-2)
    src0 = src - src_c[..., None, :]
    dst0 = dst - dst_c[..., None, :]
    # H = sum_i w_i dst0_i src0_i^T -> R = U diag(1, 1, det(U V^T)) V^T
    H = torch.einsum("...n,...ni,...nj->...ij", wn, dst0, src0)
    U, _, Vh = torch.linalg.svd(H, full_matrices=False)
    det = torch.linalg.det(U @ Vh)
    one = torch.ones_like(det)
    R = U @ torch.diag_embed(torch.stack([one, one, det], dim=-1)) @ Vh
    t = dst_c - (R @ src_c[..., None])[..., 0]
    return R, t
