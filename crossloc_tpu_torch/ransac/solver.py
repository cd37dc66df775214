"""Batched differentiable RANSAC PnP solver (counterpart of
`crossloc_tpu/ransac/solver.py`).

Sample 4-point minimal sets -> P3P -> soft inlier scores -> softmax ->
winner (argmax in eval, a draw in training) -> refinement, for a batch of
scene-coordinate maps at once. The JAX package vmaps one image's solve over
the batch and runs `fori_loop`s; here every tensor carries the batch (and
hypothesis) axes explicitly and the loops are Python loops over batched
tensors. Poses are scene poses: world-to-cam (rvec, tvec) 6-vectors.
Gradients reach the scene coordinates through the scores, the refinement
and P3P's implicit backward.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..geometry import (
    intrinsics,
    invert_se3,
    inverse_rodrigues,
    p3p_from_4pts,
    pixel_grid,
    pose_vec_to_w2c,
    rodrigues,
    solve_spd,
)
from .config import RansacConfig


@contextlib.contextmanager
def solver_precision(device: torch.device):
    """Float32 means float32 inside the solver: autocast off and no TF32
    matmuls, whatever the caller set (the JAX solver runs under
    `default_matmul_precision("float32")`: reduced-precision products made
    its geometry 2.2x worse). The TF32 flag is restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class RansacResult(NamedTuple):
    cam_to_world: torch.Tensor  # [B, 4, 4] estimated camera transforms
    pose_w2c6: torch.Tensor  # [B, 6] winning (rvec, tvec) scene pose
    scores: torch.Tensor  # [B, H] soft inlier scores per hypothesis
    probs: torch.Tensor  # [B, H] softmax selection distribution
    chosen: torch.Tensor  # [B] selected hypothesis index
    inlier_count: torch.Tensor  # [B] hard inlier count of the winner
    valid: torch.Tensor  # [B] whether any valid hypothesis existed
    entropy: torch.Tensor  # [B] Shannon entropy of the distribution (nats)


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
    err = torch.sqrt((diff * diff).sum(-1) + 1e-12)  # safe norm, as the JAX solver
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


def sample_hypotheses(coords, grid, cam_mat, cfg: RansacConfig, idx=None,
                      generator: Optional[torch.Generator] = None):
    """`cfg.hypotheses` pose hypotheses per image from 4-point minimal sets.

    Draws `sample_rounds` candidate sets per hypothesis, solves P3P for all
    of them and keeps the first set whose 4 points reproject within the
    inlier threshold. `idx` [B, H * sample_rounds, 4] gives the draws
    explicitly; otherwise they come from `generator`.
    Returns (pose6 [B, H, 6], valid [B, H]).
    """
    B, N = coords.shape[:2]
    H, Rr = cfg.hypotheses, cfg.sample_rounds
    if idx is None:
        idx = torch.randint(0, N, (B, H * Rr, 4), generator=generator, device=coords.device)
    elif tuple(idx.shape) != (B, H * Rr, 4):
        raise ValueError(f"idx must be [{B}, {H * Rr}, 4], got {tuple(idx.shape)}")
    idx = idx.to(device=coords.device, dtype=torch.long)
    X4 = coords[torch.arange(B, device=coords.device)[:, None, None], idx]  # [B, H*Rr, 4, 3]
    P4 = grid[idx]  # [B, H*Rr, 4, 2]
    Rm, tm, err4, valid = p3p_from_4pts(X4, P4, cam_mat[:, None])
    Rm = Rm.reshape(B, H, Rr, 3, 3)
    tm = tm.reshape(B, H, Rr, 3)
    good = valid.reshape(B, H, Rr) & (err4.reshape(B, H, Rr) < cfg.inlier_threshold)
    first = torch.argmax(good.to(torch.uint8), dim=2)  # first valid round (or 0)
    hyp_valid = good.any(dim=2)
    R_sel = torch.gather(Rm, 2, first[:, :, None, None, None].expand(B, H, 1, 3, 3))[:, :, 0]
    t_sel = torch.gather(tm, 2, first[:, :, None, None].expand(B, H, 1, 3))[:, :, 0]
    return torch.cat([inverse_rodrigues(R_sel), t_sel], dim=-1), hyp_valid


def apply_pp_shift(cams, pp_shift):
    """Offset the principal point of [B, 3, 3] camera matrices by pp_shift,
    [2] (shared) or [B, 2]: the augmentation's zoom-in crop window moves it
    (`data/augment.py`)."""
    shift = torch.as_tensor(pp_shift, dtype=cams.dtype, device=cams.device).reshape(-1, 2)
    offset = torch.zeros_like(cams)
    offset[:, 0:2, 2] = shift.expand(cams.shape[0], 2)
    return cams + offset


def solver_inputs(scene_coords, focal_length, image_hw, cfg: RansacConfig, pp_shift=None):
    """(coords [B, N, 3], grid [N, 2], cams [B, 3, 3]) of a batch of
    scene-coordinate maps [B, Hs, Ws, 3]: principal point central, plus
    `pp_shift` when given."""
    B, Hs, Ws, _ = scene_coords.shape
    dtype, device = scene_coords.dtype, scene_coords.device
    grid = pixel_grid(Hs, Ws, cfg.subsample, dtype=dtype, device=device).reshape(Hs * Ws, 2)
    img_h, img_w = image_hw
    focal = torch.as_tensor(focal_length, dtype=dtype, device=device).expand(B)
    cams = intrinsics(focal, img_w, img_h, dtype=dtype, device=device)
    if pp_shift is not None:
        cams = apply_pp_shift(cams, pp_shift)
    return scene_coords.reshape(B, Hs * Ws, 3), grid, cams


def selection_probs(scores, hyp_valid):
    """Softmax over the valid hypotheses' scores; uniform when none is valid."""
    masked = torch.where(hyp_valid, scores, -torch.inf)
    return torch.softmax(torch.where(hyp_valid.any(-1, keepdim=True), masked, 0.0), dim=-1)


def solve_batch(
    scene_coords,
    focal_length,
    image_hw,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    pp_shift=None,
    chosen=None,
) -> RansacResult:
    """Estimate camera poses for a batch of scene-coordinate maps.

    scene_coords [B, Hs, Ws, 3] (NHWC); focal_length scalar or [B];
    image_hw (height, width) of the RGB frame, principal point central plus
    the optional `pp_shift` [2] or [B, 2] of the augmentation's crop.
    Hypothesis draws come from `idx` [B, H * sample_rounds, 4] when given,
    else from `generator`. Eval mode takes the argmax; `training=True` draws
    the winner from the softmax (`chosen` [B] gives the draw, else
    `generator` after the hypothesis draws). Gradients flow to scene_coords.
    """
    B = scene_coords.shape[0]
    device = scene_coords.device
    tau = cfg.inlier_threshold
    rows = torch.arange(B, device=device)
    with solver_precision(device):
        coords, grid, cams = solver_inputs(scene_coords, focal_length, image_hw, cfg, pp_shift)
        pose6, hyp_valid = sample_hypotheses(coords, grid, cams, cfg, idx, generator)
        errs = _project_errors(pose6, coords, grid, cams, cfg.max_pixel_error)  # [B, H, N]
        scores = soft_inlier_score(errs, cfg)
        any_valid = hyp_valid.any(-1)
        masked = torch.where(hyp_valid, scores, -torch.inf)
        probs = selection_probs(scores, hyp_valid)

        if training:
            if chosen is None:
                chosen = torch.multinomial(probs, 1, generator=generator)[:, 0]
            chosen = torch.as_tensor(chosen, device=device).long()
        elif cfg.eval_selection == "hard":
            hard = torch.where(hyp_valid, (errs < tau).sum(-1), -1)
            chosen = torch.argmax(hard, dim=-1)
        else:
            chosen = torch.argmax(probs, dim=-1)

        if not training and cfg.refine_top_k > 1:
            k = min(cfg.refine_top_k, pose6.shape[1])
            sel = masked if cfg.eval_selection != "hard" else hard
            top_idx = torch.topk(sel, k, dim=-1).indices  # [B, k]
            cand = torch.gather(pose6, 1, top_idx[..., None].expand(B, k, 6))
            refined = refine_pose(cand, coords, grid, cams, cfg)
            final = soft_inlier_score(_project_errors(refined, coords, grid, cams,
                                                      cfg.max_pixel_error), cfg)
            best = torch.argmax(final, dim=-1)
            win = refined[rows, best]
            chosen = top_idx[rows, best]
        else:
            win = refine_pose(pose6[rows, chosen][:, None], coords, grid, cams, cfg)[:, 0]

        final_errs = _project_errors(win[:, None], coords, grid, cams, cfg.max_pixel_error)[:, 0]
        inliers = (final_errs < tau).sum(-1)
        plog = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-30)), 0.0)
        entropy = -(probs * plog).sum(-1)
        return RansacResult(
            cam_to_world=invert_se3(pose_vec_to_w2c(win)),
            pose_w2c6=win,
            scores=scores,
            probs=probs,
            chosen=chosen,
            inlier_count=inliers,
            valid=any_valid,
            entropy=entropy,
        )
