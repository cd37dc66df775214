"""DSAC*'s end-to-end training objective in plain PyTorch: the expected pose
loss over the hypothesis distribution, E_h~p [ loss(refine(h), gt) ], for a
batch of scene-coordinate maps (Brachmann & Rother, arXiv:2002.12324;
vislearn/dsacstar `train_e2e.py` and its plugin's `backward_rgb`).

Each minimal set's P3P root comes from `reference/ransac.py`'s Lambda
Twist, in float64 and without its gradient; everything after the root is
this module's own. The root is checked by one Newton step of its three
points' reprojection residuals taken from it: a root is a fixed point, so
the step's value is the root to rounding (an arithmetic fault that left a
non-root moves), and its gradient is the implicit function's, -J^-1 dr/dX,
with J found by forward differentiation. The four points' errors under the
stepped pose decide the round, and the first of a hypothesis's rounds whose
four points reproject within tau wins. Projection, soft inlier scores,
softmax and refinement are `reference/ransac.py`'s; added for training are
the principal point moved by the augmentation's crop (`pp_shift`), every
hypothesis refined with the training step count, DSAC*'s pose loss with
its soft clamp, and the expectation sum_h p_h l_h over the valid
hypotheses. Nothing here knows the program under test. TF32 is whatever
the caller set (the benchmark's reference turns it off for float32).

An invalid hypothesis weighs nothing; it is scored and refined from its
image's ground-truth pose, detached, so that autograd's zero cotangent
meets finite derivatives.

Departures from DSAC*'s C++, both the port's too:
- refinement is a fixed, unrolled number of Gauss-Newton steps with inlier
  recomputation and monotone acceptance, then a polish, differentiated
  through; the plugin refines to convergence and differentiates the final
  inlier set's pose;
- sampling makes a fixed number of masked retry rounds per hypothesis (the
  first round whose four points reproject within tau wins; none: the
  hypothesis is invalid and weighs nothing); the plugin retries without
  bound.
"""
from __future__ import annotations

import math

import torch

from . import ransac


def on_target(coords, target):
    """`coords` [B, h, w, 3] with their value replaced by `target` and their
    gradient passed on unchanged: the solver sees a chosen input, the
    backward runs through whatever made `coords`."""
    return coords - coords.detach() + target.to(coords.dtype)


def _reprojection(R, t, X, pix, cams):
    """Pixel errors [..., n] of world points X [..., n, 3] under (R [..., 3, 3],
    t [..., 3]) against pixels [..., n, 2], and whether each is in front."""
    u = X @ R.transpose(-1, -2) + t[..., None, :]
    front = u[..., 2] > 1e-6
    z = torch.where(front, u[..., 2], 1.0)
    px = cams[..., 0, 0, None] * u[..., 0] / z + cams[..., 0, 2, None]
    py = cams[..., 1, 1, None] * u[..., 1] / z + cams[..., 1, 2, None]
    return torch.sqrt((px - pix[..., 0]) ** 2 + (py - pix[..., 1]) ** 2), front


def _residuals(p, R0, t0, X3, pix3, cams):
    """Reprojection residuals [M, 6] of three points X3 [M, 3, 3] under the
    pose (rodrigues(p[:3]) R0, t0 + p[3:])."""
    R = ransac.rodrigues(p[..., :3]) @ R0
    u = X3 @ R.transpose(-1, -2) + (t0 + p[..., 3:])[..., None, :]
    px = cams[..., None, 0, 0] * u[..., 0] / u[..., 2] + cams[..., None, 0, 2]
    py = cams[..., None, 1, 1] * u[..., 1] / u[..., 2] + cams[..., None, 1, 2]
    return torch.cat([px - pix3[..., 0], py - pix3[..., 1]], -1)


def _implicit(R0, t0, X3, pix3, cams, keep):
    """The pose (R0, t0) that solves three points X3 [M, 3, 3] exactly, as
    one Newton step of their residuals from itself: its value to rounding,
    its gradient the implicit function's, -J^-1 dr/dX3. Only the sets in
    `keep` [M] whose J is regular carry a gradient. Returns pose6 [M, 6]."""
    p0 = torch.zeros(R0.shape[:-2] + (6,), dtype=R0.dtype, device=R0.device)
    Xd = X3.detach()
    eye = torch.eye(6, dtype=p0.dtype, device=p0.device)
    J = torch.stack([torch.func.jvp(lambda p: _residuals(p, R0, t0, Xd, pix3, cams), (p0,),
                                    (eye[k].expand_as(p0),))[1] for k in range(6)], -1)
    probe, info = torch.linalg.solve_ex(J, _residuals(p0, R0, t0, Xd, pix3, cams))
    use = keep & (info == 0) & torch.isfinite(J).all(-1).all(-1) & torch.isfinite(probe).all(-1)
    r = _residuals(p0, R0, t0, torch.where(use[..., None, None], X3, Xd), pix3, cams)
    step = torch.linalg.solve(torch.where(use[..., None, None], J, eye),
                              torch.where(use[..., None], r, 0.0))
    R = ransac.rodrigues(-step[..., :3]) @ R0
    return torch.cat([ransac.inverse_rodrigues(R), t0 - step[..., 3:]], -1)


def sample_hypotheses(coords, grid, cams, gt_w2c, cfg: ransac.RansacConfig, idx):
    """Each hypothesis's pose from the minimal sets `idx` [B, H * rounds, 4].
    Every set's P3P root comes from `ransac._p3p_from_4pts_impl` in float64
    (no gradient), and is checked here: one Newton step of the three points'
    residuals (`_implicit`) gives its value and derivative, and the four
    points' errors under that pose, in front and within tau, decide the
    round. The first good round of each hypothesis wins; an invalid
    hypothesis (none) takes the image's ground-truth world-to-camera pose
    `gt_w2c` [B, 4, 4], detached. Returns (pose6 [B, H, 6] in `coords`'
    dtype, valid [B, H])."""
    B = coords.shape[0]
    H, Rr = cfg.hypotheses, cfg.sample_rounds
    idx = idx.to(device=coords.device, dtype=torch.long)
    rows = torch.arange(B, device=coords.device)
    X4 = coords.double()[rows[:, None, None], idx]
    pix4, cams64 = grid.double()[idx], cams.double()[:, None].expand(B, H * Rr, 3, 3)
    with torch.no_grad():
        R, t, _, solved = ransac._p3p_from_4pts_impl(X4, pix4, cams64)
    pose6 = _implicit(R, t, X4[..., :3, :], pix4[..., :3, :], cams64, solved)
    with torch.no_grad():
        err, front = _reprojection(ransac.rodrigues(pose6[..., :3]), pose6[..., 3:], X4, pix4,
                                   cams64)
    good = (solved & front.all(-1) & (err.amax(-1) < cfg.inlier_threshold)).reshape(B, H, Rr)
    first = torch.argmax(good.to(torch.uint8), dim=2)  # [B, H]
    pose6 = torch.gather(pose6.reshape(B, H, Rr, 6), 2,
                         first[..., None, None].expand(B, H, 1, 6))[:, :, 0]
    gt = gt_w2c.detach().double()
    stand_in = torch.cat([ransac.inverse_rodrigues(gt[:, :3, :3]), gt[:, :3, 3]], -1)
    valid = good.any(dim=2)
    pose6 = torch.where(valid[..., None], pose6, stand_in[:, None])
    return pose6.to(coords.dtype), valid


def pose_loss(est_c2w, gt_c2w, w_rot: float, w_trans: float, soft_clamp: float):
    """w_rot x rotation error in degrees + w_trans x translation error (in
    metres: w_trans 100 weighs centimetres), square-root clamped above
    `soft_clamp`: sqrt(soft_clamp x loss). Cam-to-world [..., 4, 4]. The
    angle's value is exact; its gradient is taken at an argument kept 1e-6
    inside [-1, 1], where arccos' is finite."""
    rot = gt_c2w[..., :3, :3] @ est_c2w[..., :3, :3].transpose(-1, -2)
    cos = torch.clamp((rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2] - 1.0) / 2.0, -1.0, 1.0)
    inner = torch.acos(torch.clamp(cos, -1.0 + 1e-6, 1.0 - 1e-6))
    angle = inner + (torch.acos(cos) - inner).detach()
    t_err = torch.linalg.vector_norm(est_c2w[..., :3, 3] - gt_c2w[..., :3, 3], dim=-1)
    loss = w_rot * angle * (180.0 / math.pi) + w_trans * t_err
    return torch.where(loss > soft_clamp, torch.sqrt(soft_clamp * torch.clamp(loss, min=1e-12)),
                       loss)


def expected_pose_loss(scene_coords, gt_c2w, focal, pp_shift, image_hw, idx,
                       cfg: ransac.RansacConfig, refine_steps: int, w_rot: float,
                       w_trans: float, soft_clamp: float):
    """The batch's mean expected pose loss. scene_coords [B, Hs, Ws, 3],
    gt_c2w [B, 4, 4], focal [], pp_shift [2] (added to the central
    principal point), image_hw (H, W), idx [B, H * rounds, 4] the minimal
    sets' cells."""
    coords, grid, cams = ransac.solver_inputs(scene_coords, focal, image_hw, cfg)
    shift = torch.zeros_like(cams)
    shift[:, 0, 2], shift[:, 1, 2] = pp_shift[0], pp_shift[1]
    cams = cams + shift
    pose6, valid = sample_hypotheses(coords, grid, cams, ransac.invert_se3(gt_c2w), cfg, idx)
    errs = ransac._project_errors(pose6, coords, grid, cams, cfg.max_pixel_error)
    probs = ransac.selection_probs(ransac.soft_inlier_score(errs, cfg), valid)
    refined = ransac.refine_pose(pose6, coords, grid, cams, cfg, steps=refine_steps)
    est = ransac.invert_se3(ransac.pose_vec_to_w2c(refined))
    losses = pose_loss(est, gt_c2w[:, None], w_rot, w_trans, soft_clamp)
    return (probs * torch.where(valid, losses, 0.0)).sum(-1).mean()
