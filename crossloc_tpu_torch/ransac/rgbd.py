"""RGB-D pose solver: Kabsch hypotheses over measured camera coordinates
(counterpart of `crossloc_tpu/ransac/rgbd.py`).

The reference plugin's RGB-D path: 3-point Kabsch hypotheses from pixels
with valid depth, 3D distance errors in centimetres, soft inlier scores and
Kabsch refinement on the inliers. Differentiable end to end through the
SVD. Indices are drawn over the whole grid, and a round is valid only if
its 3 pixels carry depth; invalid pixels get the maximal error and no
refinement weight.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import invert_se3, kabsch
from .config import PoseLossConfig, RansacConfig
from .loss import pose_loss
from .solver import selection_probs, solver_precision


class RgbdResult(NamedTuple):
    cam_to_world: torch.Tensor  # [B, 4, 4]
    scores: torch.Tensor  # [B, H]
    probs: torch.Tensor  # [B, H]
    chosen: torch.Tensor  # [B]
    inlier_count: torch.Tensor  # [B]
    valid: torch.Tensor  # [B]


def _dist_errors_cm(R, t, obj, eye, vmask, max_dist):
    """||eye - (R obj + t)|| in cm, clamped; pixels without depth get
    max_dist. R [B, K, 3, 3], t [B, K, 3], obj / eye [B, N, 3], vmask [B, N]
    -> [B, K, N]."""
    pred = torch.einsum("bkij,bnj->bkni", R, obj) + t[:, :, None, :]
    d = torch.linalg.vector_norm(eye[:, None] - pred, dim=-1) * 100.0
    return torch.clamp(torch.where(vmask[:, None], d, max_dist), max=max_dist)


def _kabsch_refine(R, t, obj, eye, vmask, cfg: RansacConfig):
    """`cfg.refine_steps` rounds of Kabsch on the inliers, each accepted only
    if the inlier count grew. R [B, K, 3, 3], t [B, K, 3]."""
    best = torch.full(R.shape[:2], 3.0, dtype=obj.dtype, device=obj.device)
    src = obj[:, None].expand(-1, R.shape[1], -1, -1)
    dst = eye[:, None].expand(-1, R.shape[1], -1, -1)
    for _ in range(cfg.refine_steps):
        d = _dist_errors_cm(R, t, obj, eye, vmask, cfg.max_pixel_error)
        w = ((d < cfg.inlier_threshold) & vmask[:, None]).to(obj.dtype)
        count = w.sum(-1)
        Rn, tn = kabsch(src, dst, w)
        ok = (count > best) & torch.isfinite(Rn).all(-1).all(-1) & torch.isfinite(tn).all(-1)
        R = torch.where(ok[..., None, None], Rn, R)
        t = torch.where(ok[..., None], tn, t)
        best = torch.maximum(best, count)
    return R, t


def _hypotheses(obj, eye, vmask, cfg: RansacConfig, idx):
    """Kabsch hypotheses from idx [B, H, sample_rounds, 3]: the first round
    whose 3 pixels have depth and fit within tau. Returns (R0 [B, H, 3, 3],
    t0 [B, H, 3], hyp_valid [B, H], scores [B, H])."""
    B, N = obj.shape[:2]
    H, Rr = cfg.hypotheses, cfg.sample_rounds
    if tuple(idx.shape) != (B, H, Rr, 3):
        raise ValueError(f"idx must be [{B}, {H}, {Rr}, 3], got {tuple(idx.shape)}")
    idx = idx.to(device=obj.device, dtype=torch.long)
    rows = torch.arange(B, device=obj.device)[:, None, None, None]
    o3, e3 = obj[rows, idx], eye[rows, idx]  # [B, H, Rr, 3, 3]
    Rk, tk = kabsch(o3, e3)
    pred = torch.einsum("bhrij,bhrnj->bhrni", Rk, o3) + tk[..., None, :]
    d3 = torch.linalg.vector_norm(e3 - pred, dim=-1) * 100.0
    good = vmask[rows, idx].all(-1) & (d3 < cfg.inlier_threshold).all(-1)
    first = torch.argmax(good.to(torch.uint8), dim=2)
    R0 = torch.gather(Rk, 2, first[:, :, None, None, None].expand(B, H, 1, 3, 3))[:, :, 0]
    t0 = torch.gather(tk, 2, first[:, :, None, None].expand(B, H, 1, 3))[:, :, 0]
    d = _dist_errors_cm(R0, t0, obj, eye, vmask, cfg.max_pixel_error)
    beta = 5.0 / cfg.inlier_threshold
    scores = cfg.inlier_alpha * torch.sigmoid(-beta * (d - cfg.inlier_threshold)).mean(-1)
    return R0, t0, good.any(dim=2), scores


def _flatten(scene_coords, camera_coords, valid_mask):
    B = scene_coords.shape[0]
    return (scene_coords.reshape(B, -1, 3), camera_coords.reshape(B, -1, 3),
            valid_mask.reshape(B, -1).bool())


def _draw(idx, generator, B, N, cfg: RansacConfig, device):
    if idx is not None:
        return idx
    return torch.randint(0, N, (B, cfg.hypotheses, cfg.sample_rounds, 3), generator=generator,
                         device=device)


def _w2c(R, t):
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def solve_rgbd(scene_coords, camera_coords, valid_mask, cfg: RansacConfig = RansacConfig(),
               training: bool = False, idx=None, chosen=None,
               generator: Optional[torch.Generator] = None) -> RgbdResult:
    """scene_coords / camera_coords [B, Hs, Ws, 3], valid_mask [B, Hs, Ws].

    The hypothesis maps scene points into the camera frame (obj -> eye); the
    result is its inverse, cam-to-world. Draws: `idx` [B, H, sample_rounds, 3]
    and, in training, `chosen` [B], else from `generator` in that order.
    Distances (tau, max_pixel_error) are in cm.
    """
    device = scene_coords.device
    with solver_precision(device):
        obj, eye, vmask = _flatten(scene_coords, camera_coords, valid_mask)
        B, N = obj.shape[:2]
        rows = torch.arange(B, device=device)
        R0, t0, hyp_valid, scores = _hypotheses(
            obj, eye, vmask, cfg, _draw(idx, generator, B, N, cfg, device))
        probs = selection_probs(scores, hyp_valid)
        if not training:
            chosen = torch.argmax(probs, dim=-1)
        elif chosen is None:
            chosen = torch.multinomial(probs, 1, generator=generator)[:, 0]
        chosen = torch.as_tensor(chosen, device=device).long()
        Rw, tw = _kabsch_refine(R0[rows, chosen][:, None], t0[rows, chosen][:, None], obj, eye,
                                vmask, cfg)
        dw = _dist_errors_cm(Rw, tw, obj, eye, vmask, cfg.max_pixel_error)[:, 0]
        inliers = ((dw < cfg.inlier_threshold) & vmask).sum(-1)
        return RgbdResult(invert_se3(_w2c(Rw[:, 0], tw[:, 0])), scores, probs, chosen, inliers,
                          hyp_valid.any(-1))


def expected_pose_loss_rgbd(scene_coords, camera_coords, valid_mask, gt_poses,
                            cfg: RansacConfig = RansacConfig(),
                            loss_cfg: PoseLossConfig = PoseLossConfig(), idx=None,
                            generator: Optional[torch.Generator] = None):
    """The DSAC objective of the RGB-D path, E_h~p [ loss(refine(h), gt) ],
    every hypothesis refined; gt_poses [B, 4, 4] cam-to-world. Returns the
    mean over the batch."""
    device = scene_coords.device
    with solver_precision(device):
        obj, eye, vmask = _flatten(scene_coords, camera_coords, valid_mask)
        B, N = obj.shape[:2]
        R0, t0, hyp_valid, scores = _hypotheses(
            obj, eye, vmask, cfg, _draw(idx, generator, B, N, cfg, device))
        probs = selection_probs(scores, hyp_valid)
        Rr, tr = _kabsch_refine(R0, t0, obj, eye, vmask, cfg)
        losses = pose_loss(invert_se3(_w2c(Rr, tr)), gt_poses[:, None], loss_cfg)
        return (probs * torch.where(hyp_valid, losses, 0.0)).sum(-1).mean()
