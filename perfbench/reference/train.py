"""The training side of CrossLoc's coord task in plain PyTorch, float32:
the batch augmentation (given its random draws), the scene-coordinate loss
with the MLE uncertainty, and Adam with the epoch-milestone LR.

Augmentation (per image: brightness, contrast, normalisation; per batch:
one scale, one in-plane angle, one crop offset through an inverse affine
map, bilinear with clamped borders for images and nearest for labels, -1
outside; focal times scale, pose times the in-plane rotation, principal
point shifted by the crop). Loss: reprojection error (L1 up to the soft
clamp, square root above it, valid where the prediction is in front of the
camera, within the hard clamp and within the init tolerance of a valid
label) plus 3 log(sigma) + e^2 / (2 sigma^2) on the valid labels, the mean
over every cell of the batch.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

RGB_MEAN = (0.4245, 0.4375, 0.3836)
RGB_STD = (0.1823, 0.1701, 0.1854)


def luma(images):
    w = torch.tensor([0.299, 0.587, 0.114], dtype=images.dtype, device=images.device)
    return (images * w).sum(-1, keepdim=True)


def _affine(out_h, out_w, scale, angle, tx, ty):
    dev = scale.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev) - (out_h - 1) / 2.0
    xs = torch.arange(out_w, dtype=torch.float32, device=dev) - (out_w - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    c, s = torch.cos(angle), torch.sin(angle)
    rx = (c * gx - s * gy) / scale + (out_w - 1) / 2.0 + tx
    ry = (s * gx + c * gy) / scale + (out_h - 1) / 2.0 + ty
    return rx, ry


def _bilinear(img, rx, ry, fill):
    B, H, W, C = img.shape
    h, w = rx.shape
    x0 = torch.clamp(torch.floor(rx).long(), 0, W - 2)
    y0 = torch.clamp(torch.floor(ry).long(), 0, H - 2)
    wx = torch.clamp(rx - x0.float(), 0.0, 1.0).reshape(1, h, w, 1)
    wy = torch.clamp(ry - y0.float(), 0.0, 1.0).reshape(1, h, w, 1)
    out = ((1 - wy) * (1 - wx)) * img[:, y0, x0] + ((1 - wy) * wx) * img[:, y0, x0 + 1] \
        + (wy * (1 - wx)) * img[:, y0 + 1, x0] + (wy * wx) * img[:, y0 + 1, x0 + 1]
    inside = ((rx >= 0) & (rx <= W - 1) & (ry >= 0) & (ry <= H - 1))[None, :, :, None]
    return torch.where(inside, out, torch.full_like(out, fill))


def _nearest(lab, rx, ry, fill):
    H, W = lab.shape[1], lab.shape[2]
    xn, yn = torch.round(rx).long(), torch.round(ry).long()
    out = lab[:, torch.clamp(yn, 0, H - 1), torch.clamp(xn, 0, W - 1)]
    inside = ((xn >= 0) & (xn <= W - 1) & (yn >= 0) & (yn <= H - 1))[None, :, :, None]
    return torch.where(inside, out, torch.full_like(out, fill))


def augment(images, labels, poses, focal, draws: Dict[str, torch.Tensor], subsample: int,
            nodata: float = -1.0):
    """images [B, H, W, 3] in [0, 1], labels [B, h, w, 3], poses [B, 4, 4],
    focal []; draws: scale [], angle [] (degrees), translation [2] in
    [-1, 1], brightness [B], contrast [B]. Returns (images, labels, poses,
    focal, pp_shift [2])."""
    B, H, W, _ = images.shape
    scale = draws["scale"]
    angle = draws["angle"] * (math.pi / 180.0)
    slack = torch.clamp(1.0 - 1.0 / scale, min=0.0)
    lim = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], device=scale.device) * slack
    tx, ty = draws["translation"] * lim

    x = torch.clamp(images * draws["brightness"].reshape(-1, 1, 1, 1), 0.0, 1.0)
    m = luma(x).mean(dim=(1, 2, 3), keepdim=True)
    x = torch.clamp((x - m) * draws["contrast"].reshape(-1, 1, 1, 1) + m, 0.0, 1.0)
    mean = torch.tensor(RGB_MEAN, device=x.device)
    std = torch.tensor(RGB_STD, device=x.device)
    x = (x - mean) / std
    rx, ry = _affine(H, W, scale, angle, tx, ty)
    x = _bilinear(x, rx, ry, nodata)

    h, w = labels.shape[1], labels.shape[2]
    lrx, lry = _affine(h, w, scale, angle, tx / subsample, ty / subsample)
    labels = _nearest(labels, lrx, lry, nodata)

    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, z, z]), torch.stack([s, c, z, z]),
                       torch.stack([z, z, o, z]), torch.stack([z, z, z, o])])
    poses = (poses[..., :, :, None] * rot[None, None, :, :]).sum(-2)
    pp_shift = torch.stack([-scale * (c * tx + s * ty), -scale * (-s * tx + c * ty)])
    return x, labels, poses, focal * scale, pp_shift


def coord_loss(pred, gt, poses, focal, pp_shift, cfg: dict, subsample: int):
    """pred [B, h, w, 4] (coords + sigma), gt [B, h, w, 3], poses [B, 4, 4]
    cam-to-world, focal [], pp_shift [2]; `cfg` the configuration's loss
    settings. Returns the batch's mean loss."""
    B, h, w, _ = pred.shape
    n = h * w
    H, W = h * subsample, w * subsample
    coords = pred[..., :3].reshape(B, n, 3)
    sigma = torch.clamp(pred[..., 3].reshape(B, n), min=1e-7)
    gt = gt.reshape(B, n, 3)
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    Rt = R.transpose(1, 2)

    def to_cam(p):  # world -> camera, elementwise (no matmul precision involved)
        q = p - t[:, None, :]
        return (Rt[:, None, :, :] * q[:, :, None, :]).sum(-1)

    cam_pred = to_cam(coords)
    cam_gt = to_cam(gt)
    reg = torch.linalg.vector_norm(cam_pred - cam_gt, dim=-1)

    xs = torch.arange(w, device=pred.device, dtype=torch.float32) * subsample + subsample / 2.0
    ys = torch.arange(h, device=pred.device, dtype=torch.float32) * subsample + subsample / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(n, 2)
    cx = W / 2.0 + pp_shift[0]
    cy = H / 2.0 + pp_shift[1]
    # K p, then its first two rows over the depth clamped at min_depth
    z = torch.clamp(cam_pred[..., 2], min=cfg["min_depth"])
    px = torch.stack([(focal * cam_pred[..., 0] + cx * cam_pred[..., 2]) / z,
                      (focal * cam_pred[..., 1] + cy * cam_pred[..., 2]) / z], -1)
    repro = torch.clamp(torch.linalg.vector_norm(px - grid, dim=-1), min=1e-7)

    valid_gt = (gt != cfg["nodata"]).all(-1)
    valid = ~((cam_pred[..., 2] < cfg["min_depth"]) | (repro > cfg["hard_clamp"])
              | ((reg > cfg["init_tolerance"]) & valid_gt))
    num_valid = valid.sum()
    masked = repro * valid
    soft = cfg["soft_clamp"]
    l1 = torch.clamp(masked * (masked <= soft), min=1e-7)
    lsq = torch.clamp(torch.sqrt(soft * torch.clamp(masked * (masked > soft), min=1e-7) + 1e-7),
                      min=1e-7)
    reproj = torch.where(num_valid > 0, l1 + lsq, torch.zeros_like(l1))
    e2 = torch.clamp(reg.square(), min=1e-7)
    unc = 3.0 * torch.log(sigma) + e2 / (2.0 * torch.clamp(sigma.square(), min=1e-7))
    per_cell = unc * valid_gt.float() + reproj
    return per_cell.sum() / (B * n)


def lr_at(step: int, opt: dict, steps_per_epoch: int) -> float:
    if not opt["lr_scheduling"]:
        return opt["lr"]
    passed = sum(step >= m * steps_per_epoch for m in opt["milestones_epochs"])
    return opt["lr"] * opt["gamma"] ** passed


class Adam:
    """Adam with bias correction, eps added to the corrected root."""

    def __init__(self, params: Sequence[torch.Tensor], opt: dict):
        self.params: List[torch.Tensor] = list(params)
        self.b1, self.b2 = opt["betas"]
        self.eps = opt["eps"]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))
