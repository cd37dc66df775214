"""Train-time augmentation on the training device, in plain PyTorch
(counterpart of `crossloc_tpu/data/augment.py`).

Per image: ColorJitter brightness and contrast, then the dataset
normalisation. Per batch: ONE scale, ONE in-plane angle and ONE crop offset,
applied through an inverse affine map onto the fixed canvas: bilinear with
clamped borders for images, nearest for labels, fill -1 outside (semantics
labels: on the image's own map, fill 0). The focal
scales, the pose is post-multiplied by the in-plane rotation, and the crop
offset's principal-point shift is returned for the loss's camera.

Random draws are arguments (`AugmentDraws`): `draw_augmentation` makes them
from a `torch.Generator`, and a test can hand in the JAX package's own draws.
Sampling is in float32 throughout (the JAX package's bf16 corner gather and
batch-inside gather layout are TPU options and have no counterpart here).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import span
from .pipeline import to_grayscale

# dataset normalisation statistics (the reference's urbanscape values)
RGB_MEAN = np.array([0.4245, 0.4375, 0.3836], np.float32)
RGB_STD = np.array([0.1823, 0.1701, 0.1854], np.float32)
GRAY_MEAN = np.array([0.4308], np.float32)
GRAY_STD = np.array([0.1724], np.float32)


class AugmentConfig(NamedTuple):
    aug_rotation: float = 30.0  # max |angle| in degrees
    aug_scale_min: float = 2.0 / 3.0
    aug_scale_max: float = 3.0 / 2.0
    aug_brightness: float = 0.1
    aug_contrast: float = 0.1
    aug_translation: bool = True  # random zoom-in crop window
    grayscale: bool = False
    nodata_value: float = -1.0
    subsample: int = 8


class AugmentDraws(NamedTuple):
    """The random numbers of one batch's augmentation."""

    scale: torch.Tensor  # [] in [aug_scale_min, aug_scale_max]
    angle: torch.Tensor  # [] degrees in [-aug_rotation, aug_rotation]
    translation: torch.Tensor  # [2] in [-1, 1]: crop offset as a share of its range
    brightness: torch.Tensor  # [B] factors in [1 - b, 1 + b]
    contrast: torch.Tensor  # [B] factors in [1 - c, 1 + c]

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(t.to(device) for t in self))


def draw_augmentation(generator: torch.Generator, batch: int,
                      cfg: AugmentConfig = AugmentConfig()) -> AugmentDraws:
    """Uniform draws for one batch from `generator` (on the generator's device)."""

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return lo + (hi - lo) * u

    return AugmentDraws(
        scale=uniform((), cfg.aug_scale_min, cfg.aug_scale_max),
        angle=uniform((), -cfg.aug_rotation, cfg.aug_rotation),
        translation=uniform((2,), -1.0, 1.0),
        brightness=uniform((batch,), 1 - cfg.aug_brightness, 1 + cfg.aug_brightness),
        contrast=uniform((batch,), 1 - cfg.aug_contrast, 1 + cfg.aug_contrast),
    )


def normalize_images(images, grayscale: bool = False):
    """Dataset normalisation of [0, 1] images (grayscale: luma first)."""
    dev = images.device
    if grayscale:
        if images.shape[-1] == 3:
            images = to_grayscale(images)
        return (images - torch.from_numpy(GRAY_MEAN).to(dev)) / torch.from_numpy(GRAY_STD).to(dev)
    return (images - torch.from_numpy(RGB_MEAN).to(dev)) / torch.from_numpy(RGB_STD).to(dev)


def color_jitter(images, brightness, contrast):
    """Per-image brightness then contrast factors [B] on raw [0, 1] images
    (torchvision ColorJitter semantics)."""
    b = brightness.reshape(-1, 1, 1, 1)
    c = contrast.reshape(-1, 1, 1, 1)
    images = torch.clamp(images * b, 0.0, 1.0)
    gray_mean = to_grayscale(images).mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((images - gray_mean) * c + gray_mean, 0.0, 1.0)


def _inverse_affine_coords(out_h, out_w, in_h, in_w, scale, angle_rad, tx, ty):
    """Input-pixel coordinates of each output pixel:
    in = C_in + R(theta) (out - C_out) / scale + t, t the crop offset in
    input pixels. Returns (rx, ry), each [out_h, out_w]."""
    dev = scale.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev) - (out_h - 1) / 2.0
    xs = torch.arange(out_w, dtype=torch.float32, device=dev) - (out_w - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    cos, sin = torch.cos(angle_rad), torch.sin(angle_rad)
    rx = (cos * gx - sin * gy) / scale + (in_w - 1) / 2.0 + tx
    ry = (sin * gx + cos * gy) / scale + (in_h - 1) / 2.0 + ty
    return rx, ry


def pp_shift_for_translation(scale, angle_rad, tx, ty):
    """Principal-point shift [2] of a crop offset (tx, ty) in input pixels:
    out = C + s R(-theta)(in - C - t) moves every projection by -s R(-theta) t."""
    cos, sin = torch.cos(angle_rad), torch.sin(angle_rad)
    dx = -scale * (cos * tx + sin * ty)
    dy = -scale * (-sin * tx + cos * ty)
    return torch.stack([dx, dy])


def _bilinear_sample(images, rx, ry, fill):
    """images [B, H, W, C] at the shared warp (rx, ry) [h, w]: clamped-border
    bilinear (the corner window's start clipped to [0, dim - 2], its weight
    saturated), the four corner terms summed in one order; fill outside."""
    B, H, W, C = images.shape
    h, w = rx.shape
    xs = torch.clamp(torch.floor(rx).long(), 0, W - 2)
    ys = torch.clamp(torch.floor(ry).long(), 0, H - 2)
    wx = torch.clamp(rx - xs.float(), 0.0, 1.0).reshape(1, h, w, 1)
    wy = torch.clamp(ry - ys.float(), 0.0, 1.0).reshape(1, h, w, 1)
    v00 = images[:, ys, xs]
    v01 = images[:, ys, xs + 1]
    v10 = images[:, ys + 1, xs]
    v11 = images[:, ys + 1, xs + 1]
    out = ((1 - wy) * (1 - wx)) * v00 + ((1 - wy) * wx) * v01 + (wy * (1 - wx)) * v10 \
        + (wy * wx) * v11
    inside = ((rx >= 0) & (rx <= W - 1) & (ry >= 0) & (ry <= H - 1))[None, :, :, None]
    return torch.where(inside, out, torch.full_like(out, fill))


def _nearest_sample(labels, rx, ry, fill):
    """labels [B, H, W, C] nearest-neighbour at (rx, ry) [h, w]; fill outside."""
    H, W = labels.shape[1], labels.shape[2]
    xn = torch.round(rx).long()
    yn = torch.round(ry).long()
    out = labels[:, torch.clamp(yn, 0, H - 1), torch.clamp(xn, 0, W - 1)]
    inside = ((xn >= 0) & (xn <= W - 1) & (yn >= 0) & (yn <= H - 1))[None, :, :, None]
    return torch.where(inside, out, torch.full_like(out, fill))


def rotation_z_pose(angle_rad):
    """In-plane rotation [4, 4] appended to the cam-to-world pose."""
    cos, sin = torch.cos(angle_rad), torch.sin(angle_rad)
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([
        torch.stack([cos, -sin, zero, zero]), torch.stack([sin, cos, zero, zero]),
        torch.stack([zero, zero, one, zero]), torch.stack([zero, zero, zero, one])])


def augment_batch(images, labels, poses, focal, draws: AugmentDraws,
                  cfg: AugmentConfig = AugmentConfig(), semantics: bool = False):
    """images [B, H, W, 3] raw [0, 1]; labels [B, h, w, C] on the subsampled
    grid, or with `semantics` [B, H, W, 1] class ids of any dtype on the
    image canvas (filled with 0 outside, not nodata); poses [B, 4, 4];
    focal [] or [B]; `draws` on the images' device.
    Returns (normalised images, labels, poses, focal, pp_shift [2])."""
    with span("augment"):
        B, H, W, _ = images.shape
        scale = draws.scale
        angle_rad = draws.angle * (math.pi / 180.0)
        if cfg.aug_translation:
            # a zoom-in shows a 1/scale window; its offset is drawn over the
            # feasible range (zero whenever scale <= 1)
            slack = torch.clamp(1.0 - 1.0 / scale, min=0.0)
            lim = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], device=scale.device) * slack
            tx, ty = draws.translation * lim
        else:
            tx = ty = torch.zeros((), device=scale.device)

        images = color_jitter(images, draws.brightness, draws.contrast)
        images = normalize_images(images, cfg.grayscale)
        rx, ry = _inverse_affine_coords(H, W, H, W, scale, angle_rad, tx, ty)
        images = _bilinear_sample(images, rx, ry, cfg.nodata_value)

        if semantics:
            labels = _nearest_sample(labels, rx, ry, 0)
        else:
            h, w = labels.shape[1], labels.shape[2]
            ss = cfg.subsample  # label cells: the crop offset in cells is t / subsample
            lrx, lry = _inverse_affine_coords(h, w, h, w, scale, angle_rad, tx / ss, ty / ss)
            labels = _nearest_sample(labels, lrx, lry, cfg.nodata_value)

        rot = rotation_z_pose(angle_rad).to(poses.dtype)
        poses = (poses[..., :, :, None] * rot[None, None, :, :]).sum(-2)  # f32, no TF32
        focal = focal * scale
        pp_shift = pp_shift_for_translation(scale, angle_rad, tx, ty)
        return images, labels, poses, focal, pp_shift
