"""Nodata marker, valid-label mask, the loss reduction and the
azimuth/elevation parametrisation of normals (counterpart of
`crossloc_tpu/losses/common.py`)."""
from __future__ import annotations

import math

import torch


def get_nodata_value(scene_name: str) -> float:
    """Nodata marker by scene family."""
    low = scene_name.lower()
    if "urbanscape" in low or "naturescape" in low:
        return -1.0
    raise NotImplementedError(f"unknown scene family: {scene_name}")


def valid_label_mask(labels, nodata_value):
    """[..., C] -> [...] True where no channel equals the nodata marker."""
    return (labels != nodata_value).all(-1)


def reduce_loss(per_image_loss, num_pixels_instance, reduction):
    """'mean' -> scalar mean over every pixel of the batch; None -> [B]
    per-instance means (the reference's reduction contract)."""
    if reduction is None:
        return per_image_loss / num_pixels_instance
    if reduction == "mean":
        return per_image_loss.sum() / (per_image_loss.shape[0] * num_pixels_instance)
    raise NotImplementedError(f"reduction={reduction}")


def xyz2ae(xyz):
    """Unit direction -> (azimuth, elevation) radians, [..., 3] -> [..., 2]:
    azimuth = atan2(y, x), elevation = atan2(z, ||xy||)."""
    azimuth = torch.atan2(xyz[..., 1], xyz[..., 0])
    elevation = torch.atan2(xyz[..., 2], torch.linalg.vector_norm(xyz[..., 0:2], dim=-1))
    return torch.stack([azimuth, elevation], dim=-1)


def ae2xyz(ae):
    """(azimuth, elevation) radians -> unit direction, [..., 2] -> [..., 3]."""
    az, el = ae[..., 0], ae[..., 1]
    cos_el = torch.cos(el)
    xyz = torch.stack([torch.cos(az) * cos_el, torch.sin(az) * cos_el, torch.sin(el)], dim=-1)
    return xyz / torch.clamp(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True), min=1e-12)


def logits_to_radian(logits):
    """Raw activation -> angle in [-pi, pi] through a clamped sigmoid."""
    r = torch.clamp(torch.sigmoid(logits), 1e-7, 1.0 - 1e-7)
    return (r * 2.0 - 1.0) * math.pi
