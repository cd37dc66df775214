"""Nodata marker, valid-label mask and the loss reduction (counterpart of
`crossloc_tpu/losses/common.py`)."""
from __future__ import annotations


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
