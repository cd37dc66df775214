"""Nodata marker and valid-label mask (counterpart of
`crossloc_tpu/losses/common.py`); the losses themselves come with the
training slice."""
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
