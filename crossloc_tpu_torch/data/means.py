"""Per-scene label means for the decoder's output offset (counterpart of
`crossloc_tpu/data/means.py`).

The reference's constants for the urbanscape / naturescape scenes (normal
means stored as pre-sigmoid logits of the azimuth/elevation angles), and a
mean computed over a dataset for other scenes.
"""
from __future__ import annotations

import numpy as np

_COORD_MEANS = {
    "naturescape": [-455.934, 417.50, 520.31],
    "urbanscape": [-29.34, 184.17, 91.96],
}
_DEPTH_MEANS = {"naturescape": [241.47], "urbanscape": [136.24]}
_NORMAL_ANGLE_MEANS = {  # azimuth/elevation in radians
    "naturescape": [-0.7943, -0.9986],
    "urbanscape": [-1.0454, -0.9858],
}


def _inverse_sigmoid(x):
    return -np.log(1.0 / (np.asarray(x) + 1e-7) - 1.0)


def _angles_to_logits(angles):
    """radians -> raw pre-sigmoid activation."""
    s = (np.asarray(angles) / np.pi + 1.0) / 2.0
    return _inverse_sigmoid(s).astype(np.float32)


def xyz2ae(xyz):
    """Unit direction -> (azimuth, elevation) radians, [..., 3] -> [..., 2]."""
    xyz = np.asarray(xyz, np.float32)
    azimuth = np.arctan2(xyz[..., 1], xyz[..., 0])
    elevation = np.arctan2(xyz[..., 2], np.linalg.norm(xyz[..., 0:2], axis=-1))
    return np.stack([azimuth, elevation], axis=-1)


def get_label_mean(scene: str, task: str, dataset=None, nodata_value: float = -1.0):
    """Mean offsets per task; `dataset` is only read for scenes outside the
    two families (iterated once)."""
    scene_l = scene.lower()
    family = None
    for fam in ("naturescape", "urbanscape"):
        if fam in scene_l:
            family = fam
            break

    if task == "coord":
        if family:
            return np.asarray(_COORD_MEANS[family], np.float32)
        return _computed_mean(dataset, "coord", 3, nodata_value)
    if task == "depth":
        if family:
            return np.asarray(_DEPTH_MEANS[family], np.float32)
        return _computed_mean(dataset, "depth", 1, nodata_value)
    if task == "normal":
        if family:
            return _angles_to_logits(_NORMAL_ANGLE_MEANS[family])
        ae = _computed_mean(dataset, "normal", 2, nodata_value)
        return np.arctanh(np.clip(ae / np.pi, -0.999999, 0.999999)).astype(np.float32)
    if task == "semantics":
        return np.zeros(6, np.float32)
    raise NotImplementedError(f"task={task}")


def _computed_mean(dataset, task: str, channels: int, nodata_value: float):
    if dataset is None:
        raise ValueError(f"unknown scene requires a dataset to compute the {task} mean")
    total = np.zeros(channels, np.float64)
    count = 0
    for i in range(len(dataset)):
        item = dataset[i]
        if task == "coord":
            lab = item.coord.reshape(-1, 3)
        elif task == "depth":
            lab = item.depth.reshape(-1, 1)
        else:
            xyz = item.normal.reshape(-1, 3)
            valid = np.all(xyz != nodata_value, axis=-1)
            total += xyz2ae(xyz[valid]).sum(axis=0)
            count += valid.sum()
            continue
        valid = np.all(lab != nodata_value, axis=-1)
        total += lab[valid].sum(axis=0)
        count += valid.sum()
    return (total / max(count, 1)).astype(np.float32)
