"""Pose, scene-coordinate, depth, normal and semantics metrics (counterpart
of `crossloc_tpu/eval/metrics.py`)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..geometry import rotation_angle_deg
from ..losses import ae2xyz, logits_to_radian, valid_label_mask


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).cpu()


def pose_err(gt_pose, est_pose) -> Tuple[float, float]:
    """(translation m, rotation deg) between 4x4 cam-to-world transforms."""
    gt, est = _f32(gt_pose), _f32(est_pose)
    t = float(np.linalg.norm(gt[0:3, 3].numpy() - est[0:3, 3].numpy()))
    r = float(rotation_angle_deg(est[0:3, 0:3], gt[0:3, 0:3]))
    return t, r


def coord_errors(scene_coords, gt_coords, nodata_value=-1.0) -> np.ndarray:
    """Per-pixel ||pred - gt|| over valid-gt pixels, flattened.
    scene_coords / gt_coords: [B, h, w, 3]."""
    pred = _f32(scene_coords).reshape(-1, 3)
    gt = _f32(gt_coords).reshape(-1, 3)
    err = torch.linalg.norm(pred - gt, dim=-1)
    return err[valid_label_mask(gt, nodata_value)].numpy()


def depth_eval(depth, gt_depth, nodata_value=-1.0) -> Tuple[float, float]:
    """(abs_rel, rms) over the valid pixels of a batch; depth / gt_depth
    [B, h, w, 1]."""
    B = depth.shape[0]
    pred = _f32(depth).reshape(B, -1)
    gt = _f32(gt_depth).reshape(B, -1)
    err = torch.abs(pred - gt)
    mask = valid_label_mask(gt[..., None], nodata_value).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    abs_rel = (err * mask / torch.where(gt == 0, torch.full_like(gt, 1e-9), gt)).sum() / denom
    rms = torch.sqrt((err * mask).square().sum() / denom)
    return float(abs_rel), float(rms)


def normal_eval(normal_logits, gt_normals, nodata_value=-1.0) -> float:
    """Mean angular error in degrees over the valid pixels of a batch;
    normal_logits [B, h, w, 2], gt_normals [B, h, w, 3] (unit, world)."""
    B = normal_logits.shape[0]
    logits = _f32(normal_logits).reshape(B, -1, 2)
    gt = _f32(gt_normals).reshape(B, -1, 3)
    pred_xyz = ae2xyz(logits_to_radian(logits))
    cos = (pred_xyz * gt).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(pred_xyz, dim=-1) * torch.linalg.vector_norm(gt, dim=-1),
        min=1e-12)
    ang = torch.rad2deg(torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7)))
    mask = valid_label_mask(gt, nodata_value).float()
    return float((ang * mask).sum() / torch.clamp(mask.sum(), min=1.0))


class SemanticsEvaluator:
    """Confusion-matrix segmentation metrics; the matrix counts in integers."""

    def __init__(self, num_class: int = 6):
        self.num_class = num_class
        self.reset()

    def reset(self):
        self.confusion_matrix = np.zeros((self.num_class, self.num_class), np.int64)

    def add_batch(self, gt_image: np.ndarray, pred_image: np.ndarray):
        if gt_image.shape != pred_image.shape:
            raise ValueError("shape mismatch")
        mask = (gt_image >= 0) & (gt_image < self.num_class)
        label = self.num_class * gt_image[mask].astype(np.int64) + pred_image[mask]
        count = np.bincount(label, minlength=self.num_class**2)
        self.confusion_matrix += count.reshape(self.num_class, self.num_class)

    def _iou(self) -> np.ndarray:
        """Per class; NaN for a class in neither the truth nor the prediction."""
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))

    def pixel_accuracy(self) -> float:
        return np.diag(self.confusion_matrix).sum() / self.confusion_matrix.sum()

    def pixel_accuracy_class(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(self.confusion_matrix) / self.confusion_matrix.sum(axis=1)
        return float(np.nanmean(acc))

    def mean_iou(self) -> float:
        return float(np.nanmean(self._iou()))

    def fw_iou(self) -> float:
        freq = self.confusion_matrix.sum(axis=1) / self.confusion_matrix.sum()
        iu = self._iou()
        return float((freq[freq > 0] * iu[freq > 0]).sum())


def semantic_scores(pred: np.ndarray, gt_label, num_class: int = 6
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per image (mIoU, FwIoU, pixel accuracy) of predicted class ids
    [B, H, W] against gt_label [B, H, W] or [B, H, W, 1]."""
    if gt_label.ndim == 4:
        gt_label = gt_label[..., 0]
    gt = np.asarray(gt_label).astype(np.int64)
    ev = SemanticsEvaluator(num_class)
    miou, fwiou, acc = [], [], []
    for g, p in zip(gt, pred):
        ev.reset()
        ev.add_batch(g, p)
        miou.append(ev.mean_iou())
        fwiou.append(ev.fw_iou())
        acc.append(ev.pixel_accuracy())
    return np.asarray(miou), np.asarray(fwiou), np.asarray(acc)


def semantic_eval(semantic_logits, gt_label) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                                       np.ndarray]:
    """Per image (predicted classes, mIoU, FwIoU, pixel accuracy);
    semantic_logits [B, H, W, C] on any device (the argmax runs there, the
    first maximum wins), gt_label [B, H, W] or [B, H, W, 1]."""
    pred = torch.argmax(torch.as_tensor(semantic_logits), dim=-1).cpu().numpy()
    return (pred, *semantic_scores(pred, gt_label, semantic_logits.shape[-1]))
