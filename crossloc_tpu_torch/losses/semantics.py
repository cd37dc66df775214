"""Semantic segmentation loss over 6 classes at full size (counterpart of
`crossloc_tpu/losses/semantics.py`): log-softmax NLL, and pixel accuracy as
the valid rate. There is no uncertainty head: passing one raises.

Channels-last: semantic_logits [B, H, W, 6], gt_labels [B, H, W] or
[B, H, W, 1] class ids of any dtype (the dataset's ids are already trimmed,
`data.trim_semantic_label`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..data.dataset import NUM_SEMANTIC_CLASSES as NUM_CLASSES
from .common import reduce_loss


def semantics_loss(semantic_logits, gt_labels, uncertainty_map=None,
                   reduction: Optional[str] = "mean"):
    """(loss, valid_rate) of the semantics task."""
    if uncertainty_map is not None:
        raise NotImplementedError("semantics has no uncertainty head")
    if gt_labels.dim() == 4:
        gt_labels = gt_labels[..., 0]
    B, H, W, C = semantic_logits.shape
    N = H * W
    labels = gt_labels.long().reshape(B, N)
    logits = semantic_logits.reshape(B, N, C).float()

    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, labels[..., None])[..., 0]  # [B, N]

    pred = torch.argmax(log_probs, dim=-1)
    valid_rate = (pred == labels).float().mean()

    loss = reduce_loss(nll.sum(dim=1), N, reduction)
    return loss, valid_rate


__all__ = ["NUM_CLASSES", "semantics_loss"]
