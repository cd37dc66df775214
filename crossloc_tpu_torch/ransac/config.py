"""RANSAC solver and pose-loss configuration (counterpart of
`crossloc_tpu/ransac/config.py`).

Defaults mirror the reference evaluation setup: 64 hypotheses, inlier
tau = 10 px, alpha = 100, max pixel error = 100, subsample 8. The C++
plugin's unbounded retry and convergence loops become `sample_rounds`
masked retry rounds and `refine_steps` fixed refinement iterations with
monotone inlier-count acceptance.
"""
from __future__ import annotations

from typing import NamedTuple


class RansacConfig(NamedTuple):
    hypotheses: int = 64  # RANSAC pool size
    inlier_threshold: float = 10.0  # px, tau
    inlier_alpha: float = 100.0  # soft inlier count scale
    max_pixel_error: float = 100.0  # reprojection clamp
    subsample: int = 8  # prediction grid stride
    sample_rounds: int = 16  # masked retry rounds per hypothesis
    refine_steps: int = 8  # outer refine iterations (inlier recompute)
    gn_iters: int = 3  # Gauss-Newton steps per refine iteration
    gn_damping: float = 1e-4  # Marquardt damping (scales diag(J^T J))
    polish_iters: int = 2  # unconditional final GN polish rounds
    train_refine_steps: int = 4  # refinement steps of each hypothesis in the DSAC loss
    # eval-time winner: "soft" = argmax of the softmax over soft inlier
    # scores; "hard" = argmax of the hard inlier count
    eval_selection: str = "soft"
    # kept for config compatibility with the JAX package (loop unrolling of
    # its compiled program); the port's loops are eager Python loops
    unroll: bool = True
    # refine the K best hypotheses and select after refinement; K=1 is the
    # reference semantics
    refine_top_k: int = 1


class PoseLossConfig(NamedTuple):
    """Pose loss weights (the reference plugin's defaults)."""

    w_rot: float = 1.0  # per degree
    w_trans: float = 1.0  # per meter
    soft_clamp: float = 100.0  # sqrt clamp above this
    max_loss: float = 1.0e7  # hard clamp
