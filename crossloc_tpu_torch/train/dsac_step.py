"""End-to-end DSAC training step: the expected pose loss through the solver
(counterpart of `crossloc_tpu/train/dsac_step.py`).

The network's scene coordinates feed the differentiable RANSAC solver, and
the DSAC expectation of the pose loss, E_h~p [ loss(refine(h), gt) ],
backpropagates into the network through the scores, the refinement and
P3P's implicit backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ransac import PoseLossConfig, RansacConfig, expected_pose_loss
from ..ransac.solver import solver_precision
from .step import TrainBatch, TrainState, apply_gradients


def make_dsac_train_step(model, ransac_cfg: Optional[RansacConfig] = None,
                         loss_cfg: Optional[PoseLossConfig] = None, subsample: int = 8):
    """step(state, batch, idx=None, generator=None) -> metrics, one update in
    place minimising the expected pose loss. The default solver config is
    the JAX package's training one (16 hypotheses, 8 retry rounds, 2
    refinement steps); `subsample` must match the model's output grid (1
    with --fullsize). Hypothesis draws: `idx` or `generator`, as in
    `ransac.solve_batch`.

    Metrics, 0-d tensors: "loss", "grad_norm" (after the sanitising below),
    and the diagnostics "valid_share" (share of valid hypotheses) and
    "nonfinite" (gradient entries that were non-finite and set to 0)."""
    if ransac_cfg is not None and ransac_cfg.subsample != subsample:
        # a grid that disagrees with the model's output would project
        # through the wrong pixel centres
        raise ValueError(
            f"ransac_cfg.subsample={ransac_cfg.subsample} conflicts with "
            f"subsample={subsample}; set the grid on the config you pass")
    cfg = ransac_cfg or RansacConfig(hypotheses=16, sample_rounds=8, train_refine_steps=2,
                                     subsample=subsample)
    lcfg = loss_cfg or PoseLossConfig()
    ntc = model.num_task_channel

    def train_step(state: TrainState, batch: TrainBatch, idx=None,
                   generator: Optional[torch.Generator] = None) -> dict:
        params = [p for p in state.model.parameters() if p.requires_grad]
        state.optimizer.adam.zero_grad(set_to_none=True)
        coords = state.model(batch.images)[..., :ntc]
        coords = coords.to(torch.promote_types(coords.dtype, torch.float32))  # no bf16 solve
        img_h, img_w = batch.images.shape[1], batch.images.shape[2]
        loss, aux = expected_pose_loss(coords, batch.poses, batch.focal.reshape(-1)[0],
                                       (img_h, img_w), cfg, lcfg, pp_shift=batch.pp_shift,
                                       idx=idx, generator=generator)
        with solver_precision(coords.device):  # the solver's backward in float32 too
            loss.backward()
        # the reference clamps unstable solver Jacobians; a non-finite
        # gradient entry is set to 0 before Adam
        nonfinite = torch.zeros((), dtype=torch.int64, device=coords.device)
        for p in params:
            if p.grad is not None:
                bad = ~torch.isfinite(p.grad)
                nonfinite += bad.sum()
                p.grad.masked_fill_(bad, 0.0)
        grad_norm = apply_gradients(state, params)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "nonfinite": nonfinite,
                "valid_share": aux["hyp_valid"].float().mean()}

    return train_step
