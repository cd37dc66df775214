"""End-to-end DSAC training step: the expected pose loss through the solver
(counterpart of `crossloc_tpu/train/dsac_step.py`).

The network's scene coordinates feed the differentiable RANSAC solver, and
the DSAC expectation of the pose loss, E_h~p [ loss(refine(h), gt) ],
backpropagates into the network through the scores, the refinement and
P3P's implicit backward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ransac import PoseLossConfig, RansacConfig, expected_pose_loss
from ..ransac.solver import solver_precision
from .step import TrainBatch, TrainState, apply_gradients, param_sum, update_params


def make_dsac_train_step(model, ransac_cfg: Optional[RansacConfig] = None,
                         loss_cfg: Optional[PoseLossConfig] = None, subsample: int = 8):
    """step(state, batch, idx=None, generator=None, global_batch=None) ->
    metrics, one update in place minimising the expected pose loss. The
    default solver config is the JAX package's training one (16 hypotheses,
    8 retry rounds, 2 refinement steps); `subsample` must match the model's
    output grid (1 with --fullsize). Hypothesis draws: `idx` or `generator`,
    as in `ransac.solve_batch`; with `global_batch` (offset, size) the
    generator draws for the global batch and this rank takes rows [offset,
    offset + B). Under data parallelism (`state.parallel`) the gradients,
    the non-finite count, the loss and the valid share are the global
    batch's.

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

    def forward_backward(state: TrainState, batch: TrainBatch, idx, generator, global_batch):
        coords = state.model(batch.images)[..., :ntc]
        coords = coords.to(torch.promote_types(coords.dtype, torch.float32))  # no bf16 solve
        if idx is None and global_batch is not None:
            # the global batch's draws, this rank's rows: the draws of an
            # image do not depend on how the batch is split over ranks
            offset, total = global_batch
            n_cells = coords.shape[1] * coords.shape[2]
            idx = torch.randint(0, n_cells, (total, cfg.hypotheses * cfg.sample_rounds, 4),
                                generator=generator, device=coords.device)
            idx = idx[offset: offset + coords.shape[0]]
        img_h, img_w = batch.images.shape[1], batch.images.shape[2]
        loss, aux = expected_pose_loss(coords, batch.poses, batch.focal.reshape(-1)[0],
                                       (img_h, img_w), cfg, lcfg, pp_shift=batch.pp_shift,
                                       idx=idx, generator=generator)
        with solver_precision(coords.device):  # the solver's backward in float32 too
            loss.backward()
        return loss, aux

    def train_step(state: TrainState, batch: TrainBatch, idx=None,
                   generator: Optional[torch.Generator] = None,
                   global_batch: Optional[Tuple[int, int]] = None) -> dict:
        dp = state.parallel
        if dp is not None and dp.mesh.spatial > 1:
            raise ValueError("the DSAC step solves on whole images; a spatial mesh splits their "
                             "rows over ranks")
        params = update_params(state)
        state.optimizer.adam.zero_grad(set_to_none=True)
        if dp is None:
            loss, aux = forward_backward(state, batch, idx, generator, global_batch)
        else:
            with dp.materialized():
                loss, aux = forward_backward(state, batch, idx, generator, global_batch)
                dp.reduce_gradients()
        # the reference clamps unstable solver Jacobians; a non-finite
        # gradient entry is set to 0 before Adam
        counts = []
        for p in params:
            if p.grad is not None:
                bad = ~torch.isfinite(p.grad)
                counts.append(bad.sum())
                p.grad.masked_fill_(bad, 0.0)
        nonfinite = param_sum(state, counts).to(torch.int64)
        grad_norm = apply_gradients(state, params)
        valid_share = aux["hyp_valid"].float().mean()
        if dp is not None:
            loss, valid_share = dp.all_mean(loss), dp.all_mean(valid_share)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "nonfinite": nonfinite,
                "valid_share": valid_share}

    train_step.ransac_cfg = cfg
    return train_step
