"""Hypothesis parallelism for the RANSAC solver over the ranks of the default
process group (counterpart of `crossloc_tpu/ransac/sharded.py`).

Each rank samples and scores its slice of the hypothesis pool, an all-gather
assembles the scores and poses in rank order (JAX's `all_gather(...,
tiled=True)`), and the softmax, the argmax and the refinement run on every
rank. The JAX package folds the shard index into its key; here the draws of
the GLOBAL pool are given (`idx`) or drawn alike on every rank from the same
`generator`, and each rank takes its slice, so the sharded solve equals
`solve_batch` with the same draws. Eval mode only, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel import all_gather_cat, topology
from .config import RansacConfig
from .solver import (
    RansacResult,
    sample_hypotheses,
    score_hypotheses,
    select_and_refine,
    solver_inputs,
    solver_precision,
)


def solve_batch_hypsharded(
    scene_coords,
    focal_length,
    image_hw,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    generator: Optional[torch.Generator] = None,
) -> RansacResult:
    """Pose estimation with the hypothesis pool split over the ranks.

    scene_coords [B, Hs, Ws, 3], the same on every rank; `cfg.hypotheses`
    is the GLOBAL pool, which the rank count must divide. `idx` [B,
    hypotheses * sample_rounds, 4] are the global pool's draws (else drawn
    from `generator`, which every rank must seed alike). Every rank returns
    the same result."""
    rank, world = topology()
    if cfg.hypotheses % world != 0:
        raise ValueError(f"hypotheses {cfg.hypotheses} not divisible by {world}")
    local_cfg = cfg._replace(hypotheses=cfg.hypotheses // world)
    B, Hs, Ws, _ = scene_coords.shape
    device = scene_coords.device
    if idx is None:
        idx = torch.randint(0, Hs * Ws, (B, cfg.hypotheses * cfg.sample_rounds, 4),
                            generator=generator, device=device)
    span = local_cfg.hypotheses * cfg.sample_rounds
    local_idx = torch.as_tensor(idx, device=device)[:, rank * span: (rank + 1) * span]
    with solver_precision(device):
        coords, grid, cams = solver_inputs(scene_coords, focal_length, image_hw, cfg)
        pose6, hyp_valid = sample_hypotheses(coords, grid, cams, local_cfg, local_idx)
        scores, hard = score_hypotheses(pose6, hyp_valid, coords, grid, cams, cfg)
        if world > 1:
            pose6 = all_gather_cat(pose6, dim=1)
            hyp_valid = all_gather_cat(hyp_valid.to(torch.uint8), dim=1).bool()
            scores = all_gather_cat(scores, dim=1)
            hard = all_gather_cat(hard, dim=1)
        return select_and_refine(pose6, hyp_valid, scores, hard, coords, grid, cams, cfg)
