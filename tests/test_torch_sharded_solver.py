"""The hypothesis-sharded RANSAC solver (`ransac/sharded.py`): two CPU ranks
(gloo) each sample and score half of the pool, and the all-gathered pool
gives exactly `solve_batch`'s answer on the same draws; the divisibility
guard has the JAX package's words.
"""
import numpy as np
import pytest
import torch

import jax

from crossloc_tpu import parallel as jparallel
from crossloc_tpu import ransac as jransac
from crossloc_tpu_torch import geometry, ransac
from crossloc_tpu_torch.ransac import sharded
from crossloc_tpu_torch.tools.parallel_check import run_ranks, solver_check

H, W, FOCAL = 12, 16, 100.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(cfg: dict, B=3):
    """Scene coordinates of a plane seen by B cameras, with noise and a few
    outliers, and the global pool's draws."""
    g = torch.Generator().manual_seed(0)
    grid = geometry.pixel_grid(H, W, 8).reshape(-1, 2).double()
    coords = []
    for b in range(B):
        depth = 30.0 + 5.0 * torch.rand(H * W, generator=g, dtype=torch.float64)
        cam = torch.stack([(grid[:, 0] - W * 4) / FOCAL * depth,
                           (grid[:, 1] - H * 4) / FOCAL * depth, depth], -1)
        world = cam + torch.tensor([float(b), -2.0, 0.5]) + 0.05 * torch.randn(
            H * W, 3, generator=g, dtype=torch.float64)
        world[:10] += 20.0 * torch.randn(10, 3, generator=g, dtype=torch.float64)
        coords.append(world.reshape(H, W, 3))
    rc = ransac.RansacConfig(**cfg)
    idx = torch.randint(0, H * W, (B, rc.hypotheses * rc.sample_rounds, 4), generator=g)
    return dict(coords=torch.stack(coords).float(), focal=FOCAL, image_hw=(H * 8, W * 8),
                ransac=cfg, idx=idx, device="cpu")


@pytest.mark.parametrize("cfg", [{}, {"eval_selection": "hard", "refine_top_k": 2}],
                         ids=["default", "hard-top2"])
def test_two_ranks_equal_solve_batch(tmp_path, cfg):
    """RansacConfig()'s 64 hypotheses (32 a rank): the same scores, choice,
    pose and inlier count as one solve over the whole pool."""
    spec = _spec(cfg)
    out = str(tmp_path / "rank0.pt")
    run_ranks(solver_check, 2, (spec, out), timeout=120)
    got = torch.load(out, weights_only=False)
    ref = ransac.solve_batch(spec["coords"], FOCAL, spec["image_hw"],
                             ransac.RansacConfig(**cfg), idx=spec["idx"])
    for k, v in ref._asdict().items():
        assert torch.equal(got[k], v), k
    assert bool(ref.valid.all()) and int(ref.inlier_count.min()) > 100


def test_one_rank_is_solve_batch():
    spec = _spec({})
    got = solver_check(spec)
    ref = ransac.solve_batch(spec["coords"], FOCAL, spec["image_hw"], idx=spec["idx"])
    for k, v in ref._asdict().items():
        assert torch.equal(got[k], v), k


def test_indivisible_pool_raises_jax_error(monkeypatch):
    mesh = jparallel.make_mesh(jax.devices()[:3], data=1, spatial=3)
    with pytest.raises(ValueError) as ref:
        jransac.sharded.solve_batch_hypsharded(np.zeros((1, H, W, 3), np.float32), FOCAL,
                                               (H * 8, W * 8), jax.random.PRNGKey(0), mesh)
    monkeypatch.setattr(sharded, "topology", lambda: (0, 3))
    with pytest.raises(ValueError) as port:
        ransac.solve_batch_hypsharded(torch.zeros(1, H, W, 3), FOCAL, (H * 8, W * 8))
    assert str(port.value) == str(ref.value) == "hypotheses 64 not divisible by 3"
