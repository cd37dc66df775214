"""The port's eval solver against the JAX solver on the noisy GT-oracle
frames, each on its own random draws (ROADMAP item 15(a)).

The frames of `tests/test_reference_plugin_parity.py` (480x720, focal 500,
1 m noise, 20 % outliers at up to 200 m, the default `RansacConfig`): the
port's `solve_batch` draws from a `torch.Generator`, JAX's from its key, so
the two are held statistically, by the ratio of their median translation
and rotation errors, port over JAX. The guards are the measured spread,
mean + 3 sigma, as the plugin-parity test derives its own: per 32-frame
seed (seeds 0-9, on the CPU; `test_pooled_oracle_ratio_is_within_the_measured_spread`
with `-s` prints them) the ratios were t 1.0533 +- 0.0933 and r 1.0549 +-
0.1091, the pooled ratios t 1.0338 and r 1.0096; the pooled median over
320 frames has sigma / sqrt(10).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import geometry as jgeo
from crossloc_tpu import ransac as jransac
from crossloc_tpu_torch import ransac

sys.path.insert(0, str(Path(__file__).parent))
from test_reference_plugin_parity import FOCAL, IMG_H, IMG_W, _frames  # noqa: E402

# per-seed ratio of the medians, port / JAX: (mean, sigma) over 10 seeds
T_RATIO, R_RATIO = (1.0533, 0.0933), (1.0549, 0.1091)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _errors(c2w, gt):
    """(translation m, rotation deg) per frame."""
    t = np.linalg.norm(c2w[:, :3, 3] - gt[:, :3, 3], axis=-1)
    r = np.asarray(jgeo.rotation_angle_deg(jnp.asarray(c2w[:, :3, :3]), jnp.asarray(gt[:, :3, :3])))
    return t, r


def _seed_errors(seed, n=32):
    """Per-frame errors of both solvers on the seed's frames: ((t, r) port,
    (t, r) JAX)."""
    frames = list(_frames(np.random.default_rng(seed), n))
    coords = np.stack([c for c, _ in frames])
    gt = np.stack([g for _, g in frames])
    jres = jransac.solve_batch(jnp.asarray(coords), FOCAL, (IMG_H, IMG_W),
                               jax.random.PRNGKey(seed))
    tres = ransac.solve_batch(torch.from_numpy(coords), FOCAL, (IMG_H, IMG_W),
                              generator=torch.Generator().manual_seed(seed))
    return _errors(tres.cam_to_world.numpy(), gt), _errors(np.asarray(jres.cam_to_world), gt)


def _ratios(port, ref):
    (tp, rp), (tj, rj) = port, ref
    return np.median(tp) / np.median(tj), np.median(rp) / np.median(rj)


def test_one_seed_oracle_ratio_is_within_the_measured_spread():
    """One 32-frame seed: the ratios within the per-seed mean + 3 sigma, and
    both solvers localise (median under 1 m)."""
    port, ref = _seed_errors(0)
    t, r = _ratios(port, ref)
    print(f"\nseed 0: port median t {np.median(port[0]):.4f} m r {np.median(port[1]):.4f} deg, "
          f"JAX t {np.median(ref[0]):.4f} m r {np.median(ref[1]):.4f} deg; ratios t {t:.4f} "
          f"r {r:.4f}")
    assert np.median(port[0]) < 1.0 and np.median(ref[0]) < 1.0
    assert t <= T_RATIO[0] + 3 * T_RATIO[1], t
    assert r <= R_RATIO[0] + 3 * R_RATIO[1], r


@pytest.mark.slow
def test_pooled_oracle_ratio_is_within_the_measured_spread():
    """320 frames over seeds 0-9: the pooled ratio of the medians within the
    mean + 3 sigma / sqrt(10) of the per-seed spread; prints every seed's."""
    errs = [_seed_errors(seed) for seed in range(10)]
    per_seed = np.array([_ratios(p, j) for p, j in errs])
    for seed, (t, r) in enumerate(per_seed):
        print(f"seed {seed}: ratio t {t:.4f} r {r:.4f}")
    print(f"per seed: t {per_seed[:, 0].mean():.4f} +- {per_seed[:, 0].std():.4f}, "
          f"r {per_seed[:, 1].mean():.4f} +- {per_seed[:, 1].std():.4f}")
    pooled = [np.concatenate([e[side][k] for e in errs]) for side in (0, 1) for k in (0, 1)]
    t = np.median(pooled[0]) / np.median(pooled[2])
    r = np.median(pooled[1]) / np.median(pooled[3])
    print(f"pooled over 320 frames: port t {np.median(pooled[0]):.4f} m r "
          f"{np.median(pooled[1]):.4f} deg, JAX t {np.median(pooled[2]):.4f} m r "
          f"{np.median(pooled[3]):.4f} deg; ratios t {t:.4f} r {r:.4f}")
    assert t <= T_RATIO[0] + 3 * T_RATIO[1] / np.sqrt(10), t
    assert r <= R_RATIO[0] + 3 * R_RATIO[1] / np.sqrt(10), r
