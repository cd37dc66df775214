"""The port's RANSAC solver against the JAX solver on JAX's own draws.

A GT-oracle scene (exact scene coordinates from known poses) with small
noise and far outliers; the port is fed the exact hypothesis indices the
JAX solver draws, rebuilt from its key: split(key, B), split per image,
randint(k_sample, (H * R, 4), 0, N).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import ransac as jransac
from crossloc_tpu_torch import ransac

IMG_H, IMG_W, FOCAL = 96, 144, 120.0
HS, WS = IMG_H // 8, IMG_W // 8
N = HS * WS


def _scene(seed, B=2):
    """Exact coords from random poses; 0.05 m noise, 20% outliers far off."""
    rng = np.random.default_rng(seed)
    xs = np.arange(WS) * 8 + 4.0
    ys = np.arange(HS) * 8 + 4.0
    gx, gy = np.meshgrid(xs, ys)
    coords = []
    for _ in range(B):
        rvec = rng.normal(size=3) * 0.5
        theta = np.linalg.norm(rvec)
        k = rvec / theta
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx
        t = rng.normal(size=3) * 20 + [0, 0, 100.0]
        d = rng.uniform(30.0, 300.0, size=gx.shape)
        cam = np.stack([(gx - IMG_W / 2) / FOCAL * d, (gy - IMG_H / 2) / FOCAL * d, d], -1)
        world = cam @ R.T + t + rng.normal(size=cam.shape) * 0.05
        out = rng.random(gx.shape) < 0.2
        world[out] += rng.uniform(-100, 100, size=(int(out.sum()), 3))
        coords.append(world)
    return np.stack(coords).astype(np.float32)


def _jax_indices(key, B, cfg):
    idx = []
    for kb in jax.random.split(key, B):
        k_sample, _ = jax.random.split(kb)
        idx.append(np.asarray(jax.random.randint(
            k_sample, (cfg.hypotheses * cfg.sample_rounds, 4), 0, N)))
    return np.stack(idx)


CFGS = {
    "default": dict(),
    "top_k": dict(refine_top_k=3),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_solve_batch_matches_jax_on_its_draws(name):
    # fewer hypotheses than the eval default keep the CPU run short;
    # unroll=False only changes how XLA compiles the JAX loops
    kw = dict(hypotheses=16, sample_rounds=8, **CFGS[name])
    jcfg = jransac.RansacConfig(unroll=False, **kw)
    cfg = ransac.RansacConfig(**kw)
    coords = _scene(3)
    focal = np.array([FOCAL, FOCAL * 1.1], np.float32)
    key = jax.random.PRNGKey(7)

    # eager: the configs share the compiled primitives, a jit would compile each
    jres = jransac.solve_batch(jnp.asarray(coords), jnp.asarray(focal), (IMG_H, IMG_W), key, jcfg)
    idx = torch.from_numpy(_jax_indices(key, 2, jcfg))
    tres = ransac.solve_batch(torch.from_numpy(coords), torch.from_numpy(focal),
                              (IMG_H, IMG_W), cfg, idx=idx)

    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    # soft inlier scores in [0, alpha]: the hypothesis poses (P3P) agree to
    # fp32 noise, which moves a score by up to ~3e-4 of its value
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-3, atol=1e-3)
    if cfg.refine_top_k == 1:
        np.testing.assert_array_equal(tres.chosen.numpy(), np.asarray(jres.chosen))
    else:
        # the K candidates refine to the same optimum on an oracle scene, so
        # their final scores tie within fp32 noise and either side may pick
        # another of them: the pick must be one of JAX's top-K hypotheses
        sel = np.where(np.asarray(jres.probs) > 0, np.asarray(jres.scores), -np.inf)
        top = np.argsort(-sel, axis=-1, kind="stable")[:, : cfg.refine_top_k]
        assert all(c in t for c, t in zip(tres.chosen.numpy(), top))
    # refined pose: rvec in rad, tvec in m at ~100 m depth
    np.testing.assert_allclose(tres.pose_w2c6.numpy(), np.asarray(jres.pose_w2c6), atol=2e-3)
    np.testing.assert_array_equal(tres.inlier_count.numpy(), np.asarray(jres.inlier_count))
    np.testing.assert_allclose(tres.cam_to_world.numpy(), np.asarray(jres.cam_to_world),
                               atol=2e-2)
    np.testing.assert_allclose(tres.entropy.numpy(), np.asarray(jres.entropy), atol=1e-4)


def test_sample_hypotheses_matches_jax():
    cfg = jransac.RansacConfig(hypotheses=16, sample_rounds=8)
    coords = _scene(5, B=1)[0].reshape(N, 3)
    from crossloc_tpu.geometry import intrinsics, pixel_grid

    grid = np.array(pixel_grid(HS, WS, 8)).reshape(N, 2)
    K = np.array(intrinsics(FOCAL, IMG_W, IMG_H))
    key = jax.random.PRNGKey(11)
    pose_j, valid_j = jransac.solver.sample_hypotheses(
        jnp.asarray(coords), jnp.asarray(grid), jnp.asarray(K), key, cfg)
    idx = jax.random.randint(key, (cfg.hypotheses * cfg.sample_rounds, 4), 0, N)
    pose_t, valid_t = ransac.sample_hypotheses(
        torch.from_numpy(coords)[None], torch.from_numpy(grid), torch.from_numpy(K)[None],
        ransac.RansacConfig(hypotheses=16, sample_rounds=8),
        idx=torch.from_numpy(np.array(idx))[None])
    np.testing.assert_array_equal(valid_t[0].numpy(), np.asarray(valid_j))
    v = np.asarray(valid_j)
    assert v.mean() > 0.5
    np.testing.assert_allclose(pose_t[0].numpy()[v], np.asarray(pose_j)[v], atol=5e-2)


def test_generator_draws_are_reproducible():
    coords = torch.from_numpy(_scene(9, B=1))
    cfg = ransac.RansacConfig(hypotheses=8, sample_rounds=4)
    a = ransac.solve_batch(coords, FOCAL, (IMG_H, IMG_W), cfg,
                           generator=torch.Generator().manual_seed(1))
    b = ransac.solve_batch(coords, FOCAL, (IMG_H, IMG_W), cfg,
                           generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.pose_w2c6.numpy(), b.pose_w2c6.numpy())
