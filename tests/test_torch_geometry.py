"""The port's geometry against `crossloc_tpu.geometry` on seeded inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crossloc_tpu import geometry as jgeo
from crossloc_tpu.geometry.p3p import _p3p_from_4pts_impl
from crossloc_tpu_torch import geometry as tgeo


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rvecs(rng, n=64):
    r = rng.normal(size=(n, 3)) * 0.8
    r[0] = 0.0  # identity
    r[1] = [1e-5, -2e-5, 1e-5]  # series branch
    r[2] = [np.pi - 1e-3, 0.0, 0.0]  # near pi
    r[3] = [0.0, 2.0, -1.5]
    return r.astype(np.float32)


def test_camera_matches_jax():
    f = np.array([120.0, 480.0], np.float32)
    np.testing.assert_array_equal(tgeo.intrinsics(_t(f), 720, 480).numpy(),
                                  np.asarray(jgeo.intrinsics(jnp.asarray(f), 720, 480)))
    np.testing.assert_array_equal(tgeo.pixel_grid(6, 9, 8).numpy(),
                                  np.asarray(jgeo.pixel_grid(6, 9, 8)))


def test_se3_matches_jax(rng):
    rv = _rvecs(rng)
    R_t = tgeo.rodrigues(_t(rv))
    R_j = jgeo.rodrigues(jnp.asarray(rv))
    # fp32 transcendental implementations differ by an ulp or two
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=2e-6)
    np.testing.assert_allclose(tgeo.inverse_rodrigues(R_t).numpy(),
                               np.asarray(jgeo.inverse_rodrigues(R_j)), atol=5e-5)
    pose6 = np.concatenate([rv, rng.normal(size=(len(rv), 3)).astype(np.float32) * 50], -1)
    T_t = tgeo.pose_vec_to_w2c(_t(pose6))
    T_j = jgeo.pose_vec_to_w2c(jnp.asarray(pose6))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=2e-5)
    np.testing.assert_allclose(tgeo.invert_se3(T_t).numpy(),
                               np.asarray(jgeo.invert_se3(T_j)), atol=1e-4)
    a_t = tgeo.rotation_angle_deg(R_t[:-1], R_t[1:]).numpy()
    a_j = np.asarray(jgeo.rotation_angle_deg(R_j[:-1], R_j[1:]))
    np.testing.assert_allclose(a_t, a_j, atol=1e-3)


def test_solve_spd_matches_jax(rng):
    A = rng.normal(size=(5, 7, 6, 6)).astype(np.float32)
    A = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(5, 7, 6)).astype(np.float32)
    x_t = tgeo.solve_spd(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(x_t, np.asarray(jgeo.solve_spd(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.einsum("...ij,...j->...i", A, x_t), b, atol=1e-3)


def test_bearings_match_jax(rng):
    pix = rng.uniform(0, 700, size=(3, 10, 2)).astype(np.float32)
    K = np.asarray(jgeo.intrinsics(jnp.asarray([300.0, 400.0, 500.0]), 720, 480))
    np.testing.assert_allclose(tgeo.bearings_from_pixels(_t(pix), _t(K)).numpy(),
                               np.asarray(jgeo.p3p.bearings_from_pixels(jnp.asarray(pix), K)),
                               atol=1e-6)


@pytest.mark.parametrize("noise_px", [0.0, 2.0])
def test_p3p_from_4pts_matches_jax(rng, noise_px):
    """Minimal sets from random poses (noise-free and with pixel noise): same
    winning candidate, pose and 4-point error as the JAX Lambda Twist."""
    M = 256
    K = np.asarray(jgeo.intrinsics(500.0, 720, 480), np.float32)
    rv = (rng.normal(size=(M, 3)) * 0.5).astype(np.float32)
    Rw = np.asarray(jgeo.rodrigues(jnp.asarray(rv)))
    t = (rng.normal(size=(M, 3)) * 10 + [0, 0, 60]).astype(np.float32)
    cam = np.stack([rng.uniform(-30, 30, size=(M, 4)), rng.uniform(-20, 20, size=(M, 4)),
                    rng.uniform(30, 200, size=(M, 4))], -1).astype(np.float32)
    X4 = np.einsum("mji,mnj->mni", Rw, cam - t[:, None]).astype(np.float32)  # world points
    pix = cam[..., :2] / cam[..., 2:] * 500.0 + np.array([360.0, 240.0])
    pix = (pix + rng.normal(size=pix.shape) * noise_px).astype(np.float32)

    R_j, t_j, e_j, v_j = (np.asarray(a) for a in
                          _p3p_from_4pts_impl(jnp.asarray(X4), jnp.asarray(pix), jnp.asarray(K)))
    R_t, t_t, e_t, v_t = tgeo.p3p_from_4pts(_t(X4), _t(pix), _t(K))
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_j.mean() > 0.95
    e_t = e_t.numpy()
    with np.errstate(invalid="ignore"):  # inf - inf on the invalid sets
        ok = v_j & (np.abs(e_t - e_j) < 1e-2 + 1e-3 * np.abs(e_j))
    # the best-candidate choice may differ only where two candidates reproject
    # the 4 points equally well; such sets are rare
    assert ok.sum() >= 0.98 * v_j.sum()
    # pose error from fp32 transcendental/ordering differences, amplified by
    # the polish steps: relative to depths of 30-200 m
    np.testing.assert_allclose(R_t.numpy()[ok], R_j[ok], atol=2e-3)
    np.testing.assert_allclose(t_t.numpy()[ok], t_j[ok], atol=0.2)
    if noise_px == 0.0:
        assert np.median(e_t[ok]) < 0.05
