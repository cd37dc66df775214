"""P3P's implicit backward in the port against the JAX package's vjp and
against central finite differences in float64.

`p3p_from_4pts` returns the pose of one 4-point minimal set; its backward
differentiates the selected root implicitly through the three points'
projection residuals. The port's backward is held against `jax.vjp` of
`crossloc_tpu.geometry.p3p_from_4pts` on the same sets (valid, degenerate
and invalid; invalid ones must give exactly 0), and against finite
differences of the forward in float64.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu.geometry import p3p as jp3p
from crossloc_tpu_torch.geometry import grad_firewall, p3p_from_4pts
from crossloc_tpu_torch.geometry.p3p import _p3p_from_4pts_impl

FOCAL, IMG_W, IMG_H = 500.0, 720, 480
K = np.array([[FOCAL, 0, IMG_W / 2], [0, FOCAL, IMG_H / 2], [0, 0, 1]])


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sets(seed, M=192, noise=0.5):
    """M minimal sets seen by random cameras at 30-300 m, pixel noise; the
    last 8 are degenerate: collinear, duplicate, behind the camera, tiny."""
    rng = np.random.default_rng(seed)
    X, pix = [], []
    for _ in range(M):
        rv = rng.normal(size=3) * 0.5
        th = np.linalg.norm(rv)
        k = rv / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        t = rng.normal(size=3) * 10
        uv = rng.uniform([0, 0], [IMG_W, IMG_H], size=(4, 2))
        d = rng.uniform(30.0, 300.0, size=4)
        cam = np.stack([(uv[:, 0] - K[0, 2]) / FOCAL * d, (uv[:, 1] - K[1, 2]) / FOCAL * d, d], -1)
        X.append((cam - t) @ R)  # world points: R^T (x_cam - t)
        pix.append(uv + rng.normal(size=(4, 2)) * noise)
    X, pix = np.stack(X), np.stack(pix)
    X[-8] = X[-8, 0] + np.outer([0, 1, 2, 3], X[-8, 1] - X[-8, 0])  # collinear
    X[-7, 1] = X[-7, 0]  # duplicate point
    X[-6, 2] = X[-6, 0]
    X[-5] = -X[-5]  # behind the camera
    X[-4, :3] = X[-4, 0] + 1e-4 * rng.normal(size=(3, 3))  # a tiny triangle
    X[-3] *= 1e-3
    pix[-2, :3] = pix[-2, 0]  # one bearing for three points
    pix[-1] = pix[-1, 0] + np.array([[0, 0], [1e-3, 0], [0, 1e-3], [5, 5]])
    return X, pix


def _jax_vjp(X, pix, gR, gt, dtype=np.float32):
    def f(X4):
        R, t, _, _ = jp3p.p3p_from_4pts(X4, jnp.asarray(pix, dtype), jnp.asarray(K, dtype))
        return R, t

    (R, t), vjp = jax.vjp(f, jnp.asarray(X, dtype))
    return np.asarray(R), np.asarray(t), np.asarray(vjp((jnp.asarray(gR), jnp.asarray(gt)))[0])


def _port(X, pix, gR, gt, dtype=torch.float32):
    Xt = torch.tensor(X, dtype=dtype, requires_grad=True)
    R, t, err, valid = p3p_from_4pts(Xt, torch.tensor(pix, dtype=dtype),
                                     torch.tensor(K, dtype=dtype))
    ((R * torch.tensor(gR, dtype=dtype)).sum() + (t * torch.tensor(gt, dtype=dtype)).sum()).backward()
    return R.detach().numpy(), t.detach().numpy(), valid.numpy(), Xt.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backward_matches_jax(seed):
    X, pix = _sets(seed)
    rng = np.random.default_rng(100 + seed)
    gR = rng.normal(size=(len(X), 3, 3)).astype(np.float32)
    gt = rng.normal(size=(len(X), 3)).astype(np.float32)
    Rj, tj, gj = _jax_vjp(X.astype(np.float32), pix.astype(np.float32), gR, gt)
    Rt, tt, valid, gp = _port(X.astype(np.float32), pix.astype(np.float32), gR, gt)
    _, _, _, valid_j = jp3p.p3p_from_4pts(jnp.asarray(X, jnp.float32),
                                          jnp.asarray(pix, jnp.float32), jnp.asarray(K, jnp.float32))
    np.testing.assert_array_equal(valid, np.asarray(valid_j))
    assert 0.8 < valid.mean() < 1.0  # degenerate sets are among the invalid
    # invalid sets: exactly zero in both; the 4th point gets nothing
    assert not gp[~valid].any() and not gj[~valid].any()
    assert not gp[:, 3].any()
    # valid sets: the forward agrees to f32 rounding, which the 6x6 solve
    # amplifies by the set's conditioning: per set within 1e-3 of the
    # gradient's norm, plus 1e-4 absolute
    np.testing.assert_allclose(Rt[valid], Rj[valid], atol=2e-4)
    err = np.linalg.norm((gp - gj)[valid].reshape(-1, 12), axis=-1)
    ref = np.linalg.norm(gj[valid].reshape(-1, 12), axis=-1)
    assert np.all(err <= 1e-3 * ref + 1e-4), (err / ref).max()
    assert np.isfinite(gp).all() and np.abs(gp).max() <= 1e6


def test_backward_matches_finite_differences_in_float64():
    """d <gR, R> + <gt, t> / dX by central differences (h = 1e-5 m on world
    points of 30-300 m) against the implicit backward, float64: per set
    within 1e-6 of the gradient's norm."""
    X, pix = _sets(7, M=48, noise=0.5)
    X, pix = X[:40], pix[:40]  # the generic sets
    rng = np.random.default_rng(8)
    gR, gt = rng.normal(size=(len(X), 3, 3)), rng.normal(size=(len(X), 3))
    _, _, valid, g = _port(X, pix, gR, gt, torch.float64)
    assert valid.all()

    def objective(Xp):
        R, t, _, _ = _p3p_from_4pts_impl(torch.from_numpy(Xp), torch.from_numpy(pix),
                                         torch.from_numpy(K))
        return (R.numpy() * gR).sum((-1, -2)) + (t.numpy() * gt).sum(-1)

    h = 1e-5
    fd = np.zeros_like(X)
    for i in range(4):
        for c in range(3):
            e = np.zeros_like(X)
            e[:, i, c] = h
            fd[:, i, c] = (objective(X + e) - objective(X - e)) / (2 * h)
    err = np.linalg.norm((g - fd).reshape(len(X), -1), axis=-1)
    ref = np.linalg.norm(fd.reshape(len(X), -1), axis=-1)
    assert np.all(err <= 1e-6 * ref), (err / ref).max()


def test_forward_is_the_plain_forward():
    """The autograd Function runs the unchanged forward: the same bits."""
    X, pix = _sets(3, M=64)
    args = (torch.tensor(X, dtype=torch.float32), torch.tensor(pix, dtype=torch.float32),
            torch.tensor(K, dtype=torch.float32))
    for a, b in zip(p3p_from_4pts(*args), _p3p_from_4pts_impl(*args)):
        assert torch.equal(a, b)


def test_grad_firewall_sanitizes_like_jax():
    g = np.array([1.0, np.nan, np.inf, -np.inf, 3e6, -2e7, -5.0], np.float32)
    x = torch.zeros(7, requires_grad=True)
    grad_firewall(x).backward(torch.from_numpy(g))
    ref = jax.vjp(jp3p._grad_firewall, jnp.zeros(7))[1](jnp.asarray(g))[0]
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, 0, 0, 0, 1e6, -1e6, -5.0])
