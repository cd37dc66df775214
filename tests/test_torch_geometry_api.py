"""The seven public geometry functions the port adds (`project`,
`backproject`, `reprojection_errors`, `w2c_to_pose_vec`, `transform_points`,
`orthonormalize`, `p3p_lambdatwist`) against `crossloc_tpu.geometry` on
seeded numpy inputs: float64 to 1e-10 and float32 to 1e-5, relative to the
largest reference value. P3P: the same set of valid solutions up to order on
well-conditioned triples (to 1e-10 in float64; 1e-4 in float32, where the
cubic's root and the Gauss-Newton polish move the last digits), one of them
the true pose."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossloc_tpu import geometry as jgeo
from crossloc_tpu_torch import geometry as tgeo

torch.set_num_threads(2)

DTYPES = [np.float64, np.float32]
RTOL = {np.float64: 1e-10, np.float32: 1e-5}


def _close(ours, ref, dtype):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == dtype
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=RTOL[dtype], atol=RTOL[dtype] * scale)


def _jax(fn, *args, dtype):
    """fn on jnp arrays of `dtype` (float64 under x64), results as numpy."""
    with jax.enable_x64(dtype == np.float64):
        out = fn(*(jnp.asarray(a, dtype) if isinstance(a, np.ndarray) else a for a in args))
        return jax.tree_util.tree_map(np.asarray, out)


def _torch(fn, *args, dtype):
    out = fn(*(torch.from_numpy(a.astype(dtype)) if isinstance(a, np.ndarray) else a
               for a in args))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _rotations(rng, n):
    """n rotation matrices in float64 (Rodrigues' formula) and their rvecs."""
    rv = rng.normal(size=(n, 3)) * 0.7
    theta = np.linalg.norm(rv, axis=-1)[:, None, None]
    k = rv / theta[:, :, 0]
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K), rv


def _camera(rng, n):
    K = np.zeros((n, 3, 3))
    f = rng.uniform(300, 600, size=n)
    K[:, 0, 0], K[:, 1, 1] = f, f * rng.uniform(0.95, 1.05, size=n)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = 360.0, 240.0, 1.0
    return K


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("min_depth", [None, 0.1])
def test_project(rng, dtype, min_depth):
    pts = rng.normal(size=(3, 40, 3)) * [4.0, 3.0, 0.5] + [0.0, 0.0, 6.0]
    pts[:, :4, 2] = [0.05, -0.3, 1e-3, 0.1]  # near or behind the camera plane
    if min_depth is None:
        pts[:, :4, 2] = [0.5, -0.3, 1.0, 2.0]
    K = _camera(rng, 3)
    _close(_torch(tgeo.project, pts, K, min_depth, dtype=dtype),
           _jax(jgeo.project, pts, K, min_depth, dtype=dtype), dtype)
    # a camera matrix shared by the batch
    _close(_torch(tgeo.project, pts, K[0], min_depth, dtype=dtype),
           _jax(jgeo.project, pts, K[0], min_depth, dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_backproject(rng, dtype):
    pix = rng.uniform(0, 720, size=(2, 30, 2))
    depth = rng.uniform(1.0, 80.0, size=(2, 30))
    K = _camera(rng, 2)
    _close(_torch(tgeo.backproject, pix, depth, K, dtype=dtype),
           _jax(jgeo.backproject, pix, depth, K, dtype=dtype), dtype)
    f = np.asarray(rng.uniform(300, 600, size=(2,)))
    _close(_torch(tgeo.backproject, pix, depth, f, 720, 480, dtype=dtype),
           _jax(jgeo.backproject, pix, depth, f, 720, 480, dtype=dtype), dtype)
    _close(_torch(tgeo.backproject, pix[0], depth[0], 480.0, 720, 480, dtype=dtype),
           _jax(jgeo.backproject, pix[0], depth[0], 480.0, 720, 480, dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_err", [None, 40.0])
def test_reprojection_errors(rng, dtype, max_err):
    pts = rng.normal(size=(2, 50, 3)) * [4.0, 3.0, 1.0] + [0.0, 0.0, 8.0]
    pts[:, 0, 2] = 0.01  # clamped to min_depth
    K = _camera(rng, 2)
    pix = rng.uniform(0, 720, size=(2, 50, 2))
    _close(_torch(tgeo.reprojection_errors, pts, pix, K, 0.1, max_err, dtype=dtype),
           _jax(jgeo.reprojection_errors, pts, pix, K, 0.1, max_err, dtype=dtype), dtype)


def _w2c(rng, n, rows=4):
    R, _ = _rotations(rng, n)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(n, 3)) * 20.0
    return T[:, :rows]


@pytest.mark.parametrize("dtype", DTYPES)
def test_w2c_to_pose_vec(rng, dtype):
    T = _w2c(rng, 32)
    _close(_torch(tgeo.w2c_to_pose_vec, T, dtype=dtype),
           _jax(jgeo.w2c_to_pose_vec, T, dtype=dtype), dtype)
    # the round trip through pose_vec_to_w2c
    back = tgeo.pose_vec_to_w2c(tgeo.w2c_to_pose_vec(torch.from_numpy(T))).numpy()
    np.testing.assert_allclose(back, T, atol=1e-10 * np.abs(T).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [4, 3])
def test_transform_points(rng, dtype, rows):
    T = _w2c(rng, 3, rows)
    pts = rng.normal(size=(3, 25, 3)) * 50.0
    _close(_torch(tgeo.transform_points, T, pts, dtype=dtype),
           _jax(jgeo.transform_points, T, pts, dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("iters", [1, 2, 3])
def test_orthonormalize(rng, dtype, iters):
    R, _ = _rotations(rng, 16)
    noisy = R + rng.normal(size=R.shape) * 0.02
    ours = _torch(lambda r: tgeo.orthonormalize(r, iters), noisy, dtype=dtype)
    _close(ours, _jax(lambda r: jgeo.orthonormalize(r, iters), noisy, dtype=dtype), dtype)
    if iters == 3 and dtype == np.float64:
        eye = np.einsum("bij,bkj->bik", ours, ours)
        np.testing.assert_allclose(eye, np.tile(np.eye(3), (16, 1, 1)), atol=1e-8)


def _p3p_problems(rng, n):
    """World points X [n, 3, 3], unit bearings y [n, 3, 3] and the true w2c
    (R [n, 3, 3], t [n, 3]): three points 5-25 m in front of the camera,
    spread over the image."""
    R, _ = _rotations(rng, n)
    t = rng.normal(size=(n, 3)) * 10.0
    cam = np.concatenate([rng.uniform(-0.6, 0.6, size=(n, 3, 2)),
                          np.ones((n, 3, 1))], axis=-1) * rng.uniform(5, 25, size=(n, 3, 1))
    X = np.einsum("bji,bnj->bni", R, cam - t[:, None, :])  # R^T (x_cam - t)
    y = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
    return X, y, R, t


@pytest.mark.parametrize("dtype", DTYPES)
def test_p3p_lambdatwist_same_solution_set(rng, dtype):
    X, y, R_true, t_true = _p3p_problems(rng, 48)
    Rt, tt, vt = _torch(tgeo.p3p_lambdatwist, X, y, dtype=dtype)
    Rj, tj, vj = _jax(jgeo.p3p_lambdatwist, X, y, dtype=dtype)
    assert Rt.shape == Rj.shape == (48, 4, 3, 3) and tt.shape == tj.shape == (48, 4, 3)
    tol = {np.float64: 1e-10, np.float32: 1e-4}[dtype]
    for b in range(48):
        ours = [(Rt[b, k], tt[b, k]) for k in range(4) if vt[b, k]]
        ref = [(Rj[b, k], tj[b, k]) for k in range(4) if vj[b, k]]
        assert len(ours) == len(ref) > 0, b
        scale = 1.0 + np.abs(tj[b]).max()
        for R, t in ref:  # every reference solution has one of ours beside it
            assert min(max(np.abs(R - Ro).max(), np.abs(t - to).max() / scale)
                       for Ro, to in ours) < tol, b
        # the true pose is among them
        assert min(max(np.abs(R_true[b] - Ro).max(), np.abs(t_true[b] - to).max() / scale)
                   for Ro, to in ours) < {np.float64: 1e-10, np.float32: 2e-3}[dtype], b
