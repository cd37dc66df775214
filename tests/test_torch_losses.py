"""The port's coord loss against the JAX package's on the same numpy inputs.

The inputs cross every branch: the soft clamp (100 px), the hard clamp
(1000 px), the min-depth clamp, the regression-error tolerance and nodata
cells. Values and gradients (with respect to the predictions and the
uncertainty map) agree to rtol 1e-5; gradients elementwise within 1e-5 of
their largest magnitude besides (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import geometry as jgeo
from crossloc_tpu import losses as jlosses
from crossloc_tpu_torch import losses

H, W, SUB, FOCAL = 6, 9, 8, 60.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(seed, B=3):
    """Exact coordinates of random poses, predictions perturbed into every
    branch of the loss, nodata cells, and an uncertainty map."""
    rng = np.random.default_rng(seed)
    K = np.asarray(jgeo.intrinsics(FOCAL, W * SUB, H * SUB), np.float64)
    grid = np.asarray(jgeo.pixel_grid(H, W, SUB), np.float64).reshape(-1, 2)
    poses, gts = [], []
    for _ in range(B):
        R = np.asarray(jgeo.rodrigues(jnp.asarray(rng.normal(size=3) * 0.3)), np.float64)
        t = rng.normal(size=3) * 5
        depth = rng.uniform(5.0, 60.0, size=grid.shape[0])
        cam = np.stack([(grid[:, 0] - K[0, 2]) / K[0, 0] * depth,
                        (grid[:, 1] - K[1, 2]) / K[1, 1] * depth, depth], -1)
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        poses.append(c2w)
        gts.append((cam @ R.T + t).reshape(H, W, 3))
    gt = np.stack(gts).astype(np.float32)
    poses = np.stack(poses).astype(np.float32)
    # per-cell perturbation scales: small (L1 branch), a few metres (past the
    # 100 px soft clamp), tens of metres (past 1000 px and the 50 m tolerance)
    scale = rng.choice([0.05, 3.0, 80.0], size=(B, H, W, 1), p=[0.5, 0.3, 0.2])
    pred = gt + rng.normal(size=gt.shape).astype(np.float32) * scale.astype(np.float32)
    for b in range(B):  # cells 4 m behind the camera: min-depth clamp
        for (i, j) in ((0, 0), (2, 5)):
            pred[b, i, j] = poses[b, :3, :3] @ np.array([0.3, -0.2, -4.0]) + poses[b, :3, 3]
    gt[:, 1, 2] = -1.0  # nodata cells
    gt[0, 4, 7] = -1.0
    unc = rng.uniform(0.2, 5.0, size=(B, H, W, 1)).astype(np.float32)
    return pred, gt, poses, K.astype(np.float32), unc


def _jax_value_and_grads(pred, gt, poses, K, unc, reduction):
    def f(p, u):
        loss, vr = jlosses.scene_coords_loss(p, jnp.asarray(gt), jnp.asarray(poses),
                                             jnp.asarray(K), u, reduction=reduction)
        return jnp.sum(loss), (loss, vr)

    argnums = (0,) if unc is None else (0, 1)
    (_, (loss, vr)), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        jnp.asarray(pred), None if unc is None else jnp.asarray(unc))
    return np.asarray(loss), float(vr), [np.asarray(g) for g in grads]


def _port_value_and_grads(pred, gt, poses, K, unc, reduction):
    leaves = [torch.tensor(pred, requires_grad=True)]
    if unc is not None:
        leaves.append(torch.tensor(unc, requires_grad=True))
    loss, vr = losses.scene_coords_loss(leaves[0], torch.from_numpy(gt),
                                        torch.from_numpy(poses), torch.from_numpy(K),
                                        leaves[1] if unc is not None else None,
                                        reduction=reduction)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach().numpy(), float(vr), [g.numpy() for g in grads]


@pytest.mark.parametrize("reduction", ["mean", None])
@pytest.mark.parametrize("mle", [False, True], ids=["no_unc", "MLE"])
def test_coord_loss_and_gradients_match_jax(mle, reduction):
    pred, gt, poses, K, unc = _scene(seed=3)
    unc = unc if mle else None
    j_loss, j_vr, j_grads = _jax_value_and_grads(pred, gt, poses, K, unc, reduction)
    t_loss, t_vr, t_grads = _port_value_and_grads(pred, gt, poses, K, unc, reduction)
    assert 0.2 < j_vr < 0.9  # the constraints do cut cells
    assert t_vr == pytest.approx(j_vr, abs=0)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    for t, j in zip(t_grads, j_grads):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())


def test_inputs_cross_every_branch():
    """The scene of the parity test reaches both clamps, the min depth, the
    tolerance and nodata (so the parity covers them)."""
    pred, gt, poses, K, _ = _scene(seed=3)
    w2c = np.linalg.inv(poses.astype(np.float64))
    cam = np.einsum("bij,bhwj->bhwi", w2c[:, :3, :3], pred) + w2c[:, None, None, :3, 3]
    proj = np.einsum("ij,bhwj->bhwi", K, cam)
    px = proj[..., :2] / np.maximum(proj[..., 2:], 0.1)
    grid = np.asarray(jgeo.pixel_grid(H, W, SUB))
    repro = np.linalg.norm(px - grid, axis=-1)
    assert (cam[..., 2] < 0.1).any()
    assert ((repro > 100) & (repro < 1000)).any() and (repro > 1000).any()
    assert (gt == -1).all(-1).sum() == 4
    gt_cam = np.einsum("bij,bhwj->bhwi", w2c[:, :3, :3], gt) + w2c[:, None, None, :3, 3]
    assert (np.linalg.norm(cam - gt_cam, axis=-1) > 50).any()


def test_nothing_valid_gives_no_reprojection_term():
    """Every cell invalid: the `where` keeps the loss finite (the reference's
    python branch on num_valid)."""
    pred, gt, poses, K, unc = _scene(seed=4, B=1)
    behind = poses[0, :3, :3] @ np.array([0.0, 0.0, -5.0]) + poses[0, :3, 3]
    pred = np.broadcast_to(behind.astype(np.float32), pred.shape).copy()
    t_loss, t_vr, _ = _port_value_and_grads(pred, gt, poses, K, unc, "mean")
    j_loss, j_vr, _ = _jax_value_and_grads(pred, gt, poses, K, unc, "mean")
    assert t_vr == j_vr == 0.0
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
