"""The port's depth, normal and semantics losses, their angle helpers and the
semantics path of the augmentation, against the JAX package's on the same
numpy inputs.

Tolerances: losses rtol 1e-5; gradients (with respect to the predictions and
the uncertainty map) rtol 1e-5 and elementwise within 1e-5 of their largest
magnitude (float32 sums in another order); valid rates exactly, on inputs
where no normal's angle lies within 1e-3 degrees of the hard clamp (the
degrees round in another order) and no prediction within 1e-3 of a depth
threshold; augmented semantics labels exactly (nearest sampling on JAX's own
draws).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import data as jdata
from crossloc_tpu import losses as jlosses
from crossloc_tpu_torch import data, losses

B, H, W = 3, 6, 9


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _value_and_grads(jax_fn, port_fn, pred, gt, unc, reduction):
    """(loss, valid rate, grads) of both packages; grads w.r.t. pred and unc."""
    def f(p, u):
        loss, vr = jax_fn(p, jnp.asarray(gt), u, reduction)
        return jnp.sum(loss), (loss, vr)

    argnums = (0,) if unc is None else (0, 1)
    (_, (j_loss, j_vr)), j_grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        jnp.asarray(pred), None if unc is None else jnp.asarray(unc))
    leaves = [torch.tensor(pred, requires_grad=True)]
    if unc is not None:
        leaves.append(torch.tensor(unc, requires_grad=True))
    t_loss, t_vr = port_fn(leaves[0], torch.from_numpy(gt), leaves[1] if unc is not None else None,
                           reduction)
    t_grads = torch.autograd.grad(t_loss.sum(), leaves)
    return ((np.asarray(j_loss), float(j_vr), [np.asarray(g) for g in j_grads]),
            (t_loss.detach().numpy(), float(t_vr), [g.numpy() for g in t_grads]))


def _assert_match(jax_out, port_out, expect_rate):
    (j_loss, j_vr, j_grads), (t_loss, t_vr, t_grads) = jax_out, port_out
    assert expect_rate(j_vr)
    assert t_vr == j_vr
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    for t, j in zip(t_grads, j_grads):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())


def _depth_inputs(seed):
    """Predictions around the truth: within and beyond the 10 m hard clamp,
    some below the 0.1 m minimum depth; nodata cells; a sigma map."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(5.0, 60.0, (B, H, W, 1)).astype(np.float32)
    scale = rng.choice([1.0, 30.0], size=gt.shape, p=[0.7, 0.3])
    pred = (gt + rng.normal(size=gt.shape) * scale).astype(np.float32)
    pred[0, 0, :3] = rng.uniform(-2.0, 0.05, (3, 1))
    gt[:, 1, 2] = -1.0
    gt[0, 4, 7] = -1.0
    unc = rng.uniform(0.2, 5.0, gt.shape).astype(np.float32)
    err = np.abs(pred - gt)
    assert np.abs(err - 10.0).min() > 1e-3 and np.abs(pred - 0.1).min() > 1e-3
    return pred, gt, unc


@pytest.mark.parametrize("reduction", ["mean", None])
@pytest.mark.parametrize("mle", [False, True], ids=["no_unc", "MLE"])
def test_depth_loss_and_gradients_match_jax(mle, reduction):
    pred, gt, unc = _depth_inputs(seed=1)
    cfg = jlosses.DepthLossConfig(), losses.DepthLossConfig()
    out = _value_and_grads(lambda p, g, u, r: jlosses.depth_loss(p, g, u, cfg[0], r),
                           lambda p, g, u, r: losses.depth_loss(p, g, u, cfg[1], r),
                           pred, gt, unc if mle else None, reduction)
    _assert_match(*out, expect_rate=lambda vr: 0.3 < vr < 0.9)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _normal_inputs(seed, hard_clamp=10.0):
    """Logits whose angles lie about 0.15 rad from true unit normals (some
    within the 10 degree clamp, some beyond), kept off the sigmoid's clamp;
    nodata cells; a sigma map."""
    rng = np.random.default_rng(seed)
    gt = _unit(rng, B * H * W).reshape(B, H, W, 3).astype(np.float32)
    ae = np.stack([np.arctan2(gt[..., 1], gt[..., 0]),
                   np.arctan2(gt[..., 2], np.linalg.norm(gt[..., :2], axis=-1))], -1)
    ae = np.clip(ae + rng.normal(size=ae.shape) * 0.15, -3.0, 3.0)
    s = (ae / np.pi + 1.0) / 2.0
    logits = np.log(s / (1.0 - s)).astype(np.float32)
    gt[:, 1, 2] = -1.0
    gt[0, 4, 7] = -1.0
    unc = rng.uniform(0.2, 5.0, (B, H, W, 1)).astype(np.float32)
    # the validity angle of every valid cell, in float64: none near the clamp
    r = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    a = (2 * r - 1) * np.pi
    xyz = np.stack([np.cos(a[..., 0]) * np.cos(a[..., 1]), np.sin(a[..., 0]) * np.cos(a[..., 1]),
                    np.sin(a[..., 1])], -1)
    ang = np.degrees(np.arccos(np.clip((xyz * gt).sum(-1), -1, 1)))
    valid = (gt != -1).all(-1)
    assert np.abs(ang[valid] - hard_clamp).min() > 1e-3
    return logits, gt, unc


@pytest.mark.parametrize("reduction", ["mean", None])
@pytest.mark.parametrize("mle", [False, True], ids=["no_unc", "MLE"])
def test_normal_loss_and_gradients_match_jax(mle, reduction):
    logits, gt, unc = _normal_inputs(seed=2)
    cfg = jlosses.NormalLossConfig(), losses.NormalLossConfig()
    out = _value_and_grads(lambda p, g, u, r: jlosses.normal_loss(p, g, u, cfg[0], r),
                           lambda p, g, u, r: losses.normal_loss(p, g, u, cfg[1], r),
                           logits, gt, unc if mle else None, reduction)
    _assert_match(*out, expect_rate=lambda vr: 0.2 < vr < 0.9)


def test_normal_validity_sees_no_gradient():
    """The validity angle runs on a detached prediction: the gradient is that
    of the regression terms alone, whatever the hard clamp."""
    logits, gt, _ = _normal_inputs(seed=2)
    grads = []
    for clamp in (1.0, 10.0, 180.0):
        x = torch.tensor(logits, requires_grad=True)
        loss, _ = losses.normal_loss(x, torch.from_numpy(gt), None,
                                     losses.NormalLossConfig(hard_clamp=clamp))
        grads.append(torch.autograd.grad(loss, x)[0])
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[1], grads[2])


@pytest.mark.parametrize("reduction", ["mean", None])
def test_semantics_loss_and_gradients_match_jax(reduction):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(B, H, W, 6)) * 2.0).astype(np.float32)
    labels = rng.integers(0, 6, (B, H, W, 1)).astype(np.float32)
    out = _value_and_grads(lambda p, g, u, r: jlosses.semantics_loss(p, g, u, r),
                           lambda p, g, u, r: losses.semantics_loss(p, g, u, r),
                           logits, labels, None, reduction)
    _assert_match(*out, expect_rate=lambda vr: 0.05 < vr < 0.5)
    # int labels of [B, H, W] give the same loss as float [B, H, W, 1]
    t_int, _ = losses.semantics_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels[..., 0].astype(np.uint8)),
                                     reduction=reduction)
    np.testing.assert_array_equal(t_int.numpy(), out[1][0])


def test_semantics_with_an_uncertainty_raises():
    x = torch.zeros(1, 2, 2, 6)
    with pytest.raises(NotImplementedError, match="no uncertainty head"):
        losses.semantics_loss(x, torch.zeros(1, 2, 2, 1), torch.ones(1, 2, 2, 1))


def test_angle_helpers_match_jax():
    """xyz2ae, ae2xyz and logits_to_radian within 1e-6 (float32 atan2,
    trigonometry and norms in another library)."""
    rng = np.random.default_rng(4)
    xyz = _unit(rng, 200).astype(np.float32)
    ae = rng.uniform(-3.0, 3.0, (200, 2)).astype(np.float32)
    logits = rng.normal(size=(200, 2)).astype(np.float32) * 4
    for jf, tf, x in ((jlosses.xyz2ae, losses.xyz2ae, xyz), (jlosses.ae2xyz, losses.ae2xyz, ae),
                      (jlosses.logits_to_radian, losses.logits_to_radian, logits)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)


def _jax_draws(key, B_, cfg):
    """The draws of JAX's augment_batch for `key`, as the port's AugmentDraws
    (the key is split as `crossloc_tpu/data/augment.py::augment_batch` and
    `color_jitter` split it)."""
    k_scale, k_rot, k_jit, k_tr = jax.random.split(key, 4)
    kb, kc = jax.random.split(k_jit)
    u = lambda k, shape, lo, hi: np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    return data.AugmentDraws(
        scale=torch.tensor(u(k_scale, (), cfg.aug_scale_min, cfg.aug_scale_max)),
        angle=torch.tensor(u(k_rot, (), -cfg.aug_rotation, cfg.aug_rotation)),
        translation=torch.tensor(u(k_tr, (2,), -1.0, 1.0)),
        brightness=torch.tensor(u(kb, (B_, 1, 1, 1), 1 - cfg.aug_brightness,
                                  1 + cfg.aug_brightness).reshape(B_)),
        contrast=torch.tensor(u(kc, (B_, 1, 1, 1), 1 - cfg.aug_contrast,
                                1 + cfg.aug_contrast).reshape(B_)),
    )


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_semantics_augmentation_matches_jax_on_its_draws(seed):
    """Labels on the image canvas with the image's own map, 0 outside; the
    port's uint8 labels against JAX's float ones, exactly."""
    img_h, img_w = 32, 48
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (2, img_h, img_w, 3)).astype(np.float32)
    labels = rng.integers(0, 6, (2, img_h, img_w, 1)).astype(np.uint8)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    key = jax.random.PRNGKey(seed)
    jcfg = jdata.AugmentConfig()
    j_img, j_lab, j_pose, j_focal, j_pp = jdata.augment_batch(
        jnp.asarray(images), jnp.asarray(labels.astype(np.float32)), jnp.asarray(poses),
        jnp.float32(40.0), key, jcfg, semantics=True)
    t_img, t_lab, t_pose, t_focal, t_pp = data.augment_batch(
        torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(poses),
        torch.tensor(40.0), _jax_draws(key, 2, jcfg), data.AugmentConfig(), semantics=True)
    assert t_lab.dtype == torch.uint8 and t_lab.shape == (2, img_h, img_w, 1)
    np.testing.assert_array_equal(t_lab.numpy().astype(np.float32), np.asarray(j_lab))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-5)
    np.testing.assert_allclose(t_pp.numpy(), np.asarray(j_pp), atol=1e-6)
    filled = (np.asarray(j_lab) == 0).mean()
    assert filled > (labels == 0).mean()  # zoom-outs and turns fill with 0
