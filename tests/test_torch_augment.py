"""The port's device augmentation against the JAX package's, on JAX's own draws.

The test splits the key as `crossloc_tpu/data/augment.py::augment_batch` and
`color_jitter` do, draws the same uniforms, and hands them to the port.
Tolerances: images atol 1e-5 (float32 means and corner sums in another
order); labels, poses, focal and the principal-point shift 1e-6. Beside it,
the geometric invariant: a world point seen at an input pixel projects under
the augmented camera onto the affine image of that pixel.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import data as jdata
from crossloc_tpu_torch import data, geometry, losses
from crossloc_tpu_torch.data import AugmentConfig, AugmentDraws, augment_batch

H, W = 48, 72


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_draws(key, B, cfg):
    """The draws of JAX's augment_batch for `key`, as the port's AugmentDraws."""
    k_scale, k_rot, k_jit, k_tr = jax.random.split(key, 4)
    kb, kc = jax.random.split(k_jit)
    u = lambda k, shape, lo, hi: np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    return AugmentDraws(
        scale=torch.tensor(u(k_scale, (), cfg.aug_scale_min, cfg.aug_scale_max)),
        angle=torch.tensor(u(k_rot, (), -cfg.aug_rotation, cfg.aug_rotation)),
        translation=torch.tensor(u(k_tr, (2,), -1.0, 1.0)),
        brightness=torch.tensor(u(kb, (B, 1, 1, 1), 1 - cfg.aug_brightness,
                                  1 + cfg.aug_brightness).reshape(B)),
        contrast=torch.tensor(u(kc, (B, 1, 1, 1), 1 - cfg.aug_contrast,
                                1 + cfg.aug_contrast).reshape(B)),
    )


def _batch(seed, B=3):
    rng = np.random.default_rng(seed)
    samples = [jdata.synth_sample(rng, img_h=H, img_w=W, focal=60.0) for _ in range(B)]
    images = np.stack([s["image"] for s in samples])
    labels = np.stack([s["coord"] for s in samples])
    labels[0, 2, 3] = -1.0
    poses = np.stack([s["pose"] for s in samples])
    return images, labels, poses, np.float32(60.0)


@pytest.mark.parametrize("grayscale", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_batch_matches_jax_on_its_draws(seed, grayscale):
    images, labels, poses, focal = _batch(seed)
    cfg_j = jdata.AugmentConfig(grayscale=grayscale)
    cfg = AugmentConfig(grayscale=grayscale)
    key = jax.random.PRNGKey(100 + seed)
    j_out = jdata.augment_batch(jnp.asarray(images), jnp.asarray(labels), jnp.asarray(poses),
                                jnp.asarray(focal), key, cfg_j)
    t_out = augment_batch(torch.from_numpy(images), torch.from_numpy(labels),
                          torch.from_numpy(poses), torch.tensor(focal),
                          _jax_draws(key, images.shape[0], cfg), cfg)
    j_img, j_lab, j_pose, j_focal, j_pp = (np.asarray(a) for a in j_out)
    t_img, t_lab, t_pose, t_focal, t_pp = (a.numpy() for a in t_out)
    assert t_img.shape == j_img.shape == (3, H, W, 1 if grayscale else 3)
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_lab, j_lab, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_pose, j_pose, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_focal, j_focal, rtol=1e-6)
    np.testing.assert_allclose(t_pp, j_pp, rtol=1e-6, atol=1e-6)


def test_draws_lie_in_their_ranges():
    cfg = AugmentConfig()
    d = data.draw_augmentation(torch.Generator().manual_seed(0), 64, cfg)
    assert cfg.aug_scale_min <= float(d.scale) <= cfg.aug_scale_max
    assert abs(float(d.angle)) <= cfg.aug_rotation
    assert float(d.translation.abs().max()) <= 1.0
    assert d.brightness.shape == d.contrast.shape == (64,)
    assert float((d.brightness - 1).abs().max()) <= 0.1
    assert float((d.contrast - 1).abs().max()) <= 0.1


@pytest.mark.parametrize("seed", range(4))
def test_augmented_pose_and_camera_reproject_exactly(seed):
    """A world point seen at input pixel p projects, under the augmented pose,
    focal and principal-point shift, onto the forward affine image of p
    (out = C + s R(-theta)(in - C - t)), translation included."""
    rng = np.random.default_rng(seed)
    s = jdata.synth_sample(rng, img_h=192, img_w=256, focal=200.0)
    Hb, Wb = 192, 256
    cfg = AugmentConfig(aug_scale_min=1.05)
    d = data.draw_augmentation(torch.Generator().manual_seed(seed), 1, cfg)
    img = torch.zeros(1, Hb, Wb, 3)
    _, _, pose_aug, focal_aug, pp = augment_batch(
        img, torch.from_numpy(s["coord"][None]), torch.from_numpy(s["pose"][None]),
        torch.tensor(s["focal"]), d, cfg)
    scale, rad = float(d.scale), np.deg2rad(float(d.angle))
    t = d.translation.numpy() * np.array([(Wb - 1) / 2, (Hb - 1) / 2]) * (1 - 1 / scale)
    c = np.array([(Wb - 1) / 2, (Hb - 1) / 2])
    rot = np.array([[np.cos(rad), np.sin(rad)], [-np.sin(rad), np.cos(rad)]])
    for (i, j) in ((5, 7), (12, 20), (20, 3)):
        p_in = np.array([j * 8 + 4, i * 8 + 4], np.float64)
        p_out = c + scale * (rot @ ((p_in - 0.5) - c - t)) + 0.5  # pixel centres: index + 0.5
        K = geometry.intrinsics(float(focal_aug), Wb, Hb).double().numpy()
        K[0, 2] += float(pp[0])
        K[1, 2] += float(pp[1])
        w2c = geometry.invert_se3(pose_aug[0].double()).numpy()
        Xc = w2c[:3, :3] @ s["coord"][i, j].astype(np.float64) + w2c[:3, 3]
        proj = K @ Xc
        np.testing.assert_allclose(proj[:2] / proj[2], p_out, atol=0.05)


def test_augmented_labels_reproject_within_a_cell():
    """The coord loss of augmented labels against themselves under the
    augmented camera stays within nearest-resampling quantisation (under
    half a cell's diagonal, 8 px cells)."""
    rng = np.random.default_rng(7)
    s = jdata.synth_sample(rng, img_h=192, img_w=256, focal=200.0)
    B = 2
    labels = torch.from_numpy(np.stack([s["coord"]] * B))
    poses = torch.from_numpy(np.stack([s["pose"]] * B))
    for seed in range(4):
        d = data.draw_augmentation(torch.Generator().manual_seed(seed), B, AugmentConfig())
        _, lab, pose, focal, pp = augment_batch(torch.zeros(B, 192, 256, 3), labels, poses,
                                                torch.tensor(s["focal"]), d)
        K = geometry.intrinsics(float(focal), 256, 192)
        K[0, 2] += pp[0]
        K[1, 2] += pp[1]
        loss, valid = losses.scene_coords_loss(lab, lab, pose, K)
        assert float(loss) < 8.0 and float(valid) > 0.3, (seed, float(loss))


def test_zoom_out_fills_outside():
    images = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    cfg = AugmentConfig(aug_scale_min=0.5, aug_scale_max=0.51)
    d = data.draw_augmentation(torch.Generator().manual_seed(1), 1, cfg)
    img, lab, _, _, _ = augment_batch(images, torch.ones(1, 8, 8, 3), torch.eye(4)[None],
                                      torch.tensor(100.0), d, cfg)
    assert img[0, 0, 0].tolist() == [-1.0] * 3
    assert lab[0, 0, 0].tolist() == [-1.0] * 3
