"""The port's pose loss, DSAC expected pose loss and training-mode solver
against the JAX package on JAX's own draws.

A GT-oracle scene (exact scene coordinates from known poses, 0.05 m noise,
20 % far outliers) at 96x144. The port is fed the hypothesis indices the
JAX functions draw, rebuilt from their keys, and in training the winner
JAX sampled. Values and gradients with respect to the scene coordinates
are compared with the tolerances stated at each assertion.
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
# the DSAC step's default solver config
TRAIN_KW = dict(hypotheses=16, sample_rounds=8, train_refine_steps=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(seed, B=2):
    """(coords [B, HS, WS, 3], cam-to-world poses [B, 4, 4]) float32."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(WS) * 8 + 4.0, np.arange(HS) * 8 + 4.0)
    coords, poses = [], []
    for _ in range(B):
        rv = rng.normal(size=3) * 0.5
        th = np.linalg.norm(rv)
        k = rv / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        t = rng.normal(size=3) * 20 + [0, 0, 100.0]
        d = rng.uniform(30.0, 300.0, size=gx.shape)
        cam = np.stack([(gx - IMG_W / 2) / FOCAL * d, (gy - IMG_H / 2) / FOCAL * d, d], -1)
        world = cam @ R.T + t + rng.normal(size=cam.shape) * 0.05
        out = rng.random(gx.shape) < 0.2
        world[out] += rng.uniform(-100, 100, size=(int(out.sum()), 3))
        coords.append(world)
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        poses.append(c2w)
    return np.stack(coords).astype(np.float32), np.stack(poses).astype(np.float32)


def _loss_indices(key, B, cfg):
    """expected_pose_loss's draws: split(key, B), randint(k, (H * R, 4))."""
    return np.stack([np.asarray(jax.random.randint(k, (cfg.hypotheses * cfg.sample_rounds, 4),
                                                   0, N)) for k in jax.random.split(key, B)])


def _solve_indices(key, B, cfg):
    """solve_batch's draws: split(key, B), split per image, randint(k_sample, ...)."""
    return np.stack([np.asarray(jax.random.randint(jax.random.split(k)[0], (
        cfg.hypotheses * cfg.sample_rounds, 4), 0, N)) for k in jax.random.split(key, B)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- pose loss ---------------------------------------------------------------

def _rot(rng, n, scale):
    rv = rng.normal(size=(n, 3)) * scale
    out = []
    for r in rv:
        th = np.linalg.norm(r)
        k = r / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        out.append(np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx)
    return np.stack(out)


def _pose_pairs(case, rng, n=16):
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = _rot(rng, n, 1.0)
    gt[:, :3, 3] = rng.normal(size=(n, 3)) * 50
    est = gt.copy()
    if case != "equal":
        scale = {"random": (0.05, 1.0), "soft_clamp": (0.5, 200.0), "max_loss": (1.0, 1e13)}[case]
        est[:, :3, :3] = _rot(rng, n, scale[0]) @ gt[:, :3, :3]
        est[:, :3, 3] += rng.normal(size=(n, 3)) * scale[1]
    return est.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "equal", "soft_clamp", "max_loss"])
def test_pose_loss_matches_jax(case):
    est, gt = _pose_pairs(case, np.random.default_rng(1))
    w = np.random.default_rng(2).uniform(0.5, 1.5, size=len(est)).astype(np.float32)
    lj, vjp = jax.vjp(lambda e: jransac.pose_loss(e, jnp.asarray(gt)), jnp.asarray(est))
    gj = np.asarray(vjp(jnp.asarray(w))[0])
    e = torch.from_numpy(est).requires_grad_()
    lt = ransac.pose_loss(e, torch.from_numpy(gt))
    lt.backward(torch.from_numpy(w))
    # f32: the angle to 2e-3 deg, the translation to its rounding
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=1e-5, atol=2e-3)
    g = e.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max() + 1e-6)
    if case == "equal":
        assert lt.max() < 1e-2  # sqrt(1e-12) m and the arccos of a rounded 1
    if case == "max_loss":
        assert (lt.detach().numpy() == ransac.PoseLossConfig().max_loss).all()
    if case == "soft_clamp":
        assert (lt.detach().numpy() > 100.0).all()  # square-root clamped


# -- expected pose loss --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_expected_loss():
    cfg = jransac.RansacConfig(unroll=False, **TRAIN_KW)

    def f(coords, gt, pp, key):
        return jransac.expected_pose_loss(coords, gt, FOCAL, (IMG_H, IMG_W), key, cfg,
                                          pp_shift=pp)

    return cfg, jax.jit(jax.value_and_grad(f, has_aux=True))


@pytest.mark.parametrize("seed, pp", [(3, [1.5, -2.25]), (4, [[0.0, 0.0], [-12.0, 30.5]])])
def test_expected_pose_loss_matches_jax(jax_expected_loss, seed, pp):
    jcfg, f = jax_expected_loss
    coords, gt = _scene(seed)
    # a perturbed GT: the refined hypotheses land off it and the loss is positive
    gt[:, :3, 3] += 0.5
    pp = np.asarray(pp, np.float32)
    key = jax.random.PRNGKey(seed)
    (lj, auxj), gj = f(jnp.asarray(coords), jnp.asarray(gt),
                       jnp.broadcast_to(jnp.asarray(pp), (2, 2)), key)
    c = torch.from_numpy(coords).requires_grad_()
    lt, aux = ransac.expected_pose_loss(
        c, torch.from_numpy(gt), FOCAL, (IMG_H, IMG_W), ransac.RansacConfig(**TRAIN_KW),
        pp_shift=torch.from_numpy(pp), idx=torch.from_numpy(_loss_indices(key, 2, jcfg)))
    lt.backward()
    assert aux["hyp_valid"].float().mean() > 0.5 and float(lt) > 0.1
    # the loss per image to f32 rounding of the refinement (1e-4 relative)
    np.testing.assert_allclose(aux["per_image"].detach().numpy(), np.asarray(auxj["per_image"]),
                               rtol=1e-4)
    # dL/dcoords through scores, refinement and P3P: within 1e-3 of its norm
    # (measured 1e-4: the sums of the refinement's 6x6 systems reassociate)
    g = c.grad.numpy()
    assert np.isfinite(g).all()
    assert _rel(g, np.asarray(gj)) < 1e-3, _rel(g, np.asarray(gj))


# DSAC*'s published training settings, the benchmark cell's solver and pose loss
DSACSTAR_KW = dict(hypotheses=64, sample_rounds=8, train_refine_steps=2)


@pytest.fixture(scope="module")
def jax_dsacstar_loss():
    cfg = jransac.RansacConfig(unroll=False, **DSACSTAR_KW)
    loss_cfg = jransac.PoseLossConfig(w_trans=100.0)

    def f(coords, gt, pp, key):
        return jransac.expected_pose_loss(coords, gt, FOCAL, (IMG_H, IMG_W), key, cfg, loss_cfg,
                                          pp_shift=pp)

    return cfg, jax.jit(jax.value_and_grad(f, has_aux=True))


@pytest.mark.parametrize("seed", [3, 4])
def test_expected_pose_loss_at_dsacstar_settings_matches_jax(jax_dsacstar_loss, seed):
    """64 hypotheses x 8 rounds, 2 refinement steps, w_trans 100 (the pose
    loss in degrees and centimetres) on JAX's draws, each image its own
    principal-point shift. Seed 3 leaves 6 hypotheses invalid: the port
    scores and refines them from a valid pose (`guard_invalid`), JAX from
    their own, and JAX's gradient is finite there."""
    jcfg, f = jax_dsacstar_loss
    coords, gt = _scene(seed)
    gt[:, :3, 3] += 0.5
    pp = np.array([[1.5, -2.25], [-12.0, 30.5]], np.float32)
    key = jax.random.PRNGKey(seed)
    (_, auxj), gj = f(jnp.asarray(coords), jnp.asarray(gt), jnp.asarray(pp), key)
    gj = np.asarray(gj)
    c = torch.from_numpy(coords).requires_grad_()
    lt, aux = ransac.expected_pose_loss(
        c, torch.from_numpy(gt), FOCAL, (IMG_H, IMG_W), ransac.RansacConfig(**DSACSTAR_KW),
        ransac.PoseLossConfig(w_trans=100.0), pp_shift=torch.from_numpy(pp),
        idx=torch.from_numpy(_loss_indices(key, 2, jcfg)))
    lt.backward()
    assert np.isfinite(gj).all() and float(lt) > 10.0
    if seed == 3:
        assert int((~aux["hyp_valid"]).sum()) == 6
    # the loss per image within 1e-4 (measured 3.3e-6)
    np.testing.assert_allclose(aux["per_image"].detach().numpy(), np.asarray(auxj["per_image"]),
                               rtol=1e-4)
    # dL/dcoords within 1e-3 of its norm (measured 6.8e-4 on seed 3, where the
    # port's P3P is float64 and JAX's float32; 9.3e-6 on seed 4)
    g = c.grad.numpy()
    assert np.isfinite(g).all()
    assert _rel(g, gj) < 1e-3, _rel(g, gj)


def test_apply_pp_shift_matches_jax():
    cams = np.tile(np.array([[FOCAL, 0, 72.0], [0, FOCAL, 48.0], [0, 0, 1]], np.float32), (3, 1, 1))
    for pp in (np.array([2.5, -1.0], np.float32), np.arange(6, dtype=np.float32).reshape(3, 2)):
        np.testing.assert_array_equal(
            ransac.apply_pp_shift(torch.from_numpy(cams), torch.from_numpy(pp)).numpy(),
            np.asarray(jransac.solver.apply_pp_shift(jnp.asarray(cams), jnp.asarray(pp), 3,
                                                     jnp.float32)))


# -- solve_batch in training mode ------------------------------------------------

def test_solve_batch_training_matches_jax():
    """The JAX draw of the winner is injected as `chosen`; the pose and the
    gradient of <w, pose> with respect to the coordinates agree. JAX runs
    eagerly: its jit rounds one P3P of this scene to another retry round."""
    kw = dict(hypotheses=16, sample_rounds=8, refine_steps=2)
    jcfg = jransac.RansacConfig(**kw)
    coords, _ = _scene(5)
    pp = np.array([3.0, -4.0], np.float32)
    w = np.random.default_rng(6).normal(size=(2, 6)).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def f(c):
        r = jransac.solve_batch(c, FOCAL, (IMG_H, IMG_W), key, jcfg, training=True,
                                pp_shift=jnp.asarray(pp))
        return jnp.sum(r.pose_w2c6 * w), r

    (_, jres), gj = jax.value_and_grad(f, has_aux=True)(jnp.asarray(coords))
    c = torch.from_numpy(coords).requires_grad_()
    tres = ransac.solve_batch(c, FOCAL, (IMG_H, IMG_W), ransac.RansacConfig(**kw),
                              idx=torch.from_numpy(_solve_indices(key, 2, jcfg)), training=True,
                              pp_shift=torch.from_numpy(pp),
                              chosen=torch.from_numpy(np.array(jres.chosen)))
    (tres.pose_w2c6 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(tres.chosen.numpy(), np.asarray(jres.chosen))
    np.testing.assert_array_equal(tres.inlier_count.numpy(), np.asarray(jres.inlier_count))
    np.testing.assert_allclose(tres.scores.detach().numpy(), np.asarray(jres.scores), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(tres.pose_w2c6.detach().numpy(), np.asarray(jres.pose_w2c6),
                               atol=2e-3)
    g = c.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    assert _rel(g, np.asarray(gj)) < 1e-3, _rel(g, np.asarray(gj))


def test_training_draws_come_from_the_softmax():
    """Without `chosen`, the winner is drawn from `probs` by the generator:
    reproducible, and over many draws its frequencies follow `probs`."""
    coords = torch.from_numpy(_scene(7, B=1)[0])
    cfg = ransac.RansacConfig(hypotheses=8, sample_rounds=4, inlier_threshold=200.0,
                              refine_steps=0, polish_iters=0)
    idx = torch.randint(0, N, (1, 32, 4), generator=torch.Generator().manual_seed(0))
    res = ransac.solve_batch(coords, FOCAL, (IMG_H, IMG_W), cfg, idx=idx, training=True,
                             generator=torch.Generator().manual_seed(1))
    again = ransac.solve_batch(coords, FOCAL, (IMG_H, IMG_W), cfg, idx=idx, training=True,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(res.chosen, again.chosen)
    gen = torch.Generator().manual_seed(2)
    draws = [int(ransac.solve_batch(coords, FOCAL, (IMG_H, IMG_W), cfg, idx=idx, training=True,
                                    generator=gen).chosen) for _ in range(200)]
    freq = np.bincount(draws, minlength=8) / 200.0
    assert np.abs(freq - res.probs[0].numpy()).max() < 0.15


def test_eval_mode_is_unchanged():
    """training=False on the same idx: gradient tracking changes no bit, and
    a training solve handed the eval winner refines to the same pose."""
    coords, _ = _scene(8)
    cfg = ransac.RansacConfig(hypotheses=16, sample_rounds=8)
    idx = torch.randint(0, N, (2, 128, 4), generator=torch.Generator().manual_seed(3))
    plain = ransac.solve_batch(torch.from_numpy(coords), FOCAL, (IMG_H, IMG_W), cfg, idx=idx)
    tracked = ransac.solve_batch(torch.from_numpy(coords).requires_grad_(), FOCAL,
                                 (IMG_H, IMG_W), cfg, idx=idx)
    for a, b in zip(plain, tracked):
        assert torch.equal(a, b.detach())
    drawn = ransac.solve_batch(torch.from_numpy(coords), FOCAL, (IMG_H, IMG_W), cfg, idx=idx,
                               training=True, chosen=plain.chosen)
    assert torch.equal(drawn.pose_w2c6, plain.pose_w2c6)
