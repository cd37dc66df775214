"""The port's weighted Kabsch and RGB-D solver against the JAX package.

Kabsch values and gradients (through the SVD, with the gradient firewall
on its inputs: a minimal set of duplicate points gives zero, not NaN);
`solve_rgbd` in eval and training mode and `expected_pose_loss_rgbd` on
JAX's own draws, rebuilt from its keys, with the training winner injected.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import geometry as jgeo
from crossloc_tpu import ransac as jransac
from crossloc_tpu.ransac import rgbd as jrgbd
from crossloc_tpu_torch import geometry, ransac

HS, WS = 12, 18
N = HS * WS
KW = dict(hypotheses=16, sample_rounds=8, refine_steps=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rot(rng, scale):
    rv = rng.normal(size=3) * scale
    th = np.linalg.norm(rv)
    k = rv / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _scene(seed, B=2):
    """(scene coords, camera coords, valid mask, cam-to-world) for B frames:
    camera points at 5-50 m with 2 cm noise, 15 % far outliers in the scene
    coordinates, 10 % of the pixels without depth (camera coordinate 0)."""
    rng = np.random.default_rng(seed)
    obj, eye, valid, poses = [], [], [], []
    for _ in range(B):
        R, t = _rot(rng, 0.6), rng.normal(size=3) * 5
        cam = rng.uniform([-10, -10, 5], [10, 10, 50], size=(N, 3))
        world = (cam - t) @ R  # x_cam = R x_world + t
        out = rng.random(N) < 0.15
        world[out] += rng.uniform(-5, 5, size=(int(out.sum()), 3))
        cam = cam + rng.normal(size=cam.shape) * 0.02
        v = rng.random(N) > 0.1
        cam[~v] = 0.0
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R.T, -R.T @ t
        obj.append(world.reshape(HS, WS, 3))
        eye.append(cam.reshape(HS, WS, 3))
        valid.append(v.reshape(HS, WS))
        poses.append(c2w)
    f32 = lambda a: np.stack(a).astype(np.float32)
    return f32(obj), f32(eye), np.stack(valid), f32(poses)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_kabsch_matches_jax_values_and_gradients():
    rng = np.random.default_rng(0)
    M, n = 64, 7
    src = rng.normal(size=(M, n, 3)).astype(np.float32) * 5
    R = np.stack([_rot(rng, 1.0) for _ in range(M)])
    dst = (np.einsum("mij,mnj->mni", R, src) + rng.normal(size=(M, 1, 3)) * 3
           + rng.normal(size=src.shape) * 0.05).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(M, n)).astype(np.float32)
    gR = rng.normal(size=(M, 3, 3)).astype(np.float32)
    gt = rng.normal(size=(M, 3)).astype(np.float32)
    (Rj, tj), vjp = jax.vjp(jgeo.kabsch, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    gj = [np.asarray(g) for g in vjp((jnp.asarray(gR), jnp.asarray(gt)))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (src, dst, w)]
    Rt, tt = geometry.kabsch(*ts)
    ((Rt * torch.from_numpy(gR)).sum() + (tt * torch.from_numpy(gt)).sum()).backward()
    # f32 SVDs of two libraries: the rotation to 1e-5, the translation to
    # 1e-4 of its 5-10 m, the gradients within 1e-4 of their norm
    np.testing.assert_allclose(Rt.detach().numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(tj), atol=1e-4)
    for name, a, b in zip(("src", "dst", "weights"), ts, gj):
        assert _rel(a.grad.numpy(), b) < 1e-4, (name, _rel(a.grad.numpy(), b))


def test_kabsch_of_duplicate_points_gives_zero_gradient():
    """A minimal set whose three points coincide: the SVD's backward is not
    finite there, and both firewalls give exactly zero."""
    rng = np.random.default_rng(1)
    src = rng.normal(size=(4, 3, 3)).astype(np.float32)
    src[0] = src[0, 0]  # three identical points
    src[1, 1] = src[1, 0]  # two identical points
    dst = src @ _rot(rng, 0.5).T.astype(np.float32) + 1.0
    gR = rng.normal(size=(4, 3, 3)).astype(np.float32)
    (Rj, _), vjp = jax.vjp(lambda s, d: jgeo.kabsch(s, d), jnp.asarray(src), jnp.asarray(dst))
    gj = vjp((jnp.asarray(gR), jnp.zeros((4, 3))))
    s, d = torch.from_numpy(src).requires_grad_(), torch.from_numpy(dst).requires_grad_()
    Rt, _ = geometry.kabsch(s, d)
    (Rt * torch.from_numpy(gR)).sum().backward()
    for a, b in ((s, gj[0]), (d, gj[1])):
        g = a.grad.numpy()
        assert np.isfinite(g).all()
        assert not g[0].any() and not np.asarray(b)[0].any()
    np.testing.assert_allclose(s.grad.numpy()[2:], np.asarray(gj[0])[2:], rtol=1e-3, atol=1e-4)


def _solve_indices(key, B, cfg):
    """solve_rgbd's draws: split(key, B), split per image, randint(k_sample, (H, R, 3))."""
    return np.stack([np.asarray(jax.random.randint(jax.random.split(k)[0], (
        cfg.hypotheses, cfg.sample_rounds, 3), 0, N)) for k in jax.random.split(key, B)])


@pytest.mark.parametrize("training", [False, True])
def test_solve_rgbd_matches_jax(training):
    obj, eye, valid, gt = _scene(2)
    jcfg, cfg = jransac.RansacConfig(**KW), ransac.RansacConfig(**KW)
    key = jax.random.PRNGKey(4)
    jres = jransac.solve_rgbd(jnp.asarray(obj), jnp.asarray(eye), jnp.asarray(valid), key, jcfg,
                              training=training)
    tres = ransac.solve_rgbd(torch.from_numpy(obj), torch.from_numpy(eye),
                             torch.from_numpy(valid), cfg, training=training,
                             idx=torch.from_numpy(_solve_indices(key, 2, jcfg)),
                             chosen=torch.from_numpy(np.array(jres.chosen)))
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(tres.chosen.numpy(), np.asarray(jres.chosen))
    np.testing.assert_array_equal(tres.inlier_count.numpy(), np.asarray(jres.inlier_count))
    # soft scores in [0, 100] of hypotheses from 3-point SVDs in two
    # libraries: within 1e-3 relative (measured 2e-4)
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-3, atol=1e-3)
    # the softmax of scores near 70 multiplies their rounding: 1e-2 relative
    np.testing.assert_allclose(tres.probs.numpy(), np.asarray(jres.probs), rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(tres.cam_to_world.numpy(), np.asarray(jres.cam_to_world),
                               atol=1e-4)
    # the measured frames: within 5 cm of the ground truth
    assert np.abs(tres.cam_to_world.numpy()[:, :3, 3] - gt[:, :3, 3]).max() < 0.05


def _expected_losses(monkeypatch, dtype, per_hypothesis_firewall):
    """(JAX loss, JAX gradient, port loss, port gradient) of the expected
    RGB-D loss on scene 3 at JAX's draws, in `dtype`. With
    `per_hypothesis_firewall`, JAX's refinement gets the image's points
    broadcast per hypothesis (a zero that depends on the hypothesis), so its
    Kabsch firewall sanitizes each hypothesis' cotangent, as the port's does
    (ROADMAP R10)."""
    obj, eye, valid, gt = _scene(3)
    gt[:, :3, 3] += 0.3  # off the refined poses: a positive loss
    jcfg = jransac.RansacConfig(**KW)
    key = jax.random.PRNGKey(5)
    if per_hypothesis_firewall:
        refine = jrgbd._kabsch_refine
        monkeypatch.setattr(jrgbd, "_kabsch_refine", lambda R, t, o, *a: refine(
            R, t, o + 0.0 * jax.lax.stop_gradient(R[0, 0]), *a))
    idx = torch.from_numpy(np.stack([np.asarray(jax.random.randint(
        k, (jcfg.hypotheses, jcfg.sample_rounds, 3), 0, N)) for k in jax.random.split(key, 2)]))
    with jax.enable_x64(dtype == np.float64):
        lj, gj = jax.value_and_grad(lambda o: jrgbd.expected_pose_loss_rgbd(
            o, jnp.asarray(eye, dtype), jnp.asarray(valid), jnp.asarray(gt, dtype), key,
            jcfg))(jnp.asarray(obj, dtype))
        lj, gj = float(lj), np.asarray(gj)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    o = torch.tensor(obj, dtype=tdt, requires_grad=True)
    lt = ransac.expected_pose_loss_rgbd(o, torch.tensor(eye, dtype=tdt), torch.from_numpy(valid),
                                        torch.tensor(gt, dtype=tdt), ransac.RansacConfig(**KW),
                                        idx=idx)
    lt.backward()
    assert np.isfinite(o.grad.numpy()).all() and float(lt) > 0.1
    return lj, gj, float(lt), o.grad.numpy()


def test_expected_pose_loss_rgbd_matches_jax(monkeypatch):
    """In float64 the two agree to 1e-9 (value) and 1e-6 (gradient), with
    JAX's firewall per hypothesis (R10). In float32 the softmax of scores
    near 70 amplifies the SVDs' rounding: the f32 loss sits about 2 % from
    the f64 one in each package, so the port's f32 value is held within
    twice the JAX f32's distance from float64."""
    lj, gj, lt, g = _expected_losses(monkeypatch, np.float64, True)
    np.testing.assert_allclose(lt, lj, rtol=1e-9)
    assert _rel(g, gj) < 1e-6, _rel(g, gj)
    lj32, _, lt32, _ = _expected_losses(monkeypatch, np.float32, True)
    assert abs(lt32 - lj32) <= 2 * abs(lj32 - lj), (lt32, lj32, lj)


def test_jax_rgbd_loss_drops_a_frame_s_gradient_r10(monkeypatch):
    """ROADMAP R10. JAX's refinement runs under a vmap over hypotheses with
    the image's points unbatched, so its Kabsch firewall sanitizes the
    cotangent summed over the hypotheses: the 0 * inf of one degenerate
    refinement's SVD backward turns every entry NaN and the firewall zeroes
    the frame's whole refinement gradient. Frame 1 of this scene: JAX's
    gradient is 0 to rounding, the port's is not; the values agree."""
    lj, gj, lt, g = _expected_losses(monkeypatch, np.float64, False)
    np.testing.assert_allclose(lt, lj, rtol=1e-9)
    assert np.abs(gj[1]).max() < 1e-12 < 1e-3 < np.abs(g[1]).max()
    np.testing.assert_allclose(g[0], gj[0], rtol=1e-6, atol=1e-12)
