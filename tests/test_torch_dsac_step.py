"""The port's DSAC training step against the JAX package's.

One `make_dsac_train_step` update on a tiny coord + MLE net with the JAX
net's weights (`state_dict_from_flax`), the same batch (with a
principal-point shift) and JAX's own hypothesis draws: the expected pose
loss, the gradient norm and every parameter gradient. The solver config
is the JAX test's permissive one (tau 5000 px), under which an untrained
net has valid hypotheses and a positive loss.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import models as jmodels
from crossloc_tpu import ransac as jransac
from crossloc_tpu import train as jtrain
from crossloc_tpu_torch import compat, models, ransac
from crossloc_tpu_torch.train import TrainBatch, TrainState, make_dsac_train_step, make_optimizer

IMG_H, IMG_W, FOCAL = 48, 64, 50.0
MEAN = [1.0, -2.0, 30.0]
CFG = dict(hypotheses=8, sample_rounds=4, train_refine_steps=1, refine_steps=2, gn_iters=1,
           inlier_threshold=5000.0, max_pixel_error=10000.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(B=2):
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    poses[:, :3, 3] = np.asarray(MEAN) - [0.0, 0.0, 30.0] + rng.normal(size=(B, 3))
    return dict(images=rng.normal(size=(B, IMG_H, IMG_W, 3)).astype(np.float32), poses=poses,
                labels=np.zeros((B, IMG_H // 8, IMG_W // 8, 3), np.float32),
                focal=np.float32(FOCAL), pp_shift=np.array([1.5, -2.25], np.float32))


@pytest.fixture(scope="module")
def jax_step():
    """(params, loss, grads, metrics of the JAX step) on the fixed batch and key."""
    jnet = jmodels.build_network("coord", "MLE", tiny=True, mean=MEAN)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"]
    b = _batch()
    jb = jtrain.TrainBatch(*(jnp.asarray(b[k])
                             for k in ("images", "poses", "labels", "focal", "pp_shift")))
    cfg = jransac.RansacConfig(unroll=False, **CFG)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):  # train/dsac_step.py's loss_fn
        coords = jnet.apply({"params": p}, jb.images)[..., :3].astype(jnp.float32)
        return jransac.expected_pose_loss(coords, jb.poses, FOCAL, (IMG_H, IMG_W), key, cfg,
                                          pp_shift=jb.pp_shift)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jtrain.make_optimizer(2e-4, steps_per_epoch=1)
    state = jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    _, metrics = jax.jit(jtrain.make_dsac_train_step(jnet, tx, cfg))(state, jb, key)
    idx = np.stack([np.asarray(jax.random.randint(k, (cfg.hypotheses * cfg.sample_rounds, 4), 0,
                                                  (IMG_H // 8) * (IMG_W // 8)))
                    for k in jax.random.split(key, 2)])
    return params, float(loss), grads, metrics, idx


def _port(params, dtype=torch.float32):
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    net.load_state_dict(compat.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params), net), strict=True)
    if dtype == torch.float64:
        net.double().dtype = torch.float64
    return net


def _port_step(params, idx, dtype=torch.float32):
    """(metrics, {name: gradient}) of one port step in `dtype`."""
    net = _port(params, dtype)  # a float64 net outputs float64: the solver runs in float64
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4, steps_per_epoch=1))
    b = _batch()
    m = make_dsac_train_step(net, ransac.RansacConfig(**CFG))(
        state, TrainBatch(*(torch.from_numpy(np.asarray(b[k])).to(dtype)
                            for k in ("images", "poses", "labels", "focal", "pp_shift"))),
        idx=torch.from_numpy(idx))
    assert state.step == 1
    return m, {k: p.grad.double().numpy() for k, p in net.named_parameters()}


def test_dsac_step_matches_jax(jax_step):
    """The loss to 1e-4. The gradients: a random net's coordinates make an
    ill-conditioned solve, and the f32 gradient sits 2.5-3 % from float64 in
    both packages (JAX's own jit and eager runs differ by 1.8 %). So, as on
    the card, the yardstick is f32 rounding: per tensor, the port within
    1e-3 of the JAX gradient's norm plus twice the larger of the port's and
    JAX's f32 distance from the port's float64 gradient, plus 1e-6 of the
    global norm (stem1's conv bias and the uncertainty channel have true
    gradients of 0)."""
    params, loss, grads, metrics, idx = jax_step
    m, g32 = _port_step(params, idx)
    m64, g64 = _port_step(params, idx, torch.float64)
    assert int(m["nonfinite"]) == 0 and float(m["valid_share"]) > 0.5 and loss > 0.0
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-4)
    np.testing.assert_allclose(float(m["loss"]), float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m64["loss"]), loss, rtol=1e-4)
    n32, nj, n64 = float(m["grad_norm"]), float(metrics["grad_norm"]), float(m64["grad_norm"])
    assert abs(n32 - nj) <= 2 * max(abs(n32 - n64), abs(nj - n64)) + 1e-4 * n64
    j_by_key = compat.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads), _port(params))
    assert set(g32) == set(j_by_key) - {"mean", "decoder.mean"}
    over = []
    for name, g in g32.items():
        ref = j_by_key[name].numpy().astype(np.float64)
        yard = max(np.linalg.norm(g - g64[name]), np.linalg.norm(ref - g64[name]))
        err = np.linalg.norm(g - ref)
        if err > 1e-3 * np.linalg.norm(ref) + 2 * yard + 1e-6 * n64:
            over.append((name, err, yard, np.linalg.norm(ref)))
    assert not over, over


def test_subsample_mismatch_is_refused_like_jax():
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    cfg = ransac.RansacConfig(subsample=8)
    with pytest.raises(ValueError, match="conflicts with subsample=1") as port:
        make_dsac_train_step(net, cfg, subsample=1)
    with pytest.raises(ValueError) as ref:
        jtrain.make_dsac_train_step(None, None, jransac.RansacConfig(subsample=8), subsample=1)
    assert str(port.value) == str(ref.value)


def test_nonfinite_gradients_are_zeroed_before_adam(jax_step, monkeypatch):
    """A NaN reaching one coordinate's gradient: the entries it poisons are
    counted and set to 0, the norm stays finite and the weights finite."""
    from crossloc_tpu_torch.train import dsac_step

    loss_fn = dsac_step.expected_pose_loss

    def poisoned(coords, *a, **k):
        loss, aux = loss_fn(coords, *a, **k)
        return loss + (coords[0, 0, 0, 0] * torch.tensor(float("nan"))).clamp(0, 0), aux

    monkeypatch.setattr(dsac_step, "expected_pose_loss", poisoned)
    m, grads = _port_step(jax_step[0], jax_step[4])
    assert int(m["nonfinite"]) > 0 and np.isfinite(float(m["grad_norm"]))
    assert all(np.isfinite(g).all() for g in grads.values())


def test_solver_backward_runs_without_tf32(jax_step, monkeypatch):
    """The caller's TF32 flag on: the solver's forward and backward both run
    with it off (float32 means float32 inside the solver), and the flag is
    the caller's again after the step."""
    from crossloc_tpu_torch.train import dsac_step

    loss_fn, seen = dsac_step.expected_pose_loss, []

    def watched(coords, *a, **k):
        seen.append(("forward", torch.backends.cuda.matmul.allow_tf32))
        coords.register_hook(
            lambda g: seen.append(("backward", torch.backends.cuda.matmul.allow_tf32)))
        return loss_fn(coords, *a, **k)

    monkeypatch.setattr(dsac_step, "expected_pose_loss", watched)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _port_step(jax_step[0], jax_step[4])
        after = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert after is True
    assert seen == [("forward", True), ("backward", False)]
