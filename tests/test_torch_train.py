"""The port's training step, optimizer, schedule and checkpoints against the
JAX package's.

One `train_step` on a tiny net from identical weights (`state_dict_from_flax`)
and an identical batch against `make_train_step`: loss, valid rate and
gradient norm within rtol 1e-4, every gradient tensor within 1e-4 of its
norm plus 1e-6 of the global norm (f32 convs through 20 layers, sums in
another order; the allowance covers stem1's conv bias, whose true gradient
is zero). torch Adam with
the port's schedule against optax over 120 steps crossing both milestones,
to 1e-6. The full-state file continues exactly like an uninterrupted run.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import geometry as jgeo
from crossloc_tpu import models as jmodels
from crossloc_tpu import train as jtrain
from crossloc_tpu_torch import compat, models
from crossloc_tpu_torch.train import (
    CheckpointManager,
    TrainBatch,
    TrainState,
    load_train_state,
    make_optimizer,
    multistep_lr,
    save_train_state,
    train_step,
)

IMG_H, IMG_W, FOCAL = 48, 64, 50.0
MEAN = [1.0, -2.0, 30.0]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, B=2):
    """Normalised-looking images, poses, exact coordinates near MEAN, a focal
    and a principal-point shift: numpy arrays for both packages."""
    rng = np.random.default_rng(seed)
    h, w = IMG_H // 8, IMG_W // 8
    K = np.asarray(jgeo.intrinsics(FOCAL, IMG_W, IMG_H), np.float64)
    grid = np.asarray(jgeo.pixel_grid(h, w, 8), np.float64).reshape(-1, 2)
    poses, coords = [], []
    for _ in range(B):
        R = np.asarray(jgeo.rodrigues(jnp.asarray(rng.normal(size=3) * 0.1)), np.float64)
        t = np.asarray(MEAN) - R @ np.array([0.0, 0.0, 30.0]) + rng.normal(size=3)
        depth = rng.uniform(20.0, 40.0, size=grid.shape[0])
        cam = np.stack([(grid[:, 0] - K[0, 2]) / K[0, 0] * depth,
                        (grid[:, 1] - K[1, 2]) / K[1, 1] * depth, depth], -1)
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        poses.append(c2w)
        coords.append((cam @ R.T + t).reshape(h, w, 3))
    coords = np.stack(coords).astype(np.float32)
    coords[0, 1, 1] = -1.0  # a nodata cell
    return dict(images=rng.normal(size=(B, IMG_H, IMG_W, 3)).astype(np.float32),
                poses=np.stack(poses).astype(np.float32), labels=coords,
                focal=np.float32(FOCAL), pp_shift=np.array([1.5, -2.25], np.float32))


@pytest.fixture(scope="module")
def jax_net_and_params():
    jnet = jmodels.build_network("coord", "MLE", tiny=True, mean=MEAN)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"]
    return jnet, params


def _port_model(jnet_params):
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    params_np = jax.tree_util.tree_map(np.asarray, jnet_params)
    net.load_state_dict(compat.state_dict_from_flax(params_np, net), strict=True)
    return net


def _port_batch(b):
    return TrainBatch(*(torch.from_numpy(np.asarray(b[k]))
                        for k in ("images", "poses", "labels", "focal", "pp_shift")))


def test_train_step_matches_jax(jax_net_and_params):
    jnet, params = jax_net_and_params
    b = _batch()
    jbatch = jtrain.TrainBatch(*(jnp.asarray(b[k])
                                 for k in ("images", "poses", "labels", "focal", "pp_shift")))

    def loss_fn(p):
        preds = jnet.apply({"params": p}, jbatch.images)
        return jtrain.task_loss_fn("coord", preds, jbatch, "MLE", 3)

    (_, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jtrain.make_optimizer(2e-4, steps_per_epoch=1)
    jstate = jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    _, j_metrics = jax.jit(jtrain.make_train_step(jnet, tx, "coord", "MLE"))(jstate, jbatch)

    net = _port_model(params)
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4, steps_per_epoch=1))
    metrics = train_step(state, _port_batch(b), "coord", "MLE")
    assert state.step == 1
    for k in ("loss", "valid_rate", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-4, err_msg=k)

    grads_np = jax.tree_util.tree_map(np.asarray, j_grads)
    j_by_key = compat.state_dict_from_flax(grads_np, net)
    named = dict(net.named_parameters())
    assert set(named) == set(j_by_key) - {"mean", "decoder.mean"}
    # 1e-4 of each tensor's norm, plus 1e-6 of the global norm for the conv
    # biases whose true gradient is zero (a GroupNorm of one channel per
    # group removes them), where rounding alone is left on both sides
    total = float(j_metrics["grad_norm"])
    for name, p in named.items():
        ref = j_by_key[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref)
        assert err <= 1e-4 * np.linalg.norm(ref) + 1e-6 * total, (name, err, np.linalg.norm(ref))


def test_grad_clip_scales_like_optax(jax_net_and_params):
    """clip_by_global_norm: the gradients reach Adam scaled to the clip; the
    reported norm is the unclipped one."""
    net = _port_model(jax_net_and_params[1])
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4, grad_clip=1e-3))
    metrics = train_step(state, _port_batch(_batch()), "coord", "MLE")
    clipped = torch.sqrt(sum(p.grad.square().sum() for p in net.parameters()))
    assert float(metrics["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(clipped), 1e-3, rtol=1e-5)


def test_adam_and_schedule_match_optax_across_milestones():
    """120 updates of fixed pseudo-gradients with steps_per_epoch=1: the LR
    halves at updates 50 and 100 in both, and the parameters agree to 1e-6."""
    rng = np.random.default_rng(5)
    init = [rng.normal(size=s).astype(np.float32) for s in ((7, 3), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * (k % 7 + 1) for p in init]
             for k in range(120)]

    tx = jtrain.make_optimizer(2e-4, steps_per_epoch=1)
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = make_optimizer(params, 2e-4, steps_per_epoch=1)
    sched = jtrain.multistep_lr(2e-4, steps_per_epoch=1)
    for k in range(120):
        upd, jstate = tx.update([jnp.asarray(g) for g in grads[k]], jstate, jparams)
        jparams = [p + u for p, u in zip(jparams, upd)]
        for p, g in zip(params, grads[k]):
            p.grad = torch.from_numpy(g)
        for group in opt.adam.param_groups:
            group["lr"] = opt.schedule(k)
        opt.adam.step()
        assert opt.schedule(k) == pytest.approx(float(sched(k)), rel=1e-6)
        for p, j in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-6)
    assert [opt.schedule(k) for k in (49, 50, 99, 100)] == [2e-4, 1e-4, 1e-4, 5e-5]
    assert multistep_lr(2e-4, 10, enabled=False)(10**6) == 2e-4


def test_log_parse_resume_restarts_the_jax_schedule_but_not_the_port_s():
    """ROADMAP R5. The JAX CLI's log-parse resume sets only TrainState.step;
    optax's own count stays 0, so the first update after resuming at epoch 60
    runs at the base LR. The port's LR follows the step: half of it."""
    tx = jtrain.make_optimizer(2e-4, steps_per_epoch=1)
    params = {"w": jnp.ones(4)}
    state = jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    state = state._replace(step=jnp.asarray(60, jnp.int32))  # cli/train_single_task.py:396
    upd, _ = tx.update({"w": jnp.full(4, 0.3)}, state.opt_state, state.params)
    np.testing.assert_allclose(-np.asarray(upd["w"]), 2e-4, rtol=1e-3)  # Adam: lr * sign(g)

    w = torch.nn.Parameter(torch.ones(4))
    port = TrainState(torch.nn.Module(), make_optimizer([w], 2e-4, steps_per_epoch=1), step=60)
    w.grad = torch.full((4,), 0.3)
    for group in port.optimizer.adam.param_groups:
        group["lr"] = port.optimizer.schedule(port.step)
    port.optimizer.adam.step()
    np.testing.assert_allclose(1.0 - w.detach().numpy(), 1e-4, rtol=1e-3)


def test_state_file_continues_exactly(jax_net_and_params, tmp_path):
    """Two steps, save, two more; a fresh state loaded from the file takes
    the same two steps to the same bits."""
    b = _port_batch(_batch(seed=2))
    net = _port_model(jax_net_and_params[1])
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4, steps_per_epoch=1))
    for _ in range(2):
        train_step(state, b, "coord", "MLE")
    path = save_train_state(str(tmp_path / "s"), state)
    assert path.endswith("s.state")
    for _ in range(2):
        train_step(state, b, "coord", "MLE")

    net2 = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    other = TrainState(net2, make_optimizer(net2.parameters(), 2e-4, steps_per_epoch=1))
    load_train_state(path, other)
    assert other.step == 2
    for _ in range(2):
        train_step(other, b, "coord", "MLE")
    for (k, a), (_, r) in zip(net.state_dict().items(), net2.state_dict().items()):
        assert torch.equal(a, r), k


def test_checkpoint_manager_keeps_the_newest_five(tmp_path):
    net = models.build_network("coord", "MLE", tiny=True)
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(state) is None
    for step in range(1, 8):
        state.step = step
        mgr.save(state)
        mgr.save(state)  # once per step
    assert mgr.all_steps() == [3, 4, 5, 6, 7]
    assert sorted(p.name for p in tmp_path.iterdir())[0] == "state_000000003.state"
    state.step = 0
    assert mgr.restore_latest(state).step == 7
    # the orbax backend: torch.distributed.checkpoint directories <dir>/<step>/
    dcp = CheckpointManager(str(tmp_path / "dcp"), backend="orbax")
    dcp.save(state)
    assert dcp.all_steps() == [7] and (tmp_path / "dcp" / "7" / ".metadata").exists()
    other_net = models.build_network("coord", "MLE", tiny=True)
    other = TrainState(other_net, make_optimizer(other_net.parameters(), 2e-4))
    assert dcp.restore_latest(other).step == 7
    for (k, a), (_, r) in zip(net.state_dict().items(), other.model.state_dict().items()):
        assert torch.equal(a, r), k


def test_tasks_other_than_coord_raise(jax_net_and_params):
    """Beyond the four tasks a step raises, and so does semantics with an
    uncertainty channel (as in the JAX package)."""
    net = _port_model(jax_net_and_params[1])
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4))
    with pytest.raises(NotImplementedError, match="task=pose"):
        train_step(state, _port_batch(_batch()), "pose", None)
    with pytest.raises(NotImplementedError, match="no uncertainty head"):
        train_step(state, _port_batch(_batch()), "semantics", "MLE")
