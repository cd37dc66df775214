"""Data-parallel and ZeRO training steps of the port against the port's
single-process step and the JAX package's data-parallel step.

Two CPU ranks (gloo, `tools/parallel_check.py`) take one gradient and three
Adam steps of the tiny coord + MLE net, carried over from the JAX net's
weights by `state_dict_from_flax`, on their halves of a global batch of 4.
JAX runs the same global batch on a 2-device slice of the virtual CPU mesh
(`make_mesh(data=2)`, `replicate` or `shard_params(axis="data")`, the batch
on "data"; the pattern of `tests/test_train.py::TestShardingEquivalence`).
The yardsticks are JAX's own there: gradients to rtol 1e-5 plus 1e-5 of
max|g|, parameters to 2e-4 per step. Rank 1's half holds no valid pixel (its
camera looks away from the scene and its labels are nodata), so the coord
loss's valid-pixel gate must be the global batch's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from crossloc_tpu import geometry as jgeo
from crossloc_tpu import models as jmodels
from crossloc_tpu import parallel as jparallel
from crossloc_tpu import train as jtrain
from crossloc_tpu_torch import compat, models
from crossloc_tpu_torch.losses import CoordLossConfig, scene_coords_loss
from crossloc_tpu_torch.tools.parallel_check import run_ranks, step_check

IMG_H, IMG_W, FOCAL = 48, 64, 50.0
MEAN = [1.0, -2.0, 30.0]
STEPS, LR = 3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(B=4):
    """Images, poses and exact coordinates near MEAN for the first half; the
    second half's cameras sit beyond the scene looking away from it, with
    nodata labels (no valid pixel there)."""
    rng = np.random.default_rng(0)
    h, w = IMG_H // 8, IMG_W // 8
    K = np.asarray(jgeo.intrinsics(FOCAL, IMG_W, IMG_H), np.float64)
    grid = np.asarray(jgeo.pixel_grid(h, w, 8), np.float64).reshape(-1, 2)
    poses, coords = [], []
    for i in range(B):
        R = np.asarray(jgeo.rodrigues(jnp.asarray(rng.normal(size=3) * 0.1)), np.float64)
        t = np.asarray(MEAN) - R @ np.array([0.0, 0.0, 30.0]) + rng.normal(size=3)
        depth = rng.uniform(20.0, 40.0, size=grid.shape[0])
        cam = np.stack([(grid[:, 0] - K[0, 2]) / K[0, 0] * depth,
                        (grid[:, 1] - K[1, 2]) / K[1, 1] * depth, depth], -1)
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        pts = (cam @ R.T + t).reshape(h, w, 3)
        if i >= B // 2:
            c2w[:3, 3] = np.asarray(MEAN) + [0.0, 0.0, 200.0]
            pts = np.full_like(pts, -1.0)
        poses.append(c2w)
        coords.append(pts)
    return dict(images=rng.normal(size=(B, IMG_H, IMG_W, 3)).astype(np.float32),
                poses=np.stack(poses).astype(np.float32),
                labels=np.stack(coords).astype(np.float32),
                focal=np.float32(FOCAL), pp_shift=np.array([1.5, -2.25], np.float32))


@pytest.fixture(scope="module")
def jax_net():
    jnet = jmodels.build_network("coord", "MLE", tiny=True, mean=MEAN)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"]
    return jnet, params


def _spec(jax_net, zero=False, grad_clip=None):
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    sd = compat.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax_net[1]), net)
    return dict(state_dict=sd,
                batch={k: torch.from_numpy(np.asarray(v)) for k, v in _batch().items()},
                kind="coord", uncertainty="MLE", mean=MEAN, tiny=True, zero=zero, steps=STEPS,
                lr=LR, grad_clip=grad_clip, device="cpu")


def _two_ranks(spec, tmp_path):
    out = str(tmp_path / "rank0.pt")
    run_ranks(step_check, 2, (spec, out), timeout=120)
    return torch.load(out, weights_only=False)


def _jax_dp(jax_net, zero=False, grad_clip=None):
    """(gradients, per-step losses, params after STEPS) of JAX's step on a
    2-device "data" mesh, on the same global batch."""
    jnet, params = jax_net
    b = _batch()
    tx = jtrain.make_optimizer(LR, steps_per_epoch=10, grad_clip=grad_clip)
    mesh = jparallel.make_mesh(jax.devices()[:2], data=2)
    shard_state = ((lambda t: jparallel.shard_params(mesh, t, axis="data")) if zero
                   else (lambda t: jparallel.replicate(mesh, t)))

    def loss_of(p, bb):
        preds = jnet.apply({"params": p}, bb.images)
        return jtrain.task_loss_fn("coord", preds, bb, "MLE", 3)[0]

    step = jax.jit(jtrain.make_train_step(jnet, tx, "coord", "MLE"))
    with mesh:
        batch = jtrain.TrainBatch(*(
            jax.device_put(jnp.asarray(b[k]), NamedSharding(mesh, P("data") if k in (
                "images", "poses", "labels") else P()))
            for k in ("images", "poses", "labels", "focal", "pp_shift")))
        grads = jax.jit(jax.grad(loss_of))(shard_state(params), batch)
        state = shard_state(jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)))
        losses = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    to_port = lambda t: compat.state_dict_from_flax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, jax.device_get(t)), net)
    return to_port(grads), losses, to_port(state.params)


def _assert_grads(got, ref, what):
    gscale = max(float(v.abs().max()) for v in ref.values())
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-5 * gscale,
                                   err_msg=f"{what}: {name}")


def _assert_params(got, ref, what):
    for name, p in ref.items():
        np.testing.assert_allclose(got[name].numpy(), p.numpy(), rtol=1e-5,
                                   atol=2e-4 * STEPS, err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def jax_dp(jax_net):
    """JAX's DP step, replicated, and its ZeRO step (`shard_params(axis=
    "data")`) with the clip active; computed once per module."""
    return {(False, None): _jax_dp(jax_net), (True, 1.0): _jax_dp(jax_net, True, 1.0)}


@pytest.mark.parametrize("zero, grad_clip", [(False, None), (True, None), (True, 1.0)],
                         ids=["dp", "zero", "zero-clip"])
def test_parallel_step_matches_single_process_and_jax(jax_net, jax_dp, tmp_path, zero,
                                                      grad_clip):
    """DP, ZeRO, and ZeRO with the global-norm clip active (the norm summed
    over the shards): gradients, losses, grad norms and parameters against
    the port's single-process step at the global batch and JAX's DP step
    (ZeRO without the clip against JAX's replicated one, which JAX's own
    tests hold equal to its ZeRO step)."""
    spec = _spec(jax_net, zero=zero, grad_clip=grad_clip)
    dp = _two_ranks(spec, tmp_path)
    single = step_check(spec)
    jgrads, jlosses, jparams = jax_dp[(zero, grad_clip) if grad_clip else (False, None)]
    assert set(dp["grads"]) == set(single["grads"]) == set(jgrads) - {"mean", "decoder.mean"}
    _assert_grads(dp["grads"], single["grads"], "port 1 rank")
    _assert_grads(dp["grads"], jgrads, "jax dp")
    np.testing.assert_allclose(dp["loss"], single["loss"], rtol=2e-6)
    np.testing.assert_allclose(dp["loss"], jlosses, rtol=1e-5)  # JAX's own loss yardstick
    np.testing.assert_allclose(dp["grad_norm"], single["grad_norm"], rtol=1e-5)
    if grad_clip is not None:
        assert min(single["grad_norm"]) > 10 * grad_clip  # the clip acts on every step
    _assert_params(dp["params"], single["params"], "port 1 rank")
    _assert_params(dp["params"], jparams, "jax dp")


def test_valid_pixel_gate_is_batch_global():
    """A rank whose images have no valid pixel: its reprojection term is
    gated on the global count (`count_reduce`), as on the whole batch."""
    b = _batch()
    rows = slice(2, 4)
    args = [torch.from_numpy(b[k][rows]) for k in ("labels", "labels", "poses")]
    args[0] = args[0] + 5.0  # any prediction: none is valid with this camera
    cam = torch.from_numpy(np.array(jgeo.intrinsics(FOCAL, IMG_W, IMG_H), np.float32))
    cfg = CoordLossConfig()
    local, rate = scene_coords_loss(*args, cam, None, cfg)
    gated, _ = scene_coords_loss(*args, cam, None, cfg, count_reduce=lambda n: n + 7)
    assert float(rate) == 0.0 and float(local) == 0.0
    np.testing.assert_allclose(float(gated), 1e-7 + np.sqrt(100.0 * 1e-7 + 1e-7), rtol=1e-5)
