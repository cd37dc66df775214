"""The port's MLR net (encoder towers merged before the decoder) against the
JAX package's on identical numpy weights and inputs.

Forwards at tiny widths for num_mlr 2 and 3 with 0 or 1 trainable tower,
and at full width (the merge norm at C=1536, through the plain twin here),
within 1e-3 of each output channel's spread. The coord loss's gradients
against `jax.grad` within `test_torch_train.py`'s limit (1e-4 of each
tensor's norm plus 1e-6 of the global norm); frozen towers get no gradient
in the port and exactly zero in JAX. `.net` files cross in both directions;
the MLR wiring of task-pretrain `.net` files equals the JAX package's
exactly; one Adam step leaves frozen towers bit-unchanged on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import compat as jcompat
from crossloc_tpu import models as jmodels
from crossloc_tpu import train as jtrain
from crossloc_tpu.cli import common as jcommon
from crossloc_tpu_torch import compat, models
from crossloc_tpu_torch.cli import common
from crossloc_tpu_torch.ops import groupnorm
from crossloc_tpu_torch.train import (
    TrainBatch,
    TrainState,
    load_train_state,
    make_optimizer,
    save_train_state,
    task_loss_fn,
    train_step,
)

MEAN = [1.0, -2.0, 30.0]
IMG_H, IMG_W, FOCAL = 32, 48, 40.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_params(jnet, seed, hw=(16, 16)):
    """Seeded numpy weights in the net's tree (no JAX init): conv kernels
    normal over sqrt(fan_in), norm scales near 1, biases and means small."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if name.endswith("['scale']") else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def _jax_mlr(num_mlr, num_unfrozen, tiny=True):
    return jmodels.build_network("coord", "MLE", tiny=tiny, num_mlr=num_mlr,
                                 num_unfrozen_encoder=num_unfrozen, mean=MEAN)


def _port_mlr(num_mlr, num_unfrozen, params, tiny=True):
    net = models.build_network("coord", "MLE", tiny=tiny, num_mlr=num_mlr,
                               num_unfrozen_encoder=num_unfrozen)
    net.load_state_dict(compat.state_dict_from_flax(params, net), strict=True)
    return net


def _rel_err(a, b):
    """max |a - b| per output channel over that channel's spread; the worst."""
    return float((np.abs(a - b).max(axis=(0, 1, 2)) / b.std(axis=(0, 1, 2))).max())


def _images(hw, seed, B=2):
    return np.random.default_rng(seed).uniform(0, 1, size=(B,) + hw + (3,)).astype(np.float32)


@pytest.mark.parametrize("num_mlr, num_unfrozen", [(2, 0), (2, 1), (3, 0), (3, 1)])
def test_tiny_mlr_forward_matches_jax(num_mlr, num_unfrozen):
    params = _random_params(_jax_mlr(num_mlr, 0), seed=num_mlr)
    jnet = _jax_mlr(num_mlr, num_unfrozen)
    net = _port_mlr(num_mlr, num_unfrozen, params)
    x = _images((IMG_H, IMG_W), seed=1)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, IMG_H // 8, IMG_W // 8, 4)
    # f32 convs (XLA vs oneDNN summation order) through the towers and merge;
    # the JAX merge norm takes the fast variance, the port's centres
    assert _rel_err(out, ref) < 1e-3
    trainable = {n.split(".")[0] for n, p in net.named_parameters() if p.requires_grad}
    towers = {f"mlr_encoder_{i}" for i in range(1, num_unfrozen + 1)}
    assert trainable == towers | {"mlr_skip", "mlr_norm", "mlr_forward", "decoder"}


def test_full_width_mlr_forward_matches_jax():
    """Three full-width towers: the merge norm runs at C=1536."""
    params = _random_params(_jax_mlr(3, 1, tiny=False), seed=7)
    jnet = _jax_mlr(3, 1, tiny=False)
    net = _port_mlr(3, 1, params, tiny=False)
    assert net.mlr_norm.weight.shape == (1536,) and net.mlr_skip[0].weight.shape[1] == 1536
    x = _images((64, 96), seed=2, B=1)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == (1, 8, 12, 4)
    assert _rel_err(out, ref) < 1e-3


def test_frozen_towers_build_no_graph(monkeypatch):
    """Under grad, only the trainable tower's norms, the five merge norms and
    the decoder's eleven go through autograd (17 + 5 + 11 at full width);
    the frozen towers' outputs carry no graph."""
    calls = []
    real = groupnorm._GroupNormReLU

    class Counting:
        @staticmethod
        def apply(*a):
            calls.append(a[0].shape[-1])
            return real.apply(*a)

    monkeypatch.setattr(groupnorm, "_GroupNormReLU", Counting)
    net = models.build_network("coord", "MLE", num_mlr=3, num_unfrozen_encoder=1)
    seen = []
    for tower in net.towers():
        tower.register_forward_hook(lambda m, i, o: seen.append(o.requires_grad))
    y = net(torch.from_numpy(_images((16, 24), seed=3, B=1)))
    assert y.requires_grad and seen == [True, False, False]
    assert len(calls) == 33 and calls.count(1536) == 1


@pytest.fixture(scope="module")
def mlr_case():
    """Tiny num_mlr=2 with the first tower trainable: JAX weights, a batch,
    JAX's gradients and one JAX Adam step."""
    jnet = _jax_mlr(2, 1)
    params = _random_params(jnet, seed=11)
    b = _batch()
    jbatch = jtrain.TrainBatch(*(jnp.asarray(b[k])
                                 for k in ("images", "poses", "labels", "focal", "pp_shift")))

    def loss_fn(p):
        return jtrain.task_loss_fn("coord", jnet.apply({"params": p}, jbatch.images), jbatch,
                                   "MLE", 3)[0]

    tx = jtrain.make_optimizer(1e-4, steps_per_epoch=1, no_lr_scheduling=True)
    step = jtrain.make_train_step(jnet, tx, "coord", "MLE")

    @jax.jit
    def grads_and_step(state):  # one compilation for both
        return jax.grad(loss_fn)(state.params), step(state, jbatch)

    state = jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    grads, (new, metrics) = grads_and_step(state)
    return dict(jnet=jnet, params=params, batch=b, grads=jax.tree_util.tree_map(np.asarray, grads),
                new_params=jax.tree_util.tree_map(np.asarray, new.params), metrics=metrics)


def _batch(seed=0, B=2):
    """Images, poses, coordinates in front of the cameras around MEAN, a
    focal and a principal-point shift, as numpy arrays."""
    rng = np.random.default_rng(seed)
    h, w = IMG_H // 8, IMG_W // 8
    ys, xs = np.meshgrid(np.arange(h) * 8 + 4.0, np.arange(w) * 8 + 4.0, indexing="ij")
    depth = rng.uniform(20.0, 40.0, size=(B, h, w))
    cam = np.stack([(xs - IMG_W / 2) / FOCAL * depth, (ys - IMG_H / 2) / FOCAL * depth, depth], -1)
    poses = np.tile(np.eye(4), (B, 1, 1))
    poses[:, :3, 3] = np.asarray(MEAN) - np.array([0.0, 0.0, 30.0]) + rng.normal(size=(B, 3))
    coords = cam + poses[:, None, None, :3, 3]
    return dict(images=rng.normal(size=(B, IMG_H, IMG_W, 3)).astype(np.float32),
                poses=poses.astype(np.float32), labels=coords.astype(np.float32),
                focal=np.float32(FOCAL), pp_shift=np.array([1.5, -2.25], np.float32))


def _port_batch(b):
    return TrainBatch(*(torch.from_numpy(np.asarray(b[k]))
                        for k in ("images", "poses", "labels", "focal", "pp_shift")))


def _port_state(case):
    net = _port_mlr(2, 1, case["params"])
    trainable = [p for p in net.parameters() if p.requires_grad]
    return TrainState(net, make_optimizer(trainable, 1e-4, 1, no_lr_scheduling=True))


def test_mlr_gradients_match_jax(mlr_case):
    state = _port_state(mlr_case)
    net = state.model
    net.zero_grad()
    batch = _port_batch(mlr_case["batch"])
    loss, _ = task_loss_fn("coord", net(batch.images), batch, "MLE", 3)
    loss.backward()
    j_by_key = compat.state_dict_from_flax(mlr_case["grads"], net)
    total = float(np.sqrt(sum(np.square(g).sum()
                              for g in jax.tree_util.tree_leaves(mlr_case["grads"]))))
    for name, p in net.named_parameters():
        ref = j_by_key[name].numpy()
        if name.startswith("mlr_encoder_2."):
            assert p.grad is None and not p.requires_grad, name
            assert not ref.any(), name  # stop_gradient: exactly zero
            continue
        err = np.linalg.norm(p.grad.numpy() - ref)
        assert err <= 1e-4 * np.linalg.norm(ref) + 1e-6 * total, (name, err, np.linalg.norm(ref))


def test_mlr_train_step_matches_jax(mlr_case):
    state = _port_state(mlr_case)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = train_step(state, _port_batch(mlr_case["batch"]), "coord", "MLE")
    np.testing.assert_allclose(float(metrics["loss"]), float(mlr_case["metrics"]["loss"]),
                               rtol=1e-4)
    after = state.model.state_dict()
    j_new = compat.state_dict_from_flax(mlr_case["new_params"], state.model)
    j_old = compat.state_dict_from_flax(mlr_case["params"], state.model)
    for k in after:
        if k.startswith("mlr_encoder_2."):
            assert torch.equal(after[k], before[k]), k
            assert torch.equal(j_new[k], j_old[k]), k
    assert not torch.equal(after["mlr_encoder_1.conv1.weight"], before["mlr_encoder_1.conv1.weight"])
    assert not torch.equal(after["mlr_forward.0.weight"], before["mlr_forward.0.weight"])


def test_state_file_of_an_mlr_net_resumes_exactly(mlr_case, tmp_path):
    """Adam holds only the trainable parameters; a `.state` written after
    two steps and loaded into a fresh net takes two more to the same bits."""
    b = _port_batch(mlr_case["batch"])
    state = _port_state(mlr_case)
    for _ in range(2):
        train_step(state, b, "coord", "MLE")
    path = save_train_state(str(tmp_path / "mlr"), state)
    for _ in range(2):
        train_step(state, b, "coord", "MLE")
    other = _port_state(mlr_case)
    load_train_state(path, other)
    for _ in range(2):
        train_step(other, b, "coord", "MLE")
    for (k, a), (_, r) in zip(state.model.state_dict().items(), other.model.state_dict().items()):
        assert torch.equal(a, r), k
    frozen = compat.state_dict_from_flax(mlr_case["params"], other.model)
    assert torch.equal(other.model.mlr_encoder_2.conv1.weight, frozen["mlr_encoder_2.conv1.weight"])


def test_jax_saved_mlr_net_loads_strictly_and_back(tmp_path):
    jnet = _jax_mlr(3, 1)
    params = _random_params(jnet, seed=5)
    path = str(tmp_path / "model.net")
    jcompat.save_net(path, params, jnet)
    net = models.build_network("coord", "MLE", tiny=True, num_mlr=3, num_unfrozen_encoder=1)
    compat.load_net(path, net)  # strict
    x = _images((IMG_H, IMG_W), seed=6, B=1)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        assert _rel_err(net.eval()(torch.from_numpy(x)).numpy(), ref) < 1e-3
    out_path = str(tmp_path / "port.net")
    compat.save_net(out_path, net)
    back = jcompat.load_net(out_path, jnet)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def donors(tmp_path_factory):
    """Task-pretrain `.net` files written by the JAX package, in folders named
    after their task; the semantics net carries the DUC head's keys."""
    root = tmp_path_factory.mktemp("donors")
    paths = {}
    for i, (task, unc, full) in enumerate([("coord", "MLE", False), ("depth", "MLE", False),
                                           ("normal", "MLE", False), ("semantics", None, True)]):
        jnet = jmodels.build_network(task, uncertainty=unc, tiny=True, fullsize=full,
                                     mean=[0.5] * jmodels.task_channels(task))
        d = root / task
        d.mkdir()
        paths[task] = str(d / "model.net")
        jcompat.save_net(paths[task], _random_params(jnet, seed=20 + i, hw=(32, 32)), jnet)
    return paths


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no_reuse"])
@pytest.mark.parametrize("tasks", [("coord", "depth", "normal"),
                                   ("coord", "depth", "normal", "semantics")],
                         ids=["cdn", "cdns"])
def test_wiring_matches_jax(donors, reuse, tasks):
    paths = [donors[t] for t in tasks]
    num_mlr = len(tasks) - (0 if reuse else 1)
    jnet = _jax_mlr(num_mlr, 1 if reuse else 0)
    j_wired = jcommon.wire_mlr_weights(_random_params(jnet, seed=3), jnet, paths, reuse)
    j_state = jcompat.params_to_torch_state(j_wired, jnet)

    net = models.build_network("coord", "MLE", tiny=True, num_mlr=num_mlr,
                               num_unfrozen_encoder=1 if reuse else 0)
    models.init_weights(net, torch.Generator().manual_seed(0))
    common.wire_mlr_weights(net, paths, reuse)
    state = net.state_dict()
    wired = [k for k in state if k.startswith(("mlr_encoder_", "decoder.")) or k == "mean"]
    assert {k.split(".")[0] for k in set(state) - set(wired)} == {"mlr_skip", "mlr_forward",
                                                                  "mlr_norm"}
    for k in wired:
        assert torch.equal(state[k], j_state[k]), k
    donor_enc = compat.load_net(paths[1])
    tower = 2 if reuse else 1
    assert torch.equal(state[f"mlr_encoder_{tower}.conv1.weight"], donor_enc["encoder.conv1.weight"])


def test_wiring_checks_the_donors(donors):
    net = models.build_network("coord", "MLE", tiny=True, num_mlr=3)
    with pytest.raises(ValueError, match="coord task"):
        common.wire_mlr_weights(net, [donors["depth"], donors["coord"]], False)
    with pytest.raises(ValueError, match="num_mlr=3"):
        common.wire_mlr_weights(net, [donors["coord"], donors["depth"]], False)
    wide = models.build_network("coord", "MLE", num_mlr=2)
    with pytest.raises((KeyError, RuntimeError)):
        common.wire_mlr_weights(wide, [donors["coord"], donors["depth"]], True)
