"""The port's VanillaNetwork against the JAX one with the same weights.

JAX-initialised params go through `state_dict_from_flax` into the port
(strict load) and the forwards are compared on seeded grayscale images; a
`.net` the port writes loads in the JAX package's `compat.load_net`; the
state-dict keys are `vanilla_net_key_map`'s; the CLIs build the net for a
scene outside urbanscape / naturescape and refuse to run on one with the
JAX package's exception and words.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import compat as jcompat
from crossloc_tpu import losses as jlosses
from crossloc_tpu import models as jmodels
from crossloc_tpu.cli import common as jcli_common
from crossloc_tpu.compat import torch_import
from crossloc_tpu_torch import compat, models
from crossloc_tpu_torch.cli import common as cli_common
from crossloc_tpu_torch.cli import test_single_task as test_cli
from crossloc_tpu_torch.train import TrainState, load_train_state, make_optimizer, save_train_state

MEAN = [1.0, -2.0, 3.0]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[True, False], ids=["tiny", "full"])
def jax_net(request):
    """(tiny, JAX net, its params) on a grayscale input."""
    jnet = jmodels.VanillaNetwork(tiny=request.param, mean_init=MEAN)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 1)))["params"]
    return request.param, jnet, params


def _port_net(tiny, params):
    net = models.VanillaNetwork(tiny=tiny, mean_init=MEAN)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    net.load_state_dict(compat.state_dict_from_flax(params_np, net), strict=True)
    return net.eval()


def _images(seed=1, B=2, hw=(32, 48)):
    return np.random.default_rng(seed).uniform(0, 1, size=(B,) + hw + (1,)).astype(np.float32)


def _forwards(jnet, params, net, x):
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy(), ref


def test_forward_matches_jax(jax_net):
    """f32, within 1e-5 of max|ref| (no norm: the convs' summation order
    is all that differs)."""
    tiny, jnet, params = jax_net
    out, ref = _forwards(jnet, params, _port_net(tiny, params), _images())
    assert out.shape == ref.shape == (2, 4, 6, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_port_written_net_loads_in_jax(jax_net, tmp_path):
    tiny, jnet, params = jax_net
    net = _port_net(tiny, params)
    path = str(tmp_path / "model.net")
    compat.save_net(path, net)
    back = jcompat.load_net(path, jnet)
    x = _images(seed=2)
    out, ref = _forwards(jnet, back, net, x)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_keys_are_the_vanilla_key_map(jax_net):
    tiny, jnet, _ = jax_net
    net = models.VanillaNetwork(tiny=tiny)
    want = [k for k, _, _ in torch_import.vanilla_net_key_map(jnet)]
    assert list(net.state_dict()) == want
    assert [k for k, _, _ in compat.vanilla_net_key_map(net)] == want
    assert ("res2_skip.weight" in want) == (not tiny)


def test_train_state_round_trips(tmp_path):
    """The full-state checkpoint holds a vanilla net as it holds the TransPose
    nets; its `.net` loads strictly."""
    gen = torch.Generator().manual_seed(0)
    net = models.init_weights(models.VanillaNetwork(tiny=True), gen)
    state = TrainState(net, make_optimizer(list(net.parameters()), 1e-3, 10, False))
    state.step = 7
    path = save_train_state(str(tmp_path / "s"), state)
    fresh = TrainState(models.VanillaNetwork(tiny=True),
                       make_optimizer(list(net.parameters()), 1e-3, 10, False))
    load_train_state(path, fresh)
    assert fresh.step == 7
    for a, b in zip(fresh.model.state_dict().values(), net.state_dict().values()):
        assert torch.equal(a, b)
    compat.save_net(str(tmp_path / "v.net"), net)
    compat.load_net(str(tmp_path / "v.net"), models.VanillaNetwork(tiny=True))


def test_cli_builds_the_vanilla_net_outside_the_families():
    net = cli_common.build_network("cambridge", "coord", True, True, "MLE", False, MEAN)
    assert isinstance(net, models.VanillaNetwork) and net.conv1.in_channels == 1
    np.testing.assert_array_equal(net.mean.numpy(), MEAN)
    rgb = cli_common.build_network("cambridge", "coord", False, False, None, False, MEAN,
                                   dtype=torch.bfloat16)
    assert rgb.conv1.in_channels == 3 and rgb.dtype == torch.bfloat16
    assert isinstance(cli_common.build_network("urbanscape", "coord", True, False, "MLE", False,
                                               MEAN), models.TransPoseNet)


def test_eval_cli_refuses_the_scene_with_jax_s_words(tmp_path):
    (tmp_path / "model.net").write_bytes(b"")
    with pytest.raises(NotImplementedError) as ref:
        jlosses.get_nodata_value("cambridge")
    with pytest.raises(NotImplementedError) as port:
        test_cli.main(["cambridge", "--task", "coord", "--network_in",
                       str(tmp_path / "model.net"), "--device", "cpu"])
    assert str(port.value) == str(ref.value) == "unknown scene family: cambridge"
    with pytest.raises(NotImplementedError) as ref:
        jcli_common.resolve_train_roots("cambridge", "coord", "in_place", 0.0, 1.0, False)
    with pytest.raises(NotImplementedError) as port:
        cli_common.resolve_train_roots("cambridge", "coord", "in_place", 0.0, 1.0, False)
    assert str(port.value) == str(ref.value) == "scene=cambridge"
