"""The port's TransPose net against the JAX one with the same weights.

JAX-initialised params go through `state_dict_from_flax` into the port
(strict load); a `.net` written by the JAX package's `compat.save_net`
loads strictly too. Forwards are compared on seeded images.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import compat as jcompat
from crossloc_tpu import models as jmodels
from crossloc_tpu_torch import compat, models
from crossloc_tpu_torch.cli import common as cli_common


HW_TINY, HW_FULL = (32, 48), (64, 96)


def _jax_net(tiny, stem_s2d=False, dtype=jnp.float32):
    return jmodels.build_network("coord", "MLE", tiny=tiny, mean=[1.0, -2.0, 3.0],
                                 stem_s2d=stem_s2d, dtype=dtype)


@pytest.fixture(scope="module")
def tiny_params():
    return jax.jit(_jax_net(True).init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]


@pytest.fixture(scope="module")
def full_params():
    # the space-to-depth stems keep the same param tree, so one init serves both
    return jax.jit(_jax_net(False).init)(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3)))["params"]


def _jax_forward(jnet, params, x):
    return np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))


def _port_net(tiny, params, dtype=torch.float32):
    net = models.build_network("coord", "MLE", tiny=tiny, dtype=dtype)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    net.load_state_dict(compat.state_dict_from_flax(params_np, net), strict=True)
    return net.eval()


def _images(hw, seed=1, B=2):
    return np.random.default_rng(seed).uniform(0, 1, size=(B,) + hw + (3,)).astype(np.float32)


def _rel_err(a, b, rms=False):
    """max (or rms) |a - b| per output channel over that channel's spread;
    the worst channel."""
    d = np.abs(a - b)
    d = np.sqrt((d * d).mean(axis=(0, 1, 2))) if rms else d.max(axis=(0, 1, 2))
    return float((d / b.std(axis=(0, 1, 2))).max())


def _port_forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


def test_tiny_forward_matches_jax(tiny_params):
    x = _images(HW_TINY)
    ref = _jax_forward(_jax_net(True), tiny_params, x)
    out = _port_forward(_port_net(True, tiny_params), x)
    assert out.shape == ref.shape == (2, 4, 6, 4)
    # f32 convs (XLA vs oneDNN summation order) through 20 layers
    assert _rel_err(out, ref) < 1e-3


@pytest.mark.parametrize("stem_s2d", [False, True])
def test_full_width_forward_matches_jax(full_params, stem_s2d):
    """Full-width net at a small image; the JAX side with and without its
    space-to-depth stems (an exact re-layout), the port with its standard
    stems."""
    x = _images(HW_FULL, seed=2)
    ref = _jax_forward(_jax_net(False, stem_s2d), full_params, x)
    out = _port_forward(_port_net(False, full_params), x)
    assert out.shape == (2, 8, 12, 4)
    assert _rel_err(out, ref) < 1e-3


def test_bf16_forward_matches_jax_placement(tiny_params):
    """--bf16: convs and norm outputs in bf16, statistics and output f32, in
    both packages. Each bf16 net's distance from the f32 net is rounding
    noise; the port's must be no larger than the JAX package's (x1.5)."""
    x = _images(HW_TINY, seed=3)
    ref32 = _jax_forward(_jax_net(True), tiny_params, x)
    jb = _jax_forward(_jax_net(True, dtype=jnp.bfloat16), tiny_params, x)
    net = _port_net(True, tiny_params, torch.bfloat16)
    with torch.no_grad():
        tb = net(torch.from_numpy(x))
    assert tb.dtype == torch.float32
    e_port, e_jax = _rel_err(tb.numpy(), ref32, rms=True), _rel_err(jb, ref32, rms=True)
    assert 0.0 < e_port <= 1.5 * e_jax + 1e-3, (e_port, e_jax)


def test_jax_saved_net_loads_strictly(tmp_path, full_params):
    jnet = _jax_net(False)
    path = str(tmp_path / "model.net")
    jcompat.save_net(path, full_params, jnet)
    net = models.build_network("coord", "MLE")
    compat.load_net(path, net)  # strict
    x = _images(HW_FULL, seed=5, B=1)
    ref = _jax_forward(jnet, full_params, x)
    assert _rel_err(_port_forward(net.eval(), x), ref) < 1e-3
    np.testing.assert_array_equal(net.mean.numpy(), [1.0, -2.0, 3.0])

    # and the port's own writer round-trips into the JAX package
    out_path = str(tmp_path / "port.net")
    compat.save_net(out_path, net)
    back = jcompat.load_net(out_path, jnet)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(full_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unported_configs_raise():
    """What the JAX package's `build_network` refuses, and the vanilla net of
    scenes outside urbanscape / naturescape (item 11)."""
    with pytest.raises(NotImplementedError, match="no uncertainty head"):
        models.build_network("semantics", "MLE", fullsize=True)
    with pytest.raises(NotImplementedError, match="requires fullsize"):
        models.build_network("semantics", None)
    with pytest.raises(NotImplementedError, match="item 11"):
        cli_common.build_network("cambridge", "coord", True, False, "MLE", False, [0.0] * 3)
