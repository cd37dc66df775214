"""The port's DUC head and full-size decoder against the JAX package's.

`pixel_shuffle` is held on values that differ per channel, against the JAX
function and `nn.PixelShuffle`; `bilinear_resize` against `jax.image.resize`
where the two agree (equal sizes, enlarging) and at 104x152 -> 100x150,
where JAX's resize antialiases and the port's does not (ROADMAP R8). A tiny
full-size net takes a JAX net's weights through `state_dict_from_flax`; its
forward matches at sides that are multiples of 8 (within 1e-3 of each output
channel's spread: float32 convolutions summed in another order), and at
100x150 only with the resize swapped for an antialiased one. `.net` files
with the DUC keys load both ways.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from crossloc_tpu import compat as jcompat
from crossloc_tpu import models as jmodels
from crossloc_tpu.models import layers as jlayers
from crossloc_tpu_torch import compat, models
from crossloc_tpu_torch.models import transpose_net


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_pixel_shuffle_matches_jax_and_torch_order():
    """Every input channel holds its own index: any permutation shows."""
    B, H, W, C, r = 2, 3, 5, 6, 8
    x = np.broadcast_to(np.arange(C * r * r, dtype=np.float32), (B, H, W, C * r * r)).copy()
    x += np.random.default_rng(0).normal(size=x.shape).astype(np.float32) * 1e-3
    got = models.pixel_shuffle(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlayers.pixel_shuffle(jnp.asarray(x), r)))
    nchw = torch.nn.PixelShuffle(r)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got, nchw.permute(0, 2, 3, 1).numpy())
    assert got.shape == (B, H * r, W * r, C)


def _resize_pair(x, out_hw):
    jx = np.asarray(jlayers.bilinear_resize(jnp.asarray(x), *out_hw))
    return models.bilinear_resize(torch.from_numpy(x), *out_hw).numpy(), jx


@pytest.mark.parametrize("in_hw, out_hw", [((104, 152), (104, 152)), ((13, 19), (104, 152)),
                                           ((12, 16), (36, 40))],
                         ids=["same", "x8", "x3_x2.5"])
def test_bilinear_resize_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(1).normal(size=(2,) + in_hw + (3,)).astype(np.float32)
    got, ref = _resize_pair(x, out_hw)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_shrinking_resize_shows_r8():
    """104x152 -> 100x150: JAX's resize is torch's antialiased one, the
    port's is `align_corners=False` without antialiasing (its contract)."""
    x = np.random.default_rng(2).normal(size=(2, 104, 152, 3)).astype(np.float32)
    got, ref = _resize_pair(x, (100, 150))
    anti = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(100, 150),
                         mode="bilinear", align_corners=False, antialias=True)
    np.testing.assert_allclose(anti.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4)
    assert np.abs(got - ref).max() > 0.05


def _jax_net(task, unc):
    return jmodels.build_network(task, unc, tiny=True, fullsize=True,
                                 mean=[0.5] * jmodels.task_channels(task))


@pytest.fixture(scope="module", params=[("semantics", None), ("depth", "MLE")],
                ids=["semantics", "depth_MLE"])
def jax_net_and_params(request):
    jnet = _jax_net(*request.param)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"]
    return request.param, jnet, params


def _port_net(task, unc, params):
    net = models.build_network(task, unc, tiny=True, fullsize=True)
    net.load_state_dict(compat.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                    net), strict=True)
    return net.eval()


def _rel_err(a, b):
    """max |a - b| per output channel over that channel's spread; the worst."""
    return float((np.abs(a - b).max(axis=(0, 1, 2)) / b.std(axis=(0, 1, 2))).max())


def _forwards(jax_net_and_params, hw, seed):
    (task, unc), jnet, params = jax_net_and_params
    x = np.random.default_rng(seed).uniform(0, 1, (2,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    net = _port_net(task, unc, params)
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    return net, x, out, ref


@pytest.mark.parametrize("hw", [(32, 48), (40, 56)], ids=["32x48", "40x56"])
def test_full_size_forward_matches_jax(jax_net_and_params, hw):
    net, _, out, ref = _forwards(jax_net_and_params, hw, seed=4)
    assert out.shape == ref.shape == (2,) + hw + (net.decoder.fc3.out_channels,)
    assert _rel_err(out, ref) < 1e-3


def test_full_size_forward_at_100x150_differs_by_r8_alone(jax_net_and_params, monkeypatch):
    """At 100x150 the DUC output is 104x152 and shrinks: the port's net
    matches JAX's once its resize antialiases as JAX's does."""
    net, x, out, ref = _forwards(jax_net_and_params, (100, 150), seed=5)
    assert out.shape[1:3] == (100, 150)
    assert _rel_err(out, ref) > 1e-2

    def antialiased(t, h, w):
        y = F.interpolate(t.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
        return y.permute(0, 2, 3, 1)

    monkeypatch.setattr(transpose_net, "bilinear_resize", antialiased)
    with torch.no_grad():
        swapped = net(torch.from_numpy(x)).numpy()
    assert _rel_err(swapped, ref) < 1e-3


def test_duc_net_files_load_both_ways(tmp_path, jax_net_and_params):
    """A JAX-written full-size `.net` loads strictly (its duc_upsample keys
    among them) and the port's own file loads back into the JAX package."""
    (task, unc), jnet, params = jax_net_and_params
    path = str(tmp_path / "model.net")
    jcompat.save_net(path, params, jnet)
    net = models.build_network(task, unc, tiny=True, fullsize=True)
    state = compat.load_net(path, net)
    assert {"decoder.duc_upsample.conv.weight", "decoder.duc_upsample.norm.weight"} <= set(state)
    assert net.decoder.duc_upsample.conv.weight.shape[0] == 64 * net.decoder.fc3.out_channels
    out_path = str(tmp_path / "port.net")
    compat.save_net(out_path, net)
    back = jcompat.load_net(out_path, jnet)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_full_width_duc_widths():
    """The DUC conv's width is 64 x the output channels: 384 for semantics,
    128 / 192 / 256 for depth / normal / coord with MLE, 64 for depth
    without; groups min(32, C)."""
    for task, unc, width in (("semantics", None, 384), ("depth", "MLE", 128),
                             ("normal", "MLE", 192), ("coord", "MLE", 256), ("depth", None, 64)):
        duc = models.build_network(task, unc, fullsize=True).decoder.duc_upsample
        assert duc.conv.out_channels == width and duc.norm.num_groups == 32
