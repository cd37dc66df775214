"""The port's ProjHead against the JAX one with the same weights.

JAX-initialised params go through `state_dict_from_flax` (strict load) at
the tiny and the full width; the pooled features agree within 1e-3 of
their spread (`tests/test_torch_models.py`'s f32 limit), and the gradients
of a seeded projection of them within `tests/test_torch_train.py`'s limit
(1e-4 of each tensor's norm plus 1e-6 of the global norm), the input's
gradient too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu.models.transpose_net import ProjHead as JaxProjHead
from crossloc_tpu_torch import compat, models

OUT = 2048  # the default out_length: 64 channels a group


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[True, False], ids=["tiny", "full"])
def case(request):
    """The JAX head's output and gradients on seeded features and a seeded
    cotangent, and the port's head with the same weights."""
    tiny = request.param
    wide = 128 if tiny else 512
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 24, wide)).astype(np.float32)
    w = rng.normal(size=(2, OUT)).astype(np.float32)
    jhead = JaxProjHead(out_length=OUT, tiny=tiny)
    params = jax.jit(jhead.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 24, wide)))["params"]

    def loss(p, xx):
        return jnp.sum(jhead.apply({"params": p}, xx) * w)

    out = np.asarray(jax.jit(jhead.apply)({"params": params}, jnp.asarray(x)))
    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    head = models.ProjHead(out_length=OUT, tiny=tiny)
    head.load_state_dict(compat.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params), head), strict=True)
    return dict(x=x, w=w, out=out, head=head, g_x=np.asarray(g_x),
                g_params=jax.tree_util.tree_map(np.asarray, g_params))


def test_forward_matches_jax(case):
    with torch.no_grad():
        out = case["head"](torch.from_numpy(case["x"])).numpy()
    ref = case["out"]
    assert out.shape == ref.shape == (2, OUT) and out.dtype == np.float32
    assert np.abs(out - ref).max() < 1e-3 * ref.std()


def test_gradients_match_jax(case):
    head = case["head"]
    head.zero_grad()
    x = torch.from_numpy(case["x"]).requires_grad_()
    (head(x) * torch.from_numpy(case["w"])).sum().backward()
    refs = dict(compat.state_dict_from_flax(case["g_params"], head), x=case["g_x"])
    got = dict({n: p.grad for n, p in head.named_parameters()}, x=x.grad)
    total = float(np.sqrt(sum(np.square(np.asarray(g)).sum() for g in refs.values())))
    assert set(got) == set(refs)
    for name, g in got.items():
        ref = np.asarray(refs[name])
        err = np.linalg.norm(g.numpy() - ref)
        assert err <= 1e-4 * np.linalg.norm(ref) + 1e-6 * total, (name, err, np.linalg.norm(ref))


def test_keys_and_default_width():
    head = models.ProjHead(tiny=True)
    assert list(head.state_dict()) == [k for k, _, _ in compat.proj_head_key_map(head)]
    assert head.proj4.conv.out_channels == 2048 and head.proj4.norm.num_groups == 32
    assert head.proj1.conv.stride == (2, 2) and head.proj4.conv.kernel_size == (1, 1)
