"""Kernel K1's plain twin in the PyTorch port against the JAX GroupNorm.

The JAX side runs as its own tests run it on the CPU: `groupnorm_relu`,
which there takes `_gn_reference`, and flax `nn.GroupNorm` with the fast
variance as `ConvGN` calls it. The CUDA kernel itself is held against the
plain version on the card (`chip_smoke.py`, `tests/test_torch_cuda.py`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from crossloc_tpu.ops import groupnorm_relu
from crossloc_tpu.ops.pallas_groupnorm import _gn_reference
from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain


def _inputs(C, seed, shape=(2, 5, 6)):
    rng = np.random.default_rng(seed)
    # offset mean: the stats must not cancel catastrophically
    x = (rng.normal(size=shape + (C,)) * 2.0 + 3.0).astype(np.float32)
    s = rng.normal(size=C).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("C", [32, 128, 512])
def test_plain_matches_jax_groupnorm(C, relu):
    x, s, b = _inputs(C, C)
    G = min(32, C)
    port = group_norm_relu(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), G,
                           1e-5, relu).numpy()
    ref = np.asarray(groupnorm_relu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), G, 1e-5, relu))
    # both two-pass fp32 statistics: only summation order differs
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)

    gn = nn.GroupNorm(num_groups=G, epsilon=1e-5, dtype=jnp.float32, use_fast_variance=True)
    y = gn.apply({"params": {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    y = np.asarray(jax.nn.relu(y) if relu else y)
    # flax's fast variance E[x^2] - mu^2 loses ~1e-7 * E[x^2] / var relative
    np.testing.assert_allclose(port, y, rtol=1e-4, atol=1e-4)


def test_gradient_matches_jax_reference():
    x, s, b = _inputs(128, 7, shape=(2, 4, 4))
    loss = lambda x, s, b: jnp.sum(_gn_reference(x, s, b, 32, 1e-5, True) ** 2)
    gj = jax.grad(loss, (0, 1, 2))(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, s, b))
    (group_norm_relu(xt, st, bt, 32, 1e-5, True) ** 2).sum().backward()
    # same math; fp32 reduction-order noise amplified by the square
    for a, t in zip(gj, (xt, st, bt)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), rtol=1e-4, atol=1e-3)


def test_bf16_keeps_dtype_and_fp32_statistics():
    x, s, b = _inputs(64, 3)
    xb = torch.from_numpy(x).bfloat16()
    y = group_norm_relu(xb, torch.from_numpy(s), torch.from_numpy(b), 32)
    assert y.dtype == torch.bfloat16
    ref = group_norm_relu_plain(xb.float(), torch.from_numpy(s), torch.from_numpy(b), 32)
    # one bf16 rounding of the output
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), rtol=2**-7, atol=1e-2)


def test_shape_guard():
    with pytest.raises(ValueError):
        group_norm_relu(torch.zeros(1, 2, 2, 128), torch.ones(64), torch.zeros(64), 32)
    with pytest.raises(ValueError):
        group_norm_relu(torch.zeros(1, 2, 2, 48), torch.ones(48), torch.zeros(48), 32)
    with pytest.raises(ValueError):
        group_norm_relu(torch.zeros(2, 2, 128), torch.ones(128), torch.zeros(128), 32)


def test_cpu_calls_do_not_count_launches():
    before = group_norm_relu.launches
    x, s, b = _inputs(32, 1)
    group_norm_relu(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 32)
    assert group_norm_relu.launches == before == 0
