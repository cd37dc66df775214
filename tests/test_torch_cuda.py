"""Kernel K1 on the card against its plain twin, beyond the main path's shapes.

Needs a CUDA card: every test skips without one. It imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, C, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(shape + (C,), generator=g) * 2.0 + 3.0).to(device=device, dtype=dtype)
    s = torch.randn(C, generator=g).to(device)
    b = torch.randn(C, generator=g).to(device)
    return x, s, b


# (B, H, W, C, groups): odd row counts, chunks that do not divide H*W, C that
# is not a power of two, one group, group size 1, wide C (MLR norm)
SHAPES = [(2, 30, 45, 512, 32), (3, 7, 13, 96, 32), (1, 5, 5, 32, 1), (2, 9, 11, 64, 64),
          (1, 17, 23, 1536, 32), (4, 1, 1, 128, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(card, shape, dtype):
    B, H, W, C, G = shape
    dt = getattr(torch, dtype)
    x, s, b = _inputs((B, H, W), C, dt, card)
    for relu in (True, False):
        n0 = group_norm_relu.launches
        y = group_norm_relu(x, s, b, G, 1e-5, relu)
        ref = group_norm_relu_plain(x, s, b, G, 1e-5, relu)
        torch.cuda.synchronize()
        assert group_norm_relu.launches == n0 + 1
        assert y.dtype == dt and y.shape == x.shape
        # f32: summation order only; bf16: one rounding of the output
        rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (2**-7, 1e-2)
        np.testing.assert_allclose(y.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   rtol=rtol, atol=atol)


def test_constant_input_gives_finite_output(card):
    """Zero variance: rsqrt(eps), no NaN from cancellation."""
    x = torch.full((2, 8, 8, 64), 1234.5, device=card)
    y = group_norm_relu(x, torch.ones(64, device=card), torch.zeros(64, device=card), 32)
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) < 1e-2


def test_gradient_recomputes_through_plain(card):
    x, s, b = _inputs((2, 6, 6), 128, torch.float32, card, seed=3)
    leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    (group_norm_relu(*leaves, 32) ** 2).sum().backward()
    ref = [t.clone().requires_grad_() for t in (x, s, b)]
    (group_norm_relu_plain(*ref, 32) ** 2).sum().backward()
    for a, r in zip(leaves, ref):
        torch.testing.assert_close(a.grad, r.grad)


def test_kernel_raises_on_what_it_does_not_take(card):
    x, s, b = _inputs((1, 4, 4), 64, torch.float32, card)
    with pytest.raises(TypeError):
        group_norm_relu(x.half(), s, b, 32)
    with pytest.raises(ValueError):
        group_norm_relu(x.permute(0, 2, 1, 3), s, b, 32)  # not NHWC-contiguous
    with pytest.raises(ValueError):
        group_norm_relu(x, s.double(), b, 32)
    x6, s6, b6 = _inputs((1, 4, 4), 6, torch.float32, card)
    with pytest.raises(ValueError):
        group_norm_relu(x6, s6, b6, 3)  # C % 4 != 0: no 16-byte vectors
