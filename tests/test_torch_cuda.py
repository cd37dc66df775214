"""Kernel K1 on the card against its plain twin, beyond the main path's shapes.

Both designs are held: the one `_plan` picks (the cluster kernel wherever a
slab fits a cluster) and the three-pass design, reached through `_three_pass`.

Needs a CUDA card: every test skips without one. It imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain
from crossloc_tpu_torch.ops.groupnorm import _plan, _three_pass

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
# is not a power of two, one group, group size 1, wide C (MLR norm), H*W that
# is no multiple of the TMA box rows (ragged), C=2048, B=1 and B=16 at the
# path's widths (clusters of 2 and 4 CTAs)
SHAPES = [(2, 30, 45, 512, 32), (3, 7, 13, 96, 32), (1, 5, 5, 32, 1), (2, 9, 11, 64, 64),
          (1, 17, 23, 1536, 32), (4, 1, 1, 128, 32), (2, 61, 89, 256, 32),
          (1, 20, 30, 2048, 32), (1, 60, 90, 512, 32), (16, 60, 90, 256, 32)]
DESIGNS = {"planned": group_norm_relu, "three_pass": _three_pass}


def _check_against_plain(fn, x, s, b, G):
    dt = x.dtype
    for relu in (True, False):
        n0 = group_norm_relu.launches
        y = fn(x, s, b, G, 1e-5, relu)
        ref = group_norm_relu_plain(x, s, b, G, 1e-5, relu)
        torch.cuda.synchronize()
        assert group_norm_relu.launches == n0 + 1  # one launch counted per call
        assert y.dtype == dt and y.shape == x.shape
        # f32: summation order only; bf16: one rounding of the output
        rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (2**-7, 1e-2)
        np.testing.assert_allclose(y.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(card, shape, dtype):
    B, H, W, C, G = shape
    x, s, b = _inputs((B, H, W), C, getattr(torch, dtype), card)
    _check_against_plain(group_norm_relu, x, s, b, G)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_three_pass_matches_plain(card, shape, dtype):
    B, H, W, C, G = shape
    x, s, b = _inputs((B, H, W), C, getattr(torch, dtype), card)
    _check_against_plain(_three_pass, x, s, b, G)


def _fit_limit(C, G, dtype):
    """Largest H*W (as H x 1) that the planner still sends to the cluster."""
    lo, hi = 1, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _plan(1, mid, 1, C, G, dtype).design == "cluster" else (lo, mid)
    return lo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [512, 2048])
def test_slab_at_and_over_the_fit_limit(card, C, dtype):
    """A slab that fills 8 CTAs to the limit runs the cluster kernel; one row
    more goes to the three-pass design; both agree with the plain twin."""
    dt = getattr(torch, dtype)
    limit = _fit_limit(C, 32, dt)
    for rows, design in ((limit, "cluster"), (limit + 1, "three_pass")):
        assert _plan(1, rows, 1, C, 32, dt).design == design
        x, s, b = _inputs((1, rows, 1), C, dt, card, seed=rows)
        _check_against_plain(group_norm_relu, x, s, b, 32)


def _gn_float64(x, s, b, G, relu):
    B, H, W, C = x.shape
    xd = x.double().reshape(B, H * W, G, C // G)
    mu = xd.mean(dim=(1, 3), keepdim=True)
    var = (xd - mu).square().mean(dim=(1, 3), keepdim=True)
    y = ((xd - mu) / torch.sqrt(var + 1e-5)).reshape(B, H, W, C) * s.double() + b.double()
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_large_mean_keeps_f32_accuracy(card, design):
    """|mu| / std = 1000: the statistics must not lose the spread to the mean.
    Against float64, each output may be off by two f32 roundings of mu
    (2 * 2^-23 * |mu|, carried through gamma * rstd ~ gamma) besides the f32
    tolerance."""
    B, H, W, C, G = 2, 60, 90, 512, 32
    g = torch.Generator(device="cpu").manual_seed(5)
    x = (torch.randn(B, H, W, C, generator=g) + 1000.0).to(card)
    s = torch.randn(C, generator=g).to(card)
    b = torch.randn(C, generator=g).to(card)
    y = DESIGNS[design](x, s, b, G, 1e-5, False)
    ref = _gn_float64(x, s, b, G, False)
    err = (y.double() - ref).abs()
    limit = 1e-4 + 1e-4 * ref.abs() + 2.0**-23 * 1000.0 * s.double().abs() * 2.0
    assert bool((err <= limit).all()), float((err - limit).max())


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
