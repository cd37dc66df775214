"""Kernel K1 on the card against its plain twin, beyond the main path's shapes.

Both designs are held: the one `_plan` picks (the cluster kernel wherever a
slab fits a cluster) and the three-pass design, reached through `_three_pass`.
K1's backward is held against the autograd of the plain twin in both its
designs: the one `_plan_backward` picks (the cluster kernel wherever the
slabs of x and dy fit a cluster) and the four-kernel design, reached through
`_four_kernel_backward`.

Needs a CUDA card: every test skips without one. It imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from crossloc_tpu_torch.ops import (
    group_norm_relu,
    group_norm_relu_backward,
    group_norm_relu_backward_plain,
    group_norm_relu_plain,
)
from crossloc_tpu_torch.ops.groupnorm import (
    _cluster,
    _four_kernel_backward,
    _launch,
    _plan,
    _plan_backward,
    _three_pass,
)

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


def test_gradient_matches_plain_autograd(card):
    x, s, b = _inputs((2, 6, 6), 128, torch.float32, card, seed=3)
    leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    n0 = group_norm_relu_backward.launches
    (group_norm_relu(*leaves, 32) ** 2).sum().backward()
    assert group_norm_relu_backward.launches == n0 + 1
    ref = [t.clone().requires_grad_() for t in (x, s, b)]
    (group_norm_relu_plain(*ref, 32) ** 2).sum().backward()
    for a, r in zip(leaves, ref):
        torch.testing.assert_close(a.grad, r.grad)


def _off_kink_dy(x, s, b, G, seed):
    """dy of x's dtype, zero where the plain pre-activation lies within 1e-3
    of the ReLU's kink: the kernel and the plain twin round the statistics
    in another order, which may flip the mask of such a cell."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    dy = torch.randn(x.shape, generator=g).to(x.device)
    pre = group_norm_relu_plain(x.float(), s, b, G, 1e-5, False)
    return (dy * (pre.abs() > 1e-3)).to(x.dtype)


def _check_backward(x, s, b, G, relu, dy):
    """Forward under autograd on the card (which writes the statistics), the
    backward kernel through autograd, against the plain twin's autograd.
    f32: dx within 1e-4 * max|ref| + 1e-4 * |ref| (fp32 sums in another
    order); dscale, dbias within 1e-4 * max|ref|; bf16: one bf16 ulp of dx
    (2^-7 * |ref|) beyond that, both sides rounding an fp32 dx."""
    leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    y = group_norm_relu(*leaves, G, 1e-5, relu)
    n0 = group_norm_relu_backward.launches
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert group_norm_relu_backward.launches == n0 + 1
    ref = group_norm_relu_backward_plain(x, s, b, dy.contiguous(), G, 1e-5, relu)
    assert got[0].dtype == x.dtype and got[1].dtype == torch.float32
    rel = 1e-4 + (2.0**-7 if x.dtype == torch.bfloat16 else 0.0)
    for a, r in zip(got, ref):
        a, r = a.float(), r.float()
        limit = 1e-4 * r.abs().max() + (rel * r.abs() if r.dim() == 4 else 0.0)
        assert bool(((a - r).abs() <= limit).all()), float(((a - r).abs() - limit).max())
    return got


# (B, H, W, C, groups) of the backward: ragged chunks and vectors, B=1,
# C=2048, one group, group size 1, the training batch at stem widths
BWD_SHAPES = [(2, 30, 45, 512, 32), (3, 7, 13, 96, 32), (1, 5, 5, 32, 1), (2, 9, 11, 64, 64),
              (1, 17, 23, 1536, 32), (1, 20, 30, 2048, 32), (2, 61, 89, 256, 32),
              (12, 24, 36, 32, 32), (12, 15, 23, 128, 32)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_plain(card, shape, dtype, relu):
    B, H, W, C, G = shape
    x, s, b = _inputs((B, H, W), C, getattr(torch, dtype), card, seed=7)
    _check_backward(x, s, b, G, relu, _off_kink_dy(x, s, b, G, seed=8))


def _backward_of(design, x, s, b, G, relu, dy):
    """(dx, dscale, dbias) of one design from the statistics the forward
    writes: "planned" through autograd, "four_kernel" reached directly."""
    if design == "planned":
        return _check_backward(x, s, b, G, relu, dy)
    stats = torch.empty(x.shape[0], G, 2, device=x.device)
    _launch(x, s, b, G, 1e-5, relu, stats)
    n0 = group_norm_relu_backward.launches
    got = _four_kernel_backward(x, s, b, stats, dy, G, relu)
    torch.cuda.synchronize()
    assert group_norm_relu_backward.launches == n0 + 1
    ref = group_norm_relu_backward_plain(x, s, b, dy, G, 1e-5, relu)
    rel = 1e-4 + (2.0**-7 if x.dtype == torch.bfloat16 else 0.0)
    for a, r in zip(got, ref):
        a, r = a.float(), r.float()
        limit = 1e-4 * r.abs().max() + (rel * r.abs() if r.dim() == 4 else 0.0)
        assert bool(((a - r).abs() <= limit).all()), float(((a - r).abs() - limit).max())
    return got


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_four_kernel_backward_matches_plain(card, shape, dtype, relu):
    B, H, W, C, G = shape
    x, s, b = _inputs((B, H, W), C, getattr(torch, dtype), card, seed=7)
    _backward_of("four_kernel", x, s, b, G, relu, _off_kink_dy(x, s, b, G, seed=8))


# (C, H, W) of every norm layer on the main paths at 480x720 (the 28 of the
# coord net, the MLR merge norm over 3 and 4 towers), at B=2
PATH_SHAPES = [(32, 480, 720), (64, 240, 360), (128, 120, 180), (256, 60, 90), (512, 60, 90),
               (1536, 60, 90), (2048, 60, 90)]


@pytest.mark.parametrize("design", ["planned", "four_kernel"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_plain_at_path_shapes(card, shape, dtype, relu, design):
    C, H, W = shape
    G = min(32, C)
    x, s, b = _inputs((2, H, W), C, getattr(torch, dtype), card, seed=C)
    if design == "planned" and C in (256, 512):  # the 25 layers at 60x90 of a train step
        assert _plan_backward(2, H, W, C, G, x.dtype).design == "cluster"
    _backward_of(design, x, s, b, G, relu, _off_kink_dy(x, s, b, G, seed=C + 1))


# the DUC conv's norm at 480x720 (60x90): C = 64 x the output channels, 32
# groups. C=192 and 384 (6 and 12 channels a group) take blocks of 24 (f32)
# or 48 (bf16) channels, 252 threads (a partial last warp) and clusters of 8
DUC_WIDTHS = [64, 128, 192, 256, 384]


@pytest.mark.parametrize("design", ["planned", "three_pass"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", DUC_WIDTHS)
def test_kernel_matches_plain_at_duc_widths(card, C, dtype, design):
    dt = getattr(torch, dtype)
    x, s, b = _inputs((2, 60, 90), C, dt, card, seed=C)
    plan = _plan(2, 60, 90, C, 32, dt)
    assert plan.design == "cluster" and plan.cluster == (8 if C in (192, 384) else 4)
    _check_against_plain(DESIGNS[design], x, s, b, 32)


@pytest.mark.parametrize("design", ["planned", "four_kernel"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", DUC_WIDTHS)
def test_backward_matches_plain_at_duc_widths(card, C, dtype, relu, design):
    dt = getattr(torch, dtype)
    x, s, b = _inputs((2, 60, 90), C, dt, card, seed=C + 2)
    plan = _plan_backward(2, 60, 90, C, 32, dt)
    assert plan.design == "cluster" and plan.cluster == 8
    _backward_of(design, x, s, b, 32, relu, _off_kink_dy(x, s, b, 32, seed=C + 3))


@pytest.mark.parametrize("design", ["planned", "four_kernel"])
def test_backward_is_deterministic(card, design):
    x, s, b = _inputs((4, 60, 90), 256, torch.float32, card, seed=9)
    assert _plan_backward(4, 60, 90, 256, 32, x.dtype).design == "cluster"
    dy = _off_kink_dy(x, s, b, 32, seed=10)
    first = _backward_of(design, x, s, b, 32, True, dy)
    second = _backward_of(design, x, s, b, 32, True, dy)
    for a, r in zip(first, second):
        assert torch.equal(a, r)


def _backward_fit_limit(C, G, dtype):
    """Largest H*W (as H x 1) that the backward planner still sends to the
    cluster."""
    lo, hi = 1, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = _plan_backward(1, mid, 1, C, G, dtype).design == "cluster"
        lo, hi = (mid, hi) if fits else (lo, mid)
    return lo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [512, 2048])
def test_backward_slab_at_and_over_the_fit_limit(card, C, dtype):
    """Slabs of x and dy that fill a cluster of 16 CTAs to the limit run the
    cluster backward; one row more goes to the four-kernel design; both agree
    with the plain twin."""
    dt = getattr(torch, dtype)
    limit = _backward_fit_limit(C, 32, dt)
    for rows, design in ((limit, "cluster"), (limit + 1, "four_kernel")):
        assert _plan_backward(1, rows, 1, C, 32, dt).design == design
        x, s, b = _inputs((1, rows, 1), C, dt, card, seed=rows)
        _check_backward(x, s, b, 32, True, _off_kink_dy(x, s, b, 32, seed=rows + 1))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("design", ["planned", "four_kernel"])
def test_backward_large_mean_keeps_f32_accuracy(card, design, relu):
    """|mu| / std = 1000 in the cluster design (and the four-kernel one):
    against the float64 autograd, each gradient within the f32 tolerance
    plus the plain twin's own largest distance from float64."""
    B, H, W, C, G = 2, 60, 90, 512, 32
    assert _plan_backward(B, H, W, C, G, torch.float32).design == "cluster"
    g = torch.Generator(device="cpu").manual_seed(15)
    x = (torch.randn(B, H, W, C, generator=g) + 1000.0).to(card)
    s = torch.randn(C, generator=g).to(card)
    b = torch.randn(C, generator=g).to(card)
    dy = _off_kink_dy(x, s, b, G, seed=16)
    leaves = [t.double().requires_grad_() for t in (x, s, b)]
    exact = torch.autograd.grad(_gn_float64(leaves[0], leaves[1], leaves[2], G, relu), leaves,
                                dy.double())
    plain = group_norm_relu_backward_plain(x, s, b, dy, G, 1e-5, relu)
    stats = torch.empty(B, G, 2, device=card)
    _launch(x, s, b, G, 1e-5, relu, stats)
    fn = group_norm_relu_backward if design == "planned" else _four_kernel_backward
    got = fn(x, s, b, stats, dy, G, relu)
    for a, p, e in zip(got, plain, exact):
        limit = (1e-4 * e.abs().max() + (1e-4 * e.abs() if e.dim() == 4 else 0.0)
                 + (p.double() - e).abs().max())
        err = (a.double() - e).abs()
        assert bool((err <= limit).all()), float((err - limit).max())


def test_backward_takes_a_non_contiguous_dy_through_autograd(card):
    x, s, b = _inputs((2, 12, 16), 64, torch.float32, card, seed=11)
    assert _plan_backward(2, 12, 16, 64, 32, x.dtype).design == "cluster"
    dy_t = _off_kink_dy(x, s, b, 32, seed=12).transpose(1, 2).contiguous()
    leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    y = group_norm_relu(*leaves, 32)
    got = torch.autograd.grad(y.transpose(1, 2), leaves, dy_t)  # dy arrives transposed
    ref = group_norm_relu_backward_plain(x, s, b, dy_t.transpose(1, 2).contiguous(), 32)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
    stats = torch.empty(2, 32, 2, device=card)
    with pytest.raises(ValueError):
        group_norm_relu_backward(x, s, b, stats, dy_t.transpose(1, 2), 32)
    with pytest.raises(ValueError):
        group_norm_relu_backward(x, s, b, stats, dy_t.transpose(1, 2).contiguous().bfloat16(), 32)


@pytest.mark.parametrize("design", ["cluster", "three_pass"])
def test_forward_writes_the_statistics(card, design):
    B, H, W, C, G = 2, 60, 90, 256, 32
    x, s, b = _inputs((B, H, W), C, torch.float32, card, seed=13)
    stats = torch.full((B, G, 2), float("nan"), device=card)
    if design == "cluster":
        plan = _plan(B, H, W, C, G, x.dtype)
        assert plan.design == "cluster"
        _cluster(x, s, b, G, 1e-5, True, plan, stats)
    else:
        _three_pass(x, s, b, G, 1e-5, True, stats)
    xd = x.double().reshape(B, H * W, G, C // G)
    mu = xd.mean(dim=(1, 3))
    rstd = 1.0 / torch.sqrt(xd.var(dim=(1, 3), unbiased=False) + 1e-5)
    torch.testing.assert_close(stats[..., 0].double(), mu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[..., 1].double(), rstd, rtol=1e-5, atol=0.0)


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


# -- DSAC e2e on the card: P3P's implicit backward, Kabsch, the step's launches

def _minimal_sets(M=512, seed=0):
    """M 4-point sets seen by random cameras at 30-300 m (world points,
    pixels with 0.5 px noise, K), float64 numpy."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 360], [0, 500, 240], [0, 0, 1]])
    X, pix = [], []
    for _ in range(M):
        rv = rng.normal(size=3) * 0.5
        th = np.linalg.norm(rv)
        k = rv / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        uv = rng.uniform([0, 0], [720, 480], size=(4, 2))
        d = rng.uniform(30.0, 300.0, size=4)
        cam = np.stack([(uv[:, 0] - 360) / 500 * d, (uv[:, 1] - 240) / 500 * d, d], -1)
        X.append((cam - rng.normal(size=3) * 10) @ R)
        pix.append(uv + rng.normal(size=(4, 2)) * 0.5)
    return np.stack(X), np.stack(pix), K


def _p3p_grad(X, pix, K, gR, gt, device, dtype):
    from crossloc_tpu_torch.geometry import p3p_from_4pts

    Xt = torch.tensor(X, dtype=dtype, device=device, requires_grad=True)
    R, t, _, valid = p3p_from_4pts(Xt, torch.tensor(pix, dtype=dtype, device=device),
                                   torch.tensor(K, dtype=dtype, device=device))
    ((R * torch.tensor(gR, dtype=dtype, device=device)).sum()
     + (t * torch.tensor(gt, dtype=dtype, device=device)).sum()).backward()
    return R.detach().cpu().double(), Xt.grad.cpu().double(), valid.cpu()


def test_p3p_backward_on_the_card_against_float64(card):
    """The card's f32 forward and implicit backward no further from float64
    than twice the CPU's f32, plus 1e-6 of the norm."""
    X, pix, K = _minimal_sets()
    rng = np.random.default_rng(1)
    gR, gt = rng.normal(size=(len(X), 3, 3)), rng.normal(size=(len(X), 3))
    R64, g64, v64 = _p3p_grad(X, pix, K, gR, gt, "cpu", torch.float64)
    Rc, gc, vc = _p3p_grad(X, pix, K, gR, gt, "cpu", torch.float32)
    Rk, gk, vk = _p3p_grad(X, pix, K, gR, gt, card, torch.float32)
    both = v64 & vc & vk
    assert both.float().mean() > 0.9
    for card_v, cpu_v, ref in ((Rk, Rc, R64), (gk, gc, g64)):
        e_k, e_c = float((card_v - ref)[both].norm()), float((cpu_v - ref)[both].norm())
        assert e_k <= 2 * e_c + 1e-6 * float(ref[both].norm()), (e_k, e_c)
    assert not gk[~vk].any() and torch.isfinite(gk).all()


def test_kabsch_on_the_card_against_float64(card):
    from crossloc_tpu_torch.geometry import kabsch

    g = torch.Generator().manual_seed(2)
    src = torch.randn(256, 9, 3, generator=g, dtype=torch.float64) * 5
    R = torch.linalg.qr(torch.randn(256, 3, 3, generator=g, dtype=torch.float64))[0]
    R = R * torch.linalg.det(R)[:, None, None]
    dst = src @ R.transpose(-1, -2) + torch.randn(256, 1, 3, generator=g, dtype=torch.float64)
    dst = dst + 0.05 * torch.randn(dst.shape, generator=g, dtype=torch.float64)
    w = torch.rand(256, 9, generator=g, dtype=torch.float64)
    gR = torch.randn(256, 3, 3, generator=g, dtype=torch.float64)
    out = {}
    for run, dev, dt in (("card", card, torch.float32), ("cpu", "cpu", torch.float32),
                         ("f64", "cpu", torch.float64)):
        s = src.to(dev, dt).requires_grad_()
        Rk, tk = kabsch(s, dst.to(dev, dt), w.to(dev, dt))
        ((Rk * gR.to(dev, dt)).sum() + tk.sum()).backward()
        out[run] = [Rk.detach().cpu().double(), tk.detach().cpu().double(), s.grad.cpu().double()]
    for i in range(3):
        e_k = float((out["card"][i] - out["f64"][i]).norm())
        e_c = float((out["cpu"][i] - out["f64"][i]).norm())
        assert e_k <= 2 * e_c + 1e-6 * float(out["f64"][i].norm()), (i, e_k, e_c)


def test_e2e_step_launches_each_norm_kernel_once_per_layer(card):
    """One DSAC step of the tiny coord net on the card: one K1 and one
    K1-bwd launch per GroupNorm layer, a finite loss and gradient norm."""
    from crossloc_tpu_torch import models, ops, ransac
    from crossloc_tpu_torch.models.layers import GroupNorm
    from crossloc_tpu_torch.train import (TrainBatch, TrainState, make_dsac_train_step,
                                          make_optimizer)

    net = models.init_weights(models.build_network("coord", "MLE", tiny=True, mean=[0, 0, 30.0]),
                              torch.Generator().manual_seed(0)).to(card)
    layers = sum(isinstance(m, GroupNorm) for m in net.modules())
    g = torch.Generator().manual_seed(1)
    B, H, W = 2, 96, 144
    batch = TrainBatch(torch.randn(B, H, W, 3, generator=g).to(card),
                       torch.eye(4).repeat(B, 1, 1).to(card), torch.zeros(B, H // 8, W // 8, 3,
                                                                           device=card),
                       torch.tensor(120.0, device=card), None)
    cfg = ransac.RansacConfig(hypotheses=8, sample_rounds=4, train_refine_steps=1,
                              inlier_threshold=5000.0, max_pixel_error=10000.0)
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4))
    ops.group_norm_relu.launches = ops.group_norm_relu_backward.launches = 0
    m = make_dsac_train_step(net, cfg)(state, batch,
                                       generator=torch.Generator(device=card).manual_seed(3))
    torch.cuda.synchronize()
    assert ops.group_norm_relu.launches == ops.group_norm_relu_backward.launches == layers
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


# ProjHead's four norms on the encoder's 60x90x512 output at 480x720, B=8:
# clusters of 1 (and 2 for the backward at 30x45), one TMA box of 96 rows at
# 8x12, a ragged last box at 15x23, and 64 channels a group at C=2048
PROJ_SHAPES = [(512, 30, 45), (512, 15, 23), (512, 8, 12), (2048, 8, 12)]


@pytest.mark.parametrize("design", ["planned", "three_pass"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PROJ_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_at_projhead_shapes(card, shape, dtype, design):
    C, H, W = shape
    dt = getattr(torch, dtype)
    x, s, b = _inputs((8, H, W), C, dt, card, seed=H)
    assert _plan(8, H, W, C, 32, dt).design == "cluster"
    _check_against_plain(DESIGNS[design], x, s, b, 32)


@pytest.mark.parametrize("design", ["planned", "four_kernel"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PROJ_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_plain_at_projhead_shapes(card, shape, dtype, relu, design):
    C, H, W = shape
    dt = getattr(torch, dtype)
    x, s, b = _inputs((8, H, W), C, dt, card, seed=H + 1)
    assert _plan_backward(8, H, W, C, 32, dt).design == "cluster"
    _backward_of(design, x, s, b, 32, relu, _off_kink_dy(x, s, b, 32, seed=H + 2))


def test_vanilla_net_on_the_card_matches_the_cpu(card):
    """The vanilla net (no norm) at full width: the card's f32 forward, TF32
    off, within 1e-3 of max|ref| of the CPU's, and no K1 launch."""
    from crossloc_tpu_torch import models, ops

    gen = torch.Generator().manual_seed(4)
    net = models.init_weights(models.VanillaNetwork(mean_init=[1.0, -2.0, 3.0]), gen).eval()
    x = torch.rand(2, 96, 144, 1, generator=gen)
    with torch.no_grad():
        ref = net(x)
        n0 = ops.group_norm_relu.launches
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            y = net.to(card)(x.to(card)).cpu()
    assert ops.group_norm_relu.launches == n0 and y.shape == (2, 12, 18, 3)
    assert float((y - ref).abs().max()) <= 1e-3 * float(ref.abs().max())


# the cross-shard entries (the mesh's "spatial" axis): (B, H, W, C, groups),
# H splitting into 2 and 4 blocks; group sizes 1, 16 and 64, C not a power of two
SHARD_SHAPES = [(2, 32, 45, 32, 32), (2, 12, 9, 512, 32), (1, 8, 12, 2048, 32),
                (3, 8, 13, 96, 32)]


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cross_shard_entries_match_their_twins(card, shape, dtype, relu, splits):
    """Each of the four entries on the card against its plain twin on the
    same inputs (the kernels' statistics fed to both), and the merged
    blocks against the plain K1 twin on the whole image."""
    from crossloc_tpu_torch import ops

    B, H, W, C, G = shape
    dt = getattr(torch, dtype)
    x, s, b = _inputs((B, H, W), C, dt, card, seed=C + splits)
    dy = _off_kink_dy(x, s, b, G, seed=H)
    tol = 1e-4 if dtype == "float32" else 2e-2
    xs = [t.contiguous() for t in x.chunk(splits, 1)]
    dys = [t.contiguous() for t in dy.chunk(splits, 1)]
    stats = torch.stack([ops.group_norm_shard_stats(t, G) for t in xs])
    plain = torch.stack([ops.group_norm_shard_stats_plain(t, G) for t in xs])
    assert float(((stats - plain).abs() / plain.abs().clamp(min=1.0)).max()) <= 1e-5
    ys, sts = [], []
    for t in xs:
        y, st = ops.group_norm_shard_apply(t, s, b, stats, G, relu=relu)
        yp, stp = ops.group_norm_shard_apply_plain(t, s, b, stats, G, relu=relu)
        assert float((y.float() - yp.float()).abs().max()) <= tol
        assert float((st - stp).abs().max()) <= 1e-4 * float(stp.abs().max())
        ys.append(y)
        sts.append(st)
    whole = group_norm_relu_plain(x, s, b, G, relu=relu).float()
    assert float((torch.cat(ys, 1).float() - whole).abs().max()) <= tol
    sums = torch.stack([ops.group_norm_shard_backward_sums(t, s, b, st, d, G, relu)
                        for t, st, d in zip(xs, sts, dys)])
    sums_p = torch.stack([ops.group_norm_shard_backward_sums_plain(t, s, b, st, d, G, relu)
                          for t, st, d in zip(xs, sts, dys)])
    assert float((sums - sums_p).abs().max()) <= 1e-4 * float(sums_p.abs().max())
    dx_ref, ds_ref, db_ref = group_norm_relu_backward_plain(x, s, b, dy, G, relu=relu)
    dxs, ds, db = [], 0, 0
    for i, (t, st, d) in enumerate(zip(xs, sts, dys)):
        got = ops.group_norm_shard_backward_apply(t, s, b, st, d, sums, i, G, H * W, relu)
        ref = ops.group_norm_shard_backward_apply_plain(t, s, b, st, d, sums, i, G, H * W, relu)
        for a, r in zip(got, ref):
            assert float((a.float() - r.float()).abs().max()) <= tol * max(
                1.0, float(r.float().abs().max()))
        dxs.append(got[0])
        ds, db = ds + got[1], db + got[2]
    assert float((torch.cat(dxs, 1).float() - dx_ref.float()).abs().max()) <= tol * max(
        1.0, float(dx_ref.float().abs().max()))
    assert float((ds - ds_ref).abs().max()) <= 1e-4 * float(ds_ref.abs().max())
    assert float((db - db_ref).abs().max()) <= 1e-4 * float(db_ref.abs().max())
