"""Fused GroupNorm(+ReLU) over NHWC activations: kernel K1 and its plain twin.

`group_norm_relu` is the norm inside every `ConvGN` of the port. On a CUDA
tensor it launches the hand-written kernel of `csrc/groupnorm.cu` or raises;
on a CPU tensor it runs `group_norm_relu_plain`. Nothing falls back from the
kernel to the plain version. `_plan` picks the kernel's design per shape:
one cluster launch that reads x once where a slab of one image fits a thread
block cluster's shared memory, the three-pass design (stats, finalize,
apply) elsewhere; the note at the top of the source says why.
`_plan_backward` does the same for the backward, whose slab is x and dy
together: the cluster design (clusters of up to 16 CTAs), or the four-kernel
design that reads both twice.

Semantics match `crossloc_tpu/ops/pallas_groupnorm.py` (`_kernel`, and its
reference `_gn_reference`): contiguous channel groups, fp32 statistics with
the centred variance, affine, optional ReLU, output in the input's dtype.

The gradient: on CUDA tensors the forward also writes (mu, rstd) per (image,
group), and the backward launches the hand-written backward kernel
(`group_norm_relu_backward`) or raises; on CPU tensors it is the autograd of
the plain version (`group_norm_relu_backward_plain`), as the JAX `_bwd`
(`pallas_groupnorm.py:141`) is the vjp of its reference. At an exact tie
pre-activation == 0 the ReLU passes no gradient (torch's rule; JAX's
`jnp.maximum` passes half), so tests keep their inputs off the kink.

The cross-shard form, for the mesh's "spatial" axis: an image's rows are
split over the ranks of a spatial group, so the statistics span ranks. Four
entries, each a kernel launch sequence on CUDA tensors and a plain twin on
CPU tensors; `parallel/spatial.py::group_norm_relu_spatial` all-gathers
over the group between the two of each direction: `group_norm_shard_stats`
(per (image, group) count, mean and M2 of the shard), `group_norm_shard_apply` (the
ranks' statistics merged in rank order, then the norm),
`group_norm_shard_backward_sums` (per (image, channel) sums of the shard)
and `group_norm_shard_backward_apply` (the ranks' sums added in rank order,
dx with the image's whole H*W as the count, and this shard's part of dscale
and dbias, which the training step's all-reduce adds over the ranks).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import torch

GN_EPS = 1e-5  # torch nn.GroupNorm default, the nets' normaliser
_TARGET_STATS_BLOCKS = 1056  # 8 blocks per SM on a 132-SM H100
_VEC_BYTES = 16  # one vector load; also TMA's unit for strides and inner boxes
# the narrowest row of a channel block: two 32-byte sectors, the unit HBM
# moves. Measured on an H100 against 32 B (one sector): as fast or faster at
# every shape of the main path (PERF.md)
_MIN_ROW_BYTES = 64
_CLUSTER_SIZES = (1, 2, 4, 8)  # up to the portable 8 (no opt-in); powers of two pack GPCs
# K1-bwd, after the portable sizes: 16 CTAs, which H100 allows on request
# (non-portable); its GPCs hold 16-18 SMs
_CLUSTER_SIZES_NON_PORTABLE = (16,)
_CLUSTER_THREADS = 256
_BOX_MAX = 256  # TMA box: at most 256 elements along each dimension
_SMEM_PER_CTA = 232448  # 227 KB, the most one block may ask for on Hopper
_SLAB_PER_CTA = 200 * 1024  # slab bytes one CTA may hold (leaves room for the rest)
# shared memory bytes per CTA, tried in order: two CTAs share an SM's 228 KB
# (1 KB of it reserved per CTA), so one CTA's loads overlap another's
# statistics; else one CTA per SM
_CTA_SMEM_LIMITS = (228 * 1024 // 2 - 1024, _SMEM_PER_CTA)
_LIB = None


def group_norm_relu_plain(x, scale, bias, groups: int, eps: float = GN_EPS, relu: bool = True):
    """Plain PyTorch GroupNorm(+ReLU) on NHWC `x`: fp32 two-pass statistics."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, groups, C // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = y * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, scale, bias, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(
            f"scale/bias of {tuple(scale.shape)}/{tuple(bias.shape)} do not match channels {C}")
    if groups < 1 or C % groups != 0:
        raise ValueError(f"channels {C} are not divisible into {groups} groups")


class Plan(NamedTuple):
    """How K1 or K1-bwd runs one shape (see `_plan`, `_plan_backward`)."""
    design: str         # "cluster", or "three_pass" (K1) / "four_kernel" (K1-bwd)
    cb: int             # channels per cluster (whole groups); 0 otherwise
    cluster: int        # CTAs per cluster
    rows_per_cta: int   # H*W rows each CTA holds (the last CTA may hold fewer)
    box_rows: int       # rows per TMA box
    nbox: int           # boxes per CTA
    threads: int        # threads per CTA
    smem_bytes: int     # dynamic shared memory per CTA


_THREE_PASS = Plan("three_pass", 0, 0, 0, 0, 0, 0, 0)
_FOUR_KERNEL = Plan("four_kernel", 0, 0, 0, 0, 0, 0, 0)


def _channel_block(C: int, G: int, itemsize: int) -> int:
    """Fewest whole groups whose bytes per pixel reach _MIN_ROW_BYTES and are
    a multiple of 16 (TMA's inner-box rule); 0 if none divides C."""
    gs = C // G
    for k in range(1, G + 1):
        cb = k * gs
        if G % k == 0 and cb * itemsize >= _MIN_ROW_BYTES and cb * itemsize % _VEC_BYTES == 0:
            return cb
    return 0


def _red_slots(cb: int, itemsize: int, threads: int) -> int:
    """Row slots of the reduction scratch left after a warp's shuffles."""
    vpr = cb * itemsize // _VEC_BYTES
    return threads // 32 if 32 % vpr == 0 else threads // vpr


def _cluster_smem(itemsize: int, cb: int, gs: int, box_rows: int, nbox: int, threads: int,
                  cluster: int) -> int:
    """Dynamic shared memory of one forward CTA: alignment pad, slab, one
    mbarrier per box, the reduction scratch (two sums per channel and row
    slot), and the statistics, every rank's among them (the kernel's layout)."""
    slots = _red_slots(cb, itemsize, threads)
    return (128 + nbox * box_rows * cb * itemsize + 8 * nbox
            + 4 * (2 * slots * cb + (2 * cluster + 4) * (cb // gs)))


def _cluster_backward_smem(itemsize: int, cb: int, gs: int, box_rows: int, nbox: int,
                           threads: int, cluster: int) -> int:
    """Dynamic shared memory of one backward CTA: alignment pad, the slabs of
    x (padded to 128 bytes) and dy, one mbarrier per box pair, the reduction
    scratch, this CTA's, every rank's and the image's two sums per channel,
    and two coefficients per group (the kernel's layout)."""
    slots = _red_slots(cb, itemsize, threads)
    slab = nbox * box_rows * cb * itemsize
    return (128 + -(-slab // 128) * 128 + -(-slab // 16) * 16 + 8 * nbox
            + 4 * (2 * slots * cb + (2 * cluster + 4) * cb + 2 * (cb // gs)))


def _cluster_plan(HW: int, C: int, G: int, itemsize: int, slabs: int, smem_fn,
                  size_groups=(_CLUSTER_SIZES,)):
    """The cluster plan for `slabs` tensors of [H*W, cb] held per (image,
    channel block), or None where none fits: within each group of cluster
    sizes in turn, the smallest cluster whose CTAs are small enough that two
    share an SM, else the smallest whose CTAs hold at most _SLAB_PER_CTA
    bytes of slab (one CTA per SM)."""
    gs = C // G
    cb = _channel_block(C, G, itemsize)
    vpr = cb * itemsize // _VEC_BYTES
    if cb == 0 or cb > _BOX_MAX or vpr > _CLUSTER_THREADS or C * itemsize % _VEC_BYTES:
        return None
    threads = vpr * (_CLUSTER_THREADS // vpr)
    for sizes, smem_limit in itertools.product(size_groups, _CTA_SMEM_LIMITS):
        for cs in sizes:
            rows = -(-HW // cs)
            nbox = -(-rows // _BOX_MAX)
            box_rows = -(-rows // nbox)
            if nbox > 1:  # each box starts 128-byte aligned in shared memory
                box_rows = -(-box_rows // 8) * 8
            rows_per_cta = nbox * box_rows
            cluster = -(-HW // rows_per_cta)  # every CTA holds rows
            smem = smem_fn(itemsize, cb, gs, box_rows, nbox, threads, cluster)
            if slabs * rows_per_cta * cb * itemsize <= _SLAB_PER_CTA and smem <= smem_limit:
                return Plan("cluster", cb, cluster, rows_per_cta, box_rows, nbox, threads, smem)
    return None


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, W: int, C: int, G: int, dtype) -> Plan:
    """Pick K1's design for one shape: pure arithmetic on the shape.

    "cluster" when the slab of one (image, channel block), H*W*cb*itemsize,
    fits a cluster of at most 8 CTAs: the smallest cluster whose CTAs are
    small enough that two share an SM (about 100 KB of slab each), else the
    smallest whose CTAs hold at most 200 KB of slab (one CTA per SM).
    Everything else runs "three_pass"."""
    del B  # one cluster per image and channel block, whatever the batch
    plan = _cluster_plan(H * W, C, G, dtype.itemsize, 1, _cluster_smem)
    return plan or _THREE_PASS


@functools.lru_cache(maxsize=None)
def _plan_backward(B: int, H: int, W: int, C: int, G: int, dtype) -> Plan:
    """Pick K1-bwd's design for one shape, as `_plan` does for K1, with the
    slab of x and that of dy held together: "cluster" where both fit a
    cluster of at most 8 CTAs, else of 16 (at most 200 KB of the two a
    CTA); "four_kernel" elsewhere."""
    del B
    plan = _cluster_plan(H * W, C, G, dtype.itemsize, 2, _cluster_backward_smem,
                         (_CLUSTER_SIZES, _CLUSTER_SIZES_NON_PORTABLE))
    return plan or _FOUR_KERNEL


def _chunking(B: int, HW: int):
    nchunks = max(1, min(HW, -(-_TARGET_STATS_BLOCKS // B)))
    chunk_rows = -(-HW // nchunks)
    return chunk_rows, -(-HW // chunk_rows)


def _lib():
    """The kernel library, with its C signatures set once at load."""
    global _LIB
    if _LIB is None:
        from ._build import library

        lib = library("groupnorm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crossloc_gn_forward.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_forward.restype = i
        lib.crossloc_gn_cluster_forward.argtypes = [p] * 5 + [i] * 11 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_cluster_forward.restype = i
        lib.crossloc_gn_backward.argtypes = [p] * 11 + [i] * 8 + [p]
        lib.crossloc_gn_backward.restype = i
        lib.crossloc_gn_cluster_backward.argtypes = [p] * 9 + [i] * 13 + [p]
        lib.crossloc_gn_cluster_backward.restype = i
        lib.crossloc_gn_shard_stats.argtypes = [p] * 3 + [i] * 7 + [p]
        lib.crossloc_gn_shard_stats.restype = i
        lib.crossloc_gn_shard_apply.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_shard_apply.restype = i
        lib.crossloc_gn_shard_backward_sums.argtypes = [p] * 7 + [i] * 8 + [p]
        lib.crossloc_gn_shard_backward_sums.restype = i
        lib.crossloc_gn_shard_backward_apply.argtypes = [p] * 11 + [i] * 9 + [p]
        lib.crossloc_gn_shard_backward_apply.restype = i
        lib.crossloc_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_cuda(x, scale, bias) -> None:
    """Raise on any CUDA input the kernels do not take."""
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    _check_cuda_x(x)


def _check_cuda_x(x) -> None:
    """Raise on any CUDA activation the kernels do not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"groupnorm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm kernel takes a contiguous NHWC tensor")
    C = x.shape[-1]
    vec = _VEC_BYTES // x.element_size()
    if C % vec != 0 or C // vec > 1024:
        raise ValueError(f"groupnorm kernel needs C % {vec} == 0 and C <= {1024 * vec}, got {C}")
    if x.data_ptr() % _VEC_BYTES != 0:
        raise ValueError("groupnorm kernel needs a 16-byte aligned input")
    if x.numel() >= 2**31:
        raise ValueError("groupnorm kernel indexes with 32-bit ints per image")


def _raise_on(err: int, lib, design: str) -> None:
    if err != 0:
        msg = lib.crossloc_cuda_error_string(err).decode()
        raise RuntimeError(f"groupnorm {design} launch failed: error {err} ({msg})")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _three_pass(x, scale, bias, groups: int, eps: float, relu: bool, stats=None):
    """The three-pass design on x's stream: stats, finalize, apply (three
    kernels, a scratch of partials). `_plan` sends slabs too large for a
    cluster here; called directly, it takes every shape (for comparisons).
    A float32 `stats` [B, groups, 2] receives (mu, rstd) per (image, group)."""
    _check_cuda(x, scale, bias)
    lib = _lib()
    B, H, W, C = x.shape
    HW = H * W
    chunk_rows, nchunks = _chunking(B, HW)
    y = torch.empty_like(x)
    part = torch.empty(B * nchunks * 2 * C, device=x.device, dtype=torch.float32)
    affine = torch.empty(B * 3 * C, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
            affine.data_ptr(), _ptr(stats), B, HW, C, groups, chunk_rows, nchunks, float(eps),
            int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "three-pass")
    group_norm_relu.launches += 1
    return y


def _cluster(x, scale, bias, groups: int, eps: float, relu: bool, plan: Plan, stats=None):
    """The cluster design on x's stream: one launch, x read once, no scratch."""
    lib = _lib()
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_cluster_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(stats), B, H * W,
            C, groups, plan.cb, plan.cluster, plan.rows_per_cta, plan.box_rows, plan.nbox,
            plan.threads, plan.smem_bytes, float(eps), int(relu), int(x.dtype == torch.bfloat16),
            stream)
    _raise_on(err, lib, "cluster")
    group_norm_relu.launches += 1
    return y


def _launch(x, scale, bias, groups: int, eps: float, relu: bool, stats=None):
    """Launch K1 on x's stream in the design `_plan` picks. Raises on any
    input it does not take; a failed launch raises, it never falls back."""
    _check_cuda(x, scale, bias)
    B, H, W, C = x.shape
    plan = _plan(B, H, W, C, groups, x.dtype)
    if plan.design == "cluster":
        return _cluster(x, scale, bias, groups, eps, relu, plan, stats)
    return _three_pass(x, scale, bias, groups, eps, relu, stats)


def _forward(x, scale, bias, groups: int, eps: float, relu: bool):
    if x.is_cuda:
        return _launch(x, scale, bias, groups, eps, relu)
    if x.device.type == "cpu":
        return group_norm_relu_plain(x, scale, bias, groups, eps, relu)
    raise ValueError(f"no groupnorm for device {x.device}")


def group_norm_relu_backward_plain(x, scale, bias, dy, groups: int, eps: float = GN_EPS,
                                   relu: bool = True):
    """(dx, dscale, dbias) of `group_norm_relu_plain` at (x, scale, bias) for
    the output gradient dy: its autograd, recomputing the forward (the JAX
    `_bwd`). dx in x's dtype, dscale and dbias float32."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
        y = group_norm_relu_plain(*leaves, groups, eps, relu)
        return torch.autograd.grad(y, leaves, dy)


def _check_backward(x, scale, bias, stats, dy, groups: int) -> None:
    """Raise on any CUDA input the backward kernels do not take."""
    _check(x, scale, bias, groups)
    _check_cuda(x, scale, bias)
    B = x.shape[0]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} does not match x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if not dy.is_contiguous() or dy.data_ptr() % _VEC_BYTES != 0:
        raise ValueError("groupnorm backward takes a contiguous, 16-byte aligned NHWC dy")
    if (stats.shape != (B, groups, 2) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous float32 [{B}, {groups}, 2] on {x.device}")


def _four_kernel_backward(x, scale, bias, stats, dy, groups: int, relu: bool = True):
    """The four-kernel backward on x's stream: per-chunk partials, per-image
    sums, the group coefficients with dscale and dbias, dx (x and dy read
    twice). `_plan_backward` sends slabs too large for a cluster here;
    called directly, it takes every shape (for comparisons)."""
    _check_backward(x, scale, bias, stats, dy, groups)
    lib = _lib()
    B, H, W, C = x.shape
    HW = H * W
    chunk_rows, nchunks = _chunking(B, HW)
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=torch.float32)
    dbias = torch.empty(C, device=x.device, dtype=torch.float32)
    part = torch.empty(B * nchunks * 2 * C, device=x.device, dtype=torch.float32)
    sums = torch.empty(B * 2 * C, device=x.device, dtype=torch.float32)
    table = torch.empty(B * 5 * C, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_backward(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), part.data_ptr(),
            sums.data_ptr(), table.data_ptr(), B, HW, C, groups, chunk_rows, nchunks,
            int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "four-kernel backward")
    group_norm_relu_backward.launches += 1
    return dx, dscale, dbias


def _cluster_backward(x, scale, bias, stats, dy, groups: int, relu: bool, plan: Plan):
    """The cluster backward on x's stream: one cluster launch that reads x
    and dy once, then the images' per-channel sums added in order into
    dscale and dbias."""
    lib = _lib()
    B, H, W, C = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=torch.float32)
    dbias = torch.empty(C, device=x.device, dtype=torch.float32)
    sums = torch.empty(B * 2 * C, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_cluster_backward(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), sums.data_ptr(), B, H * W, C,
            groups, plan.cb, plan.cluster, plan.rows_per_cta, plan.box_rows, plan.nbox,
            plan.threads, plan.smem_bytes, int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "cluster backward")
    group_norm_relu_backward.launches += 1
    return dx, dscale, dbias


def group_norm_relu_backward(x, scale, bias, stats, dy, groups: int, relu: bool = True):
    """K1's backward on x's stream, in the design `_plan_backward` picks:
    (dx, dscale, dbias) from x, the forward's `stats` (float32 [B, groups,
    2] of mu, rstd) and dy (x's dtype, shape and layout). Raises on any
    input it does not take, including a non-contiguous dy; a failed launch
    raises, it never falls back."""
    _check_backward(x, scale, bias, stats, dy, groups)
    B, H, W, C = x.shape
    plan = _plan_backward(B, H, W, C, groups, x.dtype)
    if plan.design == "cluster":
        return _cluster_backward(x, scale, bias, stats, dy, groups, relu, plan)
    return _four_kernel_backward(x, scale, bias, stats, dy, groups, relu)


group_norm_relu_backward.launches = 0  # backward kernel launches (CUDA calls only)


class _GroupNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, relu):
        ctx.cfg = (groups, eps, relu)
        if x.is_cuda:
            stats = torch.empty(x.shape[0], groups, 2, device=x.device, dtype=torch.float32)
            y = _launch(x, scale, bias, groups, eps, relu, stats)
            ctx.save_for_backward(x, scale, bias, stats)
            return y
        ctx.save_for_backward(x, scale, bias)
        return _forward(x, scale, bias, groups, eps, relu)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, *stats = ctx.saved_tensors
        groups, eps, relu = ctx.cfg
        if x.is_cuda:
            grads = group_norm_relu_backward(x, scale, bias, stats[0], g.contiguous(), groups,
                                             relu)
        else:
            grads = group_norm_relu_backward_plain(x, scale, bias, g, groups, eps, relu)
        return (*grads, None, None, None)


def group_norm_relu(x, scale, bias, groups: int = 32, eps: float = GN_EPS, relu: bool = True):
    """GroupNorm(+ReLU) over NHWC `x` [B, H, W, C] with fp32 `scale`/`bias` [C].

    CUDA tensors launch kernel K1 (and count one launch); CPU tensors take
    the plain version. Differentiable: on CUDA the backward kernel (counted
    on `group_norm_relu_backward.launches`), on the CPU the plain autograd."""
    _check(x, scale, bias, groups)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _GroupNormReLU.apply(x, scale, bias, groups, eps, relu)
    return _forward(x, scale, bias, groups, eps, relu)


group_norm_relu.launches = 0  # kernel launches (CUDA calls); CPU calls never count


# -- the cross-shard form ------------------------------------------------------


def _is_cpu(x) -> bool:
    """True for a CPU tensor (the twin runs), False for a CUDA one (the
    kernel runs); raises for any other device."""
    if x.device.type in ("cpu", "cuda"):
        return x.device.type == "cpu"
    raise ValueError(f"no groupnorm for device {x.device}")


def _check_shard(x, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    if groups < 1 or x.shape[-1] % groups != 0:
        raise ValueError(f"channels {x.shape[-1]} are not divisible into {groups} groups")


def _check_gathered(gathered, x, shape) -> None:
    """The all-gathered statistics or sums: float32 [S, *shape] on x's device."""
    if (gathered.dim() != len(shape) + 1 or tuple(gathered.shape[1:]) != tuple(shape)
            or gathered.dtype != torch.float32 or gathered.device != x.device
            or not gathered.is_contiguous()):
        raise ValueError(f"expected a contiguous float32 [S, {', '.join(map(str, shape))}] on "
                         f"{x.device}, got {tuple(gathered.shape)} {gathered.dtype} on "
                         f"{gathered.device}")


def _per_channel(t, C: int):
    """[B, G] -> [B, 1, 1, C], each group's value on its channels."""
    return t.repeat_interleave(C // t.shape[1], dim=1)[:, None, None, :]


def group_norm_shard_stats_plain(x, groups: int):
    """Plain twin of K1-shard-stats: float32 [B, groups, 3] of (count, mean,
    M2) per (image, group) over this shard's rows, M2 the centred sum of
    squares."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, groups, C // groups)
    mean = xf.mean(dim=(1, 3))
    m2 = (xf - mean[:, None, :, None]).square().sum(dim=(1, 3))
    return torch.stack([torch.full_like(mean, float(H * W * (C // groups))), mean, m2], dim=-1)


def _merge_shard_stats(gathered):
    """(mean, var) [B, G] of [S, B, G, 3] (count, mean, M2) merged with
    Chan's formula in rank order, var clamped at 0."""
    n, mean, m2 = gathered[0].unbind(-1)
    for part in gathered[1:]:
        nb, mb, qb = part.unbind(-1)
        total = n + nb
        delta = mb - mean
        wb = nb / total
        mean = mean + delta * wb
        m2 = m2 + qb + delta * delta * n * wb
        n = total
    return mean, torch.clamp(m2 / n, min=0.0)


def group_norm_shard_apply_plain(x, scale, bias, gathered, groups: int, eps: float = GN_EPS,
                                 relu: bool = True):
    """Plain twin of K1-shard-apply: (y, stats) of this shard's rows from
    every rank's `group_norm_shard_stats` ([S, B, groups, 3], merged in rank
    order); stats is float32 [B, groups, 2] of (mu, rstd)."""
    B, H, W, C = x.shape
    mean, var = _merge_shard_stats(gathered.float())
    rstd = torch.rsqrt(var + eps)
    xf = x.float().reshape(B, H * W, groups, C // groups)
    y = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(B, H, W, C)
    y = y * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), torch.stack([mean, rstd], dim=-1)


def _masked_grad(x, scale, bias, stats, dy, relu: bool):
    """(x - mu, rstd per channel, gh): gh is dy where the forward's ReLU
    passed, in float32."""
    C = x.shape[-1]
    mu, r = _per_channel(stats[..., 0], C), _per_channel(stats[..., 1], C)
    d = x.float() - mu
    gh = dy.float()
    if relu:
        gh = torch.where(d * (scale.float() * r) + bias.float() > 0, gh, torch.zeros_like(gh))
    return d, r, gh


def group_norm_shard_backward_sums_plain(x, scale, bias, stats, dy, groups: int,
                                         relu: bool = True):
    """Plain twin of K1-bwd-shard-sums: float32 [B, 2, C], per (image,
    channel) the sums over this shard's rows of gh and gh * xhat."""
    del groups  # the stats carry them
    d, r, gh = _masked_grad(x, scale, bias, stats, dy, relu)
    return torch.stack([gh.sum(dim=(1, 2)), (gh * d * r).sum(dim=(1, 2))], dim=1)


def group_norm_shard_backward_apply_plain(x, scale, bias, stats, dy, gathered, index: int,
                                          groups: int, count_hw: int, relu: bool = True):
    """Plain twin of K1-bwd-shard-apply: (dx, dscale, dbias) from every
    rank's `group_norm_shard_backward_sums` ([S, B, 2, C], added in rank
    order); `count_hw` is the whole image's H*W. dscale and dbias are this
    shard's part (rank `index`'s sums over its images)."""
    B, H, W, C = x.shape
    sums = gathered[0]
    for part in gathered[1:]:
        sums = sums + part
    n = count_hw * (C // groups)
    g = scale.float()
    c1 = (g * sums[:, 0]).reshape(B, groups, -1).sum(-1) / n
    c2 = (g * sums[:, 1]).reshape(B, groups, -1).sum(-1) / n
    d, r, gh = _masked_grad(x, scale, bias, stats, dy, relu)
    dx = (g * r) * gh - r * _per_channel(c1, C) - d * r * r * _per_channel(c2, C)
    own = gathered[index]
    return dx.to(x.dtype), own[:, 1].sum(0), own[:, 0].sum(0)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def group_norm_shard_stats(x, groups: int):
    """K1-shard-stats: float32 [B, groups, 3] (count, mean, M2) of this
    shard's rows; the kernel on a CUDA tensor (one launch counted), the twin
    on a CPU tensor."""
    _check_shard(x, groups)
    if _is_cpu(x):
        return group_norm_shard_stats_plain(x, groups)
    _check_cuda_x(x)
    lib = _lib()
    B, H, W, C = x.shape
    chunk_rows, nchunks = _chunking(B, H * W)
    part = torch.empty(B * nchunks * 2 * C, device=x.device, dtype=torch.float32)
    out = torch.empty(B, groups, 3, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_shard_stats(x.data_ptr(), part.data_ptr(), out.data_ptr(), B,
                                          H * W, C, groups, chunk_rows, nchunks,
                                          int(x.dtype == torch.bfloat16), _stream(x))
    _raise_on(err, lib, "shard stats")
    group_norm_shard_stats.launches += 1
    return out


def group_norm_shard_apply(x, scale, bias, gathered, groups: int, eps: float = GN_EPS,
                           relu: bool = True):
    """K1-shard-apply: (y, stats [B, groups, 2] of (mu, rstd)) of this
    shard's rows from every rank's statistics `gathered` [S, B, groups, 3];
    the kernel on a CUDA tensor (one launch counted), the twin on a CPU
    tensor."""
    _check(x, scale, bias, groups)
    _check_gathered(gathered, x, (x.shape[0], groups, 3))
    if _is_cpu(x):
        return group_norm_shard_apply_plain(x, scale, bias, gathered, groups, eps, relu)
    _check_cuda(x, scale, bias)
    lib = _lib()
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    affine = torch.empty(B * 3 * C, device=x.device, dtype=torch.float32)
    stats = torch.empty(B, groups, 2, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_shard_apply(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), gathered.data_ptr(),
            affine.data_ptr(), stats.data_ptr(), gathered.shape[0], B, H * W, C, groups,
            float(eps), int(relu), int(x.dtype == torch.bfloat16), _stream(x))
    _raise_on(err, lib, "shard apply")
    group_norm_shard_apply.launches += 1
    return y, stats


def group_norm_shard_backward_sums(x, scale, bias, stats, dy, groups: int, relu: bool = True):
    """K1-bwd-shard-sums: float32 [B, 2, C] sums of gh and gh * xhat over
    this shard's rows; the kernels on CUDA tensors (one launch counted), the
    twin on CPU tensors."""
    if _is_cpu(x):
        _check(x, scale, bias, groups)
        return group_norm_shard_backward_sums_plain(x, scale, bias, stats, dy, groups, relu)
    _check_backward(x, scale, bias, stats, dy, groups)
    lib = _lib()
    B, H, W, C = x.shape
    chunk_rows, nchunks = _chunking(B, H * W)
    part = torch.empty(B * nchunks * 2 * C, device=x.device, dtype=torch.float32)
    sums = torch.empty(B, 2, C, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_shard_backward_sums(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            part.data_ptr(), sums.data_ptr(), B, H * W, C, groups, chunk_rows, nchunks,
            int(relu), int(x.dtype == torch.bfloat16), _stream(x))
    _raise_on(err, lib, "shard backward sums")
    group_norm_shard_backward_sums.launches += 1
    return sums


def group_norm_shard_backward_apply(x, scale, bias, stats, dy, gathered, index: int, groups: int,
                                    count_hw: int, relu: bool = True):
    """K1-bwd-shard-apply: (dx, dscale, dbias) of this shard from every
    rank's sums `gathered` [S, B, 2, C], the whole image's `count_hw` = H*W
    and this rank's `index` in the group (its dscale and dbias are the
    shard's part); the kernels on CUDA tensors (one launch counted), the
    twin on CPU tensors."""
    _check_gathered(gathered, x, (x.shape[0], 2, x.shape[-1]))
    if not 0 <= index < gathered.shape[0]:
        raise ValueError(f"rank index {index} outside the group of {gathered.shape[0]}")
    if _is_cpu(x):
        _check(x, scale, bias, groups)
        return group_norm_shard_backward_apply_plain(x, scale, bias, stats, dy, gathered, index,
                                                     groups, count_hw, relu)
    _check_backward(x, scale, bias, stats, dy, groups)
    lib = _lib()
    B, H, W, C = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=torch.float32)
    dbias = torch.empty(C, device=x.device, dtype=torch.float32)
    sums = torch.empty(B * 2 * C, device=x.device, dtype=torch.float32)
    table = torch.empty(B * 5 * C, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_shard_backward_apply(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            gathered.data_ptr(), sums.data_ptr(), table.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), index, gathered.shape[0], B, H * W,
            int(count_hw), C, groups, int(relu), int(x.dtype == torch.bfloat16), _stream(x))
    _raise_on(err, lib, "shard backward apply")
    group_norm_shard_backward_apply.launches += 1
    return dx, dscale, dbias


for _entry in (group_norm_shard_stats, group_norm_shard_apply, group_norm_shard_backward_sums,
               group_norm_shard_backward_apply):
    _entry.launches = 0  # launch sequences on CUDA tensors; CPU calls never count
