"""Fused GroupNorm(+ReLU) over NHWC activations: kernel K1 and its plain twin.

`group_norm_relu` is the norm inside every `ConvGN` of the port. On a CUDA
tensor it launches the hand-written kernel of `csrc/groupnorm.cu` or raises;
on a CPU tensor it runs `group_norm_relu_plain`. Nothing falls back from the
kernel to the plain version. `_plan` picks the kernel's design per shape:
one cluster launch that reads x once where a slab of one image fits a thread
block cluster's shared memory, the three-pass design (stats, finalize,
apply) elsewhere; the note at the top of the source says why.

Semantics match `crossloc_tpu/ops/pallas_groupnorm.py` (`_kernel`, and its
reference `_gn_reference`): contiguous channel groups, fp32 statistics with
the centred variance, affine, optional ReLU, output in the input's dtype.
The gradient recomputes through the plain version, as the JAX `_bwd` does.
"""
from __future__ import annotations

import ctypes
import functools
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
    """How K1 runs one shape (see `_plan`)."""
    design: str         # "cluster" or "three_pass"
    cb: int             # channels per cluster (whole groups); 0 for three_pass
    cluster: int        # CTAs per cluster
    rows_per_cta: int   # H*W rows each CTA holds (the last CTA may hold fewer)
    box_rows: int       # rows per TMA box
    nbox: int           # boxes per CTA
    threads: int        # threads per CTA
    smem_bytes: int     # dynamic shared memory per CTA


_THREE_PASS = Plan("three_pass", 0, 0, 0, 0, 0, 0, 0)


def _channel_block(C: int, G: int, itemsize: int) -> int:
    """Fewest whole groups whose bytes per pixel reach _MIN_ROW_BYTES and are
    a multiple of 16 (TMA's inner-box rule); 0 if none divides C."""
    gs = C // G
    for k in range(1, G + 1):
        cb = k * gs
        if G % k == 0 and cb * itemsize >= _MIN_ROW_BYTES and cb * itemsize % _VEC_BYTES == 0:
            return cb
    return 0


def _cluster_smem(itemsize: int, cb: int, gs: int, box_rows: int, nbox: int, threads: int,
                  cluster: int) -> int:
    """Dynamic shared memory of one CTA: alignment pad, slab, one mbarrier per
    box, the reduction scratch (two sums per channel and row slot left after
    a warp's shuffles), and the statistics, every rank's among them (the
    kernel's layout)."""
    vpr = cb * itemsize // _VEC_BYTES
    slots = threads // 32 if 32 % vpr == 0 else threads // vpr
    return (128 + nbox * box_rows * cb * itemsize + 8 * nbox
            + 4 * (2 * slots * cb + (2 * cluster + 4) * (cb // gs)))


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, W: int, C: int, G: int, dtype) -> Plan:
    """Pick K1's design for one shape: pure arithmetic on the shape.

    "cluster" when the slab of one (image, channel block), H*W*cb*itemsize,
    fits a cluster of at most 8 CTAs: the smallest cluster whose CTAs are
    small enough that two share an SM (about 100 KB of slab each), else the
    smallest whose CTAs hold at most 200 KB of slab (one CTA per SM).
    Everything else runs "three_pass"."""
    del B  # one cluster per image and channel block, whatever the batch
    itemsize = dtype.itemsize
    HW, gs = H * W, C // G
    cb = _channel_block(C, G, itemsize)
    vpr = cb * itemsize // _VEC_BYTES
    if cb == 0 or cb > _BOX_MAX or vpr > _CLUSTER_THREADS or C * itemsize % _VEC_BYTES:
        return _THREE_PASS
    threads = vpr * (_CLUSTER_THREADS // vpr)
    for smem_limit in _CTA_SMEM_LIMITS:
        for cs in _CLUSTER_SIZES:
            rows = -(-HW // cs)
            nbox = -(-rows // _BOX_MAX)
            box_rows = -(-rows // nbox)
            if nbox > 1:  # each box starts 128-byte aligned in shared memory
                box_rows = -(-box_rows // 8) * 8
            rows_per_cta = nbox * box_rows
            cluster = -(-HW // rows_per_cta)  # every CTA holds rows
            smem = _cluster_smem(itemsize, cb, gs, box_rows, nbox, threads, cluster)
            if rows_per_cta * cb * itemsize <= _SLAB_PER_CTA and smem <= smem_limit:
                return Plan("cluster", cb, cluster, rows_per_cta, box_rows, nbox, threads, smem)
    return _THREE_PASS


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
        lib.crossloc_gn_forward.argtypes = [p] * 6 + [i] * 6 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_forward.restype = i
        lib.crossloc_gn_cluster_forward.argtypes = [p] * 4 + [i] * 11 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_cluster_forward.restype = i
        lib.crossloc_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_cuda(x, scale, bias) -> None:
    """Raise on any CUDA input the kernels do not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"groupnorm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm kernel takes a contiguous NHWC tensor")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
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


def _three_pass(x, scale, bias, groups: int, eps: float, relu: bool):
    """The three-pass design on x's stream: stats, finalize, apply (three
    kernels, a scratch of partials). `_plan` sends slabs too large for a
    cluster here; called directly, it takes every shape (for comparisons)."""
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
            affine.data_ptr(), B, HW, C, groups, chunk_rows, nchunks, float(eps), int(relu),
            int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "three-pass")
    group_norm_relu.launches += 1
    return y


def _cluster(x, scale, bias, groups: int, eps: float, relu: bool, plan: Plan):
    """The cluster design on x's stream: one launch, x read once, no scratch."""
    lib = _lib()
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_cluster_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), B, H * W, C, groups,
            plan.cb, plan.cluster, plan.rows_per_cta, plan.box_rows, plan.nbox, plan.threads,
            plan.smem_bytes, float(eps), int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "cluster")
    group_norm_relu.launches += 1
    return y


def _launch(x, scale, bias, groups: int, eps: float, relu: bool):
    """Launch K1 on x's stream in the design `_plan` picks. Raises on any
    input it does not take; a failed launch raises, it never falls back."""
    _check_cuda(x, scale, bias)
    B, H, W, C = x.shape
    plan = _plan(B, H, W, C, groups, x.dtype)
    if plan.design == "cluster":
        return _cluster(x, scale, bias, groups, eps, relu, plan)
    return _three_pass(x, scale, bias, groups, eps, relu)


def _forward(x, scale, bias, groups: int, eps: float, relu: bool):
    if x.is_cuda:
        return _launch(x, scale, bias, groups, eps, relu)
    if x.device.type == "cpu":
        return group_norm_relu_plain(x, scale, bias, groups, eps, relu)
    raise ValueError(f"no groupnorm for device {x.device}")


class _GroupNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, relu):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (groups, eps, relu)
        return _forward(x, scale, bias, groups, eps, relu)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
            y = group_norm_relu_plain(*leaves, *ctx.cfg)
            grads = torch.autograd.grad(y, leaves, g)
        return (*grads, None, None, None)


def group_norm_relu(x, scale, bias, groups: int = 32, eps: float = GN_EPS, relu: bool = True):
    """GroupNorm(+ReLU) over NHWC `x` [B, H, W, C] with fp32 `scale`/`bias` [C].

    CUDA tensors launch kernel K1 (and count one launch); CPU tensors take
    the plain version. Differentiable: the backward recomputes through the
    plain version."""
    _check(x, scale, bias, groups)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _GroupNormReLU.apply(x, scale, bias, groups, eps, relu)
    return _forward(x, scale, bias, groups, eps, relu)


group_norm_relu.launches = 0  # kernel launches (CUDA calls); CPU calls never count
