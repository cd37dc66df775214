"""Fused GroupNorm(+ReLU) over NHWC activations: kernel K1 and its plain twin.

`group_norm_relu` is the norm inside every `ConvGN` of the port. On a CUDA
tensor it launches the hand-written kernel of `csrc/groupnorm.cu` (three
passes: stats, finalize, apply; see the note at the top of that file) or
raises; on a CPU tensor it runs `group_norm_relu_plain`. Nothing falls back
from the kernel to the plain version.

Semantics match `crossloc_tpu/ops/pallas_groupnorm.py` (`_kernel`, and its
reference `_gn_reference`): contiguous channel groups, fp32 statistics with
the centred variance, affine, optional ReLU, output in the input's dtype.
The gradient recomputes through the plain version, as the JAX `_bwd` does.
"""
from __future__ import annotations

import ctypes

import torch

GN_EPS = 1e-5  # torch nn.GroupNorm default, the nets' normaliser
_TARGET_STATS_BLOCKS = 1056  # 8 blocks per SM on a 132-SM H100
_VEC_BYTES = 16


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


def _chunking(B: int, HW: int):
    nchunks = max(1, min(HW, -(-_TARGET_STATS_BLOCKS // B)))
    chunk_rows = -(-HW // nchunks)
    return chunk_rows, -(-HW // chunk_rows)


def _launch(x, scale, bias, groups: int, eps: float, relu: bool):
    """Launch K1 on x's stream. Raises on any input it does not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"groupnorm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm kernel takes a contiguous NHWC tensor")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    B, H, W, C = x.shape
    vec = _VEC_BYTES // x.element_size()
    if C % vec != 0 or C // vec > 1024:
        raise ValueError(f"groupnorm kernel needs C % {vec} == 0 and C <= {1024 * vec}, got {C}")
    if x.data_ptr() % _VEC_BYTES != 0:
        raise ValueError("groupnorm kernel needs a 16-byte aligned input")
    if x.numel() >= 2**31:
        raise ValueError("groupnorm kernel indexes with 32-bit ints per image")
    from ._build import library

    lib = library("groupnorm")
    fn = lib.crossloc_gn_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    HW = H * W
    chunk_rows, nchunks = _chunking(B, HW)
    y = torch.empty_like(x)
    part = torch.empty(B * nchunks * 2 * C, device=x.device, dtype=torch.float32)
    affine = torch.empty(B * 3 * C, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
                 affine.data_ptr(), B, HW, C, groups, chunk_rows, nchunks, float(eps), int(relu),
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        lib.crossloc_cuda_error_string.restype = ctypes.c_char_p
        msg = lib.crossloc_cuda_error_string(err).decode()
        raise RuntimeError(f"groupnorm kernel launch failed: CUDA error {err} ({msg})")
    group_norm_relu.launches += 1
    return y


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
