"""Image -> pose throughput of the port (counterpart of the root `bench.py`).

The coord + MLE net in bfloat16 at 480x720 with seeded weights, fed seeded
images, then the RANSAC solver with the default `RansacConfig` (64
hypotheses, tau = 10 px): one warm-up batch, then `iters` batches between
two `torch.cuda.synchronize()` calls on the host clock.

    python -m crossloc_tpu_torch.tools.bench [batch=128] [iters=10]
    python -m crossloc_tpu_torch.tools.bench 2 1 --device cpu --tiny --size 64 96

Prints the FLOP count of one image's convolutions (2 C_in C_out k^2 H_out
W_out over every conv of the net, from the port's own conv shapes), then one
JSON line: `metric`, `value` (img/s), `unit`, `device` (the `nvidia-smi`
name and power limit), `mfu` (img/s x conv FLOP per image / 989.4 TFLOP/s,
the H100 SXM's dense bf16 peak; the solver's FLOPs are left out), and the
K1 launches per batch. On the CPU (`--device cpu`, for the tests) `device`
is "cpu" and `mfu` null: a CPU rate is no device utilization. Without CUDA
and without `--device cpu` it raises.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import models, ops
from ..device import resolve_device
from ..inference import make_localizer
from ..models.layers import Conv
from ..ransac import RansacConfig

H100_BF16_FLOPS = 989.4e12  # H100 SXM, dense bf16, NVIDIA data sheet
BASELINE_GFLOP = 291.7  # BASELINE.md: the reference net at 480x720, one image
URBANSCAPE_MEAN = [-29.34, 184.17, 91.96]


def conv_flops(model: torch.nn.Module, height: int, width: int) -> int:
    """FLOP of one image's convolutions: 2 C_in C_out k_h k_w H_out
    W_out summed over every conv that runs in one forward at height x width
    (one batch-1 forward on the model's device, the NHWC output shapes taken
    by hooks)."""
    total = 0

    def hook(conv, _inputs, out):
        nonlocal total
        kh, kw = conv.kernel_size
        total += 2 * conv.in_channels * conv.out_channels * kh * kw * out.shape[1] * out.shape[2]

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]
    try:
        p = next(model.parameters())
        with torch.no_grad():
            model(torch.zeros(1, height, width, 3, device=p.device))
    finally:
        for h in handles:
            h.remove()
    return total


def device_line(device: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def run(batch: int = 128, iters: int = 10, device=None, tiny: bool = False,
        size=(480, 720)) -> dict:
    """Build, warm up and time; returns the JSON line's dict."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    h, w = size
    model = models.init_weights(
        models.build_network("coord", "MLE", tiny=tiny, mean=URBANSCAPE_MEAN,
                             dtype=torch.bfloat16),
        torch.Generator().manual_seed(0))
    model.to(dev).eval()
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    flop = conv_flops(model, h, w)
    print(f"conv FLOP per image at {h}x{w}: {flop / 1e9:.4f} GFLOP (the port's conv shapes; "
          f"BASELINE.md counts {BASELINE_GFLOP} GFLOP for the reference net at 480x720; "
          f"the solver's FLOPs are left out)", flush=True)

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(batch, h, w, 3)).astype(np.float32)).to(dev)
    localize = make_localizer(model, RansacConfig())
    gen = torch.Generator(device=dev).manual_seed(1)
    focal = 480.0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    localize(images, focal, generator=gen)  # warm-up: cuDNN's choice, the kernels' build
    sync()
    ops.group_norm_relu.launches = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        _, res = localize(images, focal, generator=gen)
    sync()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(res.cam_to_world).all()):
        raise RuntimeError("non-finite poses")
    img_s = batch * iters / dt
    return {
        "metric": f"image_to_pose_throughput_{h}x{w}_b{batch}",
        "value": img_s,
        "unit": "images/sec/card",
        "device": device_line(dev),
        "mfu": img_s * flop / H100_BF16_FLOPS if dev.type == "cuda" else None,
        "conv_gflop_per_image": flop / 1e9,
        "k1_launches_per_batch": ops.group_norm_relu.launches / iters,
        "batch": batch,
        "iters": iters,
        "seconds": dt,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("iters", type=int, nargs="?", default=10)
    ap.add_argument("--device", default=None, help="default: cuda (raises without it)")
    ap.add_argument("--tiny", action="store_true", help="the tiny net (CPU tests)")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 720), metavar=("H", "W"))
    args = ap.parse_args(argv)
    out = run(args.batch, args.iters, args.device, args.tiny, tuple(args.size))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
