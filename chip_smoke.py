"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --phases card,kernels

Phases:
  card     print the card, turn TF32 off, build every CUDA source (nvcc, in
           parallel) and print the build time;
  kernels  hold each kernel against its plain PyTorch version at every shape
           of the main path (f32 and bf16, ReLU on and off) and time kernel,
           plain version, one PyTorch library call, against the bytes bound;
  forward  full-width coord+MLE net at 480x720, B=8, seeded weights: kernel
           path against the same net through the plain norm, and 28 kernel
           launches per forward;
  serve    write a 480x720 scene, save a seeded `.net`, run the port's
           `test_single_task` in-process on cuda (the main path: results_*.txt,
           finite poses, kernel launches counted on that run), again with
           --bf16; GT-oracle solver accuracy against the CPU; img/s.
  profile  (extra, not in the default run) kernel-time breakdown of one
           image -> pose batch with torch.profiler.

Prints the card's name and power limit, one JSON line of kernels, and last
`{"ok": true, "device": {...}}`. Exits non-zero if any phase fails, if no
CUDA device is present, or if the port's package is not beside this file.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(HERE, "crossloc_tpu_torch", "build", "smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM, non-tensor-core fp32
BATCH = 8
IMG_H, IMG_W = 480, 720

# (C, H, W, relu, layers per forward) of the 28 Conv->GN layers at 480x720
GN_PATH_SHAPES = [
    (32, 480, 720, True, 1),   # stem1
    (64, 240, 360, True, 1),   # stem2
    (128, 120, 180, True, 1),  # stem3
    (256, 60, 90, True, 4),    # stem4, res1_1..3
    (512, 60, 90, True, 20),   # res2_1..3, enc/dec add_res, res3, fc1, fc2
    (512, 60, 90, False, 1),   # res2_skip
]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, iters: int, out_dir: str):
        self.iters = iters
        self.out_dir = out_dir  # JSON and profile tables
        self.kernels = {}  # name -> dict of the kernels line
        self.device_name = None

    # -- phase 1 -----------------------------------------------------------
    def phase_card(self):
        import torch

        self.device_name = torch.cuda.get_device_name(0)
        log(f"card: {self.device_name} | {nvidia_smi_line()} | torch {torch.__version__} "
            f"cuda {torch.version.cuda} python {sys.version.split()[0]}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
        from crossloc_tpu_torch.ops import _build

        t0 = time.perf_counter()
        names = _build.all_sources()
        _build.build(names)
        for n in names:
            _build.library(n)
        log(f"built {names} in {time.perf_counter() - t0:.2f} s "
            f"(per source: {_build.build_seconds})")
        for n, rep in _build.ptxas_report.items():
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas[{n}]: {line.strip()}")

    # -- phase 2 -----------------------------------------------------------
    def phase_kernels(self):
        import torch
        import torch.nn.functional as F

        from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain

        gen = torch.Generator(device="cuda").manual_seed(0)
        worst = 0.0
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        rows = []
        for C, H, W, relu_path, count in GN_PATH_SHAPES:
            G = min(32, C)
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(BATCH, H, W, C, device="cuda", generator=gen) * 2.0 + 3.0).to(dtype)
                scale = torch.randn(C, device="cuda", generator=gen)
                bias = torch.randn(C, device="cuda", generator=gen)
                for relu in (True, False):
                    y = group_norm_relu(x, scale, bias, G, 1e-5, relu)
                    ref = group_norm_relu_plain(x, scale, bias, G, 1e-5, relu)
                    torch.cuda.synchronize()
                    err = (y.float() - ref.float()).abs()
                    # f32: reassociation of fp32 sums only; bf16: one bf16
                    # rounding step of the output (2^-7 relative) apart
                    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2.0**-7)
                    ok = bool((err <= atol + rtol * ref.float().abs()).all())
                    mx = float(err.max())
                    worst = max(worst, mx) if dtype == torch.float32 else worst
                    log(f"  K1 C={C} {H}x{W} {str(dtype)[6:]} relu={relu}: max_abs_err={mx:.3e} "
                        f"(limit {atol:g} + {rtol:g}*|ref|) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"K1 disagrees with plain at C={C} {H}x{W} {dtype}")
                if relu_path is False and dtype == torch.bfloat16:
                    continue
                relu = relu_path
                k_ms = cuda_ms(lambda: group_norm_relu(x, scale, bias, G, 1e-5, relu), self.iters)
                p_ms = cuda_ms(lambda: group_norm_relu_plain(x, scale, bias, G, 1e-5, relu),
                               max(3, self.iters // 4))
                xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
                sw, sb = scale.to(dtype), bias.to(dtype)

                def lib_call():
                    o = F.group_norm(xc, G, sw, sb, 1e-5)
                    return torch.relu_(o) if relu else o

                l_ms = cuda_ms(lib_call, self.iters)
                nbytes = 2 * x.numel() * x.element_size() + 2 * C * 4
                bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, 8 * x.numel() / FP32_FLOPS)
                rows.append(dict(C=C, H=H, W=W, dtype=str(dtype)[6:], relu=relu, ms=k_ms,
                                 plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                                 per_forward=count))
                log(f"  K1 time C={C} {H}x{W} {str(dtype)[6:]} relu={relu}: kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms, F.group_norm(+relu) {l_ms:.4f} ms, "
                    f"bytes bound {bound:.4f} ms (bound / kernel = {bound / k_ms:.1%})")
                if dtype == torch.float32:
                    tot["ms"] += count * k_ms
                    tot["plain_ms"] += count * p_ms
                    tot["library_ms"] += count * l_ms
                    tot["bound_ms"] += count * bound
                del x, y, ref
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "k1_shapes.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), rows=rows), f, indent=1)
        log(f"K1 over one f32 forward's 28 calls (B={BATCH}, 480x720): kernel {tot['ms']:.3f} ms, "
            f"plain {tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, "
            f"bound {tot['bound_ms']:.3f} ms")
        self.kernels["groupnorm"] = dict(
            name="groupnorm", route="cuda", source="crossloc_tpu_torch/csrc/groupnorm.cu",
            replaces="crossloc_tpu/ops/pallas_groupnorm.py:57", launches=0,
            max_abs_err=worst, **tot, bound_by="bytes")

    # -- phase 3 -----------------------------------------------------------
    def phase_forward(self):
        import torch

        from crossloc_tpu_torch import models, ops
        from crossloc_tpu_torch.models import layers

        gen = torch.Generator().manual_seed(2021)
        model = models.init_weights(models.build_network("coord", "MLE"), gen)
        model.to("cuda").eval().to(memory_format=torch.channels_last)
        images = torch.rand(BATCH, IMG_H, IMG_W, 3, generator=gen).cuda()

        def forward_pair(dtype):
            """(kernel-path output, plain-norm output, launches per forward, ms, plain ms)."""
            model.dtype = dtype
            with torch.no_grad():
                n0 = ops.group_norm_relu.launches
                y = model(images)
                torch.cuda.synchronize()
                per_fwd = ops.group_norm_relu.launches - n0
                fwd_ms = cuda_ms(lambda: model(images), iters=5, warmup=1)
                layers.group_norm_relu = ops.group_norm_relu_plain  # reference run only
                try:
                    ref = model(images)
                    plain_ms = cuda_ms(lambda: model(images), iters=3, warmup=1)
                finally:
                    layers.group_norm_relu = ops.group_norm_relu
            shape = (BATCH, IMG_H // 8, IMG_W // 8, 4)
            if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"forward output {tuple(y.shape)} not finite {shape}")
            if per_fwd != 28:
                raise AssertionError(f"expected 28 K1 launches per forward, got {per_fwd}")
            return y, ref, per_fwd, fwd_ms, plain_ms

        def rel(a, ref, rms=False):
            """Per output channel: max (or rms) |a - ref| / std(ref); the worst channel."""
            d = (a.float() - ref).abs()
            d = d.square().mean(dim=(0, 1, 2)).sqrt() if rms else d.amax(dim=(0, 1, 2))
            return float((d / ref.std(dim=(0, 1, 2))).max())

        y32, ref32, n, ms, pms = forward_pair(torch.float32)
        err32 = rel(y32, ref32)
        log(f"forward float32 B={BATCH} {IMG_H}x{IMG_W}: {n} K1 launches; max|kernel - plain| "
            f"/ std = {err32:.3e} (limit 1e-3: only the statistics' summation order differs); "
            f"net {ms:.2f} ms/batch with K1, {pms:.2f} ms with the plain norm")
        if err32 > 1e-3:
            raise AssertionError("f32 kernel path disagrees with the plain-norm net")
        # bf16: both paths round every norm output to bf16, so they differ by
        # rounding noise carried through 28 layers; the kernel path must be
        # as close to the f32 net as the plain bf16 path is
        yb, refb, n, ms, pms = forward_pair(torch.bfloat16)
        e_k, e_p = rel(yb, ref32, rms=True), rel(refb, ref32, rms=True)
        log(f"forward bfloat16: {n} K1 launches; rms error vs the f32 net / std: kernel path "
            f"{e_k:.3e}, plain-norm path {e_p:.3e} (limit: kernel <= 1.25 x plain + 1e-3); "
            f"max|kernel - plain| / std = {rel(yb, refb.float()):.3e}; "
            f"net {ms:.2f} ms/batch with K1, {pms:.2f} ms with the plain norm")
        if e_k > 1.25 * e_p + 1e-3:
            raise AssertionError("bf16 kernel path is less accurate than the plain bf16 net")
        model.dtype = torch.float32

    # -- phase 4 -----------------------------------------------------------
    def phase_serve(self):
        import re

        import numpy as np
        import torch

        from crossloc_tpu_torch import compat, data, eval as evaluation, models, ops, ransac
        from crossloc_tpu_torch.cli import test_single_task as cli
        from crossloc_tpu_torch.inference import make_localizer

        n_frames = 2 * BATCH
        shutil.rmtree(WORK_DIR, ignore_errors=True)
        scene = os.path.join(WORK_DIR, "datasets", "urbanscape", "val_drone_real")
        t0 = time.perf_counter()
        data.write_fake_dataset(scene, n=n_frames, img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=7)
        net_dir = os.path.join(WORK_DIR, "output", "urbanscape-coord-unc-MLE-smoke")
        os.makedirs(net_dir)
        model = models.init_weights(models.build_network("coord", "MLE"),
                                    torch.Generator().manual_seed(2021))
        compat.save_net(os.path.join(net_dir, "model.net"), model)
        log(f"wrote a {n_frames}-frame {IMG_H}x{IMG_W} scene and a seeded model.net "
            f"in {time.perf_counter() - t0:.1f} s")

        # the main path: the port's eval CLI, in-process, on cuda
        ops.group_norm_relu.launches = 0
        t0 = time.perf_counter()
        logs = cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                         "--network_in", net_dir, "--section", "val_drone_real",
                         "--datasets_dir", os.path.join(WORK_DIR, "datasets"),
                         "--save_pred", "--device", "cuda"])
        torch.cuda.synchronize()
        launches = ops.group_norm_relu.launches
        log(f"test_single_task on cuda: {time.perf_counter() - t0:.1f} s wall for {n_frames} "
            f"frames (first batch includes cuDNN autotuning), {launches} K1 launches")
        self.kernels["groupnorm"]["launches"] = launches
        if launches != 28 * math.ceil(n_frames / BATCH):
            raise AssertionError(f"K1 launched {launches} times on the main path")
        text = open(logs[0]).read()
        if not re.search(r"Median Error:\s+(\d+.\d+) deg, (\d+.\d+) m", text):
            raise AssertionError(f"no median line in {logs[0]}")
        pred_dir = os.path.join(net_dir, "coord_pred_model.net_val_drone_real")
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"]
                 for f in sorted(os.listdir(pred_dir))]
        if len(poses) != n_frames or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("missing or non-finite poses")
        log(f"results: {logs[0]} ({len(poses)} finite poses)")

        # the same CLI with --bf16: convs and K1 in bf16 (not the counted run)
        n0 = ops.group_norm_relu.launches
        cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--network_in",
                  net_dir, "--section", "val_drone_real", "--datasets_dir",
                  os.path.join(WORK_DIR, "datasets"), "--save_pred", "--bf16", "--device", "cuda"])
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"] for f in sorted(os.listdir(pred_dir))]
        n_bf16 = ops.group_norm_relu.launches - n0
        log(f"test_single_task --bf16 on cuda: {n_bf16} K1 launches, "
            f"{sum(np.isfinite(p).all() for p in poses)} finite poses")
        if n_bf16 != launches or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("the --bf16 eval run is off")

        # the solver on the card, fed the exact scene coordinates (GT oracle),
        # against the same solve on the CPU with the same hypothesis draws
        ds = data.CamLocDataset(scene)
        batch = ds.collate(range(BATCH))
        coords = torch.from_numpy(batch["coord"])
        focal = torch.from_numpy(batch["focal"])
        cfg = ransac.RansacConfig()
        N = coords.shape[1] * coords.shape[2]
        idx = torch.randint(0, N, (BATCH, cfg.hypotheses * cfg.sample_rounds, 4),
                            generator=torch.Generator().manual_seed(3))
        res_gpu = ransac.solve_batch(coords.cuda(), focal.cuda(), (IMG_H, IMG_W), cfg, idx=idx)
        res_cpu = ransac.solve_batch(coords, focal, (IMG_H, IMG_W), cfg, idx=idx)
        errs = [evaluation.pose_err(batch["pose"][b], res_gpu.cam_to_world[b].cpu())
                for b in range(BATCH)]
        t_med = float(np.median([e[0] for e in errs]))
        r_med = float(np.median([e[1] for e in errs]))
        d_pose = float((res_gpu.pose_w2c6.cpu() - res_cpu.pose_w2c6).abs().max())
        same = int((res_gpu.chosen.cpu() == res_cpu.chosen).sum())
        log(f"GT-oracle solve on cuda: median {t_med:.4f} m / {r_med:.4f} deg (limit 0.1 m / "
            f"0.1 deg); vs CPU on the same draws: chosen equal {same}/{BATCH}, "
            f"max |pose6 diff| {d_pose:.2e} (limit 1e-2)")
        if not (t_med < 0.1 and r_med < 0.1 and d_pose < 1e-2):
            raise AssertionError("solver on the card is off")

        # throughput of image -> pose (net + solver) at B=8, 480x720, f32
        model.to("cuda").eval().to(memory_format=torch.channels_last)
        wire = torch.from_numpy(data.images_to_wire(batch["image"])).cuda()
        images = data.images_from_wire(wire)
        localize = make_localizer(model, cfg)
        gen = torch.Generator(device="cuda").manual_seed(2021)
        focal_d = focal.cuda()
        times = {}
        for name, fn in (
            ("net", lambda: model(images)),
            ("solver", lambda: ransac.solve_batch(
                coords.cuda(), focal_d, (IMG_H, IMG_W), cfg, generator=gen)),
            ("net+solver", lambda: localize(images, focal_d, generator=gen)),
        ):
            with torch.no_grad():
                times[name] = cuda_ms(fn, iters=5, warmup=2)
        log(f"image->pose at B={BATCH} {IMG_H}x{IMG_W} f32 on {self.device_name} "
            f"({nvidia_smi_line()}): net+solver {times['net+solver']:.2f} ms/batch = "
            f"{1e3 * BATCH / times['net+solver']:.1f} img/s; net alone "
            f"{times['net']:.2f} ms, solver alone {times['solver']:.2f} ms")
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "serve.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), batch=BATCH,
                           ms=times, img_s=1e3 * BATCH / times["net+solver"],
                           oracle_median_m=t_med, oracle_median_deg=r_med), f, indent=1)
        shutil.rmtree(WORK_DIR, ignore_errors=True)

    # -- extra phase, not in the default run ---------------------------------
    def phase_profile(self):
        """Where the time of one image -> pose batch goes, by kernel
        (torch.profiler), and the device's busy share of the wall time."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from crossloc_tpu_torch import models, ransac
        from crossloc_tpu_torch.inference import make_localizer

        model = models.init_weights(models.build_network("coord", "MLE"),
                                    torch.Generator().manual_seed(2021))
        model.to("cuda").eval().to(memory_format=torch.channels_last)
        images = torch.rand(BATCH, IMG_H, IMG_W, 3, device="cuda")
        focal = torch.full((BATCH,), 480.0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2021)
        localize = make_localizer(model, ransac.RansacConfig())
        for dtype in (torch.float32, torch.bfloat16):
            model.dtype = dtype
            localize(images, focal, generator=gen)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                localize(images, focal, generator=gen)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
            groups = {}
            for e in kernels:
                n = e.name.lower()
                key = ("K1 groupnorm" if any(k in n for k in ("gn_stats", "gn_finalize", "gn_apply"))
                       else "conv" if any(k in n for k in ("fprop", "conv", "xmma", "cutlass",
                                                          "implicit_gemm", "cudnn"))
                       else "other (solver, residual adds, copies)")
                g = groups.setdefault(key, [0, 0.0])
                g[0] += 1
                g[1] += e.time_range.elapsed_us() / 1e3
            log(f"profile {str(dtype)[6:]} B={BATCH} {IMG_H}x{IMG_W} net+solver: wall {wall:.2f} ms, "
                f"device busy {busy:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}, "
                f"{len(kernels)} kernels; by group: "
                + ", ".join(f"{k} {v[0]} launches {v[1]:.2f} ms" for k, v in sorted(groups.items())))
            os.makedirs(self.out_dir, exist_ok=True)
            with open(os.path.join(self.out_dir, f"profile_{str(dtype)[6:]}.txt"), "w") as f:
                f.write(f"{self.device_name} | {nvidia_smi_line()}\n")
                f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
        model.dtype = torch.float32

    def kernels_line(self) -> str:
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        return json.dumps({"kernels": [{k: v[k] for k in keys} for v in self.kernels.values()]})


PHASES = ("card", "kernels", "forward", "serve")
EXTRA_PHASES = ("profile",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out-dir", default=WORK_DIR + "_report",
                    help="where the per-shape, serve and profile files go")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]

    if not os.path.isdir(os.path.join(HERE, "crossloc_tpu_torch")):
        print("chip_smoke: the crossloc_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 3

    smoke = Smoke(args.iters, os.path.abspath(args.out_dir))
    failed = []
    for p in phases:
        if p not in PHASES + EXTRA_PHASES:
            print(f"unknown phase {p}", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        log(f"== phase {p}")
        try:
            getattr(smoke, f"phase_{p}")()
        except Exception:
            traceback.print_exc()
            failed.append(p)
            log(f"== phase {p} FAILED after {time.perf_counter() - t0:.1f} s")
            if p == "card":
                break
            continue
        log(f"== phase {p} ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log(smoke.kernels_line())
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
