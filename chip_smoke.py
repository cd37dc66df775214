"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --phases card,kernels

Phases:
  card     print the card, turn TF32 off for the phases that call no CLI,
           build every CUDA source (nvcc, in parallel) and print the build
           time;
  kernels  hold each kernel against its plain PyTorch version at every shape
           of the main paths (f32 and bf16, ReLU on and off; K1 in the design
           its planner picks and in the three-pass design, and once with
           |mean|/std = 1000; the MLR merge norm at C=1536 and 2048; the DUC
           conv's norm at C=64-384, 60x90, B=12 and B=8; K1's
           backward at the training batch and at the finetune batch, with
           C=1536 and 2048 and the DUC widths, in the design its planner picks and in the
           four-kernel design, and once with |mean|/std = 1000) and time
           them: device time from CUDA graphs with the L2 evicted between
           calls, and host-inclusive call time, the two designs of K1 and
           of K1-bwd in turns (three-pass or four-kernel, planned, planned,
           three-pass or four-kernel),
           beside the plain version, one PyTorch library call and the bytes
           bound; totals over one forward / step of the coord net (28 calls)
           and of the finetune path (67 K1, 33 K1-bwd);
  forward  full-width coord+MLE net at 480x720, B=8, seeded weights: kernel
           path against the same net through the plain norm, and 28 kernel
           launches per forward;
  serve    write a 480x720 scene, save a seeded `.net`, run the port's
           `test_single_task` in-process on cuda (the main path: results_*.txt,
           finite poses, kernel launches counted on that run), again with
           --bf16; GT-oracle solver accuracy against the CPU; img/s.
  train    the port's `train_single_task` on cuda with the encoder-pretrain
           settings on a 480x720 plane scene (K1 and K1-bwd launches counted
           per step), its model.net served by `test_single_task` on cuda,
           one step's gradients on the card against the CPU, 10 steps on one
           batch, a --bf16 run, and the train-step time at B=12;
  finetune the port's `finetune_decoder_single_task` on cuda with
           decoder_finetune.sh's settings (coord + depth + normal towers from
           seeded full-width donors, the coord tower trains) on a 480x720
           pairwise plane scene: 67 K1 and 33 K1-bwd launches per step, the
           frozen towers bit-identical to their donors, its model.net served
           by `test_single_task` on cuda (num_mlr from the folder name), a
           --bf16 run, one step's trainable gradients on the card against the
           CPU, and the finetune-step time at B=8;
  tasks    the port's `train_single_task` on cuda with encoder_pretrain.sh's
           settings for depth and normal (MLE, --hardclamp 10) and semantics
           (--fullsize, the DUC head): 28 + 28 and 29 + 29 launches per step,
           each model.net served on val_sim by `test_single_task` (its report
           lines finite), card gradients against the CPU for normal and
           semantics, the step times at B=12, a --bf16 semantics run, and TF32
           left off by the CLIs' own setup (ROADMAP F1);
  profile  (extra, not in the default run) kernel-time breakdown of one
           image -> pose batch, one coord and one semantics training step and
           one finetune step with torch.profiler.

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
FLUSH_BYTES = 96 << 20  # written between timed calls: more than the 50 MB L2
BATCH = 8
TRAIN_BATCH = 12  # script_clean_training/encoder_pretrain.sh
IMG_H, IMG_W = 480, 720
# the training CLI as script_clean_training/encoder_pretrain.sh runs it (coord)
PRETRAIN_ARGS = ["urbanscape", "--task", "coord", "--inittolerance", "50.0", "--softclamp",
                 "100", "--hardclamp", "1000", "--learningrate", "2e-4", "--batch_size",
                 str(TRAIN_BATCH), "--uncertainty", "MLE", "--auto_resume",
                 "--sim_data_chunk", "1.0", "--real_data_chunk", "0.0", "--device", "cuda"]

FT_BATCH = 8  # script_clean_training/decoder_finetune.sh
# the finetune CLI as script_clean_training/decoder_finetune.sh runs it
FINETUNE_ARGS = ["urbanscape", "--task", "coord", "--inittolerance", "50.0", "--softclamp",
                 "100", "--hardclamp", "1000", "--learningrate", "1e-4", "--batch_size",
                 str(FT_BATCH), "--uncertainty", "MLE", "--auto_resume", "--real_data_domain",
                 "in_place", "--real_data_chunk", "1.0", "--sim_data_chunk", "0.0",
                 "--encoders", "coord", "depth", "normal", "--reuse_coord_encoder",
                 "--unfreeze_coord_encoder", "--no_lr_scheduling", "--device", "cuda"]
FT_TASKS = ("coord", "depth", "normal")
# the per-task flags of script_clean_training/_lib.sh::task_flags, with
# encoder_pretrain.sh's uncertainty (semantics: none)
TASK_FLAGS = {"depth": ["--hardclamp", "10", "--uncertainty", "MLE"],
              "normal": ["--hardclamp", "10", "--uncertainty", "MLE"],
              "semantics": ["--fullsize", "--uncertainty", "none"]}
# (task, scene, extra flags) of the tasks phase's runs
TASK_RUNS = [("depth", "plane", []), ("normal", "noise", []), ("semantics", "plane", [])]
# the first words of each report's lines (eval/reports.py)
TASK_REPORT_LINES = {
    "depth": ("absolute relative error, mean:", "RMS error, mean:"),
    "normal": ("angular prediction error, mean:",),
    "semantics": ("Pixel accuracy, mean:", "Mean IoU, mean:", "Frequency weighted IoU, mean:")}
FT_FWD, FT_BWD = 67, 33  # K1 per forward (3 x 17 + 5 + 11), K1-bwd per step (17 + 5 + 11)

# (C, H, W, relu, layers per forward) of the 28 Conv->GN layers at 480x720
GN_PATH_SHAPES = [
    (32, 480, 720, True, 1),   # stem1
    (64, 240, 360, True, 1),   # stem2
    (128, 120, 180, True, 1),  # stem3
    (256, 60, 90, True, 4),    # stem4, res1_1..3
    (512, 60, 90, True, 20),   # res2_1..3, enc/dec add_res, res3, fc1, fc2
    (512, 60, 90, False, 1),   # res2_skip
]
# the MLR merge norm over 3 towers (this path) and 4 (with semantics); in no
# 28-layer total
MLR_SHAPES = [(1536, 60, 90, False, 0), (2048, 60, 90, False, 0)]
# the DUC conv's norm at 480x720: C = 64 x the output channels (depth 1 + 1,
# normal 2 + 1, coord 3 + 1 with --fullsize; semantics 6 on its main path);
# held at the semantics training batch and the eval batch, in no 28-call total
DUC_SHAPES = [(C, 60, 90, True, 0) for C in (64, 128, 192, 256, 384)]
# (C, H, W, relu, K1 calls per forward, K1-bwd calls per step) of the
# finetune path: three towers forward, the first backward too, the five MLR
# norms and the decoder's eleven
FT_PATH_SHAPES = [
    (32, 480, 720, True, 3, 1),
    (64, 240, 360, True, 3, 1),
    (128, 120, 180, True, 3, 1),
    (256, 60, 90, True, 12, 4),
    (512, 60, 90, True, 41, 23),   # towers' res2 + add_res, mlr_forward, decoder
    (512, 60, 90, False, 4, 2),    # towers' res2_skip, mlr_skip
    (1536, 60, 90, False, 1, 1),   # mlr_norm
]


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fns, flush, n: int = 20, reps: int = 5) -> list:
    """Device time per call of each fn: a CUDA graph of n captured calls,
    each after `flush` (a write of FLUSH_BYTES, which evicts the 50 MB L2 so
    every call reads its input from HBM), replayed `reps` times (median),
    less the same graph of flushes alone. No host work inside the time."""
    import torch

    def graph(fn):
        fn(), flush()  # build, allocate and check configurations before capture
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                flush()
                fn()
        return g

    def replay_ms(g):
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        return sorted(ts)[len(ts) // 2]

    g0 = graph(lambda: None)
    base = replay_ms(g0)
    out = []
    for fn in fns:
        g = graph(fn)
        out.append((replay_ms(g) - base) / n)
        del g
    del g0
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-inclusive time per call: back-to-back calls between two events
    (a call's host work, when larger than its device time, sets the pace)."""
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


def _path_totals(rows, col: int, keys) -> dict:
    """Per dtype, the sums over FT_PATH_SHAPES of (calls in column `col`:
    4 = K1 per forward, 5 = K1-bwd per step) x each key of the row measured
    at that (C, relu)."""
    out = {}
    for d in ("float32", "bfloat16"):
        by = {(r["C"], r["relu"]): r for r in rows if r["dtype"] == d}
        out[d] = {k: sum(s[col] * by[(s[0], s[3])][k] for s in FT_PATH_SHAPES) for k in keys}
    return out


def _duc_row(rows, B, dtype) -> dict:
    """The row of the semantics DUC conv's norm (C=384) at batch B."""
    (row,) = [r for r in rows if r["C"] == 384 and r["B"] == B and r["dtype"] == dtype]
    return row


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
        self.launches = {}  # main path -> {kernel name: launches counted on that path's run}
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

        flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
        flush = flush_buf.zero_
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows, worst = self._forward_rows(flush, gen, BATCH, GN_PATH_SHAPES + MLR_SHAPES)
        duc_rows = []
        for B in (TRAIN_BATCH, BATCH):
            r, w = self._forward_rows(flush, gen, B, DUC_SHAPES)
            duc_rows += r
            worst = max(worst, w)
        self._large_mean_check()
        keys = ("ms", "three_pass_ms", "plain_ms", "library_ms", "bound_ms")
        tot = {d: {k: sum(r["per_forward"] * r[k] for r in rows if r["dtype"] == d) for k in keys}
               for d in ("float32", "bfloat16")}
        ft = _path_totals(rows, 4, keys)
        # the semantics net: the coord net's 28 layers and the DUC conv's (C=384)
        sem = {d: {k: tot[d][k] + _duc_row(duc_rows, BATCH, d)[k] for k in keys} for d in tot}
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "k1_shapes.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), flush_bytes=FLUSH_BYTES,
                           rows=rows, duc_rows=duc_rows, per_forward=tot, per_finetune_forward=ft,
                           per_semantics_forward=sem), f, indent=1)
        for dname, t in tot.items():
            log(f"K1 over one {dname} forward's 28 calls (B={BATCH}, 480x720), device time: "
                f"planned {t['ms']:.4f} ms, three-pass {t['three_pass_ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
        for dname, t in ft.items():
            log(f"K1 over one {dname} finetune forward's {FT_FWD} calls (B={FT_BATCH}, 480x720, "
                f"3 towers + MLR + decoder), device time: planned {t['ms']:.4f} ms, three-pass "
                f"{t['three_pass_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
        for dname, t in sem.items():
            log(f"K1 over one {dname} semantics forward's 29 calls (B={BATCH}, 480x720, the DUC "
                f"conv's at C=384), device time: planned {t['ms']:.4f} ms, three-pass "
                f"{t['three_pass_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
        f32 = tot["float32"]
        self.kernels["groupnorm"] = dict(
            name="groupnorm", route="cuda", source="crossloc_tpu_torch/csrc/groupnorm.cu",
            replaces="crossloc_tpu/ops/pallas_groupnorm.py:57",
            max_abs_err=worst, ms=f32["ms"], plain_ms=f32["plain_ms"],
            library_ms=f32["library_ms"], bound_ms=f32["bound_ms"], bound_by="bytes",
            three_pass_ms=f32["three_pass_ms"])
        self._backward_kernel(flush)

    def _forward_rows(self, flush, gen, B, shapes):
        """K1 at each (C, H, W, relu, layers per forward) of `shapes`, batch B,
        f32 and bf16, ReLU on and off, in the design `_plan` picks and in the
        three-pass design, each against the plain twin, and timed at the
        path's ReLU: device time (CUDA graphs, L2 evicted) and call time of
        the two designs in turns (three-pass, planned, planned, three-pass),
        the plain twin, one library call (`F.group_norm` + ReLU) and the
        bytes bound. Returns (rows, worst f32 |y - plain| of the planned
        design)."""
        import torch
        import torch.nn.functional as F

        from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import _plan, _three_pass

        rows, worst = [], 0.0
        for C, H, W, relu_path, count in shapes:
            G = min(32, C)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype)[6:]
                plan = _plan(B, H, W, C, G, dtype)
                x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * 2.0 + 3.0).to(dtype)
                scale = torch.randn(C, device="cuda", generator=gen)
                bias = torch.randn(C, device="cuda", generator=gen)
                for relu in (True, False):
                    ref = group_norm_relu_plain(x, scale, bias, G, 1e-5, relu)
                    for design, fn in (("planned", group_norm_relu), ("three_pass", _three_pass)):
                        y = fn(x, scale, bias, G, 1e-5, relu)
                        torch.cuda.synchronize()
                        err = (y.float() - ref.float()).abs()
                        # f32: reassociation of fp32 sums only; bf16: one bf16
                        # rounding step of the output (2^-7 relative) apart
                        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2.0**-7)
                        ok = bool((err <= atol + rtol * ref.float().abs()).all())
                        mx = float(err.max())
                        if design == "planned" and dtype == torch.float32:
                            worst = max(worst, mx)
                        name = plan.design if design == "planned" else "three_pass"
                        log(f"  K1 {name} C={C} {H}x{W} B={B} {dname} relu={relu}: max_abs_err="
                            f"{mx:.3e} (limit {atol:g} + {rtol:g}*|ref|) {'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(f"K1 {name} disagrees with plain at C={C} {H}x{W} "
                                                 f"B={B} {dtype} relu={relu}")
                    del y, ref
                relu = relu_path
                planned = lambda: group_norm_relu(x, scale, bias, G, 1e-5, relu)
                three = lambda: _three_pass(x, scale, bias, G, 1e-5, relu)
                # in turns: three-pass, planned, planned, three-pass
                dev = device_ms([three, planned, planned, three], flush)
                call = [cuda_ms(f, self.iters) for f in (three, planned, planned, three)]
                xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
                sw, sb = scale.to(dtype), bias.to(dtype)

                def lib_call():
                    o = F.group_norm(xc, G, sw, sb, 1e-5)
                    return torch.relu_(o) if relu else o

                p_ms, l_ms = device_ms(
                    [lambda: group_norm_relu_plain(x, scale, bias, G, 1e-5, relu), lib_call],
                    flush, n=5)
                nbytes = 2 * x.numel() * x.element_size() + 2 * C * 4
                bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, 8 * x.numel() / FP32_FLOPS)
                row = dict(C=C, H=H, W=W, B=B, dtype=dname, relu=relu, design=plan.design,
                           cluster=plan.cluster, cb=plan.cb, threads=plan.threads,
                           ms=(dev[1] + dev[2]) / 2, call_ms=(call[1] + call[2]) / 2,
                           three_pass_ms=(dev[0] + dev[3]) / 2,
                           three_pass_call_ms=(call[0] + call[3]) / 2, turns_ms=dev,
                           turns_call_ms=call, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                           per_forward=count)
                rows.append(row)
                where = (f"cluster of {plan.cluster} CTAs, cb={plan.cb}, {plan.threads} threads, "
                         f"{plan.smem_bytes} B smem" if plan.design == "cluster" else "three_pass")
                log(f"  K1 time C={C} {H}x{W} B={B} {dname} relu={relu} [{where}]: device "
                    f"{row['ms']:.4f} ms (three-pass {row['three_pass_ms']:.4f}; turns "
                    + "/".join(f"{t:.4f}" for t in dev) + f"), call {row['call_ms']:.4f} ms "
                    f"(three-pass {row['three_pass_call_ms']:.4f}), plain {p_ms:.4f} ms, "
                    f"F.group_norm(+relu) {l_ms:.4f} ms, bytes bound {bound:.4f} ms "
                    f"(bound / device = {bound / row['ms']:.1%})")
                del x
        return rows, worst

    def _backward_kernel(self, flush):
        """K1's backward at the coord net's shapes at B=TRAIN_BATCH (the
        28-call totals) and at the finetune path's and the MLR widths' at
        B=FT_BATCH (the 33-call totals), both designs, and at |mu|/std =
        1000."""
        shapes = [s[:4] for s in GN_PATH_SHAPES]
        rows, worst = self._backward_rows(flush, TRAIN_BATCH, shapes, seed=1)
        ft_shapes = [s[:4] for s in FT_PATH_SHAPES] + [s[:4] for s in MLR_SHAPES[1:]]
        ft_rows, ft_worst = self._backward_rows(flush, FT_BATCH, ft_shapes, seed=2)
        duc_rows = []
        for seed, B in enumerate((TRAIN_BATCH, FT_BATCH), start=3):
            r, w = self._backward_rows(flush, B, [s[:4] for s in DUC_SHAPES], seed=seed)
            duc_rows += r
            worst = max(worst, w)
        self._large_mean_backward_check()
        keys = ("ms", "four_kernel_ms", "plain_ms", "library_ms", "bound_ms")
        tot = {d: {k: sum(c * r[k] for r in rows for (C, H, W, relu, c) in GN_PATH_SHAPES
                          if r["dtype"] == d and (r["C"], r["relu"]) == (C, relu)) for k in keys}
               for d in ("float32", "bfloat16")}
        ft = _path_totals(ft_rows, 5, keys)
        sem = {d: {k: tot[d][k] + _duc_row(duc_rows, TRAIN_BATCH, d)[k] for k in keys}
               for d in tot}
        with open(os.path.join(self.out_dir, "k1_backward_shapes.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), flush_bytes=FLUSH_BYTES,
                           rows=rows + ft_rows, duc_rows=duc_rows, per_step=tot,
                           per_finetune_step=ft, per_semantics_step=sem), f, indent=1)
        for dname, t in tot.items():
            log(f"K1-bwd over one {dname} training step's 28 calls (B={TRAIN_BATCH}, 480x720), "
                f"device time: planned {t['ms']:.4f} ms, four-kernel {t['four_kernel_ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
        for dname, t in ft.items():
            log(f"K1-bwd over one {dname} finetune step's {FT_BWD} calls (B={FT_BATCH}, 480x720), "
                f"device time: planned {t['ms']:.4f} ms, four-kernel {t['four_kernel_ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
        for dname, t in sem.items():
            log(f"K1-bwd over one {dname} semantics step's 29 calls (B={TRAIN_BATCH}, 480x720, "
                f"the DUC conv's at C=384), device time: planned {t['ms']:.4f} ms, four-kernel "
                f"{t['four_kernel_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
        f32 = tot["float32"]
        self.kernels["groupnorm_backward"] = dict(
            name="groupnorm_backward", route="cuda", source="crossloc_tpu_torch/csrc/groupnorm.cu",
            replaces="crossloc_tpu/ops/pallas_groupnorm.py:141",
            max_abs_err=max(worst, ft_worst), ms=f32["ms"], plain_ms=f32["plain_ms"],
            library_ms=f32["library_ms"], bound_ms=f32["bound_ms"], bound_by="bytes",
            four_kernel_ms=f32["four_kernel_ms"])

    def _backward_rows(self, flush, B, shapes, seed):
        """K1's backward at each (C, H, W, relu) of `shapes`, batch B, f32 and
        bf16, ReLU on and off, in the design `_plan_backward` picks and in
        the four-kernel design, each against the autograd of the plain twin,
        and timed at the path's ReLU: device time (CUDA graphs, L2 evicted)
        and call time of the two designs in turns (four-kernel, planned,
        planned, four-kernel), the plain twin (host-inclusive events: its
        autograd is not captured in a graph), the library's two calls
        (threshold_backward + native_group_norm_backward on NCHW copies, its
        own layout) and the bytes bound (x and dy read once, dx written
        once). Returns (rows, worst f32 |dx - plain| of the planned design)."""
        import torch

        from crossloc_tpu_torch.ops import (group_norm_relu_backward,
                                            group_norm_relu_backward_plain, group_norm_relu_plain)
        from crossloc_tpu_torch.ops.groupnorm import _four_kernel_backward, _launch, _plan_backward

        gen = torch.Generator(device="cuda").manual_seed(seed)
        rows, worst = [], 0.0
        for C, H, W, relu_path in shapes:
            G = min(32, C)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype)[6:]
                plan = _plan_backward(B, H, W, C, G, dtype)
                x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * 2.0 + 3.0).to(dtype)
                scale = torch.randn(C, device="cuda", generator=gen)
                bias = torch.randn(C, device="cuda", generator=gen)
                # dy is zero where the plain pre-activation lies within 1e-3 of
                # the ReLU's kink: the kernel's statistics round in another
                # order, which may flip the mask of such a cell
                pre = group_norm_relu_plain(x.float(), scale, bias, G, 1e-5, False)
                dy = (torch.randn(B, H, W, C, device="cuda", generator=gen)
                      * (pre.abs() > 1e-3)).to(dtype)
                del pre
                for relu in (True, False):
                    stats = torch.empty(B, G, 2, device="cuda")
                    _launch(x, scale, bias, G, 1e-5, relu, stats)  # the forward writes them
                    ref = group_norm_relu_backward_plain(x, scale, bias, dy, G, 1e-5, relu)
                    for design, fn in (("planned", group_norm_relu_backward),
                                       ("four_kernel", _four_kernel_backward)):
                        got = fn(x, scale, bias, stats, dy, G, relu)
                        torch.cuda.synchronize()
                        # f32: dx within 1e-4 * max|ref| + 1e-4 * |ref|, dscale
                        # and dbias within 1e-4 * max|ref| (fp32 sums in another
                        # order); bf16: one bf16 ulp of dx (2^-7 * |ref|) beyond
                        # that (both sides round an fp32 dx to bf16)
                        rel = 1e-4 + (2.0**-7 if dtype == torch.bfloat16 else 0.0)
                        errs, ok = [], True
                        for name, a, r in zip(("dx", "dscale", "dbias"), got, ref):
                            a, r = a.float(), r.float()
                            err = (a - r).abs()
                            lim = 1e-4 * r.abs().max() + (rel * r.abs() if name == "dx" else 0.0)
                            ok = ok and bool((err <= lim).all())
                            errs.append(float(err.max()))
                        if dtype == torch.float32 and design == "planned":
                            worst = max(worst, errs[0])
                        name = plan.design if design == "planned" else "four_kernel"
                        log(f"  K1-bwd {name} C={C} {H}x{W} B={B} {dname} relu={relu}: max_abs_err "
                            f"dx {errs[0]:.3e} (max|dx| {float(ref[0].float().abs().max()):.3e}), "
                            f"dscale {errs[1]:.3e}, dbias {errs[2]:.3e} {'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(f"K1-bwd {name} disagrees with plain at C={C} "
                                                 f"{H}x{W} {dtype} relu={relu}")
                        del got
                    del ref
                relu = relu_path
                stats = torch.empty(B, G, 2, device="cuda")
                _launch(x, scale, bias, G, 1e-5, relu, stats)
                planned = lambda: group_norm_relu_backward(x, scale, bias, stats, dy, G, relu)
                four = lambda: _four_kernel_backward(x, scale, bias, stats, dy, G, relu)
                # in turns: four-kernel, planned, planned, four-kernel
                dev = device_ms([four, planned, planned, four], flush)
                call = [cuda_ms(f, self.iters) for f in (four, planned, planned, four)]
                plain = cuda_ms(lambda: group_norm_relu_backward_plain(
                    x, scale, bias, dy, G, 1e-5, relu), iters=3, warmup=1)
                xc = x.permute(0, 3, 1, 2).contiguous()
                dyc = dy.permute(0, 3, 1, 2).contiguous()
                sw, sb = scale.to(dtype), bias.to(dtype)
                out, mean, rstd = torch.ops.aten.native_group_norm(xc, sw, sb, B, C, H * W, G,
                                                                   1e-5)
                yl = torch.relu(out)

                def lib_call():
                    g = torch.ops.aten.threshold_backward(dyc, yl, 0.0) if relu else dyc
                    return torch.ops.aten.native_group_norm_backward(
                        g, xc, mean, rstd, sw, B, C, H * W, G, [True, True, True])

                (lib,) = device_ms([lib_call], flush, n=5)
                nbytes = 3 * x.numel() * x.element_size() + (4 * C + 2 * B * G) * 4
                bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, 12 * x.numel() / FP32_FLOPS)
                row = dict(C=C, H=H, W=W, B=B, dtype=dname, relu=relu, design=plan.design,
                           cluster=plan.cluster, cb=plan.cb, smem_bytes=plan.smem_bytes,
                           ms=(dev[1] + dev[2]) / 2, four_kernel_ms=(dev[0] + dev[3]) / 2,
                           turns_ms=dev, call_ms=(call[1] + call[2]) / 2,
                           four_kernel_call_ms=(call[0] + call[3]) / 2, turns_call_ms=call,
                           plain_ms=plain, library_ms=lib, bound_ms=bound)
                rows.append(row)
                where = (f"cluster of {plan.cluster} CTAs, cb={plan.cb}, {plan.threads} threads, "
                         f"{plan.smem_bytes} B smem" if plan.design == "cluster" else "four_kernel")
                log(f"  K1-bwd time C={C} {H}x{W} B={B} {dname} relu={relu} [{where}]: device "
                    f"{row['ms']:.4f} ms (four-kernel {row['four_kernel_ms']:.4f}; turns "
                    + "/".join(f"{t:.4f}" for t in dev) + f"), call {row['call_ms']:.4f} ms "
                    f"(four-kernel {row['four_kernel_call_ms']:.4f}), plain {plain:.4f} ms, "
                    f"library {lib:.4f} ms, bytes bound {bound:.4f} ms "
                    f"(bound / device = {bound / row['ms']:.1%})")
                del x, dy, xc, dyc, out, yl
        return rows, worst

    def _large_mean_backward_check(self):
        """K1-bwd on an f32 input with mean 1000 and std 1 at the 512-channel
        path shape (the cluster design), ReLU on and off, each design
        against the float64 autograd: per tensor within today's f32
        tolerance plus the plain twin's own largest distance from float64."""
        import torch

        from crossloc_tpu_torch.ops import group_norm_relu_backward_plain, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import (_four_kernel_backward, _launch,
                                                      _plan_backward, group_norm_relu_backward)

        C, H, W, G, mean = 512, 60, 90, 32, 1000.0
        if _plan_backward(BATCH, H, W, C, G, torch.float32).design != "cluster":
            raise AssertionError("the |mu|/std = 1000 shape does not take the cluster design")
        gen = torch.Generator(device="cuda").manual_seed(12)
        x = torch.randn(BATCH, H, W, C, device="cuda", generator=gen) + mean
        scale = torch.randn(C, device="cuda", generator=gen)
        bias = torch.randn(C, device="cuda", generator=gen)
        pre = group_norm_relu_plain(x, scale, bias, G, 1e-5, False)
        dy = torch.randn(x.shape, device="cuda", generator=gen) * (pre.abs() > 1e-3)
        del pre
        for relu in (True, False):
            leaves = [t.double().requires_grad_() for t in (x, scale, bias)]
            xd = leaves[0].reshape(BATCH, H * W, G, C // G)
            mu = xd.mean(dim=(1, 3), keepdim=True)
            var = (xd - mu).square().mean(dim=(1, 3), keepdim=True)
            y = ((xd - mu) / torch.sqrt(var + 1e-5)).reshape(x.shape) * leaves[1] + leaves[2]
            exact = torch.autograd.grad(torch.relu(y) if relu else y, leaves, dy.double())
            del leaves, xd, mu, var, y
            plain = group_norm_relu_backward_plain(x, scale, bias, dy, G, 1e-5, relu)
            stats = torch.empty(BATCH, G, 2, device="cuda")
            _launch(x, scale, bias, G, 1e-5, relu, stats)
            for name, fn in (("cluster", group_norm_relu_backward),
                             ("four_kernel", _four_kernel_backward)):
                got = fn(x, scale, bias, stats, dy, G, relu)
                torch.cuda.synchronize()
                msgs, ok = [], True
                for t, a, p, e in zip(("dx", "dscale", "dbias"), got, plain, exact):
                    e_k = (a.double() - e).abs()
                    e_p = float((p.double() - e).abs().max())
                    lim = 1e-4 * e.abs().max() + (1e-4 * e.abs() if t == "dx" else 0.0) + e_p
                    ok = ok and bool((e_k <= lim).all())
                    msgs.append(f"{t} {float(e_k.max()):.3e} (plain {e_p:.3e}, max|f64| "
                                f"{float(e.abs().max()):.3e})")
                log(f"  K1-bwd {name} |mu|/std=1000 C={C} {H}x{W} B={BATCH} f32 relu={relu}: "
                    f"max|K1-bwd - f64| " + ", ".join(msgs) + " (limit: 1e-4*max|f64| [+ "
                    f"1e-4*|f64| for dx] + max|plain - f64|) " + ("ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError(f"K1-bwd {name} loses precision at |mu|/std = 1000")
                del got

    def _large_mean_check(self):
        """f32 input with mean 1000 and std 1 at the 512-channel path shape:
        each design against float64 (two f32 roundings of mu allowed beyond
        the f32 tolerance) and against the plain twin (whose own distance
        from float64 is allowed on top)."""
        import torch

        from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import _three_pass

        C, H, W, G, mean = 512, 60, 90, 32, 1000.0
        gen = torch.Generator(device="cuda").manual_seed(11)
        x = torch.randn(BATCH, H, W, C, device="cuda", generator=gen) + mean
        scale = torch.randn(C, device="cuda", generator=gen)
        bias = torch.randn(C, device="cuda", generator=gen)
        xd = x.double().reshape(BATCH, H * W, G, C // G)
        mu = xd.mean(dim=(1, 3), keepdim=True)
        var = (xd - mu).square().mean(dim=(1, 3), keepdim=True)
        exact = ((xd - mu) / torch.sqrt(var + 1e-5)).reshape(x.shape) * scale.double() + bias.double()
        plain = group_norm_relu_plain(x, scale, bias, G, 1e-5, False).double()
        e_plain = (plain - exact).abs()
        limit = 1e-4 + 1e-4 * exact.abs() + 2 * 2.0**-23 * mean * scale.double().abs()
        for name, fn in (("planned", group_norm_relu), ("three_pass", _three_pass)):
            y = fn(x, scale, bias, G, 1e-5, False).double()
            e_exact, e_vs_plain = (y - exact).abs(), (y - plain).abs()
            ok = bool((e_exact <= limit).all()) and bool((e_vs_plain <= limit + e_plain).all())
            log(f"  K1 {name} |mu|/std=1000 C={C} {H}x{W} f32: max|K1 - f64| "
                f"{float(e_exact.max()):.3e}, max|K1 - plain| {float(e_vs_plain.max()):.3e}, "
                f"max|plain - f64| {float(e_plain.max()):.3e} (limit vs f64: 1e-4 + 1e-4*|ref| "
                f"+ 2*2^-23*|mu|*|gamma|; vs plain: that + |plain - f64|) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {name} loses precision at |mu|/std = 1000")

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
        self.launches["serve"] = dict(groupnorm=launches)
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

    # -- phase 5 -----------------------------------------------------------
    def phase_train(self):
        import re

        import numpy as np

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.cli import test_single_task as test_cli
        from crossloc_tpu_torch.cli import train_single_task as train_cli
        from crossloc_tpu_torch.utils import read_training_log

        n_frames = 2 * TRAIN_BATCH
        work = WORK_DIR + "_train"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        t0 = time.perf_counter()
        data.write_fake_dataset(os.path.join(datasets, "urbanscape", "train_sim"), n=n_frames,
                                img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=0, scene="plane")
        data.write_fake_dataset(os.path.join(datasets, "urbanscape", "val_drone_real"), n=BATCH,
                                img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=1, scene="plane")
        log(f"wrote a {n_frames}-frame train_sim and a {BATCH}-frame val_drone_real plane scene "
            f"at {IMG_H}x{IMG_W} in {time.perf_counter() - t0:.1f} s")

        def train(session, extra):
            return self._run_cli(train_cli.main, work, PRETRAIN_ARGS + [
                "--datasets_dir", datasets, "--ckpt_dir", os.path.join(work, "ckpts"),
                "--session", session, *extra])

        # the main path: encoder pretraining, 2 epochs of 2 steps
        out_dir, losses, fwd, bwd, wall = train("smoke", ["--epochs", "2"])
        steps = 2 * n_frames // TRAIN_BATCH
        log(f"train_single_task on cuda (B={TRAIN_BATCH}, {IMG_H}x{IMG_W}, f32, 2 epochs): "
            f"{wall:.1f} s wall for {steps} steps, losses {losses}, {fwd} K1 and {bwd} K1-bwd "
            f"launches")
        self.launches["train"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if fwd != 28 * steps or bwd != 28 * steps:
            raise AssertionError(f"expected {28 * steps} K1 and K1-bwd launches, got {fwd}/{bwd}")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        if read_training_log(os.path.join(out_dir, "output.log"), n_frames) != (2 * n_frames, 1):
            raise AssertionError("output.log does not parse to (iteration 48, epoch 1)")
        ckpt_dir = os.path.join(work, "ckpts", os.path.basename(out_dir))
        ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_iter_"))
        for f in ("model.net", "FLAG_training_done.nodata"):
            if not os.path.exists(os.path.join(out_dir, f)):
                raise AssertionError(f"{f} not written")
        if not ckpts or not os.path.exists(os.path.join(ckpt_dir, "FLAG_training_done.nodata")):
            raise AssertionError("ckpt_iter_*.net or the checkpoint FLAG not written")
        log(f"written: model.net, {ckpts}, FLAG_training_done.nodata (both directories)")

        # serve what was trained
        logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                              "--network_in", os.path.join(out_dir, "model.net"), "--section",
                              "val_drone_real", "--datasets_dir", datasets, "--save_pred",
                              "--device", "cuda"])
        pred_dir = os.path.join(out_dir, "coord_pred_model.net_val_drone_real")
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"]
                 for f in sorted(os.listdir(pred_dir))]
        median = re.findall(r"Median Error:\s+(\d+.\d+) deg, (\d+.\d+) m", open(logs[0]).read())
        log(f"served the trained model.net on cuda: {logs[0]}, {len(poses)} poses, median "
            f"{median[-1][1]} m / {median[-1][0]} deg after {steps} steps")
        if len(poses) != BATCH or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("missing or non-finite poses from the trained net")

        self._gradients_against_cpu(datasets)
        self._fixed_batch_descends(datasets)

        _, losses16, fwd16, bwd16, wall16 = train("smoke_bf16", ["--epochs", "1", "--bf16"])
        log(f"train_single_task --bf16 on cuda: {wall16:.1f} s, losses {losses16}, {fwd16} K1 "
            f"and {bwd16} K1-bwd launches")
        if fwd16 != 28 * 2 or bwd16 != 28 * 2 or not all(math.isfinite(v) for v in losses16):
            raise AssertionError("the --bf16 training run is off")
        self._step_time(datasets)
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 6 -----------------------------------------------------------
    def phase_finetune(self):
        import re

        import numpy as np
        import torch

        from crossloc_tpu_torch import compat, data, models, ops
        from crossloc_tpu_torch.cli import finetune_decoder_single_task as ft_cli
        from crossloc_tpu_torch.cli import test_single_task as test_cli
        from crossloc_tpu_torch.utils import read_training_log

        n_frames = FT_BATCH  # per pairwise root: 2 * FT_BATCH frames, 2 steps an epoch
        work = WORK_DIR + "_finetune"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        t0 = time.perf_counter()
        for seed, section in enumerate(("train_drone_real", "train_drone_sim", "val_drone_real")):
            data.write_fake_dataset(os.path.join(datasets, "urbanscape", section), n=n_frames,
                                    img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=seed,
                                    scene="plane")
        # full-width task-pretrain donors, in folders that name their task
        donors = {}
        for seed, task in enumerate(FT_TASKS, start=1):
            net = models.build_network(task, "MLE", mean=[0.0] * models.task_channels(task))
            models.init_weights(net, torch.Generator().manual_seed(seed))
            os.makedirs(os.path.join(work, "weights", task))
            donors[task] = os.path.join(work, "weights", task, "model.net")
            compat.save_net(donors[task], net)
        log(f"wrote a pairwise plane scene ({n_frames} frames each of train_drone_real, "
            f"train_drone_sim, val_drone_real at {IMG_H}x{IMG_W}) and three full-width donors "
            f"in {time.perf_counter() - t0:.1f} s")

        def finetune(session, extra):
            return self._run_cli(ft_cli.main, work, FINETUNE_ARGS + [
                "--coord_weight", donors["coord"], "--depth_weight", donors["depth"],
                "--normal_weight", donors["normal"], "--datasets_dir", datasets, "--image_height",
                str(IMG_H), "--ckpt_dir", os.path.join(work, "ckpts"), "--session", session,
                *extra])

        # the main path: decoder finetuning, 2 epochs of 2 steps
        out_dir, losses, fwd, bwd, wall = finetune("smoke", ["--epochs", "2"])
        steps = 2 * (2 * n_frames) // FT_BATCH
        log(f"finetune_decoder_single_task on cuda (B={FT_BATCH}, {IMG_H}x{IMG_W}, f32, 2 epochs, "
            f"3 towers): {wall:.1f} s wall for {steps} steps, losses {losses}, {fwd} K1 and {bwd} "
            f"K1-bwd launches ({fwd / steps:g} and {bwd / steps:g} per step)")
        self.launches["finetune"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if fwd != FT_FWD * steps or bwd != FT_BWD * steps:
            raise AssertionError(f"expected {FT_FWD} K1 and {FT_BWD} K1-bwd launches per step, got "
                                 f"{fwd}/{bwd} over {steps} steps")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        if read_training_log(os.path.join(out_dir, "output.log"), 2 * n_frames) != (
                4 * n_frames, 1):
            raise AssertionError("output.log does not parse to (iteration 32, epoch 1)")
        ckpt_dir = os.path.join(work, "ckpts", os.path.basename(out_dir))
        ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_iter_"))
        for d in (out_dir, ckpt_dir):
            if not os.path.exists(os.path.join(d, "FLAG_training_done.nodata")):
                raise AssertionError(f"no FLAG_training_done.nodata in {d}")
        if not ckpts or not os.path.exists(os.path.join(out_dir, "model.net")):
            raise AssertionError("model.net or ckpt_iter_*.net not written")
        log(f"written: {os.path.basename(out_dir)}/model.net, output.log, {ckpts}, "
            f"FLAG_training_done.nodata (both directories)")

        # the depth and normal towers are their donors' encoders, bit for bit;
        # the coord tower, the MLR blocks and the decoder trained
        trained = compat.load_net(os.path.join(out_dir, "model.net"))
        init = self._mlr_model("cpu").state_dict()
        for tower, task in ((2, "depth"), (3, "normal")):
            enc = {k[8:]: v for k, v in compat.load_net(donors[task]).items()
                   if k.startswith("encoder.")}
            same = all(torch.equal(trained[f"mlr_encoder_{tower}.{k}"], v) for k, v in enc.items())
            if not same or len(enc) != sum(k.startswith(f"mlr_encoder_{tower}.") for k in trained):
                raise AssertionError(f"frozen tower {tower} ({task}) changed in training")
        coord = compat.load_net(donors["coord"])
        moved = {"tower 1": not torch.equal(trained["mlr_encoder_1.conv1.weight"],
                                            coord["encoder.conv1.weight"]),
                 "decoder": not torch.equal(trained["decoder.fc3.weight"],
                                            coord["decoder.fc3.weight"])}
        moved.update({k: not torch.equal(trained[k], init[k]) for k in (
            "mlr_skip.0.weight", "mlr_norm.weight", "mlr_forward.0.weight", "mlr_forward.6.weight")})
        log(f"towers 2 and 3 bit-identical to the depth and normal donors; changed by training: "
            f"{moved}")
        if not all(moved.values()):
            raise AssertionError("a trainable part of the net did not change")

        # serve the finetuned net: num_mlr = 3 from the folder name
        ops.group_norm_relu.launches = 0
        logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                              "--network_in", os.path.join(out_dir, "model.net"), "--section",
                              "val_drone_real", "--datasets_dir", datasets, "--image_height",
                              str(IMG_H), "--save_pred", "--device", "cuda"])
        torch.cuda.synchronize()
        served = ops.group_norm_relu.launches
        self.launches["finetune_serve"] = dict(groupnorm=served)
        pred_dir = os.path.join(out_dir, "coord_pred_model.net_val_drone_real")
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"] for f in sorted(os.listdir(pred_dir))]
        median = re.findall(r"Median Error:\s+(\d+.\d+) deg, (\d+.\d+) m", open(logs[0]).read())
        log(f"served the finetuned model.net on cuda: {logs[0]}, {len(poses)} poses, {served} K1 "
            f"launches, median {median[-1][1]} m / {median[-1][0]} deg after {steps} steps")
        if served != FT_FWD or len(poses) != n_frames or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("the finetuned net did not serve")

        _, losses16, fwd16, bwd16, wall16 = finetune("smoke_bf16", ["--epochs", "1", "--bf16"])
        log(f"finetune_decoder_single_task --bf16 on cuda: {wall16:.1f} s, losses {losses16}, "
            f"{fwd16} K1 and {bwd16} K1-bwd launches")
        if fwd16 != FT_FWD * 2 or bwd16 != FT_BWD * 2 or not all(math.isfinite(v) for v in losses16):
            raise AssertionError("the --bf16 finetune run is off")

        def make(dev, dtype=None):
            return self._mlr_model(dev, dtype, donors)

        # f32 on the card, with or without K1 and cuDNN, sits further from
        # float64 at this net's stems than the CPU's f32 does (PERF.md §6):
        # the card's plain twin sets the rounding the kernels may add to
        self._gradients_against_cpu(datasets, make, section="train_drone_real",
                                    yardstick=("cpu", "card_plain"))
        self._step_time(datasets, make, FT_BATCH, "train_drone_real", "finetune.json")
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 7 -----------------------------------------------------------
    def phase_tasks(self):
        """Encoder pretraining and serving of the depth, normal and semantics
        nets through the CLIs, as `encoder_pretrain.sh` and
        `validate_encoder_pretrain.sh` run them."""
        import torch

        from crossloc_tpu_torch import data

        work = WORK_DIR + "_tasks"
        shutil.rmtree(work, ignore_errors=True)
        n_frames = 2 * TRAIN_BATCH
        t0 = time.perf_counter()
        # the plane scene's normals, (0, 0, -1), equal the nodata marker in
        # every cell: the normal task trains on the noise scene
        for scene in ("plane", "noise"):
            for seed, (section, n) in enumerate((("train_sim", n_frames), ("val_sim", BATCH))):
                data.write_fake_dataset(os.path.join(work, scene, "urbanscape", section), n=n,
                                        img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=seed,
                                        scene=scene)
        log(f"wrote {n_frames}-frame train_sim and {BATCH}-frame val_sim sections of the plane "
            f"and the noise scene at {IMG_H}x{IMG_W} in {time.perf_counter() - t0:.1f} s")

        # ROADMAP F1: the CLI's own setup turns TF32 off (torch's default is
        # on); `_run_cli` checks both flags after each run
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        report = {}
        for task, scene, extra in TASK_RUNS:
            datasets = os.path.join(work, scene)
            report[task] = self._task_run(task, datasets, work, extra)
            if task == TASK_RUNS[0][0]:
                log(f"TF32 set on before the {task} run; after it: cudnn.allow_tf32="
                    f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
                    f"{torch.backends.cuda.matmul.allow_tf32}")
            unc = None if task == "semantics" else "MLE"
            if task in ("normal", "semantics"):
                # as for the finetune net, the card's f32 (with or without the
                # kernels) may sit further from float64 than the CPU's: the
                # card's plain twin sets the rounding the kernels may add to
                self._gradients_against_cpu(
                    datasets, lambda dev, dtype=None: self._model(dev, dtype, task, unc),
                    yardstick=("cpu", "card_plain"), task=task, unc=unc)
            report[task]["step"] = self._step_time(
                datasets, lambda dev, dtype=None: self._model(dev, dtype, task, unc),
                out_name=f"tasks_{task}.json", task=task, unc=unc)

        # semantics once more with --bf16
        datasets = os.path.join(work, "plane")
        out_dir, losses, fwd, bwd, wall = self._task_train(
            "semantics", datasets, work, "smoke_bf16", ["--epochs", "1", "--bf16"])
        log(f"train_single_task --task semantics --bf16 on cuda: {wall:.1f} s, losses {losses}, "
            f"{fwd} K1 and {bwd} K1-bwd launches")
        if fwd != 29 * 2 or bwd != 29 * 2 or not all(math.isfinite(v) for v in losses):
            raise AssertionError("the --bf16 semantics run is off")
        report["semantics_bf16"] = dict(losses=losses, k1=fwd, k1_bwd=bwd, wall_s=wall)
        with open(os.path.join(self.out_dir, "tasks.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), runs=report), f,
                      indent=1)
        shutil.rmtree(work, ignore_errors=True)

    def _run_cli(self, main, work, args):
        """A training CLI's `main(args)` in process, in `work`, with the launch
        counts set to 0 just before it; (output dir, logged losses, K1 and
        K1-bwd launches, wall s). Every CLI turns TF32 off itself (ROADMAP
        F1): checked after each run."""
        import re

        import torch

        from crossloc_tpu_torch import ops

        cwd = os.getcwd()
        os.chdir(work)
        ops.group_norm_relu.launches = 0
        ops.group_norm_relu_backward.launches = 0
        t = time.perf_counter()
        try:
            out_dir = main(args)
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t
        fwd, bwd = ops.group_norm_relu.launches, ops.group_norm_relu_backward.launches
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        if any(tf32):
            raise AssertionError(f"the CLI left TF32 on: cudnn {tf32[0]}, matmul {tf32[1]}")
        text = open(os.path.join(out_dir, "output.log")).read()
        losses = [float(v) for v in re.findall(r"Total loss: ([-\w.]+),", text)]
        return out_dir, losses, fwd, bwd, wall

    def _task_train(self, task, datasets, work, session, extra):
        """The training CLI on cuda with `encoder_pretrain.sh`'s flags for
        `task` (`_run_cli`)."""
        from crossloc_tpu_torch.cli import train_single_task as train_cli

        return self._run_cli(train_cli.main, work, [
            "urbanscape", "--task", task, *TASK_FLAGS[task], "--learningrate", "2e-4",
            "--batch_size", str(TRAIN_BATCH), "--auto_resume", "--sim_data_chunk", "1.0",
            "--real_data_chunk", "0.0", "--datasets_dir", datasets, "--image_height", str(IMG_H),
            "--ckpt_dir", os.path.join(work, "ckpts"), "--session", session, "--device", "cuda",
            *extra])

    def _task_run(self, task, datasets, work, extra):
        """Train `task` 2 epochs through the CLI (its K1 / K1-bwd launches
        per step counted), then serve its model.net on val_sim through the
        eval CLI (launches counted) and check the results file."""
        import re

        import torch

        from crossloc_tpu_torch import ops
        from crossloc_tpu_torch.cli import test_single_task as test_cli

        per_step = 29 if task == "semantics" else 28
        out_dir, losses, fwd, bwd, wall = self._task_train(task, datasets, work, "smoke",
                                                           ["--epochs", "2", *extra])
        steps = 4  # 2 epochs of 24 frames at B=12
        log(f"train_single_task --task {task} on cuda (B={TRAIN_BATCH}, {IMG_H}x{IMG_W}, f32, "
            f"2 epochs): {wall:.1f} s wall for {steps} steps, losses {losses}, {fwd} K1 and {bwd} "
            f"K1-bwd launches ({fwd / steps:g} and {bwd / steps:g} per step)")
        self.launches[f"tasks_{task}"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if fwd != per_step * steps or bwd != per_step * steps:
            raise AssertionError(f"expected {per_step} K1 and K1-bwd launches per step, got "
                                 f"{fwd}/{bwd} over {steps} steps")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        for f in ("model.net", "FLAG_training_done.nodata"):
            if not os.path.exists(os.path.join(out_dir, f)):
                raise AssertionError(f"{f} not written")

        ops.group_norm_relu.launches = 0
        unc = "none" if task == "semantics" else "MLE"
        logs = test_cli.main(["urbanscape", "--task", task, "--uncertainty", unc,
                              *(["--fullsize"] if task == "semantics" else []), "--network_in",
                              os.path.join(out_dir, "model.net"), "--section", "val_sim",
                              "--datasets_dir", datasets, "--image_height", str(IMG_H),
                              "--device", "cuda"])
        torch.cuda.synchronize()
        served = ops.group_norm_relu.launches
        self.launches[f"tasks_serve_{task}"] = dict(groupnorm=served)
        text = open(logs[0]).read()
        heads = TASK_REPORT_LINES[task]
        nums = [float(v) for h in heads
                for v in re.findall(re.escape(h) + r"[^\n]*?(-?\d+\.\d+)", text)]
        log(f"served the {task} model.net on cuda: {logs[0]}, {served} K1 launches; "
            + "; ".join(line for line in text.splitlines() if line.startswith(heads)))
        if served != per_step or len(nums) != len(heads) or not all(map(math.isfinite, nums)):
            raise AssertionError(f"the {task} net did not serve: {served} K1 launches, {nums}")
        return dict(losses=losses, k1=fwd, k1_bwd=bwd, wall_s=wall, served_k1=served,
                    results=[ln for ln in text.splitlines() if ln.startswith(heads)])

    def _host_batch(self, datasets, n, section="train_sim", task="coord"):
        """(raw images, labels, poses, focal) of the first n frames of
        `section` as CPU tensors; semantics labels as the training CLI sends
        them (uint8 class ids, [n, H, W, 1])."""
        import torch

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.cli.train_single_task import labels_to_wire

        b = data.CamLocDataset(os.path.join(datasets, "urbanscape", section), coord=task == "coord",
                               depth=task == "depth", normal=task == "normal",
                               semantics=task == "semantics", image_height=IMG_H).collate(range(n))
        labels = dict(b, **labels_to_wire(b, task))[task]
        return (torch.from_numpy(b["image"]), torch.from_numpy(labels),
                torch.from_numpy(b["pose"]), torch.tensor(float(b["focal"][0])))

    def _train_batch(self, datasets, n, device, augment=True, seed=0, section="train_sim",
                     task="coord"):
        """(normalised images, poses, labels, focal, pp_shift) of the first n
        frames of `section`, augmented on the CPU with fixed draws, on `device`."""
        import torch

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.train import TrainBatch

        images, labels, poses, focal = self._host_batch(datasets, n, section, task)
        if augment:
            draws = data.draw_augmentation(torch.Generator().manual_seed(seed), n)
            images, labels, poses, focal, pp = data.augment_batch(
                images, labels, poses, focal, draws, semantics=task == "semantics")
        else:
            images, pp = data.normalize_images(images), None
        return TrainBatch(*(None if t is None else t.to(device)
                            for t in (images, poses, labels, focal, pp)))

    def _model(self, device, dtype=None, task="coord", unc="MLE"):
        """The training CLI's net for `task` (semantics full size), seeded."""
        import torch

        from crossloc_tpu_torch import data, models

        m = models.build_network(task, unc, fullsize=task == "semantics",
                                 mean=list(data.get_label_mean("urbanscape", task)))
        models.init_weights(m, torch.Generator().manual_seed(2021)).to(device)
        if dtype is not None:
            m.dtype = dtype
        return m.to(memory_format=torch.channels_last) if device == "cuda" else m

    def _mlr_model(self, device, dtype=None, donors=None):
        """The finetune CLI's net: three full-width towers, the first
        trainable, seeded MLR blocks; towers and decoder wired from the donor
        `.net` files when given."""
        import torch

        from crossloc_tpu_torch import data, models
        from crossloc_tpu_torch.cli import common

        m = models.build_network("coord", "MLE", num_mlr=3, num_unfrozen_encoder=1,
                                 mean=list(data.get_label_mean("urbanscape", "coord")))
        models.init_weights(m, torch.Generator().manual_seed(2021))
        if donors is not None:
            common.wire_mlr_weights(m, [donors[t] for t in FT_TASKS], True)
        m.to(device)
        if dtype is not None:
            m.dtype = dtype
        return m.to(memory_format=torch.channels_last) if device == "cuda" else m

    def _gradients_against_cpu(self, datasets, make_model=None, section="train_sim",
                               yardstick=("cpu",), task="coord", unc="MLE"):
        """One step at full width, 480x720, B=2, same weights and batch: the
        card (K1, K1-bwd, TF32 off) against the CPU (plain twins) in float32,
        and both against the CPU in float64 (the loss stays float32). Only
        trainable parameters have a gradient; frozen ones must have none.

        Four card runs, all reported: "card", the path as it runs, which the
        limit holds; "card_native", cuDNN off (PyTorch's own CUDA
        convolutions, im2col and an fp32 GEMM); "card_plain_bwd", K1's
        forward with the plain twin's backward; "card_plain", the plain twin
        for every norm. They tell the kernels' rounding from the rest of the
        card's. The f32 rounding the limit allows is the largest distance
        from float64 of the plain f32 runs named in `yardstick` (the CPU's,
        and for the finetune net also the card's plain twin's)."""
        import contextlib

        import torch

        from crossloc_tpu_torch.models import layers
        from crossloc_tpu_torch.ops import groupnorm as gn
        from crossloc_tpu_torch.train import TrainBatch, TrainState, make_optimizer, train_step

        @contextlib.contextmanager
        def variant(run):
            cudnn = torch.backends.cudnn.flags(enabled=run != "card_native", benchmark=False,
                                              deterministic=False, allow_tf32=False)
            saved = layers.group_norm_relu, gn.group_norm_relu_backward
            if run == "card_plain":
                layers.group_norm_relu = gn.group_norm_relu_plain
            if run == "card_plain_bwd":
                gn.group_norm_relu_backward = (
                    lambda x, s, b, st, dy, G, relu: gn.group_norm_relu_backward_plain(
                        x, s, b, dy, G, gn.GN_EPS, relu))
            try:
                with cudnn:
                    yield
            finally:
                layers.group_norm_relu, gn.group_norm_relu_backward = saved

        make_model = make_model or self._model
        grads, losses = {}, {}
        batch = self._train_batch(datasets, 2, "cpu", section=section, task=task)
        cards = ("card", "card_native", "card_plain_bwd", "card_plain")
        for run, dev, dtype in ([(c, "cuda", torch.float32) for c in cards]
                                + [("cpu", "cpu", torch.float32), ("cpu64", "cpu", torch.float64)]):
            model = make_model(dev)
            if dtype == torch.float64:
                model.double().dtype = torch.float64
            trainable = [p for p in model.parameters() if p.requires_grad]
            state = TrainState(model, make_optimizer(trainable, 2e-4))
            b = TrainBatch(*(t.to(dev, dtype) for t in batch))
            t = time.perf_counter()
            with variant(run):
                m = train_step(state, b, task, unc)
            losses[run] = float(m["loss"])
            named = dict(model.named_parameters())
            if any(p.grad is not None for p in named.values() if not p.requires_grad):
                raise AssertionError("a frozen parameter has a gradient")
            grads[run] = {k: p.grad.detach().double().cpu() for k, p in named.items()
                          if p.requires_grad}
            log(f"  one step, {run}: loss {losses[run]:.6f}, grad norm "
                f"{float(m['grad_norm']):.6f}, {len(grads[run])} of {len(named)} tensors "
                f"trainable, {time.perf_counter() - t:.1f} s")
            del model, state

        def dist(a, b):
            return {k: float((grads[a][k] - g).norm()) for k, g in grads[b].items()}

        norm = {k: float(g.norm()) for k, g in grads["cpu"].items()}
        total = float(torch.sqrt(sum(g.square().sum() for g in grads["cpu64"].values())))
        d_cpu64 = dist("cpu", "cpu64")
        d_yard = [dist(y, "cpu64") for y in yardstick]
        ref = {k: max(d[k] for d in d_yard) for k in norm}
        failed = False
        for card in cards:
            d_cc, d_c64 = dist(card, "cpu"), dist(card, "cpu64")
            rel = {k: d_cc[k] / max(norm[k], 1e-30) for k in norm}
            worst = sorted(rel, key=rel.get, reverse=True)[:4]
            log(f"{task} gradients {card} vs CPU (f32) at B=2 {IMG_H}x{IMG_W}: |g_card - g_cpu| / "
                f"|g_cpu| median {sorted(rel.values())[len(rel) // 2]:.3e} over {len(rel)} "
                f"tensors, {sum(v > 1e-3 for v in rel.values())} above 1e-3; worst "
                + ", ".join(f"{k} {rel[k]:.3e} (card vs f64 {d_c64[k] / norm[k]:.3e}, CPU f32 "
                            f"vs f64 {d_cpu64[k] / norm[k]:.3e}, |g| {norm[k]:.3e})"
                            for k in worst)
                + f"; global |g| {total:.3e}")
            # per tensor, the card within 1e-3 of the CPU's gradient, or no
            # further from the float64 gradient than 1e-3 of its norm plus
            # twice the f32 rounding allowed (for the coord net, the CPU f32
            # path's own distance from float64), plus 1e-6 of the global norm
            # (the bias of stem1's conv has a true gradient of zero: a
            # GroupNorm of one channel per group removes it)
            over = {name: [k for k in norm if rel[k] > 1e-3 and d_c64[k] > 1e-3 * norm[k]
                           + 2 * r[k] + 1e-6 * total]
                    for name, r in (("CPU f32 rounding", d_cpu64), ("yardstick", ref))}
            d_loss = abs(losses[card] - losses["cpu"]) / abs(losses["cpu"])
            log(f"  {card}: tensors over the limit with the CPU f32's rounding: "
                f"{over['CPU f32 rounding']}; with the rounding of {'/'.join(yardstick)}: "
                f"{over['yardstick']}; loss vs CPU rel {d_loss:.3e} (limit 1e-4)")
            failed = failed or (card == "card" and bool(over["yardstick"] or d_loss > 1e-4))
        if failed:
            raise AssertionError(f"{task}: card gradients disagree with the CPU's")

    def _fixed_batch_descends(self, datasets):
        import torch

        from crossloc_tpu_torch.train import TrainState, make_optimizer, train_step

        model = self._model("cuda")
        state = TrainState(model, make_optimizer(model.parameters(), 2e-4))
        batch = self._train_batch(datasets, 2, "cuda", augment=False)
        losses = [float(train_step(state, batch, "coord", "MLE")["loss"]) for _ in range(10)]
        log(f"10 steps on one fixed batch (B=2, no augmentation): losses "
            + ", ".join(f"{v:.2f}" for v in losses))
        if not losses[-1] < losses[0]:
            raise AssertionError("the loss did not go down on a fixed batch")

    def _step_time(self, datasets, make_model=None, batch_size=TRAIN_BATCH,
                   section="train_sim", out_name="train.json", task="coord", unc="MLE"):
        """One training step (augmentation of uint8 images, forward, loss,
        backward, Adam over the trainable parameters) at `batch_size`,
        between CUDA events, f32 (TF32 off) and bf16, with img/s and peak
        memory; returns {dtype: {ms, img_s, peak_gib}}."""
        import torch

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.train import TrainBatch, TrainState, make_optimizer, train_step

        make_model = make_model or self._model
        B = batch_size
        images, labels, poses, focal = (t.cuda() for t in self._host_batch(datasets, B, section,
                                                                             task))
        wire = torch.from_numpy(data.images_to_wire(images.cpu().numpy())).cuda()
        draws = data.draw_augmentation(torch.Generator().manual_seed(0), B).to("cuda")
        out = {}
        os.makedirs(self.out_dir, exist_ok=True)
        for dtype in (torch.float32, torch.bfloat16):
            model = make_model("cuda", dtype)
            trainable = [p for p in model.parameters() if p.requires_grad]
            state = TrainState(model, make_optimizer(trainable, 2e-4))

            def step():
                im, lab, po, fo, pp = data.augment_batch(data.images_from_wire(wire), labels,
                                                         poses, focal, draws,
                                                         semantics=task == "semantics")
                return train_step(state, TrainBatch(im, po, lab, fo, pp), task, unc)

            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, iters=5, warmup=2)
            peak = torch.cuda.max_memory_allocated() / 2**30
            name = str(dtype)[6:]
            out[name] = dict(ms=ms, img_s=1e3 * B / ms, peak_gib=peak)
            log(f"{out_name[:-5]} step ({task}) B={B} {IMG_H}x{IMG_W} {name} on {self.device_name} "
                f"({nvidia_smi_line()}): {ms:.2f} ms = {1e3 * B / ms:.1f} img/s, "
                f"peak memory {peak:.2f} GiB")
            del model, state
        with open(os.path.join(self.out_dir, out_name), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), batch=B, task=task,
                           steps=out), f, indent=1)
        return out

    # -- extra phase, not in the default run ---------------------------------
    def phase_profile(self):
        """Where the time of one image -> pose batch, one training step (coord
        and semantics) and one finetune step goes, by kernel group
        (torch.profiler), and the device's busy share of the wall time."""
        self._profile_serve()
        self._profile_step(self._model, TRAIN_BATCH, "train")
        self._profile_step(lambda dev, dtype: self._model(dev, dtype, "semantics", None),
                           TRAIN_BATCH, "semantics", task="semantics")
        self._profile_step(self._mlr_model, FT_BATCH, "finetune")

    @staticmethod
    def _kernel_groups(prof):
        """(device busy ms, kernel count, {group: [launches, ms]}) of a trace."""
        import torch

        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        groups = {}
        for e in kernels:
            n = e.name.lower()
            key = ("K1-bwd groupnorm" if "gnb_" in n
                   else "K1 groupnorm" if any(k in n for k in ("gn_stats", "gn_finalize",
                                                               "gn_apply", "gn_cluster"))
                   else "conv" if any(k in n for k in ("fprop", "dgrad", "wgrad", "conv", "xmma",
                                                      "cutlass", "implicit_gemm", "cudnn"))
                   else "other")
            g = groups.setdefault(key, [0, 0.0])
            g[0] += 1
            g[1] += e.time_range.elapsed_us() / 1e3
        return sum(g[1] for g in groups.values()), len(kernels), groups

    def _profile_step(self, make_model, B, tag, task="coord"):
        """One training step (augmentation, forward, loss, backward, Adam) of
        `make_model`'s net at batch B, 480x720, f32 and bf16, on a seeded
        synthetic batch (semantics: class ids on the image canvas)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.train import TrainBatch, TrainState, make_optimizer, train_step

        gen = torch.Generator(device="cuda").manual_seed(5)
        wire = torch.randint(0, 256, (B, IMG_H, IMG_W, 3), device="cuda", generator=gen,
                             dtype=torch.uint8)
        mean = torch.tensor(data.get_label_mean("urbanscape", "coord"), device="cuda")
        labels = mean + 20 * torch.randn(B, IMG_H // 8, IMG_W // 8, 3, device="cuda",
                                         generator=gen)
        if task == "semantics":
            labels = torch.randint(0, 6, (B, IMG_H, IMG_W, 1), device="cuda", generator=gen,
                                   dtype=torch.uint8)
        poses = torch.eye(4, device="cuda").repeat(B, 1, 1)
        poses[:, :3, 3] = mean - torch.tensor([0.0, 0.0, 90.0], device="cuda")
        focal = torch.tensor(480.0, device="cuda")
        draws = data.draw_augmentation(torch.Generator().manual_seed(0), B).to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            model = make_model("cuda", dtype)
            trainable = [p for p in model.parameters() if p.requires_grad]
            state = TrainState(model, make_optimizer(trainable, 2e-4))

            def step():
                im, lab, po, fo, pp = data.augment_batch(data.images_from_wire(wire), labels,
                                                         poses, focal, draws,
                                                         semantics=task == "semantics")
                return float(train_step(state, TrainBatch(im, po, lab, fo, pp), task,
                                        None if task == "semantics" else "MLE")["loss"])

            step(), step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy, n, groups = self._kernel_groups(prof)
            name = str(dtype)[6:]
            log(f"profile {tag} step {name} B={B} {IMG_H}x{IMG_W}: wall {wall:.2f} ms, device "
                f"busy {busy:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}, {n} "
                f"kernels; by group: " + ", ".join(
                    f"{k} {v[0]} launches {v[1]:.2f} ms" for k, v in sorted(groups.items())))
            with open(os.path.join(self.out_dir, f"profile_{tag}_{name}.txt"), "w") as f:
                f.write(f"{self.device_name} | {nvidia_smi_line()}\n")
                f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
            del model, state

    def _profile_serve(self):
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
            busy, n_kernels, groups = self._kernel_groups(prof)
            log(f"profile {str(dtype)[6:]} B={BATCH} {IMG_H}x{IMG_W} net+solver: wall {wall:.2f} ms, "
                f"device busy {busy:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}, "
                f"{n_kernels} kernels; by group: "
                + ", ".join(f"{k} {v[0]} launches {v[1]:.2f} ms" for k, v in sorted(groups.items())))
            os.makedirs(self.out_dir, exist_ok=True)
            with open(os.path.join(self.out_dir, f"profile_{str(dtype)[6:]}.txt"), "w") as f:
                f.write(f"{self.device_name} | {nvidia_smi_line()}\n")
                f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
        model.dtype = torch.float32

    def kernels_line(self) -> str:
        """The kernels JSON line: `launches` sums each main path's counted run
        (`launches_by_path` lists them); times are the 28-call totals, beside
        them the other design's (`three_pass_ms`, `four_kernel_ms`)."""
        out = []
        for name, v in self.kernels.items():
            by_path = {p: n[name] for p, n in self.launches.items() if name in n}
            out.append(dict(v, launches=sum(by_path.values()), launches_by_path=by_path))
        return json.dumps({"kernels": out})


PHASES = ("card", "kernels", "forward", "serve", "train", "finetune", "tasks")
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
