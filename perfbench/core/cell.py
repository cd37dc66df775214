"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line's fields."""
from __future__ import annotations

import gc
import math
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import List, Optional

import torch

from . import peaks as peaks_mod
from . import spec, work
from .tracer import Tracer


def precision(config: dict) -> str:
    return "tf32" if config.get("tf32") else config["dtype"]


def window_summary(rec: dict, host: dict) -> str:
    """The spread of the window's step or batch times within the run, and
    the host seconds of each span per unit, for telling the spread within a
    run from the spread between runs and naming where it lies."""
    times = rec.get("times") or []
    n = max(rec["units"], 1)
    spans = ", ".join(f"{k} {1e3 * v / n:.3f}" for k, v in sorted(host.items()))
    if len(times) < 4:
        return f"window: {rec['units']} units; host ms a unit: {spans}"
    q1, med, q3 = (1e3 * q for q in statistics.quantiles(times, n=4))
    return (f"window: {len(times)} units, mean {1e3 * statistics.fmean(times):.3f} ms, "
            f"sd {1e3 * statistics.stdev(times):.3f} ms, quartiles {q1:.3f} / {med:.3f} / "
            f"{q3:.3f} ms, spread {100 * (q3 - q1) / med:.2f} %; host ms a unit: {spans}")


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, workdir: str,
            device: str = "cuda", t_start: Optional[float] = None) -> SimpleNamespace:
    """Set up (the scene written under `workdir`), run the window and free
    the program. Returns the window's record, the tracer, the window's peak
    memory, the set-up seconds and what the program produced for the check."""
    t_start = time.perf_counter() if t_start is None else t_start
    if precision(cell.config) != "float32":
        raise ValueError(f"{cell.config['name']} states {precision(cell.config)}; the loops run "
                         "float32 with TF32 off only")
    loop = spec.loop(cell.workload["loop"])
    prog = loop.Program(cell, seed, workdir, device)
    dev = prog.dev
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = Tracer(trace, dev)
    rec = prog.window(seconds, tracer)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    evidence = prog.evidence
    prog.close()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tracer.finish()
    return SimpleNamespace(loop=loop, dev=dev, rec=rec, tracer=tracer, peak=peak,
                           setup_s=setup_s, evidence=evidence)


def per_layer(entries: List[dict], ctx) -> dict:
    """The readings of the per-layer metrics `entries` from a traced run's
    context: each metric whose kind of loop (`spec.trains`) is the run's,
    where its reader finds something to read."""
    metrics = {}
    for metric in entries:
        if spec.trains(metric["name"]) != ctx.training:
            continue
        value = spec.metric_reader(metric["name"]).read(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return metrics


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, device_extra: Optional[dict] = None) -> dict:
    """Run `cell` once; returns the result line's dict. `t_start` is the
    process's start on the host clock (default: now)."""
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        m = measure(cell, seed, seconds, trace, tmp, device, t_start)
        readings = m.loop.check(cell, seed, m.evidence, m.dev)
    loop, dev, rec, tracer, peak = m.loop, m.dev, m.rec, m.tracer, m.peak
    print(window_summary(rec, tracer.host), file=sys.stderr)

    limits = cell.workload["limits"]
    checks = {n: {"value": readings[n], "limit": limits[n]} for n in loop.CHECKS}
    correct = all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                   "count": cell.chips if dev.type == "cuda" else 1, "memory_peak_bytes": peak}
    device_info.update(device_extra or {})
    out = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"]}
    if not trace:
        values = dict(loop.end_to_end(rec), setup_s=m.setup_s, peak_mem_gib=peak / 2 ** 30)
        metrics = {}
        for metric in cell.end_to_end:
            if metric["name"] not in values:
                raise KeyError(f"the {cell.workload['loop']} loop does not measure "
                               f"{metric['name']}")
            metrics[metric["name"]] = {"value": values[metric["name"]], "unit": metric["unit"]}
        out.update(metrics=metrics, device=device_info)
    else:
        tr = tracer.trace
        ctx = SimpleNamespace(  # what a reader sees: whether the loop trains, not its name
            training=bool(loop.TRAINING), trace=tr, host=dict(tracer.host), units=rec["units"],
            traced_units=tracer.units, peaks=peaks_mod.for_device(name, precision(cell.config)),
            config=cell.config, workload=cell.workload)
        ctx.work = work.counts(cell.config, int(cell.workload["batch"]), ctx.training, ctx.peaks)
        metrics = per_layer(cell.per_layer, ctx)
        device_info.update(busy_s=tr.busy_s if tr else 0.0, window_s=tr.window_s if tr else 0.0)
        out.update(metrics=metrics, device=device_info)
        if tr is not None:
            out["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    out["checks"] = checks
    return out
