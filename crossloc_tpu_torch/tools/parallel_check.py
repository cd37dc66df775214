"""Multi-rank checks of the parallel layer on one host: start ranks joined
through a `file://` process group, run one training step on a mesh (data,
ZeRO, data x spatial or data x model), a forward on a spatial mesh, the
halo-exchanged convs, or the hypothesis-sharded solver, on each, and hand
back what rank 0 saw. `chip_smoke.py`'s parallel and spatial phases,
`tools/multichip.py` and the CPU tests use it; the same functions with
`world=1` in the calling process are the single-process reference.

A rank that exits non-zero or outlives its timeout fails the run (the
others are then stopped).

    python -m crossloc_tpu_torch.tools.parallel_check <counts.json> <cli module> <argv...>

runs one rank of a CLI (`main(argv)`) with K1's launch counts set to 0 just
before it and written to `counts.json` just after, beside the wall time.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .. import models, parallel, ransac
from ..cli.common import select_device_from_env
from ..models.layers import Conv
from ..ops import (
    group_norm_relu,
    group_norm_relu_backward,
    group_norm_shard_apply,
    group_norm_shard_backward_apply,
    group_norm_shard_backward_sums,
    group_norm_shard_stats,
)
from ..ransac.solver import solver_precision
from ..train import (
    CheckpointManager,
    TrainBatch,
    TrainState,
    make_dsac_train_step,
    make_optimizer,
    task_loss_fn,
    train_state_dict,
    train_step,
    update_params,
)


def _rank_main(fn: Callable, rank: int, world: int, init_method: str, device: str,
               threads: int, args: Sequence) -> None:
    torch.set_num_threads(threads)
    parallel.initialize_distributed(init_method, world, rank, device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), device: str = "cpu",
              timeout: float = 300.0, threads: int = 2) -> None:
    """Run `fn(*args)` on `world` spawned ranks of one process group (gloo
    for CPU ranks and for ranks sharing a card, else NCCL); raises when a
    rank fails or any is still running after `timeout` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="crossloc_pg_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, device, threads, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for r, p in enumerate(procs):
                p.join(max(0.1, deadline - time.monotonic()))
                if p.is_alive():
                    raise TimeoutError(f"rank {r} still running after {timeout:.0f} s")
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


_COUNTED = (group_norm_relu, group_norm_relu_backward, group_norm_shard_stats,
            group_norm_shard_apply, group_norm_shard_backward_sums,
            group_norm_shard_backward_apply)


def _zero_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def _counts() -> tuple:
    """(K1, K1-bwd) and (the four cross-shard entries) launch counts."""
    n = [fn.launches for fn in _COUNTED]
    return tuple(n[:2]), tuple(n[2:])


def _batch_rows(spec: Dict[str, Any], mesh, device) -> TrainBatch:
    """This rank's part of the spec's global batch on `device`."""
    b = spec["batch"]
    full = TrainBatch(b["images"], b["poses"], b["labels"], b["focal"], b["pp_shift"])
    part = parallel.shard_batch(mesh, full, shard_spatial=mesh.spatial > 1)
    return TrainBatch(*(None if t is None else t.to(device) for t in part))


def _forward_backward(state: TrainState, spec: Dict[str, Any], batch: TrainBatch, rows: slice):
    """One forward and backward of the step `spec["kind"]`: "coord", "e2e",
    or "surrogate" (JAX's smooth stand-in for the coord loss in its
    spatial-sharding test: the mean of the squared coordinates plus the
    mean uncertainty). Returns (the loss of this rank's part, the net's
    output)."""
    net, dp = state.model, state.parallel
    if spec["kind"] == "e2e":  # train/dsac_step.py's forward and backward
        coords = net(batch.images)[..., :net.num_task_channel]
        coords = coords.to(torch.promote_types(coords.dtype, torch.float32))
        loss, _ = ransac.expected_pose_loss(
            coords, batch.poses, batch.focal.reshape(-1)[0], tuple(batch.images.shape[1:3]),
            ransac.RansacConfig(**spec["ransac"]), pp_shift=batch.pp_shift,
            idx=spec["idx"][rows].to(coords.device))
        with solver_precision(coords.device):
            loss.backward()
        return loss, coords
    preds = net(batch.images)
    if spec["kind"] == "surrogate":
        loss = preds[..., :3].square().mean() + preds[..., 3].mean()
    else:
        loss, _ = task_loss_fn("coord", preds, batch, spec["uncertainty"], net.num_task_channel,
                               count_reduce=dp.all_sum if dp is not None else None,
                               spatial=dp.spatial_block if dp is not None else (0, 1))
    loss.backward()
    return loss, preds


def _full_gradients(state: TrainState) -> Dict[str, torch.Tensor]:
    """Name -> the averaged gradient of every trainable tensor (ZeRO shards
    all-gathered), on the CPU."""
    dp = state.parallel
    if dp is None:
        return {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()
                if p.requires_grad}
    out = {n: p.grad.detach().cpu() for n, p in dp.replicated}
    if dp.shard is not None:
        out.update({n: g.cpu() for n, g in dp.full_tensors(dp.shard.grad).items()})
    return out


def _device_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_split(prof, wall_ms: float) -> Dict[str, float]:
    """This process's device time in a torch.profiler trace beside the wall:
    the summed durations of its kernels and of its copies and memsets
    (gloo stages CUDA tensors through the host)."""
    kernel_ms = copy_ms = 0.0
    kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith(("Memcpy", "Memset")):
            copy_ms += ms
        else:
            kernel_ms += ms
            kernels += 1
    return dict(wall_ms=wall_ms, kernel_ms=kernel_ms, copy_ms=copy_ms, kernels=kernels)


def _gather_objects(obj) -> list:
    """`obj` of every rank of the default group, in rank order ([obj] without
    a process group)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def step_check(spec: Dict[str, Any], out_path: Optional[str] = None) -> Dict[str, Any]:
    """On each rank: the spec's net and its rows of the global batch; the
    averaged gradient of the first step, then `spec["steps"]` training steps
    through `train_step` (or the DSAC step with the global pool's draws).
    Returns, and rank 0 writes to `out_path`: "grads" and "params" (names
    -> CPU tensors), "preds" (the first forward's output of the global
    batch), "loss", "grad_norm", the wall "step_ms" (the step's enqueue to
    its loss on the host), K1's forward and backward launches per step on
    this rank ("launches") and the cross-shard entries' ("shard_launches":
    stats, apply, backward sums, backward apply), "by_rank" (each rank's
    own "launches", "shard_launches", "step_ms" and "profile", in rank
    order), "profile" (with `spec["profile"]`: the last step's wall to the
    end of its device work beside this process's kernel and copy time on
    the device, `_device_split`), "held" (after the steps:
    the elements of the flat shard, of the whole sharded tensors, and
    whether the full tensors are freed), and the process group's
    "backend".

    spec: "state_dict", "batch" (images, poses, labels, focal, pp_shift of
    the global batch, CPU tensors), "kind", "uncertainty", "mean", "tiny",
    "zero", "steps", "lr", "grad_clip", "device", optionally "float64",
    "mesh" (`make_mesh`'s arguments; ignored at world size 1), "profile"
    (trace the last step), and for
    "e2e" "ransac" (RansacConfig fields) and "idx" (the global pool's
    draws)."""
    state, batch, rows = _setup(spec)
    net, dp = state.model, state.parallel
    device = batch.images.device
    if dp is None:
        _, preds = _forward_backward(state, spec, batch, rows)
    else:
        with dp.materialized():
            _, preds = _forward_backward(state, spec, batch, rows)
            preds = parallel.unshard_batch(dp.mesh, preds.detach())
            dp.reduce_gradients()
    grads = _full_gradients(state)
    for p in update_params(state):
        p.grad = None

    dsac = None
    if spec["kind"] == "e2e":
        dsac = make_dsac_train_step(net, ransac.RansacConfig(**spec["ransac"]))
    out = {"grads": grads, "preds": preds.detach().cpu(), "loss": [], "grad_norm": [],
           "launches": [], "shard_launches": [], "step_ms": [],
           "backend": dist.get_backend() if dist.is_initialized() else None}
    for i in range(spec["steps"]):
        profiling = spec.get("profile") and i == spec["steps"] - 1
        _zero_counts()
        with _device_profile() if profiling else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            if dsac is not None:
                m = dsac(state, batch, idx=spec["idx"][rows].to(device))
            else:
                m = train_step(state, batch, "coord", spec["uncertainty"])
            out["loss"].append(float(m["loss"]))  # waits for the step
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            if profiling and device.type == "cuda":
                torch.cuda.synchronize(device)  # the update's kernels too
            if profiling:
                wall = 1e3 * (time.perf_counter() - t0)
        if profiling:
            out["profile"] = _device_split(prof, wall)
        out["grad_norm"].append(float(m["grad_norm"]))
        k1, shard = _counts()
        out["launches"].append(k1)
        out["shard_launches"].append(shard)
    out["by_rank"] = _gather_objects({k: out.get(k) for k in ("launches", "shard_launches",
                                                               "step_ms", "profile")})
    if dp is not None:
        out["held"] = dict(shard=0 if dp.shard is None else dp.shard.numel(),
                           whole=sum(shape.numel() for shape, _ in dp._layout),
                           freed=all(p.data.numel() == 0 for _, p in dp.sharded))
        dp.gather()
    out["params"] = {n: t.detach().cpu() for n, t in net.state_dict().items()}
    if parallel.topology()[0] == 0 and out_path is not None:
        torch.save(out, out_path)
    return out


def checkpoint_check(spec: Dict[str, Any], directory: str, backend: str,
                     out_path: Optional[str] = None) -> Dict[str, Any]:
    """On each rank: `spec["steps"]` training steps, then a full-state save
    through `CheckpointManager(directory, backend=backend)`. Returns, and
    rank 0 writes, the whole state (`train_state_dict`, on the CPU)."""
    state, batch, _ = _setup(spec)
    for _ in range(spec["steps"]):
        train_step(state, batch, "coord", spec["uncertainty"])
    CheckpointManager(directory, backend=backend).save(state)
    sd = train_state_dict(state, full=True)
    out = {k: ({n: t.detach().cpu() for n, t in v.items()} if isinstance(v, dict)
               else v.detach().cpu()) for k, v in sd.items()}
    if parallel.topology()[0] == 0 and out_path is not None:
        torch.save(out, out_path)
    return out


def _setup(spec: Dict[str, Any]):
    """(state, this rank's batch, its rows of the global batch) of a spec
    (`step_check`)."""
    rank, world = parallel.topology()
    device = select_device_from_env(spec["device"])  # the CLIs' device, TF32 off
    net = models.build_network("coord", spec["uncertainty"], tiny=spec["tiny"],
                               mean=spec["mean"])
    net.load_state_dict(spec["state_dict"])
    if spec.get("float64"):  # the whole step in float64, the solver too
        net.double().dtype = torch.float64
    net.to(device)
    if device.type == "cuda":
        net.to(memory_format=torch.channels_last)
    mesh = parallel.make_mesh(**(spec.get("mesh") or {}) if world > 1 else {})
    dp = parallel.DataParallel(net, zero=spec["zero"], mesh=mesh) if world > 1 else None
    params = (dp.update_params() if dp is not None
              else [p for p in net.parameters() if p.requires_grad])
    state = TrainState(net, make_optimizer(params, spec["lr"], steps_per_epoch=10,
                                           grad_clip=spec.get("grad_clip")), parallel=dp)
    B = spec["batch"]["images"].shape[0] // mesh.batch_shards
    rows = slice(mesh.batch_index * B, (mesh.batch_index + 1) * B)
    batch = _batch_rows(spec, mesh, device)
    if spec.get("float64"):
        batch = TrainBatch(*(t.double() for t in batch))
    return state, batch, rows


def solver_check(spec: Dict[str, Any], out_path: Optional[str] = None) -> Dict[str, Any]:
    """On each rank: `ransac.solve_batch_hypsharded` of the spec's
    coordinates with the global pool's draws `idx`. Returns, and rank 0
    writes, the result's fields as CPU tensors."""
    device = select_device_from_env(spec["device"])
    res = ransac.solve_batch_hypsharded(spec["coords"].to(device), spec["focal"],
                                        spec["image_hw"], ransac.RansacConfig(**spec["ransac"]),
                                        idx=spec["idx"].to(device))
    out = {k: v.detach().cpu() for k, v in res._asdict().items()}
    if parallel.topology()[0] == 0 and out_path is not None:
        torch.save(out, out_path)
    return out


def forward_check(spec: Dict[str, Any], out_path: Optional[str] = None) -> torch.Tensor:
    """On each rank: the spec's net (optionally an MLR net: "num_mlr",
    "num_unfrozen_encoder") on the mesh `spec["mesh"]`, its forward under
    no_grad on this rank's part of `spec["images"]`; returns, and rank 0
    writes, the output of the global batch (on the CPU)."""
    device = select_device_from_env(spec["device"])
    net = models.build_network("coord", spec["uncertainty"], tiny=spec["tiny"],
                               mean=spec["mean"], num_mlr=spec.get("num_mlr", 0),
                               num_unfrozen_encoder=spec.get("num_unfrozen_encoder", 0))
    net.load_state_dict(spec["state_dict"])
    net.to(device).eval()
    mesh = parallel.make_mesh(**spec["mesh"])
    parallel.spatialize(net, mesh.shard)
    images = spec["images"]
    part = parallel.shard_batch(mesh, TrainBatch(images, None, None, None),
                                shard_spatial=mesh.spatial > 1)
    with torch.no_grad():
        out = parallel.unshard_batch(mesh, net(part.images.to(device))).cpu()
    if parallel.topology()[0] == 0 and out_path is not None:
        torch.save(out, out_path)
    return out


HALO_CASES = [(1, 1), (1, 2), (3, 1), (3, 2)]  # (kernel, stride)


def halo_check(device: str = "cpu", out_path: Optional[str] = None) -> Dict[str, Any]:
    """On each rank of a spatial-only mesh: a seeded `Conv` of each
    (kernel, stride) of HALO_CASES on the whole input and on this rank's
    rows (the halo exchange), with the backward of a seeded weighting of
    the output. Returns, and rank 0 writes, per case the max |diff| of the
    output, the input gradient and the summed weight gradient against the
    unsharded conv, each beside the largest |value| of the unsharded one."""
    device = select_device_from_env(device)
    mesh = parallel.make_mesh(data=1, spatial=parallel.topology()[1])
    out = {}
    for k, stride in HALO_CASES:
        gen = torch.Generator().manual_seed(10 * k + stride)
        conv = Conv(5, 7, k, stride)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
        conv.to(device)
        x = torch.randn(2, 8 * mesh.spatial, 6, 5, generator=gen).to(device)
        xr = x.clone().requires_grad_()
        y = conv(xr)
        wy = torch.randn(y.shape, generator=gen).to(device)
        (y * wy).sum().backward()
        ref = (y.detach(), xr.grad, conv.weight.grad.clone())
        conv.weight.grad = None
        parallel.spatialize(conv, mesh.shard)
        part = parallel.shard_batch(mesh, TrainBatch(x, None, wy, None), shard_spatial=True)
        xl = part.images.clone().requires_grad_()
        yl = conv(xl)
        (yl * part.labels).sum().backward()
        dw = conv.weight.grad.clone()
        dist.all_reduce(dw)
        got = (parallel.unshard_batch(mesh, yl.detach()),
               parallel.unshard_batch(mesh, xl.grad), dw)
        out[(k, stride)] = [(float((a - b).abs().max()), float(b.abs().max()))
                            for a, b in zip(got, ref)]
    if parallel.topology()[0] == 0 and out_path is not None:
        torch.save(out, out_path)
    return out


def checks(jobs: Sequence) -> None:
    """Run `fn(*args)` for each (fn, args) of `jobs` in turn (on each rank)."""
    for fn, args in jobs:
        fn(*args)


def cli_rank(counts_path: str, module: str, argv: Sequence[str]) -> None:
    """`module.main(argv)` with K1's forward and backward launch counts set to
    0 just before and written to `counts_path` just after."""
    cli = importlib.import_module(module)
    group_norm_relu.launches = group_norm_relu_backward.launches = 0
    t0 = time.perf_counter()
    cli.main(list(argv))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    counts = dict(rank=parallel.topology()[0], groupnorm=group_norm_relu.launches,
                  groupnorm_backward=group_norm_relu_backward.launches,
                  wall_s=time.perf_counter() - t0)
    with open(counts_path, "w") as f:
        json.dump(counts, f)


if __name__ == "__main__":
    cli_rank(sys.argv[1], sys.argv[2], sys.argv[3:])
