"""The DSAC training objective replayed from CUDA graphs.

On a card, `expected_pose_loss` at the training shapes is some ten thousand
small kernels forward and thirteen thousand backward, and the host takes
longer to launch each one than the card takes to run it. Which kernels run
depends on the shapes and the configs alone: the minimal sets `idx` are an
input, and no value goes back to the host. So `GraphedPoseLoss` captures the
forward and its backward once per shape as two CUDA graphs, with
`expected_pose_loss` unchanged as their body, and replays them: the same
kernels in the same precision, launched by the card. The first call of a
shape runs eagerly: it loads the kernels and makes the library handles and
workspaces that a capture must find ready. The second captures, and it and
every later call replay.

The graphs read static input buffers, and each call copies its tensors into
them: the coordinates (the one input that takes a gradient), the
ground-truth poses, the focal length, the minimal sets and the
principal-point shift. What a call returns is a copy, so a later replay
changes none of it. The one rule is the training step's order: a forward's
backward runs before the next forward of the same key, and a backward that
comes too late raises.

Spans (`utils/profiling.py::span`), each with `expected_pose_loss`'s counts
`sets`, `hypotheses` and `cells`: `solver.capture` (`captures=1`: the two
captures, with `expected_pose_loss`'s own spans inside) and `solver.graph`
(`replays=1`: the forward's replay). The backward replays in autograd's
node `_PoseLossReplayBackward`. A shape's first, eager call has
`expected_pose_loss`'s spans alone.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from .config import PoseLossConfig, RansacConfig
from .loss import expected_pose_loss, span_counts
from .solver import draw_minimal_sets, solver_precision

MAX_GRAPHS = 4  # keys kept; a training run has one (`drop_last` fixes B), at most two


def graph_inputs(scene_coords, gt_poses, focal_length, cfg: RansacConfig, pp_shift=None,
                 idx=None, generator: Optional[torch.Generator] = None) -> list:
    """[coords, gt_poses, focal, idx] and pp_shift where given: one call's
    inputs to the graphs, the focal length and the shift as tensors of the
    coordinates' dtype and device (as `solver_inputs` makes them). Without
    `idx` the minimal sets are drawn from `generator` as `sample_hypotheses`
    draws them."""
    device, dtype = scene_coords.device, scene_coords.dtype
    B, Hs, Ws = scene_coords.shape[:3]
    if idx is None:
        idx = draw_minimal_sets(B, Hs * Ws, cfg, generator, device)
    inputs = [scene_coords, gt_poses, torch.as_tensor(focal_length, dtype=dtype, device=device),
              idx.to(device=device, dtype=torch.long)]
    if pp_shift is not None:
        inputs.append(torch.as_tensor(pp_shift, dtype=dtype, device=device))
    return inputs


def graph_key(inputs, image_hw, cfg: RansacConfig, loss_cfg: PoseLossConfig) -> tuple:
    """What a capture bakes in: each input's shape and dtype, the device,
    the image size and both configs."""
    return (tuple((tuple(t.shape), t.dtype) for t in inputs), inputs[0].device,
            tuple(image_hw), cfg, loss_cfg)


class _Graphs:
    """One key's forward and backward graphs and their static buffers."""

    def __init__(self, inputs, image_hw, cfg: RansacConfig, loss_cfg: PoseLossConfig):
        def body(coords, gt_poses, focal, idx, *pp):
            loss, aux = expected_pose_loss(coords, gt_poses, focal, image_hw, cfg, loss_cfg,
                                           pp_shift=pp[0] if pp else None, idx=idx)
            return loss, aux["per_image"].detach(), aux["hyp_valid"], aux["poses"], aux["inliers"]

        self.inputs = [t.detach().clone() for t in inputs]
        coords = self.inputs[0].requires_grad_()
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd):
            outputs = body(*self.inputs)
        self.grad_out = torch.empty_like(outputs[0])
        with torch.cuda.graph(self.bwd, pool=self.fwd.pool()):
            (self.grad_in,) = torch.autograd.grad(outputs[0], coords, self.grad_out)
        self.outputs = tuple(o.detach() for o in outputs)
        self.forwards = 0  # forward replays, to tell a backward whether its forward is the last


class _PoseLossReplay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphs: _Graphs, *inputs):
        for static, t in zip(graphs.inputs, inputs):
            static.copy_(t)
        graphs.fwd.replay()
        graphs.forwards += 1
        ctx.graphs, ctx.forward_no, ctx.n_inputs = graphs, graphs.forwards, len(inputs)
        out = tuple(o.clone() for o in graphs.outputs)
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad, *_):
        graphs = ctx.graphs
        if graphs.forwards != ctx.forward_no:
            raise RuntimeError("the pose loss's graphs replayed a later forward before this "
                               "forward's backward; its saved values are gone")
        graphs.grad_out.copy_(grad)
        graphs.bwd.replay()
        return (None, graphs.grad_in.clone()) + (None,) * (ctx.n_inputs - 1)


class GraphedPoseLoss:
    """`expected_pose_loss` on CUDA tensors: eager at the first call of each
    key (`graph_key`), replayed from the graphs captured at the second and
    every later call. The `MAX_GRAPHS` most recently used keys are kept.
    `captures` and `replays` count the calls that captured and the calls
    that replayed (those that captured among them)."""

    def __init__(self):
        self._graphs: "collections.OrderedDict[tuple, Optional[_Graphs]]" = (
            collections.OrderedDict())
        self.captures = 0
        self.replays = 0

    def __call__(self, scene_coords, gt_poses, focal_length, image_hw,
                 cfg: RansacConfig = RansacConfig(), loss_cfg: PoseLossConfig = PoseLossConfig(),
                 pp_shift=None, idx=None, generator: Optional[torch.Generator] = None):
        """`expected_pose_loss`'s arguments and results; a replay's
        aux["per_image"] takes no gradient."""
        inputs = graph_inputs(scene_coords, gt_poses, focal_length, cfg, pp_shift, idx, generator)
        key = graph_key(inputs, image_hw, cfg, loss_cfg)
        counts = span_counts(scene_coords.shape, cfg)
        first = key not in self._graphs
        graphs = self._graphs.pop(key, None)
        self._graphs[key] = graphs
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        if first:
            return expected_pose_loss(scene_coords, gt_poses, focal_length, image_hw, cfg,
                                      loss_cfg, pp_shift, idx=inputs[3])
        with solver_precision(scene_coords.device), torch.cuda.device(scene_coords.device):
            if graphs is None:
                with span("solver.capture", captures=1, **counts):
                    graphs = self._graphs[key] = _Graphs(inputs, tuple(image_hw), cfg, loss_cfg)
                self.captures += 1
            with span("solver.graph", replays=1, **counts):
                loss, per_image, hyp_valid, poses, inliers = _PoseLossReplay.apply(graphs, *inputs)
        self.replays += 1
        return loss, {"per_image": per_image, "hyp_valid": hyp_valid, "poses": poses,
                      "inliers": inliers}
