"""The DSAC pose loss replayed from CUDA graphs (`ransac/graph.py`).

On the CPU: the graphs' inputs (the minimal sets drawn outside the graph as
`sample_hypotheses` draws them), the cache key, the bottom row of the SE(3)
matrices that a capture needs made on the device, and the training step's
eager path on CPU tensors.

On a card (`cuda` marker; these skip without one): the graphed loss against
the eager `expected_pose_loss` at the DSAC* cell's solver settings, over
replays with fresh inputs; a second shape's capture; the spans' counts; the
training step's capture and replays, in one process and on two data-parallel
ranks that share the card. A shape's first call is eager and its
second captures. This file imports no JAX, so the card's
tests run on a machine that has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_solver_graph.py
"""
import math

import numpy as np
import pytest
import torch

from crossloc_tpu_torch import models, ransac
from crossloc_tpu_torch.geometry import backproject, invert_se3, pixel_grid, pose_vec_to_w2c
from crossloc_tpu_torch.geometry import se3
from crossloc_tpu_torch.ransac.graph import MAX_GRAPHS, GraphedPoseLoss, graph_inputs, graph_key
from crossloc_tpu_torch.ransac.solver import sample_hypotheses, solver_inputs, solver_precision
from crossloc_tpu_torch.tools.parallel_check import run_ranks, step_check
from crossloc_tpu_torch.train import TrainBatch, TrainState, make_dsac_train_step, make_optimizer
from crossloc_tpu_torch.train import dsac_step as dsac_mod
from crossloc_tpu_torch.utils import profiling

# the DSAC* cell's solver and pose loss (perfbench's dsacstar-e2e-coord-480x720)
CFG = ransac.RansacConfig(hypotheses=64, sample_rounds=8, train_refine_steps=2,
                          inlier_threshold=10.0, inlier_alpha=100.0, max_pixel_error=100.0)
LOSS_CFG = ransac.PoseLossConfig(w_rot=1.0, w_trans=100.0, soft_clamp=100.0)
FOCAL = 480.0


def _scene(B, seed, Hs=60, Ws=90):
    """(coords [B, Hs, Ws, 3] f32, gt cam-to-world [B, 4, 4] f32, image (h, w),
    pp_shift [2]): a random depth field seen from a seeded pose, the
    right half of each image turned 5 degrees about the vertical through its
    mean (a second rigid mode, so the softmax is not saturated), plus 5 cm
    of noise."""
    g = torch.Generator().manual_seed(seed)
    img_h, img_w = Hs * 8, Ws * 8
    pix = pixel_grid(Hs, Ws, 8, dtype=torch.float64).reshape(-1, 2)
    depth = 20.0 + 10.0 * torch.rand(B, Hs * Ws, generator=g, dtype=torch.float64)
    cam = backproject(pix, depth, FOCAL, img_w, img_h)  # [B, N, 3]
    c2w = pose_vec_to_w2c(torch.cat([0.1 * torch.randn(B, 3, generator=g, dtype=torch.float64),
                                     5.0 * torch.randn(B, 3, generator=g, dtype=torch.float64)],
                                    dim=-1))
    world = (cam @ c2w[:, :3, :3].transpose(-1, -2) + c2w[:, None, :3, 3]).reshape(B, Hs, Ws, 3)
    a = math.radians(5.0)
    turn = torch.tensor([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float64)
    mean = world.flatten(1, 2).mean(1)[:, None, None, :]
    right = (torch.arange(Ws) >= Ws // 2)[None, None, :, None]
    world = torch.where(right, (world - mean) @ turn.T + mean, world)
    world = world + 0.05 * torch.randn(world.shape, generator=g, dtype=torch.float64)
    return world.float(), c2w.float(), (img_h, img_w), torch.tensor([1.5, -2.25])


# -- the CPU ---------------------------------------------------------------------------


def test_minimal_sets_drawn_outside_are_sample_hypotheses_draws():
    """Without `idx`, `graph_inputs` draws exactly `sample_hypotheses`' own
    minimal sets and leaves the generator where that draw leaves it."""
    coords, gt, hw, _ = _scene(2, 0, Hs=6, Ws=9)
    flat, grid, cams = solver_inputs(coords, FOCAL, hw, CFG)
    ours, theirs, again = (torch.Generator().manual_seed(11) for _ in range(3))
    idx = graph_inputs(coords, gt, FOCAL, CFG, generator=ours)[3]
    assert idx.dtype == torch.long and idx.shape == (2, CFG.hypotheses * CFG.sample_rounds, 4)
    # the call `sample_hypotheses` made before the draw had a name of its own
    assert torch.equal(idx, torch.randint(0, 54, (2, CFG.hypotheses * CFG.sample_rounds, 4),
                                          generator=again))
    drawn = sample_hypotheses(flat, grid, cams, CFG, generator=theirs)
    given = sample_hypotheses(flat, grid, cams, CFG, idx=idx)
    assert torch.equal(drawn[1], given[1])
    assert torch.equal(torch.nan_to_num(drawn[0]), torch.nan_to_num(given[0]))
    assert torch.equal(ours.get_state(), theirs.get_state())


def test_given_minimal_sets_pass_through():
    coords, gt, hw, pp = _scene(2, 1, Hs=6, Ws=9)
    idx = torch.randint(0, 54, (2, CFG.hypotheses * CFG.sample_rounds, 4), dtype=torch.int32)
    inputs = graph_inputs(coords, gt, torch.tensor(FOCAL, dtype=torch.float64), CFG, pp, idx)
    assert len(inputs) == 5 and inputs[0] is coords and inputs[1] is gt
    assert torch.equal(inputs[3], idx.long())
    assert inputs[2].dtype == torch.float32 and float(inputs[2]) == FOCAL
    assert inputs[4].dtype == torch.float32 and torch.equal(inputs[4], pp)


def _old_bottom_row(top):
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bottom_row_made_on_the_device_is_the_old_one(dtype, monkeypatch):
    """`_bottom_row` built by device ops: the same values and shape, and
    `pose_vec_to_w2c` and `invert_se3` give the same values and gradients."""
    pose6 = torch.randn(3, 5, 6, generator=torch.Generator().manual_seed(2), dtype=dtype)
    top = torch.randn(3, 5, 3, 4, dtype=dtype)
    assert torch.equal(se3._bottom_row(top), _old_bottom_row(top))
    assert se3._bottom_row(top).shape == (3, 5, 1, 4)

    def run():
        p = pose6.clone().requires_grad_()
        T = invert_se3(pose_vec_to_w2c(p))
        (T * torch.linspace(-1.0, 1.0, 16, dtype=dtype).reshape(4, 4)).sum().backward()
        return T.detach(), p.grad

    new = run()
    monkeypatch.setattr(se3, "_bottom_row", _old_bottom_row)
    old = run()
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])


def test_graph_key_follows_what_a_capture_bakes_in():
    coords, gt, hw, pp = _scene(2, 3, Hs=6, Ws=9)
    idx = torch.zeros(2, CFG.hypotheses * CFG.sample_rounds, 4, dtype=torch.long)

    def key(c=coords, image_hw=hw, cfg=CFG, loss_cfg=LOSS_CFG, shift=None, i=idx):
        return graph_key(graph_inputs(c, gt[: c.shape[0]], FOCAL, cfg, shift, i[: c.shape[0]]),
                         image_hw, cfg, loss_cfg)

    base = key()
    assert key(c=coords.clone()) == base  # fresh tensors of the same shapes
    assert key(c=coords.clone().requires_grad_()) == base  # the backward is always captured
    assert key(c=coords[:1]) != base  # B
    assert key(c=coords[:, :5]) != base  # the grid
    assert key(c=coords.double()) != base
    assert key(image_hw=(hw[0] + 8, hw[1])) != base
    assert key(cfg=CFG._replace(inlier_threshold=5.0)) != base
    assert key(cfg=CFG._replace(train_refine_steps=4)) != base
    assert key(loss_cfg=LOSS_CFG._replace(w_trans=1.0)) != base
    assert key(shift=pp) != base
    assert key(shift=pp[None].expand(2, 2)) != key(shift=pp)


def _tiny_step(device):
    """(state, step, batch) of a tiny coord net's DSAC step at 48x64, B=2,
    the DSAC* solver settings but 8 hypotheses and a permissive threshold
    (an untrained net's coordinates then have valid hypotheses)."""
    net = models.init_weights(models.build_network("coord", "MLE", tiny=True,
                                                   mean=[1.0, -2.0, 30.0]),
                              torch.Generator().manual_seed(0)).to(device)
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4, steps_per_epoch=4))
    cfg = CFG._replace(hypotheses=8, inlier_threshold=5000.0, max_pixel_error=10000.0)
    step = make_dsac_train_step(net, cfg, LOSS_CFG)
    g = torch.Generator().manual_seed(1)
    poses = torch.eye(4).repeat(2, 1, 1)
    poses[:, :3, 3] = torch.tensor([1.0, -2.0, 0.0]) + torch.randn(2, 3, generator=g)
    batch = TrainBatch(torch.randn(2, 48, 64, 3, generator=g), poses, torch.zeros(2, 6, 8, 3),
                       torch.tensor(50.0), torch.tensor([1.5, -2.25]))
    return state, step, TrainBatch(*(t.to(device) for t in batch))


def test_cpu_step_runs_the_eager_loss(monkeypatch):
    """CPU tensors: the step calls `expected_pose_loss` as before and never
    the graphed loss."""
    calls = []
    eager = dsac_mod.expected_pose_loss

    def counted(*a, **k):
        calls.append(a[0].device.type)
        return eager(*a, **k)

    def refused(self, *a, **k):
        raise AssertionError("the graphed pose loss ran on CPU tensors")

    monkeypatch.setattr(dsac_mod, "expected_pose_loss", counted)
    monkeypatch.setattr(GraphedPoseLoss, "__call__", refused)
    state, step, batch = _tiny_step("cpu")
    for _ in range(2):
        m = step(state, batch, generator=torch.Generator().manual_seed(5))
    assert calls == ["cpu", "cpu"] and math.isfinite(float(m["loss"]))
    assert step.graphed_pose_loss.captures == 0 and step.graphed_pose_loss.replays == 0


# -- the card ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_inputs(card, B, seed):
    coords, gt, hw, pp = _scene(B, seed)
    idx = torch.randint(0, coords.shape[1] * coords.shape[2],
                        (B, CFG.hypotheses * CFG.sample_rounds, 4),
                        generator=torch.Generator().manual_seed(100 + seed))
    return coords.to(card), gt.to(card), torch.tensor(FOCAL, device=card), hw, pp.to(card), \
        idx.to(card)


def _run(fn, coords, gt, focal, hw, pp, idx):
    """(loss, coords' gradient, aux) of one call and its backward, as the
    training step runs them."""
    c = coords.clone().requires_grad_()
    loss, aux = fn(c, gt, focal, hw, CFG, LOSS_CFG, pp_shift=pp, idx=idx)
    with solver_precision(c.device):
        loss.backward()
    return loss.detach(), c.grad, aux


def _gap(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) /
                 max(float(torch.linalg.vector_norm(b.double())), 1e-30))


@pytest.mark.cuda
def test_graphed_loss_matches_eager_over_replays(card):
    """Four calls with fresh inputs (eager, a capture, then replays): the
    loss, the coordinates' gradient (within 1e-6 of its norm) and every aux
    value as the eager loss gives them; what an earlier call returned is
    unchanged by the later replays."""
    graphed = GraphedPoseLoss()
    kept = []
    for seed in range(4):
        args = _card_inputs(card, 2, seed)
        loss, grad, aux = _run(graphed, *args)
        e_loss, e_grad, e_aux = _run(ransac.expected_pose_loss, *args)
        assert float(e_loss) > 0 and bool(e_aux["hyp_valid"].any())
        assert _gap(loss, e_loss) <= 1e-6 and _gap(grad, e_grad) <= 1e-6
        assert float(torch.linalg.vector_norm(grad)) > 0
        for k in ("hyp_valid", "inliers"):
            assert torch.equal(aux[k], e_aux[k]), k
        for k in ("per_image", "poses"):
            assert _gap(aux[k], e_aux[k].detach()) <= 1e-6, k
        kept.append((loss, grad, aux, (loss.clone(), grad.clone(),
                                       {k: v.clone() for k, v in aux.items()})))
    for loss, grad, aux, (loss0, grad0, aux0) in kept:
        assert torch.equal(loss, loss0) and torch.equal(grad, grad0)
        assert all(torch.equal(aux[k], aux0[k]) for k in aux)
    assert (graphed.captures, graphed.replays) == (1, 3)


@pytest.mark.cuda
def test_second_shape_captures_again(card):
    """Each key: eager, then a capture; a key beyond `MAX_GRAPHS` drops the
    least recently used, which starts again from an eager call."""
    graphed = GraphedPoseLoss()
    sizes = range(1, MAX_GRAPHS + 1)
    for B in list(sizes) * 2:
        loss, grad, _ = _run(graphed, *_card_inputs(card, B, B))
        assert math.isfinite(float(loss)) and bool(torch.isfinite(grad).all())
    assert (graphed.captures, graphed.replays) == (MAX_GRAPHS, MAX_GRAPHS)
    for B in (MAX_GRAPHS + 1, 1, 1):  # the new key drops B=1's graphs
        _run(graphed, *_card_inputs(card, B, B))
    assert (graphed.captures, graphed.replays) == (MAX_GRAPHS + 1, MAX_GRAPHS + 1)


@pytest.mark.cuda
def test_late_backward_is_refused(card):
    graphed = GraphedPoseLoss()
    args = _card_inputs(card, 2, 0)
    _run(graphed, *args)  # eager
    c = args[0].clone().requires_grad_()
    first, _ = graphed(c, *args[1:4], CFG, LOSS_CFG, pp_shift=args[4], idx=args[5])
    graphed(c, *args[1:4], CFG, LOSS_CFG, pp_shift=args[4], idx=args[5])
    with pytest.raises(RuntimeError, match="later forward"):
        first.backward()


@pytest.mark.cuda
def test_spans_count_captures_and_replays(card):
    """Under a profiler, three calls: the first eager (`expected_pose_loss`'s
    spans alone), then one `solver.capture` (captures=1) with the body's
    spans inside it, and one `solver.graph` (replays=1) a later call, with
    the solver's counts. Engagement, replays / (replays + eager calls
    outside a capture), reads 1.0 over the calls after the first."""
    from torch.profiler import ProfilerActivity, profile

    graphed = GraphedPoseLoss()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for seed in range(3):
            _run(graphed, *_card_inputs(card, 2, seed))
    recs = profiling.records()
    counts = dict(sets=2 * 64 * 8, hypotheses=2 * 64, cells=2 * 60 * 90)
    capture = [r for r in recs if r.name == "solver.capture"]
    replay = [r for r in recs if r.name == "solver.graph"]
    assert [r.counts for r in capture] == [dict(captures=1, **counts)]
    assert [r.counts for r in replay] == [dict(replays=1, **counts)] * 2
    eager = [r for r in recs if r.name == "solver.loss"]
    assert [r.parent for r in eager] == [None, "solver.capture"]
    later = [r for r in recs if r.start_ns >= capture[0].start_ns]
    replays = sum(r.counts.get("replays", 0) for r in later if r.name == "solver.graph")
    outside = sum(r.name == "solver.loss" and r.parent != "solver.capture" for r in later)
    assert replays / (replays + outside) == 1.0


@pytest.mark.cuda
def test_training_step_captures_once_and_replays(card, monkeypatch):
    """The DSAC step on CUDA tensors: eager on its first step, a capture on
    its second, replays from then on, and the same losses and weights as
    with the eager loss."""

    def three_steps():
        state, step, batch = _tiny_step(card)
        losses = [float(step(state, batch, generator=torch.Generator(device=card).manual_seed(s))
                        ["loss"]) for s in range(3)]
        return step, losses, torch.cat([p.detach().flatten() for p in state.model.parameters()])

    step, losses, weights = three_steps()
    assert (step.graphed_pose_loss.captures, step.graphed_pose_loss.replays) == (1, 2)
    monkeypatch.setattr(GraphedPoseLoss, "__call__",
                        lambda self, *a, **k: ransac.expected_pose_loss(*a, **k))
    _, eager_losses, eager_weights = three_steps()
    np.testing.assert_allclose(losses, eager_losses, rtol=1e-6)
    assert _gap(weights, eager_weights) <= 1e-6


def _group_norm_relu_f64(x, scale, bias, groups, eps, relu=True):
    """GroupNorm(+ReLU) on NHWC `x` in its own dtype: K1 and the plain twin
    take their statistics in float32, which a float64 check cannot use."""
    y = torch.nn.functional.group_norm(x.permute(0, 3, 1, 2), groups, scale.to(x.dtype),
                                       bias.to(x.dtype), eps).permute(0, 2, 3, 1)
    return torch.relu(y) if relu else y


def _float64_norm_step_check(spec, out_path=None):
    """`step_check` with the net's norms by `_group_norm_relu_f64`."""
    from crossloc_tpu_torch.models import layers

    layers.group_norm_relu = _group_norm_relu_f64
    return step_check(spec, out_path)


@pytest.mark.cuda
def test_data_parallel_step_replays_graphs(card, tmp_path, monkeypatch):
    """Two ranks sharing the card (gloo) take three DSAC steps of the tiny
    net (`tools/parallel_check.py::step_check`), each on its half of a
    global batch of 4 and its rows of the global draws: each rank captures
    on its second step inside `dp.materialized()` and replays from then on.
    Losses, gradients and weights are those of one process on the whole
    batch, on the card (graphed) and on the CPU (eager), in float64 (the
    net's norms too, `_group_norm_relu_f64`) at
    `tests/test_torch_parallel_e2e.py`'s yardsticks."""
    from crossloc_tpu_torch.models import layers

    steps, B, h, w = 3, 4, 48, 64
    mean = [1.0, -2.0, 30.0]
    net = models.init_weights(models.build_network("coord", "MLE", tiny=True, mean=mean),
                              torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    poses = torch.eye(4).repeat(B, 1, 1)
    poses[:, :3, 3] = torch.tensor([1.0, -2.0, 0.0]) + torch.randn(B, 3, generator=g)
    cfg = dict(hypotheses=8, sample_rounds=4, train_refine_steps=1, refine_steps=2, gn_iters=1,
               inlier_threshold=5000.0, max_pixel_error=10000.0)
    idx = torch.randint(0, (h // 8) * (w // 8), (B, 8 * 4, 4), generator=g)
    spec = dict(state_dict={k: v.clone() for k, v in net.state_dict().items()},
                batch=dict(images=torch.randn(B, h, w, 3, generator=g), poses=poses,
                           labels=torch.zeros(B, h // 8, w // 8, 3), focal=torch.tensor(50.0),
                           pp_shift=torch.tensor([1.5, -2.25])),
                kind="e2e", uncertainty="MLE", mean=mean, tiny=True, zero=False, steps=steps,
                lr=1e-4, grad_clip=None, device="cuda", float64=True, ransac=cfg, idx=idx)
    out = str(tmp_path / "rank0.pt")
    run_ranks(_float64_norm_step_check, 2, (spec, out), device="cuda", timeout=300)
    dp = torch.load(out, weights_only=False)
    monkeypatch.setattr(layers, "group_norm_relu", _group_norm_relu_f64)
    single = step_check(spec)
    cpu = step_check(dict(spec, device="cpu"))
    assert [r["graphs"] for r in dp["by_rank"]] == [[1, steps - 1]] * 2
    assert single["graphs"] == [1, steps - 1] and cpu["graphs"] == [0, 0]
    assert min(dp["loss"]) > 0.0
    for ref in (single, cpu):
        gscale = max(float(v.abs().max()) for v in ref["grads"].values())
        for name, grad in dp["grads"].items():
            np.testing.assert_allclose(grad.numpy(), ref["grads"][name].numpy(), rtol=1e-5,
                                       atol=1e-5 * gscale, err_msg=name)
        np.testing.assert_allclose(dp["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(dp["grad_norm"][0], ref["grad_norm"][0], rtol=1e-5)
        for name, p in ref["params"].items():
            np.testing.assert_allclose(dp["params"][name].numpy(), p.numpy(), rtol=1e-5,
                                       atol=2e-4 * steps, err_msg=name)
