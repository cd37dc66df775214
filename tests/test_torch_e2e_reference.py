"""The port's DSAC* end-to-end step against the benchmark's plain reference,
the CLI's solver and pose-loss flags, and the solver's spans.

One `make_dsac_train_step` update of a seeded coord net (the published
widths without the added residual blocks, no uncertainty head) at 64x96,
B=2, 8 hypotheses x 4 rounds, in float64 on the CPU, on the on-target
two-mode input of the benchmark's e2e loop (`perfbench/loops/train_e2e.py`):
its loss and every leaf's gradient against the plain expected pose loss of
`perfbench/reference/e2e.py` through the plain net. The camera and the
inlier threshold are the benchmark cell's scaled to the 8x12 grid (focal
64 for 480, tau and the error clamp by the same factor), so the two modes
are apart in pixels as at 480x720.
"""
import math
import types

import numpy as np
import pytest
import torch

from crossloc_tpu_torch import models, ransac
from crossloc_tpu_torch.cli import train_single_task as cli
from crossloc_tpu_torch.models.layers import Conv, GroupNorm
from crossloc_tpu_torch.train import (TrainBatch, TrainState, make_dsac_train_step,
                                      make_optimizer, train_ransac_config)
from crossloc_tpu_torch.utils import profiling
from perfbench.core import scene, spec
from perfbench.reference import e2e as ref_e2e
from perfbench.reference import net as ref_net
from perfbench.reference import ransac as ref_ransac

IMG_H, IMG_W, FOCAL, B = 64, 96, 64.0, 2
SCALE = FOCAL / 480.0  # the cell's pixels to these
SOLVER = dict(hypotheses=8, sample_rounds=4, inlier_threshold=10.0 * SCALE,
              inlier_alpha=100.0, max_pixel_error=100.0 * SCALE)
W_ROT, W_TRANS, CLAMP, STEPS = 1.0, 100.0, 100.0, 2
PP = (3.0, -2.0)
MEAN = [scene.PLANE_CX, scene.PLANE_CY, scene.PLANE_Z]
# float64 on both sides. The losses agree to rounding (5e-15), the
# gradients to 1.0e-6 of the worst leaf (the reference's P3P derivative is
# its own implicit function's, from a Newton step at the root); the faults
# below read 9.4e-4 (one refinement step's loss) and more
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _net():
    """The seeded float64 net: conv kernels over sqrt(fan_in), biases and
    norm affines away from 0 and 1, so each term shows in the gradient."""
    net = models.TransPoseNet(num_task_channel=3, num_pos_channel=0, enc_add_res_block=0,
                              dec_add_res_block=0, mean_init=MEAN, dtype=torch.float64)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Conv):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * m.weight[0].numel()
                               ** -0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
            elif isinstance(m, GroupNorm):
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    return net.double()


def _inputs():
    """(images, cam-to-world poses, labels, two-mode target, idx) of the batch."""
    poses, labels = [], []
    for i in range(B):
        R, t = scene.camera(7, "train_sim", i)
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = R, t
        poses.append(pose)
        lab = scene.labels(7, "train_sim", i, R, t, FOCAL, IMG_H, IMG_W, 8, 0.1)
        labels.append(lab.transpose(1, 2, 0))
    labels = torch.from_numpy(np.stack(labels)).double()
    e2e = spec.loop("train_e2e")
    target = e2e.target_of(labels, 11, 0, 0, {"turn_deg": 5.0, "noise_m": 0.05})
    gen = torch.Generator().manual_seed(3)
    images = torch.randn(B, IMG_H, IMG_W, 3, generator=gen, dtype=torch.float64)
    idx = torch.randint(0, labels.shape[1] * labels.shape[2],
                        (B, SOLVER["hypotheses"] * SOLVER["sample_rounds"], 4), generator=gen)
    return images, torch.from_numpy(np.stack(poses)), labels, target, idx


def _port(net, inputs, steps=STEPS, w_trans=W_TRANS):
    """The port's loss and per-leaf gradients of one step on target."""
    images, poses, labels, target, idx = inputs
    wrapped = spec.loop("train_e2e").OnTarget(net)
    wrapped.target = target
    state = TrainState(wrapped, make_optimizer(list(net.parameters()), 1e-6))
    rcfg = ransac.RansacConfig(train_refine_steps=steps, subsample=8, **SOLVER)
    step = make_dsac_train_step(wrapped, rcfg, ransac.PoseLossConfig(w_rot=W_ROT, w_trans=w_trans))
    batch = TrainBatch(images, poses, labels, torch.tensor(FOCAL, dtype=torch.float64),
                       torch.tensor(PP, dtype=torch.float64))
    m = step(state, batch, idx=idx)
    return float(m["loss"]), {n: p.grad.clone() for n, p in net.named_parameters()}


def _reference(P, inputs, steps=STEPS, w_trans=W_TRANS):
    """The plain reference's loss and per-leaf gradients on the same input."""
    images, poses, _, target, idx = inputs
    leaves = {n: t.clone().requires_grad_() for n, t in P.items() if n.endswith(("weight", "bias"))}
    params = dict(P, **leaves)
    arch = ref_net.Arch(enc_blocks=0, dec_blocks=0)
    pred = ref_net.forward(images, params, arch)
    cfg = ref_ransac.RansacConfig(subsample=8, **SOLVER)
    loss = ref_e2e.expected_pose_loss(ref_e2e.on_target(pred[..., :3], target), poses,
                                      torch.tensor(FOCAL, dtype=torch.float64),
                                      torch.tensor(PP, dtype=torch.float64), (IMG_H, IMG_W),
                                      idx, cfg, steps, W_ROT, w_trans, CLAMP)
    loss.backward()
    return float(loss), {n: t.grad for n, t in leaves.items()}


def _gap(got, ref):
    """(relative loss gap, worst leaf's gradient gap against the larger of
    its norm and the median leaf's)."""
    med = float(np.median([float(g.norm()) for g in ref[1].values()]))
    grad = max(float((got[1][n] - g).norm()) / max(float(g.norm()), med)
               for n, g in ref[1].items())
    return abs(got[0] - ref[0]) / abs(ref[0]), grad


@pytest.fixture(scope="module")
def run():
    net = _net()
    P = {n: t.detach().clone() for n, t in net.state_dict().items()}
    inputs = _inputs()
    return types.SimpleNamespace(port=_port(net, inputs), P=P, inputs=inputs,
                                 ref=_reference(P, inputs))


def test_port_step_equals_the_plain_reference(run):
    assert run.ref[0] > 0 and all(torch.isfinite(g).all() for g in run.ref[1].values())
    assert set(run.port[1]) == set(run.ref[1])
    loss_gap, grad_gap = _gap(run.port, run.ref)
    assert loss_gap < TOL and grad_gap < TOL, (loss_gap, grad_gap)


@pytest.mark.parametrize("fault", [dict(steps=1), dict(w_trans=1.0)],
                         ids=["one_refine_step", "w_trans_1"])
def test_a_fault_reads_outside_the_tolerance(run, fault):
    loss_gap, grad_gap = _gap(_reference(run.P, run.inputs, **fault), run.ref)
    assert loss_gap > 10 * TOL and grad_gap > 10 * TOL, (loss_gap, grad_gap)


def test_a_p3p_fault_shared_with_the_reference_s_copy_reads_outside_the_tolerance(
        run, monkeypatch):
    """The same arithmetic fault in the port's P3P and in the copy the
    reference takes its roots from (every translation 1e-4 off its root):
    the reference's Newton step at each root moves the faulty one back, the
    port keeps it, and the check sees it."""
    from crossloc_tpu_torch.ransac import solver as solver_mod

    def faulty(p3p):
        def p3p_off(X4, pix4, cam):
            R, t, err, valid = p3p(X4, pix4, cam)
            return R, t * (1.0 + 1e-4), err, valid
        return p3p_off

    monkeypatch.setattr(solver_mod, "p3p_from_4pts", faulty(solver_mod.p3p_from_4pts))
    monkeypatch.setattr(ref_ransac, "_p3p_from_4pts_impl", faulty(ref_ransac._p3p_from_4pts_impl))
    port = _port(_net(), run.inputs)
    ref = _reference(run.P, run.inputs)
    assert abs(ref[0] - run.ref[0]) < TOL * abs(run.ref[0])  # the reference is unmoved
    loss_gap, grad_gap = _gap(port, ref)
    assert loss_gap > 10 * TOL and grad_gap > 10 * TOL, (loss_gap, grad_gap)


def _opt(*flags):
    return cli.normalize_opt(cli.config_parser().parse_args(["urbanscape", "--task", "coord",
                                                             *flags]))


def test_cli_flags_reach_the_configs():
    rcfg, lcfg = cli.e2e_configs(_opt("--e2e_pose_loss", "--hypotheses", "64", "--threshold",
                                      "8", "--inlieralpha", "50", "--maxpixelerror", "90",
                                      "--weightrot", "2", "--weighttrans", "100"), 8)
    assert rcfg == train_ransac_config(8)._replace(
        hypotheses=64, inlier_threshold=8.0, inlier_alpha=50.0, max_pixel_error=90.0)
    assert lcfg == ransac.PoseLossConfig(w_rot=2.0, w_trans=100.0)


def test_cli_flags_reach_the_step(tmp_path, monkeypatch):
    """A one-epoch e2e run of the CLI builds its step with the flags'
    solver and pose loss."""
    from crossloc_tpu_torch import data

    data.write_fake_dataset(str(tmp_path / "datasets" / "urbanscape" / "train_sim"), n=2,
                            img_h=32, img_w=48, focal=40.0, seed=0, scene="plane")
    built, make = [], cli.make_dsac_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)
        built.append((step, args[2]))
        return step

    monkeypatch.setattr(cli, "make_dsac_train_step", recording)
    monkeypatch.chdir(tmp_path)
    cli.main(["urbanscape", "--task", "coord", "--tiny", "--batch_size", "2", "--epochs", "1",
              "--sim_data_chunk", "1.0", "--real_data_chunk", "0.0", "--datasets_dir",
              "./datasets", "--image_height", "32", "--device", "cpu", "--e2e_pose_loss",
              "--hypotheses", "8", "--threshold", "4", "--weighttrans", "100"])
    (step, lcfg), = built
    assert step.ransac_cfg == train_ransac_config(8)._replace(hypotheses=8,
                                                              inlier_threshold=4.0)
    assert lcfg == ransac.PoseLossConfig(w_trans=100.0)


def test_cli_defaults_are_the_step_s_own():
    net = models.build_network("coord", None, tiny=True)
    rcfg, lcfg = cli.e2e_configs(_opt("--e2e_pose_loss"), 8)
    assert rcfg == make_dsac_train_step(net).ransac_cfg == ransac.RansacConfig(
        hypotheses=16, sample_rounds=8, train_refine_steps=2, subsample=8)
    assert lcfg == ransac.PoseLossConfig() and lcfg.w_trans == 1.0
    assert cli.e2e_configs(_opt("--e2e_pose_loss", "--fullsize"), 1)[0].subsample == 1


@pytest.mark.parametrize("flag", ["--hypotheses 64", "--weighttrans 100", "--threshold 5"])
def test_cli_refuses_the_flags_without_the_pose_loss(flag):
    with pytest.raises(ValueError, match="require --e2e_pose_loss"):
        _opt(*flag.split())


def test_default_flags_compute_the_default_step_s_bits(run):
    """Without the DSAC* flags the CLI builds the step with the step's own
    defaults (`make_dsac_train_step(model, subsample=...)`): the same loss
    and weights, bit for bit, on the on-target input. The step's arithmetic
    itself (P3P in float64, `guard_invalid`) is held against the JAX package
    by `test_torch_dsac_loss.py`."""
    images, poses, labels, target, _ = run.inputs
    batch = TrainBatch(images.float(), poses.float(), labels.float(), torch.tensor(FOCAL),
                       torch.tensor(PP))
    idx = torch.randint(0, labels.shape[1] * labels.shape[2], (B, 16 * 8, 4),
                        generator=torch.Generator().manual_seed(2))
    out = []
    for build in (lambda n: make_dsac_train_step(n, *cli.e2e_configs(_opt("--e2e_pose_loss"), 8),
                                                 subsample=8),
                  lambda n: make_dsac_train_step(n, subsample=8)):
        net = models.init_weights(models.build_network("coord", None, tiny=True, mean=MEAN),
                                  torch.Generator().manual_seed(0))
        wrapped = spec.loop("train_e2e").OnTarget(net)
        wrapped.target = target.float()
        state = TrainState(wrapped, make_optimizer(list(net.parameters()), 1e-3))
        m = build(wrapped)(state, batch, idx=idx)
        out.append((m["loss"], [p.detach().clone() for p in net.parameters()]))
    assert float(out[0][0]) > 0
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def _solver_spans(run, record):
    net = _net()
    profiling.clear()
    if record:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _port(net, run.inputs)
    else:
        _port(net, run.inputs)
    return [r for r in profiling.records() if r.name.startswith(("solver.", "step.backward"))]


def test_an_e2e_step_records_the_solver_spans_under_a_profiler(run):
    recs = _solver_spans(run, record=True)
    names = [r.name for r in recs]
    assert names == ["solver.sample", "solver.score", "solver.refine", "solver.loss",
                     "solver.score", "step.backward"], names
    H, R = SOLVER["hypotheses"], SOLVER["sample_rounds"]
    want = {"sets": B * H * R, "hypotheses": B * H, "cells": B * (IMG_H // 8) * (IMG_W // 8)}
    for r in recs[:-1]:
        assert r.counts == (dict(want, steps=STEPS) if r.name == "solver.refine" else want)
        # counts come from shapes: plain ints, never a tensor read off the device
        assert all(type(v) is int for v in r.counts.values())
    assert recs[-1].counts == {} and all(r.end_ns >= r.start_ns for r in recs)
    assert [r.parent for r in recs] == [None] * len(recs)


def test_no_solver_span_without_a_profiler(run):
    assert _solver_spans(run, record=False) == []


def test_target_turns_the_right_half():
    """The e2e loop's target: the left half is the labels plus the noise,
    the right half turned 5 degrees about the vertical through the mean."""
    lab = torch.randn(1, 4, 6, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    e2e = spec.loop("train_e2e")
    still = e2e.target_of(lab, 3, 0, 0, {"turn_deg": 0.0, "noise_m": 0.0})
    assert torch.allclose(still, lab, rtol=0, atol=1e-12)
    t = e2e.target_of(lab, 3, 0, 0, {"turn_deg": 5.0, "noise_m": 0.0})
    assert torch.equal(t[:, :, :3], lab[:, :, :3])
    mean = lab.flatten(1, 2).mean(1)
    d0, d1 = (lab[0, :, 3:] - mean)[..., :2], (t[0, :, 3:] - mean)[..., :2]
    ang = torch.atan2(d1[..., 1], d1[..., 0]) - torch.atan2(d0[..., 1], d0[..., 0])
    ang = torch.remainder(ang + math.pi, 2 * math.pi) - math.pi
    assert torch.allclose(ang, torch.full_like(ang, math.radians(5.0)), atol=1e-12)
    assert torch.allclose(t[..., 3:, 2], lab[..., 3:, 2], rtol=0, atol=1e-12)
    noisy = e2e.target_of(lab, 3, 0, 0, {"turn_deg": 0.0, "noise_m": 0.05})
    assert 0.03 < float((noisy - lab).std()) < 0.07
    assert torch.equal(noisy, e2e.target_of(lab, 3, 0, 0, {"turn_deg": 0.0, "noise_m": 0.05}))
    assert not torch.equal(noisy, e2e.target_of(lab, 3, 0, 1, {"turn_deg": 0.0, "noise_m": 0.05}))


def _expected_loss(inputs, monkeypatch, t0=None):
    """The port's expected pose loss and coordinate gradient in float32 on
    the on-target input, with hypothesis 0 of image 0 made invalid and, with
    `t0`, left the translation `t0` by its first round."""
    from crossloc_tpu_torch.ransac import loss as loss_mod

    _, poses, _, target, idx = inputs
    sample = loss_mod.sample_hypotheses

    def invalid_first(*args, **kwargs):
        pose6, valid = (x.clone() for x in sample(*args, **kwargs))
        valid[0, 0] = False
        if t0 is not None:
            pose6[0, 0, 3:] = t0
        return pose6, valid

    monkeypatch.setattr(loss_mod, "sample_hypotheses", invalid_first)
    c = target.float().requires_grad_()
    loss, aux = ransac.expected_pose_loss(
        c, poses.float(), FOCAL, (IMG_H, IMG_W),
        ransac.RansacConfig(train_refine_steps=STEPS, subsample=8, **SOLVER),
        ransac.PoseLossConfig(w_trans=W_TRANS), pp_shift=torch.tensor(PP), idx=idx)
    loss.backward()
    assert aux["hyp_valid"][0].sum() >= 2
    return loss.detach(), c.grad


@pytest.mark.parametrize("t0", [1e30, math.nan], ids=["far", "nan"])
def test_an_invalid_hypothesis_s_pose_leaves_the_gradient_finite(run, monkeypatch, t0):
    """A degenerate minimal set can leave an invalid hypothesis any pose.
    Its weight is 0, but scored and refined from a wild pose its zero
    cotangent meets an infinite derivative and the image's gradient turns
    NaN. The training objective gives it a valid hypothesis's pose: the
    loss and the
    gradient are those of the same hypothesis left a sane pose."""
    from crossloc_tpu_torch.ransac import loss as loss_mod

    sane = _expected_loss(run.inputs, monkeypatch)
    wild = _expected_loss(run.inputs, monkeypatch, t0=t0)
    assert torch.equal(wild[0], sane[0]) and torch.equal(wild[1], sane[1])
    if math.isnan(t0):  # refined as it is, the same hypothesis poisons its image
        monkeypatch.setattr(loss_mod, "guard_invalid", lambda valid, c, pose6: (pose6, c))
        unguarded = _expected_loss(run.inputs, monkeypatch, t0=t0)
        assert torch.equal(unguarded[0], sane[0]) and torch.isnan(unguarded[1][0]).all()
        assert torch.equal(unguarded[1][1:], sane[1][1:])


def test_training_p3p_runs_in_float64(run, monkeypatch):
    """The training objective solves P3P in float64 on float32 coordinates
    (a near-degenerate winning set's float32 derivative is rounding alone)
    and hands float32 poses on."""
    from crossloc_tpu_torch.ransac import loss as loss_mod

    seen, sample = [], loss_mod.sample_hypotheses

    def recording(coords, grid, cams, *args, **kwargs):
        seen.append((coords.dtype, grid.dtype, cams.dtype))
        pose6, valid = sample(coords, grid, cams, *args, **kwargs)
        seen.append(pose6.dtype)
        return pose6, valid

    monkeypatch.setattr(loss_mod, "sample_hypotheses", recording)
    loss, grad = _expected_loss(run.inputs, monkeypatch)
    assert seen[0] == (torch.float64,) * 3 and seen[1] == torch.float64
    assert loss.dtype == grad.dtype == torch.float32 and torch.isfinite(grad).all()


def _training_solve(inputs, monkeypatch, t0=None, guard=True):
    """`solve_batch(training=True)` on the on-target input, in float32, with
    hypothesis 0 of image 0 made invalid and, with `t0`, left the
    translation `t0`; the winner is each image's best valid hypothesis.
    Returns (scores, pose, gradient of <w, pose> + the entropies)."""
    from crossloc_tpu_torch.ransac import solver as solver_mod

    _, _, _, target, idx = inputs
    sample = solver_mod.sample_hypotheses

    def invalid_first(*args, **kwargs):
        pose6, valid = (x.clone() for x in sample(*args, **kwargs))
        valid[0, 0] = False
        if t0 is not None:
            pose6[0, 0, 3:] = t0
        return pose6, valid

    monkeypatch.setattr(solver_mod, "sample_hypotheses", invalid_first)
    if not guard:
        monkeypatch.setattr(solver_mod, "guard_invalid", lambda valid, c, pose6: (pose6, c))
    cfg = ransac.RansacConfig(refine_steps=STEPS, subsample=8, **SOLVER)
    c = target.float().requires_grad_()
    kw = dict(idx=idx, training=True, pp_shift=torch.tensor(PP))
    with torch.no_grad():
        probs = ransac.solve_batch(c, FOCAL, (IMG_H, IMG_W), cfg, **kw).probs
    res = ransac.solve_batch(c, FOCAL, (IMG_H, IMG_W), cfg, chosen=probs.argmax(-1), **kw)
    w = torch.linspace(-1.0, 1.0, 12).reshape(B, 6)
    ((res.pose_w2c6 * w).sum() + res.entropy.sum()).backward()
    assert res.valid.all() and not res.probs[0, 0]
    return res.scores.detach(), res.pose_w2c6.detach(), c.grad


@pytest.mark.parametrize("t0", [1e30, math.nan], ids=["far", "nan"])
def test_a_training_solve_s_invalid_hypothesis_leaves_the_gradient_finite(run, monkeypatch,
                                                                          t0):
    """`solve_batch(training=True)` scores and refines an invalid hypothesis
    through `guard_invalid` too: its own pose's score is reported, the pose,
    the other scores and the gradient are those of the same hypothesis left
    a sane pose. Unguarded, a NaN pose poisons its image's gradient through
    the scores."""
    sane = _training_solve(run.inputs, monkeypatch)
    monkeypatch.undo()
    wild = _training_solve(run.inputs, monkeypatch, t0=t0)
    assert torch.equal(wild[0][:, 1:], sane[0][:, 1:]) and torch.equal(wild[0][1], sane[0][1])
    assert torch.equal(wild[1], sane[1]) and torch.equal(wild[2], sane[2])
    assert torch.isfinite(sane[2]).all() and sane[2].abs().sum() > 0
    if math.isnan(t0):  # its own score: every error at the clamp
        assert wild[0][0, 0] < 1e-10 < sane[0][0, 0]
        monkeypatch.undo()
        unguarded = _training_solve(run.inputs, monkeypatch, t0=t0, guard=False)
        assert torch.isnan(unguarded[2][0]).all() and torch.equal(unguarded[2][1], sane[2][1])


def _rgbd_loss(inputs, monkeypatch, fault=None, guard=True, seen=None):
    """The RGB-D objective on the on-target scene coordinates and their
    camera-frame coordinates under the ground truth (1 cm of noise), in
    float32; `fault` "nan" or "far" leaves hypothesis 0 of image 0 no valid
    round with that minimal-set pose. Returns (loss, gradient)."""
    from crossloc_tpu_torch.geometry import invert_se3
    from crossloc_tpu_torch.ransac import rgbd as rgbd_mod

    _, poses, _, target, _ = inputs
    w2c = invert_se3(poses.float())
    obj = target.float()
    eye = (obj @ w2c[:, None, :3, :3].transpose(-1, -2) + w2c[:, None, None, :3, 3]
           + 0.01 * torch.randn(obj.shape, generator=torch.Generator().manual_seed(4)))
    kabsch = rgbd_mod.kabsch

    def faulty(src, dst, weights=None):
        R, t = kabsch(src, dst, weights)
        if weights is None:  # the minimal sets
            if seen is not None:
                seen.append(src.dtype)
            R, t = R.clone(), t.clone()
            if fault == "nan":
                R[0, 0] = math.nan
            elif fault == "far":
                t[0, 0] += 1e3
        return R, t

    monkeypatch.setattr(rgbd_mod, "kabsch", faulty)
    if not guard:
        monkeypatch.setattr(rgbd_mod, "guard_invalid", lambda valid, c, R, t: (R, t, c))
    cfg = ransac.RansacConfig(hypotheses=8, sample_rounds=4, refine_steps=2)
    idx = torch.randint(0, obj.shape[1] * obj.shape[2], (B, 8, 4, 3),
                        generator=torch.Generator().manual_seed(6))
    o = obj.clone().requires_grad_()
    loss = ransac.expected_pose_loss_rgbd(o, eye, torch.ones(obj.shape[:3], dtype=torch.bool),
                                          poses.float(), cfg, ransac.PoseLossConfig(w_trans=100.0),
                                          idx=idx)
    loss.backward()
    return loss.detach(), o.grad


def test_the_rgbd_objective_s_invalid_hypothesis_leaves_the_gradient_finite(run, monkeypatch):
    """The RGB-D objective scores and refines an invalid hypothesis through
    `guard_invalid`: a NaN minimal-set pose gives the loss and gradient of
    a far one, where unguarded it poisons its image's gradient."""
    far = _rgbd_loss(run.inputs, monkeypatch, "far")
    monkeypatch.undo()
    wild = _rgbd_loss(run.inputs, monkeypatch, "nan")
    assert float(far[0]) > 0 and torch.isfinite(far[1]).all() and far[1].abs().sum() > 0
    assert torch.equal(wild[0], far[0]) and torch.equal(wild[1], far[1])
    monkeypatch.undo()
    unguarded = _rgbd_loss(run.inputs, monkeypatch, "nan", guard=False)
    assert torch.isnan(unguarded[1][0]).all() and torch.equal(unguarded[1][1], far[1][1])


def test_the_rgbd_objective_solves_minimal_sets_in_float64(run, monkeypatch):
    """The RGB-D objective's minimal-set Kabsch runs in float64 on float32
    coordinates, as the RGB objective's P3P does; the loss stays float32."""
    seen = []
    loss, grad = _rgbd_loss(run.inputs, monkeypatch, seen=seen)
    assert seen == [torch.float64]
    assert loss.dtype == grad.dtype == torch.float32 and torch.isfinite(grad).all()
