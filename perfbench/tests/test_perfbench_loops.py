"""Both loop kinds end to end on the CPU at a small size: the port agrees
with the plain reference, the result line has the contract's keys, and a
run with the timed path broken underneath comes out not correct. A
training loop under another name, built from the train loop's parts
through its hooks alone, is run and read as the train loop is."""
import functools
import tempfile
import types

import pytest
import torch
import torch.nn.functional as F

from perfbench.core import cell as cell_mod
from perfbench.core import spec

SEED = 2 ** 33 + 5  # more than 32 bits, as large run seeds are
CELLS = spec.workload_names()  # every workload file, named in BENCHMARK.json or not


def _run(c, trace=False):
    return cell_mod.run(c, SEED, 0.5, trace, "cpu")


def _over(out):
    return {n for n, c in out["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_the_reference(tiny, name):
    out = _run(tiny(name))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny, trace):
    c = tiny("coord-pretrain-f32-b12")
    out = _run(c, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(out["metrics"]) <= {m["name"] for m in c.per_layer}
        assert "host_wait_ms.train" in out["metrics"]
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_a_step_that_leaves_the_state_unchanged_fails(tiny, monkeypatch):
    import crossloc_tpu_torch.train as port_train

    step = port_train.train_step

    def unchanged(state, batch, *args, **kwargs):
        saved = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, batch, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        return out

    monkeypatch.setattr(port_train, "train_step", unchanged)
    out = _run(tiny("coord-pretrain-f32-b12"))
    assert not out["correct"] and "change_gap" in _over(out)


@pytest.mark.parametrize("name", ["coord-pretrain-f32-b12", "mlr-finetune-f32-b8"])
def test_half_the_batch_left_out_fails(tiny, monkeypatch, name):
    import crossloc_tpu_torch.train as port_train

    step = port_train.train_step

    def half(state, batch, *args, **kwargs):
        n = batch.images.shape[0] // 2
        cut = batch._replace(images=batch.images[:n], poses=batch.poses[:n],
                             labels=batch.labels[:n])
        return step(state, cut, *args, **kwargs)

    monkeypatch.setattr(port_train, "train_step", half)
    out = _run(tiny(name))
    assert not out["correct"] and "loss_gap" in _over(out)


def test_an_altered_pose_fails(tiny, monkeypatch):
    import crossloc_tpu_torch.ransac as port_ransac

    solve = port_ransac.solve_batch

    def altered(*args, **kwargs):
        res = solve(*args, **kwargs)
        cam = res.cam_to_world.clone()
        cam[0, 0, 3] += 1.0
        return res._replace(cam_to_world=cam)

    monkeypatch.setattr(port_ransac, "solve_batch", altered)
    out = _run(tiny("coord-validate-f32-b64"))
    assert not out["correct"] and "pose_t_gap_m" in _over(out)


def test_half_the_batch_predicted_fails(tiny, monkeypatch):
    from crossloc_tpu_torch.models import TransPoseNet

    forward = TransPoseNet.forward

    def half(self, x):
        out = forward(self, x[: max(1, x.shape[0] // 2)])
        return torch.cat([out, out])[: x.shape[0]]

    monkeypatch.setattr(TransPoseNet, "forward", half)
    out = _run(tiny("coord-validate-f32-b64"))
    assert not out["correct"] and "coord_gap" in _over(out)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["norm_affine", "conv_bias"])
def test_a_dropped_affine_or_bias_fails(tiny, monkeypatch, name, fault):
    """The seeded norm scales, shifts and conv biases sit away from 1 and 0,
    so a forward that drops them is seen, in every cell."""
    from crossloc_tpu_torch.models import layers

    if fault == "norm_affine":
        gn = layers.group_norm_relu

        def dropped(x, weight, bias, *args, **kwargs):
            return gn(x, torch.ones_like(weight), torch.zeros_like(bias), *args, **kwargs)

        monkeypatch.setattr(layers, "group_norm_relu", dropped)
    else:
        def dropped(self, x):
            y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None, self.stride,
                         self.padding)
            return y.permute(0, 2, 3, 1)

        monkeypatch.setattr(layers.Conv, "forward", dropped)
    out = _run(tiny(name))
    assert not out["correct"], out["checks"]


def _loop_from_train_parts(seen):
    """A loop kind of its own made from `loops/train.py`'s parts as a loop
    file would make it: its step through `Program.port_step`, which adds
    evidence for each step, and its reference loss, which reads it."""
    base = spec.loop("train")

    class Program(base.Program):
        def port_step(self, tb):
            metrics, extra = super().port_step(tb)
            assert extra is None
            seen["steps"] += 1
            return metrics, {"step": seen["steps"] - 1, "rows": tb.images.shape[0]}

    def loss(cell, pred, lab, pose, focal, pp, step, evidence, rows):
        seen["loss"].append((step, evidence["extra"][step], pred.shape[0]))
        return base.coord_loss(cell, pred, lab, pose, focal, pp, step, evidence, rows)

    mod = types.ModuleType("perfbench_loop_train_alt")
    mod.TRAINING, mod.CHECKS, mod.Program, mod.end_to_end = (True, base.CHECKS, Program,
                                                             base.end_to_end)
    mod.check = functools.partial(base.check, loss=loss)
    mod.controls = functools.partial(base.controls, loss=loss)
    return mod


@pytest.fixture
def train_alt(monkeypatch):
    seen = {"steps": 0, "loss": []}
    alt, load = _loop_from_train_parts(seen), spec.loop
    monkeypatch.setattr(spec, "loop", lambda kind: alt if kind == "train_alt" else load(kind))
    return seen


def test_a_loop_of_train_s_parts_under_another_name_is_correct_and_read(tiny, train_alt):
    """Traced, the loop under another name comes out correct, its loss sees
    each checked step's index and evidence, and it gets every per-layer
    reading the train loop gets on the same cell: the readers follow
    `TRAINING`."""
    c = tiny("coord-pretrain-f32-b12")
    train = _run(c, trace=True)
    c.workload["loop"] = "train_alt"
    alt = _run(c, trace=True)
    assert alt["correct"], alt["checks"]
    checked = c.workload["checked_steps"]
    assert train_alt["steps"] >= checked + 2  # the checked steps, then the window's
    assert train_alt["loss"] == [(k, {"step": k, "rows": 2}, 2) for k in range(checked)]
    assert "host_wait_ms.train" in train["metrics"]
    assert set(alt["metrics"]) == set(train["metrics"])


def test_a_loop_of_train_s_parts_sees_its_controls(tiny, train_alt):
    """`controls` passes the loop's loss on: the half-batch fault reaches
    the loss with the rows it keeps, and reads over the limit."""
    c = tiny("coord-pretrain-f32-b12")
    c.workload["loop"] = "train_alt"
    with tempfile.TemporaryDirectory() as tmp:
        m = cell_mod.measure(c, SEED, 0.2, False, tmp, "cpu")
        readings = m.loop.controls(c, SEED, m.evidence, m.dev)
    assert readings["half_batch"]["loss_gap"] > c.workload["limits"]["loss_gap"]
    assert {rows for _, _, rows in train_alt["loss"]} == {2, 1}
