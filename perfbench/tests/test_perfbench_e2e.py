"""The DSAC* end-to-end cell: its entries, its loop on a small copy on the
CPU (correct, and not correct under a fault in the port's step), and the
solver's readers on hand-built traces."""
from types import SimpleNamespace

import pytest

from perfbench.core import cell as cell_mod
from perfbench.core import spec, trace

CELL = "coord-e2e-f32-b12"
SEED = 2 ** 33 + 5  # more than 32 bits, as large run seeds are
SOLVER_METRICS = {"solver_device_ms.train", "solver_launches.train"}


def test_cell_reports_the_four_end_to_end_metrics_and_the_solver_s():
    c = spec.cell(CELL)
    assert {m["name"] for m in c.end_to_end} == {"train_img_s", "train_step_p90_ms",
                                                 "peak_mem_gib", "setup_s"}
    per_layer = {m["name"]: m for m in c.per_layer}
    assert SOLVER_METRICS <= set(per_layer)
    assert all(per_layer[n]["layer"] == "solver" for n in SOLVER_METRICS)
    # the DSAC step has no `step.loss` span: that reader has nothing to read here
    assert "loss_device_ms.train" not in per_layer
    assert c.config["uncertainty"] is None and c.config["layers"][-1]["cout"] == 3
    assert spec.loop(c.workload["loop"]).TRAINING


def test_the_loop_builds_the_cli_s_configs():
    from crossloc_tpu_torch.ransac import PoseLossConfig, RansacConfig

    rcfg, lcfg = spec.loop("train_e2e").cli_configs(spec.config("dsacstar-e2e-coord-480x720"))
    assert rcfg == RansacConfig(hypotheses=64, sample_rounds=8, train_refine_steps=2,
                                inlier_threshold=10.0, inlier_alpha=100.0, max_pixel_error=100.0,
                                subsample=8)
    assert lcfg == PoseLossConfig(w_rot=1.0, w_trans=100.0, soft_clamp=100.0)


def _run(c):
    return cell_mod.run(c, SEED, 0.5, False, "cpu")


def test_the_loop_on_a_small_copy_is_correct(tiny):
    out = _run(tiny(CELL))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def _faulty_step(monkeypatch, fault):
    """The port's DSAC step with `fault`: half of each batch left out (with
    its minimal sets), or one refinement step in place of the config's."""
    import crossloc_tpu_torch.train as port_train

    make = port_train.make_dsac_train_step

    def faulty(model, rcfg, lcfg, **kwargs):
        if fault == "one_refine_step":
            return make(model, rcfg._replace(train_refine_steps=1), lcfg, **kwargs)
        step = make(model, rcfg, lcfg, **kwargs)

        def half(state, batch, idx):
            n = batch.images.shape[0] // 2
            model.target = model.target[:n]
            cut = batch._replace(images=batch.images[:n], poses=batch.poses[:n],
                                 labels=batch.labels[:n])
            return step(state, cut, idx=idx[:n])

        return half

    monkeypatch.setattr(port_train, "make_dsac_train_step", faulty)


@pytest.mark.parametrize("fault", ["half_batch", "one_refine_step"])
def test_a_fault_in_the_port_s_step_is_not_correct(tiny, monkeypatch, fault):
    _faulty_step(monkeypatch, fault)
    out = _run(tiny(CELL))
    assert not out["correct"], out["checks"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"]["limit"]


def _kernel(name, seconds, *under):
    return trace.Kernel(name, seconds, frozenset(under))


AUTOGRAD = "autograd::engine::evaluate_function: "
KERNELS = [
    _kernel("p3p_elementwise", 1e-4, "crossloc.solver.sample", "perfbench.step"),
    _kernel("reduce_kernel", 2e-4, "crossloc.solver.score", "perfbench.step"),
    _kernel("bmm_kernel", 3e-4, AUTOGRAD + "BmmBackward0", "BmmBackward0"),  # the solver's backward
    # the net's: its forward, its conv, K1-bwd and ReLU backward, Adam
    _kernel("sm80_xmma_fprop", 4e-4, "aten::convolution", "perfbench.step"),
    _kernel("dgrad_engine", 5e-4, AUTOGRAD + "ConvolutionBackward0", "aten::convolution_backward"),
    _kernel("gnb_cluster_kernel", 6e-4, AUTOGRAD + "_GroupNormReLUBackward"),
    _kernel("threshold_backward", 7e-4, AUTOGRAD + "ReluBackward0"),
    _kernel("multi_tensor_apply_kernel", 8e-4, "crossloc.step.optimizer"),
]
SPANS = [(100, 300, "crossloc.solver.sample"), (300, 400, "crossloc.solver.score"),
         (400, 600, "crossloc.step.backward"), (550, 700, "crossloc.step.optimizer")]
BUSY = [(150, 200), (350, 500), (650, 900)]


def _ctx(kernels=KERNELS, spans=SPANS, units=2, tr=True):
    t = trace.Trace(1e-6, 4e-7, list(kernels), [], [], busy=BUSY, bounds=(0, 1000),
                    spans=list(spans)) if tr else None
    return SimpleNamespace(training=True, trace=t, traced_units=units, units=units + 3)


READINGS = {
    "solver_device_ms.train": 1e3 * (1e-4 + 2e-4 + 3e-4) / 2,
    "solver_launches.train": 3 / 2,
}


@pytest.mark.parametrize("name", sorted(SOLVER_METRICS))
def test_solver_readers_on_a_hand_built_trace(name):
    got = spec.metric_reader(name).read(_ctx())
    assert got == pytest.approx(READINGS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(SOLVER_METRICS))
def test_solver_readers_none_without_a_trace_or_the_program_s_spans(name):
    reader = spec.metric_reader(name)
    assert reader.read(_ctx(tr=False)) is None
    assert reader.read(_ctx(units=0)) is None
    # the parent's program: the same kernels, no solver span over any of them
    parent = [trace.Kernel(k.name, k.seconds,
                           frozenset(a for a in k.ancestors if not a.startswith("crossloc.")))
              for k in KERNELS]
    assert reader.read(_ctx(parent, [s for s in SPANS if "solver" not in s[2]])) is None
