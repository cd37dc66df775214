"""`core/trace.py::reduce` on a fixed event list, and the readers of the
program's spans (`core/spans.py`) on hand-built traces and records: the
values they give, and None where there is no trace, no record, or a
program that keeps no span records. A traced run asks each reader by
whether the loop trains, never by its name (`core/cell.py::per_layer`)."""
import threading
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from crossloc_tpu_torch.utils import profiling
from perfbench.core import cell as cell_mod
from perfbench.core import spans, spec, trace, work

MAIN, WORKER = threading.main_thread().ident, 1


class Ev:
    def __init__(self, name, start, end, kind, corr, linked=0, thread=MAIN, cuda=False):
        self._v = (name, start, end, kind, corr, linked, thread, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def activity_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def device_type(self):
        return DeviceType.CUDA if self._v[7] else DeviceType.CPU


def _events(program_spans=True):
    host = [Ev("perfbench.traced", 0, 1000, "user_annotation", 1),
            Ev("perfbench.data", 0, 300, "user_annotation", 2),
            Ev("perfbench.step", 300, 900, "user_annotation", 4),
            Ev("aten::add", 305, 310, "cpu_op", 7),
            Ev("aten::convolution", 320, 400, "cpu_op", 5),
            Ev("perfbench.loss_read", 900, 1000, "user_annotation", 8),
            Ev("cudaLaunchKernel", 306, 307, "cuda_runtime", 101, linked=7)]
    if program_spans:
        host += [Ev("crossloc.data.loader_wait", 10, 250, "user_annotation", 3),
                 Ev("crossloc.data.wire", 250, 280, "user_annotation", 9),
                 Ev("crossloc.data.copy", 280, 300, "user_annotation", 10),
                 Ev("crossloc.augment", 300, 320, "user_annotation", 6),
                 Ev("crossloc.data.collate", -500, 100, "user_annotation", 11, thread=WORKER)]
    device = [Ev("sm80_conv_kernel", 350, 600, "kernel", 200, linked=5, cuda=True),
              Ev("void at::native::add_kernel(float)", 320, 340, "kernel", 101, cuda=True),
              Ev("Memcpy HtoD (Pinned -> Device)", 100, 150, "gpu_memcpy", 202, cuda=True),
              Ev("perfbench.step", 300, 900, "gpu_user_annotation", 203, cuda=True),
              Ev("late_kernel", 1100, 1200, "kernel", 204, linked=5, cuda=True)]
    return host + device


def _reduce(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return trace.reduce(prof)


@pytest.mark.parametrize("program_spans", [True, False], ids=["with", "without"])
def test_reduce_on_a_fixed_event_list(program_spans):
    tr = _reduce(_events(program_spans))
    assert tr.window_s == pytest.approx(1000e-9, rel=1e-12)
    assert tr.busy_s == pytest.approx(320e-9, rel=1e-12)
    assert [n for n, _ in tr.device_ops] == ["sm80_conv_kernel", "gpu_memcpy",
                                             "at::native::add_kernel"]
    assert [v for _, v in tr.device_ops] == pytest.approx([250e-9, 50e-9, 20e-9], rel=1e-12)
    # gaps (0, 100), (150, 320) under data; (340, 350), (600, 1000) under step
    assert [n for n, _ in tr.idle_gaps] == ["perfbench.step", "perfbench.data"]
    assert [v for _, v in tr.idle_gaps] == pytest.approx([410e-9, 270e-9], rel=1e-12)
    assert tr.seconds(under={"aten::convolution"}) == pytest.approx(250e-9, rel=1e-12)
    augment = tr.seconds(under={"crossloc.augment"})
    assert augment == (pytest.approx(20e-9, rel=1e-12) if program_spans else 0.0)
    assert tr.busy == [(100, 150), (320, 340), (350, 600)] and tr.bounds == (0, 1000)
    # the main thread's program spans, clipped to the stretch; not a worker's
    assert [n for _, _, n in tr.spans] == ([
        "crossloc.data.loader_wait", "crossloc.data.wire", "crossloc.data.copy",
        "crossloc.augment"] if program_spans else [])
    assert tr.intervals("crossloc.data.") == ([(10, 300)] if program_spans else [])
    assert tr.intervals("crossloc.augment") == ([(300, 320)] if program_spans else [])


def _span(name, start, end, thread=MAIN, **counts):
    return profiling.Span(name, thread, start, end, None, counts)


RECORDS = [_span("collate", -500, 100, WORKER),
           _span("data.collate", -500, 100, WORKER, epoch=0, batch=1, frames=12),
           _span("data.loader_wait", 10, 250, epoch=0, batch=0),
           _span("data.wire", 250, 280, bytes=30),
           _span("data.collate", 100, 400, WORKER, epoch=0, batch=2, frames=12),
           _span("data.copy", 280, 300, bytes=20),
           _span("augment", 300, 320)]

READERS = {  # per traced step (2 in the stretch), a collated batch, or a share
    "loader_wait_ms.train": 240e-6 / 2,
    "wire_ms.train": 30e-6 / 2,
    "host_copy_ms.train": 20e-6 / 2,
    "collate_ms.train": (600e-6 + 300e-6) / 2,
    # data spans cover (10, 300); the memcpy (100, 150) is the only busy part
    "idle_in_data_pct.train": 100.0 * (290 - 50) / 1000,
    "augment_device_ms.train": 20e-6 / 2,
    "loss_device_ms.train": None,  # no kernel under step.loss in the events
    "optimizer_device_ms.train": None,
}


def _ctx(tr, units=2, training=True):
    return SimpleNamespace(training=training, trace=tr, traced_units=units, units=units + 3)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_values(monkeypatch, name):
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    got = spec.metric_reader(name).read(_ctx(_reduce(_events())))
    want = READERS[name]
    assert got == (None if want is None else pytest.approx(want, rel=1e-9))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_none_without_trace_or_from_a_program_without_spans(monkeypatch, name):
    reader = spec.metric_reader(name)
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    assert reader.read(_ctx(None)) is None
    assert reader.read(_ctx(_reduce(_events()), units=0)) is None
    monkeypatch.delattr(profiling, "records")  # the parent's program
    assert reader.read(_ctx(_reduce(_events(program_spans=False)))) is None


@pytest.mark.parametrize("name", sorted(n for n in READERS if "device_ms" not in n
                                         and n != "idle_in_data_pct.train"))
def test_span_readers_none_without_records(monkeypatch, name):
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert spec.metric_reader(name).read(_ctx(_reduce(_events()))) is None


def test_idle_in_data_needs_the_busy_intervals():
    """The reader takes the busy intervals and the bounds that `reduce`
    keeps: with the memcpy in the data spans (10, 300) left out of them,
    the whole of those spans reads idle."""
    reader = spec.metric_reader("idle_in_data_pct.train")
    tr = _reduce(_events())
    assert reader.read(_ctx(tr)) == pytest.approx(24.0, rel=1e-9)
    tr.busy = tr.busy[1:]
    assert reader.read(_ctx(tr)) == pytest.approx(29.0, rel=1e-9)


@pytest.mark.parametrize("records", [[], RECORDS[:1] + [_span("data.copy", 400, 900)]],
                         ids=["none", "elsewhere"])
def test_idle_in_data_reads_the_trace_not_the_records(monkeypatch, records):
    """The data spans come from the trace, on the busy intervals' clock:
    the program's records, on the host's, change nothing."""
    monkeypatch.setattr(profiling, "records", lambda: list(records))
    reader = spec.metric_reader("idle_in_data_pct.train")
    assert reader.read(_ctx(_reduce(_events()))) == pytest.approx(24.0, rel=1e-9)


def test_overlap_of_interval_lists():
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([], [(0, 5)]) == 0
    assert spans.overlap_ns([(0, 100)], [(10, 20), (30, 40), (90, 200)]) == 30


READER_FILES = sorted(p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py"))


def _every_layer_trace():
    """A hand-built trace with a kernel for every reader: convs, K1, K1-bwd,
    the program's augment, loss and optimizer spans, the solver's span."""
    ks = [trace.Kernel(name, 1e-4, frozenset(under)) for name, under in (
        ("sm80_xmma_fprop_implicit_gemm", {"aten::convolution", "perfbench.step"}),
        ("gn_cluster_kernel_float_", {"perfbench.step"}),
        ("gnb_cluster_kernel_float_", {"perfbench.step"}),
        ("elementwise_kernel", {"crossloc.augment"}),
        ("reduce_kernel", {"crossloc.step.loss"}),
        ("multi_tensor_apply_kernel", {"crossloc.step.optimizer"}),
        ("p3p_kernel", {"perfbench.solve"}))]
    return trace.Trace(1e-3, 3.2e-4, ks, [], [], busy=[(100, 150), (320, 340), (350, 600)],
                       bounds=(0, 1000), spans=[(10, 300, "crossloc.data.loader_wait")])


@pytest.mark.parametrize("training", [True, False], ids=["trains", "does_not_train"])
@pytest.mark.parametrize("name", READER_FILES)
def test_readers_follow_whether_the_loop_trains(monkeypatch, name, training):
    """A traced run reads a `.train` metric in any loop that trains,
    whatever its name (the context carries none), and leaves it out in
    one that does not; a `.validate` metric the other way round. Each
    reader gives a value on a trace with something of its layer in it."""
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    peaks = {"flops": 67e12, "bytes_per_s": 3.35e12}
    ctx = _ctx(_every_layer_trace(), training=training)
    ctx.host, ctx.peaks = {"data": 0.5}, peaks
    ctx.work = work.counts(spec.config("crossloc-coord-480x720"), 2, training, peaks)
    got = cell_mod.per_layer([{"name": name, "unit": "u"}], ctx)
    reads = name.endswith(".train") == training
    assert (name in got) == reads, got
    if reads:
        assert got[name]["value"] > 0
