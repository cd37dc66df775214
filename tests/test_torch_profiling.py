"""The port's section timers against the JAX package's: the same `StopWatch`
report for the same totals; `device_sync` and `trace` on the CPU; the spans
of the train path: off without a profiler, and under one each with its
parent, thread and counts, on the profiler's clock."""
import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crossloc_tpu.utils import profiling as jprofiling
from crossloc_tpu_torch import data, models
from crossloc_tpu_torch.train import TrainBatch, TrainState, make_optimizer, train_step
from crossloc_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_records():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name():
    out = {}
    for r in profiling.records():
        out.setdefault(r.name, []).append(r)
    return out


def test_stopwatch_report_matches_jax():
    port, ref = profiling.StopWatch(), jprofiling.StopWatch()
    for sw in (port, ref):
        sw.totals = {"train": 12.3456789, "sweep": 0.0004}
        sw.counts = {"train": 4000, "sweep": 3}
    assert port.report() == ref.report()
    assert port.report().splitlines()[0] == "train: total 12345.7ms over 4000 calls (3.09ms avg)"


def test_stopwatch_sections_accumulate():
    sw = profiling.StopWatch()
    for _ in range(3):
        with sw.section("a", sync_result={"out": [torch.ones(2)]}):
            torch.ones(4).sum()
    with pytest.raises(ValueError):
        with sw.section("b"):
            raise ValueError("the section still counts")
    assert sw.counts == {"a": 3, "b": 1}
    assert all(t >= 0.0 for t in sw.totals.values())


def test_device_sync_takes_cpu_tensors_and_containers():
    for x in (torch.ones(3), [torch.ones(1)], {"a": (1, torch.ones(1))}, None, 3.0, []):
        profiling.device_sync(x)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.span("before"):  # no profiler: no record, nothing in spans.jsonl
        pass
    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.span("outer", n=2):
            torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.load(open(f"{d}/trace.json"))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.get("name") == "crossloc.outer" for e in events)
    lines = [json.loads(line) for line in open(f"{d}/spans.jsonl")]
    assert [(x["name"], x["parent"], x["counts"]) for x in lines] == [("outer", None, {"n": 2})]
    assert set(lines[0]) == set(profiling.Span._fields)
    assert lines[0]["end_ns"] >= lines[0]["start_ns"]


def _raise(*args, **kwargs):
    raise AssertionError("called with no profiler recording")


def _wire_and_copy():
    wire = data.images_to_wire(np.full((2, 4, 6, 3), 0.5, np.float32))
    list(data.device_prefetch([{"image": wire, "pose": np.eye(4, dtype=np.float32)[None]}],
                              "cpu"))


def _span():
    with profiling.span("x", n=1):
        pass


def _section():
    with profiling.StopWatch().section("x"):
        pass


@pytest.mark.parametrize("call", [_span, _section, _wire_and_copy],
                         ids=["span", "stopwatch_section", "wire_and_copy"])
def test_no_profiler_no_annotation_no_clock_no_record(monkeypatch, call):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(profiling, "time", SimpleNamespace(time_ns=_raise,
                                                           perf_counter=lambda: 0.0))
    assert profiling.profiler_enabled() is False
    assert profiling.span("x") is profiling.span("y", n=3)  # one shared no-op, no object made
    call()
    assert profiling.records() == []


def test_add_counts_reaches_the_innermost_open_span_of_its_thread():
    profiling.add_counts(n=1)  # no span open: nothing to add to, nothing raised
    with _cpu_profile():
        with profiling.span("outer", a=1):
            with profiling.span("inner"):
                profiling.add_counts(n=2)
            profiling.add_counts(m=3)
    names = _by_name()
    assert names["inner"][0].counts == {"n": 2}
    assert names["outer"][0].counts == {"a": 1, "m": 3}
    assert names["inner"][0].parent == "outer"


def test_the_flag_follows_the_profiler_in_every_thread():
    seen = []

    def look():
        seen.append(profiling.profiler_enabled())

    look()
    with _cpu_profile():
        look()
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    look()
    assert seen == [False, True, True, False]


def test_main_thread_span_is_a_profiler_event_on_its_clock():
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner", bytes=12):
                torch.ones(8).sum()
    (inner,), (outer,) = _by_name()["inner"], _by_name()["outer"]
    assert (inner.parent, outer.parent, inner.counts) == ("outer", None, {"bytes": 12})
    assert inner.thread == outer.thread == threading.get_ident()
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()}
    for r in (inner, outer):
        assert abs(events["crossloc." + r.name].start_ns() - r.start_ns) < 1_000_000


def test_a_span_the_profiler_did_not_see_end_keeps_no_record():
    prof = _cpu_profile()
    prof.__enter__()
    s = profiling.span("open")
    s.__enter__()
    prof.__exit__(None, None, None)
    s.__exit__(None, None, None)
    with profiling.span("after"):
        pass
    assert profiling.records() == []


def test_the_ring_keeps_the_newest(monkeypatch):
    import collections

    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=3))
    with _cpu_profile():
        for i in range(5):
            with profiling.span("s", i=i):
                pass
    assert [r.counts["i"] for r in profiling.records()] == [2, 3, 4]
    assert profiling.RING_SIZE == 65536


def test_threads_lose_no_record():
    """More threads than cores, switching often: every span is kept once."""
    n_threads, n_spans = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            def work(k):
                for i in range(n_spans):
                    with profiling.span("w", k=k, i=i):
                        pass

            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = sorted((r.counts["k"], r.counts["i"]) for r in profiling.records())
    assert got == [(k, i) for k in range(n_threads) for i in range(n_spans)]


def test_stopwatch_section_is_a_span():
    sw = profiling.StopWatch()
    with _cpu_profile():
        with sw.section("phase"):
            with profiling.span("inside"):
                pass
    names = _by_name()
    assert names["inside"][0].parent == "phase" and names["phase"][0].parent is None
    assert sw.counts == {"phase": 1}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spans") / "train_sim")
    data.write_fake_dataset(root, n=7, img_h=16, img_w=24, focal=20.0, seed=0)
    return root


def test_loader_workers_record_collate_and_the_consumer_its_waits(scene):
    loader = data.Loader(data.CamLocDataset(scene, image_height=16), 3, shuffle=True,
                         num_workers=2, prefetch=1)
    loader.set_epoch(4)
    with _cpu_profile():
        got = list(loader)
    main = threading.get_ident()
    names = _by_name()
    collate = sorted(names["data.collate"], key=lambda r: r.counts["batch"])
    assert [r.counts for r in collate] == [{"epoch": 4, "batch": 0, "frames": 3, "direct": 3},
                                           {"epoch": 4, "batch": 1, "frames": 3, "direct": 3},
                                           {"epoch": 4, "batch": 2, "frames": 1, "direct": 1}]
    assert all(r.thread != main and r.parent is None for r in collate)
    waits = names["data.loader_wait"]  # each batch, then the end of the epoch
    assert [r.counts for r in waits] == [{"epoch": 4, "batch": i} for i in range(len(got) + 1)]
    assert all(r.thread == main for r in waits)


def test_train_path_spans_their_parents_and_bytes():
    torch.manual_seed(0)
    net = models.build_network("coord", "MLE", tiny=True)
    state = TrainState(net, make_optimizer(net.parameters(), 2e-4))
    images = np.random.default_rng(0).uniform(size=(2, 32, 48, 3)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    coord = np.random.default_rng(1).normal(size=(2, 4, 6, 3)).astype(np.float32)
    sw = profiling.StopWatch()
    with _cpu_profile() as prof:
        with sw.section("data"):
            wire = data.images_to_wire(images)
            (batch,) = data.device_prefetch([{"image": wire, "pose": pose, "coord": coord}],
                                            "cpu", keys=("image", "pose", "coord"))
        with sw.section("step"):
            draws = data.draw_augmentation(torch.Generator().manual_seed(0), 2,
                                           data.AugmentConfig())
            x, lab, poses, focal, pp = data.augment_batch(
                data.images_from_wire(batch["image"]), batch["coord"], batch["pose"],
                torch.tensor(40.0), draws, data.AugmentConfig())
            train_step(state, TrainBatch(x, poses, lab, focal, pp), "coord", "MLE")
    names = _by_name()
    assert {n: [(r.parent, r.counts) for r in rs] for n, rs in names.items()} == {
        "data.wire": [("data", {"bytes": images.size})],
        "data.copy": [("data", {"bytes": wire.nbytes + pose.nbytes + coord.nbytes})],
        "data": [(None, {})],
        "augment": [("step", {})],
        "step.loss": [("step", {})],
        "step.optimizer": [("step", {})],
        "step": [(None, {})]}
    assert wire.nbytes == images.size
    host = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert {"crossloc." + n for n in names} <= host
