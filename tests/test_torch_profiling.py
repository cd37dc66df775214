"""The port's section timers against the JAX package's: the same `StopWatch`
report for the same totals; `timeit`, `device_sync` and `trace` on the CPU."""
import json

import pytest
import torch

from crossloc_tpu.utils import profiling as jprofiling
from crossloc_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def test_timeit_runs_warmup_then_iters():
    calls = []

    def fn(v):
        calls.append(v)
        return torch.full((2,), float(v))

    s = profiling.timeit(fn, 7, iters=4, warmup=3)
    assert s >= 0.0 and calls == [7] * 7


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as d:
        torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.load(open(f"{d}/trace.json"))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
