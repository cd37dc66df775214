"""Small copies of the benchmark's cells for CPU tests: the published
widths at a 32x48 image, a batch of 2 and a few frames."""
import copy

import pytest

from perfbench.core import spec


def tiny_cell(name: str, height: int = 32, width: int = 48, batch: int = 2, frames: int = 6):
    c = spec.cell(name)
    c.config = copy.deepcopy(c.config)
    c.workload = copy.deepcopy(c.workload)
    c.config["image"] = [height, width]
    c.workload["batch"] = batch
    c.workload["scene"]["roots"] = [[root, frames] for root, _ in c.workload["scene"]["roots"]]
    c.workload["trace"] = dict(c.workload["trace"], skip=0)
    if "check" in c.workload:
        c.workload["check"] = {"batches": 1, "from_first": 2}
    return c


@pytest.fixture
def tiny():
    return tiny_cell
