"""The control, on the card, at the cells' own sizes (the sizes the limits
were read at; `perfbench/control.py` reads more seeds): the plain reference
in the program's place, computed in TF32 where the configurations state
float32 with TF32 off, fails at least one compared number, while the
program passes them all."""
import tempfile

import pytest
import torch

from perfbench.core import cell as cell_mod
from perfbench.core import spec

CELLS = spec.workload_names()  # every workload file, named in BENCHMARK.json or not


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3 * 10 ** 9 + 101, 3 * 10 ** 9 + 102, 3 * 10 ** 9 + 103])
def test_control_fails_and_program_passes(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    c = spec.cell(name)
    with tempfile.TemporaryDirectory() as tmp:
        m = cell_mod.measure(c, seed, 0.5, False, tmp, "cuda")
        readings = m.loop.controls(c, seed, m.evidence, m.dev)
    limits = c.workload["limits"]
    assert all(readings["program"][k] <= v for k, v in limits.items()), readings["program"]
    assert any(readings["tf32"][k] > v for k, v in limits.items()), readings["tf32"]
