"""The solver's kernels in a traced training step, by what launched them.

Forward: every kernel with one of the solver's spans among its ancestors,
the program's (`crossloc.solver.*`, `crossloc_tpu_torch/ransac/loss.py`)
or the benchmark's own around a solve (`perfbench.solve`, the validate
loop's, which no training cell emits; `tests/test_perfbench_spans.py`
marks its hand-built trace's solver kernel with it). Backward:
autograd runs it on its own device thread, outside the main thread's
spans, so every kernel that autograd launches (an ancestor
`autograd::engine::evaluate_function: ...`) counts, except under the net's
own backward nodes: the convolutions', K1-bwd's and the ReLUs' after the
residual adds. What is left of the net's backward (the residual adds'
gradient sums, the coordinate slice's) is counted with the solver's.
"""
from __future__ import annotations

from typing import List, Optional

from .trace import PROGRAM_PREFIX, Kernel

SPANS = (PROGRAM_PREFIX + "solver.", "perfbench.solve")
AUTOGRAD = "autograd::engine::evaluate_function: "
NET_BACKWARD = ("ConvolutionBackward", "_GroupNormReLUBackward", "ReluBackward")


def _forward(k: Kernel) -> bool:
    return any(a.startswith(SPANS) for a in k.ancestors)


def _backward(k: Kernel) -> bool:
    nodes = [a for a in k.ancestors if a.startswith(AUTOGRAD)]
    return bool(nodes) and not any(n in a for a in nodes for n in NET_BACKWARD)


def kernels(ctx) -> Optional[List[Kernel]]:
    """The solver's forward and backward kernels of the traced steps, or
    None where no kernel ran under a solver span (no trace, or a program
    without the spans)."""
    if ctx.trace is None or not ctx.traced_units:
        return None
    fwd = [k for k in ctx.trace.kernels if _forward(k)]
    if not fwd:
        return None
    return fwd + [k for k in ctx.trace.kernels if not _forward(k) and _backward(k)]
