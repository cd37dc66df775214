"""Device ms per traced step of the solver's kernels in a training step:
those launched under the solver's spans, and those of the backward that
autograd runs outside the net's conv, GroupNorm and ReLU backward
(`perfbench/core/solver.py` states the rule)."""
from perfbench.core import solver

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    ks = solver.kernels(ctx)
    if ks is None:
        return None
    return 1e3 * sum(k.seconds for k in ks) / ctx.traced_units
