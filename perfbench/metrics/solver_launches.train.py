"""Kernels per traced step of the solver in a training step: those launched
under the solver's spans, and those of the backward that autograd runs
outside the net's conv, GroupNorm and ReLU backward
(`perfbench/core/solver.py` states the rule)."""
from perfbench.core import solver

UNIT = "kernels"
MOVES = "train_img_s"


def read(ctx):
    ks = solver.kernels(ctx)
    if ks is None:
        return None
    return len(ks) / ctx.traced_units
