"""Small fixed-size SPD solve (counterpart of `crossloc_tpu/geometry/linalg.py`).

The unrolled Cholesky runs elementwise over the batch: the refinement of
the solver solves one 6x6 system per pose and iteration, batched over
images and hypotheses.
"""
from __future__ import annotations

import torch


def solve_spd(A, b):
    """Solve A x = b for SPD A [..., n, n], b [..., n] -> [..., n].

    Diagonal pivots are floored at a tiny positive value, so a rank-deficient
    A gives a finite result."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-20))
        L[j][j] = d
        inv_d[j] = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d[j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * inv_d[i]
    return torch.stack(x, dim=-1)
