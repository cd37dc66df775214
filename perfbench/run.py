"""Run one cell of the benchmark of `crossloc_tpu_torch` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets the cell up from the seed (the scene written under TMPDIR, seeded
weights made on the card, the cell's shapes warmed up), measures the cell's
loop for `--seconds`, checks what the loop produced against the plain
reference in `perfbench/reference/`, and prints one JSON line last on
standard output: the end-to-end metrics with `--trace 0`, the per-layer
metrics (from a profiled stretch of the window) with `--trace 1`. The
numbers compared and their limits are the last lines on standard error and
the last key of the line.

Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "crossloc_tpu")


def set_environ():
    """Every cache of the program and its libraries at a fixed place in the
    checkout; no JAX through a library."""
    cache = ROOT / ".perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None):
    """The forbidden top-level names among `modules` (default: those
    loaded), each compared whole: `crossloc_tpu_torch` is not `crossloc_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environ()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.core import cell as cell_mod
    from perfbench.core import spec

    c = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"perfbench: {args.workload} needs {c.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = cell_mod.run(c, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                       device_extra={"power_limit": power_limit()})
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, chk in out["checks"].items():
        print(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
