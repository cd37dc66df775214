"""Readings that the limits of `correct` are set from, at a cell's own sizes
on the card: the compared numbers of sound runs of the program over many
seeds, of the control (the plain reference in the program's place, computed
in TF32 where the configuration states float32 with TF32 off) and, for the
training cells, of a fault (half of each batch left out, the mean taken
over the rest). The benchmark's own runs never run these.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 \\
        --control-seeds 11 12 13 --seconds 2 --out readings.jsonl

Each seed is set up and run for `--seconds` as a run is; one JSON line per
seed goes to standard output and to `--out`.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from perfbench.core import cell as cell_mod
    from perfbench.core import spec

    c = spec.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
            m = cell_mod.measure(c, seed, args.seconds, False, tmp, args.device)
            if seed in args.control_seeds:
                readings = m.loop.controls(c, seed, m.evidence, m.dev)
            else:
                readings = {"program": m.loop.check(c, seed, m.evidence, m.dev)}
        line = json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
