"""The port's host input pipeline, measured (counterpart of
`tools/loader_bench.py`). Runs on the CPU; needs no card.

On the noise scene of the port's synthetic writer (`data.write_fake_dataset`,
480x720 PNGs by default) it measures:
  1. native and PIL decode + resize to the standard height, img/s, at each
     thread count of `--threads` (best of `--repeat`);
  2. the host's usable cores (`len(os.sched_getaffinity(0))`);
  3. the inline `collate` of one mode-1 batch (decode into the uint8 wire
     images, label tensor, pose, calibration) with the dataset's decoder,
     img/s, and what the training CLI's main thread still spends on the
     wire of that batch (`images_to_wire`, which hands collate's uint8
     images on unconverted), ms a batch;
  4. the `Loader`'s stall: a consumer that sleeps for each of `--step-ms`
     per batch (the card's measured step times) and records how long each
     `next()` waited; the first batch (the pipeline filling) apart from the
     mean of the others.

    python -m crossloc_tpu_torch.tools.loader_bench --step-ms 38.14 274.89

Prints a table, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from .. import data, native
from ..data.dataset import _load_image, _resize_height
from ..data.pipeline import Loader, images_to_wire


def rate(fn, paths, threads: int, repeat: int) -> float:
    """Best-of-`repeat` img/s of fn over `paths` on a pool of `threads`."""
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            for r in pool.map(fn, paths):
                if r is None:
                    raise RuntimeError("an image did not decode")
        best = min(best, time.perf_counter() - t0)
    return len(paths) / best


def loader_stall(dataset, batch: int, step_ms: float) -> dict:
    """Waits in ms of a consumer that spends `step_ms` per batch, behind the
    Loader the CLIs build (its default knobs)."""
    waits = []
    it = iter(Loader(dataset, batch, drop_last=True))
    while True:
        t0 = time.perf_counter()
        try:
            next(it)
        except StopIteration:
            break
        waits.append(1e3 * (time.perf_counter() - t0))
        time.sleep(step_ms / 1e3)
    rest = waits[1:]
    return {"first_ms": waits[0], "stall_ms": sum(rest) / len(rest) if rest else None,
            "batches": len(waits)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 720), metavar=("H", "W"))
    ap.add_argument("--image-height", type=int, default=480, help="the decode target height")
    ap.add_argument("--threads", type=int, nargs="+", default=(1, 2, 4, 8))
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--step-ms", type=float, nargs="+", required=True,
                    help="consumer time per batch, e.g. the card's measured step times")
    ap.add_argument("--workdir", default=None, help="default: a temporary directory")
    args = ap.parse_args(argv)

    cores = len(os.sched_getaffinity(0))
    h, w = args.size
    out = {"metric": "loader_bench", "unit": "img/s", "usable_cores": cores,
           "cpu_count": os.cpu_count(), "frames": args.frames, "size": [h, w],
           "image_height": args.image_height,
           "native": native.available(), "native_build_s": native.build_seconds,
           "native_error": (native.build_error() or "").splitlines()[:1]}
    print(f"usable cores {cores} (cpu_count {os.cpu_count()}); {args.frames} noise-scene "
          f"frames at {h}x{w} to height {args.image_height}; best of {args.repeat}")
    with tempfile.TemporaryDirectory(dir=args.workdir) as tmp:
        root = os.path.join(tmp, "train_sim")
        t0 = time.perf_counter()
        data.write_fake_dataset(root, n=args.frames, img_h=h, img_w=w, focal=480.0, seed=0)
        out["write_s"] = time.perf_counter() - t0
        rgb = os.path.join(root, "rgb")
        paths = [os.path.join(rgb, f) for f in sorted(os.listdir(rgb))]
        ih = args.image_height
        decoders = {"PIL": lambda p: _resize_height(_load_image(p), ih)}
        if native.available():
            decoders["native"] = lambda p: native.load_image_std_height(p, ih)
        else:
            print(f"native decoder unavailable: {native.build_error()}")
        print(f"{'decoder':>8} " + " ".join(f"{n:>4} thr" for n in args.threads) + "  (img/s)")
        for name, fn in decoders.items():
            rates = [rate(fn, paths, n, args.repeat) for n in args.threads]
            for n, r in zip(args.threads, rates):
                out[f"{name.lower()}_t{n}"] = r
            print(f"{name:>8} " + " ".join(f"{r:8.1f}" for r in rates))

        ds = data.CamLocDataset(root, mode=1, image_height=ih)
        idx = list(range(min(args.batch, len(ds))))
        best, wire = float("inf"), float("inf")
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            batch = ds.collate(idx)
            t1 = time.perf_counter()
            images_to_wire(batch["image"])
            best = min(best, t1 - t0)
            wire = min(wire, time.perf_counter() - t1)
        out["collate_decoder"] = ds.decoder
        out["collate_inline"] = len(idx) / best
        out["wire_ms"] = 1e3 * wire
        print(f"collate of {len(idx)} mode-1 frames inline ({ds.decoder}): "
              f"{out['collate_inline']:.1f} img/s; their wire on the main thread {1e3 * wire:.3f} ms")

        out["loader"] = {}
        for step in args.step_ms:
            r = loader_stall(ds, args.batch, step)
            out["loader"][str(step)] = r
            stall = "n/a" if r["stall_ms"] is None else f"{r['stall_ms']:.2f} ms"
            print(f"Loader (num_workers=4, prefetch=2), B={args.batch}, "
                  f"{step} ms steps, {r['batches']} batches: first {r['first_ms']:.2f} ms, "
                  f"then {stall} a batch")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
