"""Training curves, keyword series, pose-error CDFs and the semantics grid
(counterpart of `crossloc_tpu/cli/visualize.py`, same functions, arguments,
regexes and file names).

Extracts per-iteration loss and valid-rate from `output.log` by regex,
plots moving-average curves, and renders CDF histograms of pose errors from
`*_pose_errors.npy` files and `--save_pred` dumps. matplotlib is imported
inside the plotting functions only: parsing needs numpy alone.

    python -m crossloc_tpu_torch.cli.visualize output/<run>/output.log
    python -m crossloc_tpu_torch.cli.visualize --pose_errors output/<run>
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np


LOG_PATTERN = (
    r"Iteration:\s+(?P<iter>\d+), Epoch:\s+(?P<epoch>\d+), Total loss:\s+"
    r"(?P<loss>[-\d.]+), Valid:\s+(?P<valid>[\d.]+)%, Avg Time:\s+(?P<time>[\d.]+)s"
)


def parse_training_log(log_path: str) -> dict:
    """Extract iteration / epoch / loss / valid-rate / time series."""
    with open(log_path) as f:
        text = f.read()
    rows = re.findall(LOG_PATTERN, text)
    if not rows:
        return {k: np.zeros(0) for k in ("iteration", "epoch", "loss", "valid_rate", "time")}
    arr = np.asarray([[float(x) for x in row] for row in rows])
    return {
        "iteration": arr[:, 0],
        "epoch": arr[:, 1],
        "loss": arr[:, 2],
        "valid_rate": arr[:, 3],
        "time": arr[:, 4],
    }


def moving_average(x: np.ndarray, w: int = 100) -> np.ndarray:
    if len(x) == 0:
        return x
    w = max(1, min(w, len(x)))
    return np.convolve(x, np.ones(w) / w, mode="valid")


def plot_training_curves(log_path: str, out_path: str = None, window: int = 100):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = parse_training_log(log_path)
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    for ax, key, label in zip(axes, ("loss", "valid_rate"), ("Total loss", "Valid rate (%)")):
        y = moving_average(series[key], window)
        x = series["iteration"][len(series[key]) - len(y):]
        ax.plot(x, y)
        ax.set_xlabel("iteration")
        ax.set_ylabel(label)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    out_path = out_path or os.path.join(os.path.dirname(os.path.abspath(log_path)), "training_curves.png")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_pose_error_cdf(t_errs, r_errs, out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    units = ("m", "deg")
    for ax, errs, label, unit in zip(
            axes, (t_errs, r_errs), ("translation error (m)", "rotation error (deg)"), units):
        e = np.sort(np.asarray(errs))
        cdf = np.arange(1, len(e) + 1) / len(e)
        ax.plot(e, cdf)
        med = float(np.median(e))
        # median marker line, as in the reference CDF plot (visualize.py:185-189)
        ax.axvline(med, color="tab:orange", label="Median={:.2f}{:s}".format(med, unit))
        ax.set_xlabel(label)
        ax.set_ylabel("Cumulative probability")
        ax.set_ylim([0, 1])
        ax.legend(loc="center right")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def semantic_plotter(image, class_prediction, gt_label, network_path, section, batch_idx):
    """Qualitative semantics grid: RGB | prediction | ground truth
    (parity with `semantic_plotter`, `utils/evaluation.py:417-445`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    image = np.asarray(image)
    class_prediction = np.asarray(class_prediction)
    gt_label = np.asarray(gt_label)
    if gt_label.ndim == 4:
        gt_label = gt_label[..., 0]
    B = image.shape[0]
    fig, axes = plt.subplots(B, 3, figsize=(9, 3 * B), squeeze=False)
    for row in range(B):
        axes[row, 0].imshow(np.clip(image[row], 0, 1))
        axes[row, 1].imshow(class_prediction[row], vmin=0, vmax=6)
        axes[row, 2].imshow(gt_label[row], vmin=0, vmax=6)
        for col in range(3):
            axes[row, col].axis("off")
    plt.subplots_adjust(wspace=0.01, hspace=0.01)
    out = os.path.abspath(os.path.join(
        network_path, "..", "sm_section_{:s}_batch_{:d}.png".format(section, batch_idx)))
    fig.savefig(out, bbox_inches="tight", pad_inches=0.1, dpi=150)
    plt.close(fig)
    return out


def extract_keyword_series(log_path: str, keyword: str) -> np.ndarray:
    """All numeric values following '<keyword>:' in the log (parity with
    the reference's --keywords extraction, `visualize.py:29,40-78`)."""
    with open(log_path) as f:
        text = f.read()
    vals = re.findall(re.escape(keyword) + r":\s*(-?[\d.]+)", text)
    return np.asarray([float(v) for v in vals])


def plot_keywords(log_path: str, keywords, out_path=None, window: int = 100):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(keywords), figsize=(6 * len(keywords), 4), squeeze=False)
    for ax, kw in zip(axes[0], keywords):
        y = moving_average(extract_keyword_series(log_path, kw), window)
        ax.plot(y)
        ax.set_title(kw)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    out_path = out_path or os.path.join(
        os.path.dirname(os.path.abspath(log_path)), "keywords.png")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def load_pose_errors(paths):
    """Collect per-frame (t_err, r_err) arrays from eval artifacts.

    Accepts any mix of `*_pose_errors.npy` files ([N, 2] t/r written by
    `eval.reports.scene_coords_report`), `--save_pred` npz dumps
    (keys `pose_t_err`/`pose_r_err`), and directories (recursively globbed
    for both). Analog of the reference's per-run error arrays fed to
    `plot_results_info` (`visualize.py:159-204`)."""
    import glob

    t_errs, r_errs = [], []

    def _consume(path):
        if path.endswith(".npz"):
            with np.load(path) as z:
                if "pose_t_err" in z and "pose_r_err" in z:
                    t_errs.append(np.atleast_1d(np.asarray(z["pose_t_err"], np.float64)))
                    r_errs.append(np.atleast_1d(np.asarray(z["pose_r_err"], np.float64)))
        else:
            arr = np.asarray(np.load(path), np.float64).reshape(-1, 2)
            t_errs.append(arr[:, 0])
            r_errs.append(arr[:, 1])

    for p in paths:
        if os.path.isdir(p):
            # One source per CONTAINING directory: *_pose_errors.npy is
            # authoritative; --save_pred npz dumps are a fallback only for
            # directories with no npy (a dir holding both artifacts for the
            # same run would otherwise double-count every frame and shift
            # the CDF medians). The preference is per-directory, not
            # per-tree: a parent dir mixing npy-producing runs with older
            # npz-only runs must keep the npz-only runs' frames.
            npys = sorted(
                glob.glob(os.path.join(p, "**", "*_pose_errors.npy"), recursive=True)
            )
            npy_dirs = {os.path.dirname(os.path.abspath(h)) for h in npys}
            root = os.path.abspath(p)

            def _covered(path):
                # npz dumps live in <run>/coord_pred_*/ below the run dir
                # holding the npy — suppress them if ANY ancestor (within
                # the searched root) already contributed an npy
                d = os.path.dirname(path)
                while len(d) >= len(root):
                    if d in npy_dirs:
                        return True
                    d = os.path.dirname(d)
                return False

            npzs = sorted(
                h for h in glob.glob(os.path.join(p, "**", "*.npz"), recursive=True)
                if not _covered(os.path.abspath(h))
            )
            for h in npys + npzs:
                _consume(h)
        else:
            _consume(p)
    if not t_errs:
        raise FileNotFoundError(
            "no pose-error artifacts (*_pose_errors.npy / pred *.npz) in %s" % (paths,)
        )
    return np.concatenate(t_errs), np.concatenate(r_errs)


def main(argv=None):
    parser = argparse.ArgumentParser()
    # positional log path like the reference (`visualize.py:27`); --log kept
    parser.add_argument("log_path", type=str, nargs="?", default=None)
    parser.add_argument("--log", type=str, default=None, help="path to output.log")
    parser.add_argument("--keywords", type=str, default=None, nargs="+",
                        help="plot arbitrary '<keyword>: <value>' series from the log")
    parser.add_argument("--pose_errors", type=str, default=None, nargs="+",
                        help="*_pose_errors.npy files, --save_pred npz dumps, or "
                             "directories thereof; renders pose-error CDFs "
                             "(reference visualize.py:159-204)")
    parser.add_argument("--window", type=int, default=100, help="moving-average window")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    log = args.log_path or args.log
    if args.pose_errors:
        t_errs, r_errs = load_pose_errors(args.pose_errors)
        first = args.pose_errors[0]
        base_dir = first if os.path.isdir(first) else os.path.dirname(os.path.abspath(first))
        out = plot_pose_error_cdf(
            t_errs, r_errs, args.out or os.path.join(base_dir, "results_info.png"))
        print("Saved pose-error CDF ({:d} frames, median {:.2f} m / {:.2f} deg) to {:s}".format(
            len(t_errs), float(np.median(t_errs)), float(np.median(r_errs)), out))
    elif log and args.keywords:
        out = plot_keywords(log, args.keywords, args.out, args.window)
        print("Saved keyword plots to", out)
    elif log:
        out = plot_training_curves(log, args.out, args.window)
        print("Saved training curves to", out)


if __name__ == "__main__":
    main()
