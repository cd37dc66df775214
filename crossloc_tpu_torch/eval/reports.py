"""Result writers with exact textual-format parity (counterpart of
`crossloc_tpu/eval/reports.py`, coord task).

The strings are regex-scraped by the checkpoint selector
(`script_clean_validation/select_ckpt.py`) and by downstream tooling, so the
formats of the reference's `utils/evaluation.py:193-244` are kept verbatim.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def scene_coords_report(
    t_err_ls: Sequence[float],
    r_err_ls: Sequence[float],
    est_xyz_ls: Sequence[Sequence[float]],
    coords_error_ls: Sequence[np.ndarray],
    testing_log: str,
    network_path: str,
    section: str,
    file_name_ls: Sequence[str],
) -> str:
    """Pose accuracy buckets + medians + coord regression stats
    (`scene_coords_printout`, `utils/evaluation.py:193-244`)."""
    t = np.asarray(t_err_ls)
    r = np.asarray(r_err_ls)
    xyz = np.stack([np.asarray(x) for x in est_xyz_ls], axis=0)
    coords_error = np.concatenate([np.asarray(c).ravel() for c in coords_error_ls])

    pct30_10 = np.sum((t < 30.0) & (r < 10.0))
    pct20_10 = np.sum((t < 20.0) & (r < 10.0))
    pct10_10 = np.sum((t < 10.0) & (r < 10.0))
    pct10_7 = np.sum((t < 10.0) & (r < 7.0))
    pct5 = np.sum((t < 5.0) & (r < 5.0))
    pct3 = np.sum((t < 3.0) & (r < 3.0))
    n = len(t)

    eval_str = "\nAccuracy:"
    eval_str += "\n30m10deg: %.1f%%\n20m10deg: %.1f%%" % (pct30_10 / n * 100, pct20_10 / n * 100)
    eval_str += "\n10m7deg: %.1f%%" % (pct10_7 / n * 100)
    eval_str += "\n10m10deg: %.1f%%" % (pct10_10 / n * 100) + "\n5m5deg: %.1f%%" % (pct5 / n * 100)
    eval_str += "\n3m3deg: %.1f%%" % (pct3 / n * 100)
    eval_str += "\nMedian Error: %.1f deg, %.2f m" % (np.median(r), np.median(t))
    eval_str += "\nMean Errors: %.1f plus-minus %.1f deg, %.2f plus-minus %.2f m" % (
        np.mean(r), np.std(r), np.mean(t), np.std(t))
    eval_str += "\nCoordinate regression error: mean {:.1f}, std {:.1f}, median {:.1f}".format(
        np.mean(coords_error), np.std(coords_error), np.median(coords_error))

    with open(testing_log, "a") as f:
        f.write("{:s} Evaluation on section {:s} {:s}".format("=" * 20, section, "=" * 20) + "\n")
        f.write(eval_str)
        f.write("\n")

    base = os.path.basename(network_path)
    out_dir = os.path.dirname(network_path)
    np.save(os.path.join(out_dir, "{:s}_{:s}_out_xyz_poses.npy".format(section, base)), xyz)
    # Per-frame (t, r) errors for CDF plotting (`visualize.py:159-204` reads
    # per-frame error arrays); [N, 2] columns = translation m, rotation deg.
    np.save(
        os.path.join(out_dir, "{:s}_{:s}_pose_errors.npy".format(section, base)),
        np.stack([t, r], axis=1),
    )
    with open(os.path.join(out_dir, "{:s}_{:s}_out_xyz_poses.txt".format(section, base)), "w") as f:
        for file, pose_xyz in zip(file_name_ls, xyz):
            f.write(file + " {:.2f} {:.2f} {:.2f}".format(*pose_xyz) + "\n")
    return eval_str
