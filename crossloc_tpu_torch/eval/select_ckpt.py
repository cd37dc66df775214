"""Checkpoint selection: scrape `results_*task_*.txt` and rank them
(counterpart of `crossloc_tpu/eval/select_ckpt.py`).

As the reference's `script_clean_validation/select_ckpt.py`: coord ranks by
median translation error, depth by median RMS, normal by median angular
error, semantics by mean IoU (descending); writes `results_overall.txt` and
a `FLAG_SELECTED_ITER_%07d.nodata` marker.
"""
from __future__ import annotations

import glob
import os
import re
from typing import List, Tuple

import numpy as np


def _iter_num(file_name: str) -> int:
    """'results_ckpt_iter_1108534.net_task_coord.txt' -> 1108534."""
    return int(os.path.basename(file_name).split(".net")[0].split("_")[-1])


def _last_match(pattern: str, log: str, path: str):
    found = re.findall(pattern, log)
    if not found:
        raise ValueError(f"{path} is wrong (no match for {pattern})")
    return found[-1]


def select_checkpoint(task: str, work_dir: str = ".") -> str:
    """Rank all results files for `task` in `work_dir`; returns the flag path."""
    txt_ls = sorted(glob.glob(os.path.join(work_dir, f"results_*task_{task}.txt")))
    if not txt_ls:
        raise FileNotFoundError(f"no results_*task_{task}.txt under {work_dir}")
    overall = os.path.join(work_dir, "results_overall.txt")

    rank_rows: List[Tuple] = []
    with open(overall, "w") as f:
        for path in txt_ls:
            f.write("\nThe results is from {:s}".format(path) + "\n")
            with open(path) as f_in:
                log = f_in.read()
            f.write(log)

            if task == "coord":
                r = _last_match(r"Median Error:\s+(\d+.\d+) deg, (\d+.\d+) m", log, path)
                med_r, med_t = float(r[0]), float(r[1])
                acc55 = float(_last_match(r"5m5deg: (\d+.\d+)%", log, path))
                acc107 = 0.0
                m = re.findall(r"10m7deg: (\d+.\d+)%", log)
                if m:
                    acc107 = float(m[-1])
                acc2010 = float(_last_match(r"20m10deg: (\d+.\d+)%", log, path))
                rank_rows.append((med_t, (med_r, med_t, acc55, acc107, acc2010)))
            elif task == "depth":
                ar = _last_match(
                    r"absolute relative error, mean:\s+(\d+.\d+)%, median:\s+(\d+.\d+)%", log, path
                )
                rms = _last_match(r"RMS error, mean:\s+(\d+.\d+)m, median:\s+(\d+.\d+)m", log, path)
                rank_rows.append((float(rms[1]), (float(ar[1]), float(rms[1]))))
            elif task == "normal":
                r = _last_match(
                    r"angular prediction error, mean:\s+(\d+.\d+) deg, median:\s+(\d+.\d+) deg",
                    log, path,
                )
                rank_rows.append((float(r[1]), (float(r[0]), float(r[1]))))
            elif task == "semantics":
                acc = _last_match(r"Pixel accuracy, mean:\s+(\d+.\d+), median:\s+(\d+.\d+)", log, path)
                miou = _last_match(r"Mean IoU, mean:\s+(\d+.\d+), median:\s+(\d+.\d+)", log, path)
                fwiou = _last_match(
                    r"Frequency weighted IoU, mean:\s+(\d+.\d+), median:\s+(\d+.\d+)", log, path
                )
                # higher mIoU is better -> negate the sort key
                rank_rows.append(
                    (-float(miou[1]), (float(acc[1]), float(miou[1]), float(fwiou[1])))
                )
            else:
                raise NotImplementedError(f"task={task}")

    idx_sort = np.argsort([row[0] for row in rank_rows], kind="stable")
    with open(overall, "a") as f:
        for rank, idx in enumerate(idx_sort):
            vals = rank_rows[idx][1]
            if task == "coord":
                s = "\nRank {:d}, median: {:.2f}m, {:.2f}deg. ".format(rank, vals[1], vals[0])
                s += "\nAcc5m5deg: {:.1f}%, Acc10m7deg: {:.1f}%, Acc20m10deg: {:.1f}%".format(
                    vals[2], vals[3], vals[4])
            elif task == "depth":
                s = "\nRank {:d}, median RMS: {:.2f}m, abs-rel: {:.1f}%. ".format(rank, vals[1], vals[0])
            elif task == "normal":
                s = "\nRank {:d}, median prediction error: {:.1f}deg. ".format(rank, vals[1])
            else:
                s = "\nRank {:d}, median FwIOU: {:.2f}, median mIOU: {:.2f}, median accuracy: {:.2f} ".format(
                    rank, vals[2], vals[1], vals[0])
            s += "\nfile: {:s}".format(txt_ls[idx])
            f.write(s)

    best = txt_ls[idx_sort[0]]
    flag_path = os.path.join(work_dir, "FLAG_SELECTED_ITER_{:07d}.nodata".format(_iter_num(best)))
    with open(flag_path, "w") as f:
        f.write("This is a dummy file.")
    return flag_path
