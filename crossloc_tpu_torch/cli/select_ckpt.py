"""Checkpoint-selection CLI: rank the results files of a directory and
write `FLAG_SELECTED_ITER_*.nodata` (counterpart of
`crossloc_tpu/cli/select_ckpt.py`)."""
from __future__ import annotations

import argparse

from ..eval import select_checkpoint


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", type=str, required=True,
                        help='"coord", "depth", "normal" or "semantics"')
    parser.add_argument("--work_dir", type=str, default=".",
                        help="directory holding results_*task_*.txt")
    args = parser.parse_args(argv)
    flag = select_checkpoint(args.task, args.work_dir)
    print("\nCheckpoint selection flag is saved at: {:s}".format(flag))
    return flag


if __name__ == "__main__":
    main()
