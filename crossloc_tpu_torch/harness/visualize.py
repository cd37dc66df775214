#!/usr/bin/env python3
"""The port's `visualize.py` for the unchanged bash harness, which calls
`python3 visualize.py` in its working directory: link this file there (as
`examples/dress_rehearsal.sh` links the JAX package's root shims). The
repository root is found from this file's real path, so no PYTHONPATH is
needed."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(__file__)))))

from crossloc_tpu_torch.cli.visualize import main  # noqa: E402

if __name__ == "__main__":
    main()
