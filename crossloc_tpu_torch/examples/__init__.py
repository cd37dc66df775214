"""Runnable examples of the port: `quickstart.py` (train on a synthetic scene,
then localize) and `dress_rehearsal.sh` (the experiment matrix through the
unchanged bash harness)."""
