"""Logging, output directories, resume bookkeeping and section timers."""
from .profiling import StopWatch, device_sync, trace
from .io import (
    check_encoders,
    config_directory,
    config_log,
    get_epoch_from_dirname,
    get_unique_file_name,
    read_training_log,
    safe_printout,
    search_epoch_extension_model,
)

__all__ = [
    "StopWatch",
    "check_encoders",
    "config_directory",
    "config_log",
    "device_sync",
    "get_epoch_from_dirname",
    "get_unique_file_name",
    "read_training_log",
    "safe_printout",
    "search_epoch_extension_model",
    "trace",
]
