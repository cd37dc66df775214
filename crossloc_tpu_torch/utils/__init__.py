"""Logging, output directories and resume bookkeeping."""
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
    "check_encoders",
    "config_directory",
    "config_log",
    "get_epoch_from_dirname",
    "get_unique_file_name",
    "read_training_log",
    "safe_printout",
    "search_epoch_extension_model",
]
