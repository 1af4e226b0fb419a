"""Bulk table IO on the host: a C parser and threaded directory loads."""
from mind_the_gaps_tpu_torch.io.fastio import (
    build_native,
    have_native,
    load_columns,
    load_directory,
    load_table,
)

__all__ = ["load_table", "load_columns", "load_directory", "have_native", "build_native"]
