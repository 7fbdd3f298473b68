"""Stdout tee-logger (port of mtt_tpu/utils/logger.py): mirrors everything
printed to a log_file.txt with fsync."""

from __future__ import annotations

import os
import sys


class Logger:
    def __init__(self, fpath: str | None = None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
            self.file = open(fpath, "a")

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)
            self.file.flush()
            os.fsync(self.file.fileno())

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()

    def close(self):
        if self.file is not None:
            self.file.close()


def install(fpath: str):
    sys.stdout = Logger(fpath)
