"""Logging helpers (port of llavamod_tpu/utils/logging.py): `rank0_print`,
`build_logger` and `StreamToLogger` (the reference's utils.py:50-91).

The rank is torch.distributed's where a process group is initialised, else
0, so a single process always prints.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

_handler = None


def process_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank0_print(*args, **kwargs):
    """Print only from rank 0."""
    if process_rank() == 0:
        print(*args, **kwargs)


def build_logger(logger_name: str, logger_filename: str,
                 log_dir: str = ".") -> logging.Logger:
    """A logger that mirrors into a daily-rotating file in `log_dir`; the
    file handler, made once per process, is added to every logger that
    exists then."""
    global _handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )

    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=logging.INFO, encoding="utf-8")
    for h in root.handlers:
        h.setFormatter(formatter)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if _handler is None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, logger_filename)
        _handler = logging.handlers.TimedRotatingFileHandler(
            path, when="D", utc=True, encoding="utf-8")
        _handler.setFormatter(formatter)
        for item in logging.root.manager.loggerDict.values():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)
    return logger


class StreamToLogger:
    """File-like shim that forwards whole lines written to it to a logger
    (for capturing stdout); other attributes are the terminal's."""

    def __init__(self, logger: logging.Logger, log_level: int = logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp = self.linebuf + buf
        self.linebuf = ""
        for line in temp.splitlines(True):
            if line.endswith("\n"):
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf:
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""
