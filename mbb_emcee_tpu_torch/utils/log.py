"""Package logging: messages go through the standard `logging` module under
the "mbb_emcee_tpu_torch" logger; `enable_console()` prints them as plain
lines on stdout for the CLI and for `verbose=True` library calls."""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("mbb_emcee_tpu_torch")


class _StdoutHandler(logging.Handler):
    """Writes each record to the sys.stdout of the moment it is emitted,
    so redirecting stdout after the handler exists still works."""

    def emit(self, record):
        print(self.format(record), file=sys.stdout, flush=True)


def enable_console(level=logging.INFO):
    """Attach a plain-format stdout handler once and set the level; returns
    the package logger."""
    if not logger.handlers:
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(level)
    return logger
