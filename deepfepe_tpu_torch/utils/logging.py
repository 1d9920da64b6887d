"""Coloured console logging without dependencies.

Counterpart of `deepfepe_tpu/utils/logging.py` (the reference's
utils/logging.py: coloredlogs' install and the toRed/toCyan helpers), in
ANSI codes, plain where stdout is not a terminal.
"""

from __future__ import annotations

import logging
import sys

_COLORS = {
    "red": "31",
    "green": "32",
    "yellow": "33",
    "blue": "34",
    "magenta": "35",
    "cyan": "36",
}


def _wrap(text: str, color: str) -> str:
    if not sys.stdout.isatty():
        return text
    return f"\033[{_COLORS[color]}m{text}\033[0m"


def to_red(t: str) -> str:
    return _wrap(t, "red")


def to_green(t: str) -> str:
    return _wrap(t, "green")


def to_cyan(t: str) -> str:
    return _wrap(t, "cyan")


def to_yellow(t: str) -> str:
    return _wrap(t, "yellow")


class _ColorFormatter(logging.Formatter):
    LEVEL_COLORS = {
        logging.DEBUG: "blue",
        logging.INFO: "green",
        logging.WARNING: "yellow",
        logging.ERROR: "red",
        logging.CRITICAL: "magenta",
    }

    def format(self, record):
        msg = super().format(record)
        color = self.LEVEL_COLORS.get(record.levelno)
        return _wrap(msg, color) if color else msg


def install(level=logging.INFO, fmt="%(asctime)s %(levelname)s %(message)s"):
    """coloredlogs.install equivalent."""
    handler = logging.StreamHandler()
    handler.setFormatter(_ColorFormatter(fmt))
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(level)
    return root
