"""Leveled console logging (counterpart of `morb_slam_tpu/utils/verbose.py`):
QUIET, NORMAL, VERBOSE, VERY_VERBOSE and DEBUG, QUIET by default; messages
go to stderr."""
from __future__ import annotations

import enum
import sys


class Level(enum.IntEnum):
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    VERY_VERBOSE = 3
    DEBUG = 4


_level = Level.QUIET


def set_level(level: Level):
    global _level
    _level = Level(level)


def get_level() -> Level:
    return _level


def print_mess(msg: str, level: Level = Level.NORMAL):
    """Print `msg` when the configured verbosity admits `level`."""
    if level <= _level:
        print(msg, file=sys.stderr, flush=True)
