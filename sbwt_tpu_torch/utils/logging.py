"""Timestamped logging, mirroring the reference operator experience.

Equivalent of write_log/LogLevel (include/sbwt/globals.hh:61-70,
src/globals.cpp:85-105): seconds-since-start stderr lines gated by a
global level.
"""
from __future__ import annotations

import sys
import time
from enum import IntEnum


class LogLevel(IntEnum):
    OFF = 0
    MAJOR = 1
    MINOR = 2
    DEBUG = 3


_START = time.monotonic()
_LEVEL = LogLevel.MAJOR


def set_log_level(level: LogLevel):
    global _LEVEL
    _LEVEL = level


def get_log_level() -> LogLevel:
    return _LEVEL


def write_log(message: str, level: LogLevel = LogLevel.MAJOR):
    if level <= _LEVEL:
        elapsed = time.monotonic() - _START
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        sys.stderr.write(f"{ts} ({elapsed:.2f}s): {message}\n")
        sys.stderr.flush()


def cur_time_micros() -> int:
    return int(time.time() * 1e6)
