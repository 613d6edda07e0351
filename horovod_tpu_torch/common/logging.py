"""Leveled logging with a per-rank prefix.

A copy of ``horovod_tpu/common/logging.py`` (:1-84) with a plain
``threading.Lock`` where the reference takes a ``lockdep`` lock (the
lock-order sanitizer is not ported). The level comes from
``HOROVOD_LOG_LEVEL`` (trace/debug/info/warning/error/fatal);
``HOROVOD_LOG_HIDE_TIME`` drops the timestamps.
"""

from __future__ import annotations

import sys
import threading
import time

from horovod_tpu_torch.common import config as hconfig

TRACE, DEBUG, INFO, WARNING, ERROR, FATAL = range(6)

_LEVEL_NAMES = ["trace", "debug", "info", "warning", "error", "fatal"]
_lock = threading.Lock()


def _level_of(name: str) -> int:
    try:
        return _LEVEL_NAMES.index(name.lower())
    except ValueError:
        return WARNING


_min = _level_of(hconfig.env_str("HOROVOD_LOG_LEVEL", "warning"))


def set_level(name: str) -> None:
    """Set the level (``init`` applies ``Config.log_level`` here)."""
    global _min
    _min = _level_of(name)


def log(level: int, msg: str, rank: int | None = None) -> None:
    if level < _min:
        return
    parts = []
    if not hconfig.env_bool("HOROVOD_LOG_HIDE_TIME", False):
        t = time.time()
        parts.append(time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t))
                     + ".%06d" % int((t % 1) * 1e6))
    if rank is not None:
        parts.append("[%d]" % rank)
    parts.append("[%s]" % _LEVEL_NAMES[level].upper())
    line = " ".join(parts) + " " + msg + "\n"
    with _lock:
        sys.stderr.write(line)
        sys.stderr.flush()


def warning(msg, rank=None):
    log(WARNING, msg, rank)


def error(msg, rank=None):
    log(ERROR, msg, rank)
