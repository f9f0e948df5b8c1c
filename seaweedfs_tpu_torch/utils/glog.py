"""Leveled logging (reference weed/glog: V(n) verbosity, leveled
prefixes, one stream). Port of seaweedfs_tpu/utils/glog.py, whole.
Stdlib-logging-free on purpose: one process-wide verbosity knob
(SEAWEED_V), glog-style line format:

  I0729 12:34:56.789 volume_server] message
"""

from __future__ import annotations

import os
import sys
import threading
import time

_verbosity = int(os.environ.get("SEAWEED_V", "0"))
_lock = threading.Lock()


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v


def v_enabled(level: int) -> bool:
    return level <= _verbosity


def _emit(sev: str, component: str, msg: str) -> None:
    t = time.time()  # one read: HH:MM:SS and .ms must agree at boundaries
    ts = time.strftime("%m%d %H:%M:%S", time.localtime(t))
    ms = int((t % 1) * 1000)
    with _lock:
        sys.stderr.write(f"{sev}{ts}.{ms:03d} {component}] {msg}\n")
        sys.stderr.flush()


class Logger:
    """Per-component logger: glog.logger('master').info(...)"""

    def __init__(self, component: str):
        self.component = component

    def v(self, level: int, msg: str, *args) -> None:
        if v_enabled(level):
            _emit("I", self.component, msg % args if args else msg)

    def info(self, msg: str, *args) -> None:
        _emit("I", self.component, msg % args if args else msg)

    def warning(self, msg: str, *args) -> None:
        _emit("W", self.component, msg % args if args else msg)

    def error(self, msg: str, *args) -> None:
        _emit("E", self.component, msg % args if args else msg)


def logger(component: str) -> Logger:
    return Logger(component)
