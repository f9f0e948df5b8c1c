"""Durability helpers: the fsync + atomic-rename + dir-fsync discipline
the reference applies to every published artifact (ec_decoder.go:44-90,
volume_vacuum.go:228). Port of seaweedfs_tpu/utils/fs.py, plus
`fsync_seconds`: an account of the wall seconds a block spends in fsync
(the leaf repair's `repair_patch.fsync` stage key)."""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

_account = threading.local()


def fsync(fd: int) -> None:
    """os.fsync, its wall seconds added to this thread's open
    `fsync_seconds` account, where there is one."""
    acc = getattr(_account, "seconds", None)
    if acc is None:
        os.fsync(fd)
        return
    t0 = time.perf_counter()
    try:
        os.fsync(fd)
    finally:
        acc[0] += time.perf_counter() - t0


@contextmanager
def fsync_seconds():
    """Account the wall seconds of this thread's fsyncs made through
    `fsync` (and so through `fsync_dir` and `atomic_write`) inside the
    block: yields a one-item list holding their sum. An enclosing account
    gets the same seconds too."""
    outer = getattr(_account, "seconds", None)
    acc = [0.0]
    _account.seconds = acc
    try:
        yield acc
    finally:
        _account.seconds = outer
        if outer is not None:
            outer[0] += acc[0]


def fsync_dir(path: str) -> None:
    """fsync the directory containing `path` so renames survive power loss."""
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        fsync(dirfd)
    finally:
        os.close(dirfd)


def atomic_write(path: str, data: bytes) -> None:
    """Write-temp + fsync + rename + dir-fsync publication."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
