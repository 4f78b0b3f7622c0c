"""An exclusive file lock around a build, shared by the kernel build
(ops/_build.py) and the native data helpers (data/native.py)."""

from __future__ import annotations

import contextlib
import fcntl
from pathlib import Path


@contextlib.contextmanager
def build_lock(directory: Path):
    """An exclusive lock on `directory`/lock for a build: concurrent
    processes (the ranks of a run started together) take turns, so the
    first builds and the others find its result."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield
