"""Busy windows: tell the liveness scan "slow, not dead" (port of
``horovod_tpu/common/busy.py``).

A rank inside a checkpoint write or a drain's teardown can hold its
heartbeat thread behind I/O for longer than the liveness window.  The
heartbeat thread stamps every ``HeartbeatMsg`` with :func:`active`, and
the coordinator doubles the liveness window of a rank whose last beat
was busy.  Windows nest.
"""

import contextlib
import threading

_lock = threading.Lock()
_depth = 0


@contextlib.contextmanager
def window():
    """Mark this process busy (slow I/O expected) for the duration."""
    global _depth
    with _lock:
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


def active() -> bool:
    with _lock:
        return _depth > 0
