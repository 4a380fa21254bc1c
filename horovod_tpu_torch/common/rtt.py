"""Per-key round-trip-time EWMAs for adaptive liveness deadlines (port
of ``horovod_tpu/common/rtt.py``).

A fixed liveness window takes a slow but live rank for a dead one.  Each
rank samples the round trips of its heartbeats, folds them into an EWMA
and reports it with every beat; the coordinator widens that rank's
window by an RTT-proportional slack and, where a rank's RTT stays far
above the median, records a straggler verdict
(``ops/tcp_controller.py``).  The port's bytes travel over NCCL or gloo,
so the heartbeat is the only link sampled (the reference also samples
its TCP ring's chunk acks).
"""

import threading

from horovod_tpu_torch.utils import env as env_util

# the key of the control plane's round trips in the process's tracker
COORD_KEY = "coordinator"


class RttTracker:
    """Thread-safe per-key EWMA of durations (seconds).  ``alpha``
    (``HVD_TPU_RTT_ALPHA``) is the weight of the newest sample."""

    def __init__(self, alpha=None):
        if alpha is None:
            alpha = env_util.get_float(env_util.HVD_TPU_RTT_ALPHA,
                                       env_util.DEFAULT_RTT_ALPHA)
        self.alpha = min(max(float(alpha), 0.01), 1.0)
        self._ewma = {}                 # key -> seconds; guarded by self._lock
        self._lock = threading.Lock()

    def sample(self, key, seconds):
        if seconds < 0:
            return
        with self._lock:
            prev = self._ewma.get(key)
            self._ewma[key] = (seconds if prev is None
                               else prev + self.alpha * (seconds - prev))

    def worst(self) -> float:
        """The largest EWMA across keys: the figure a rank reports."""
        with self._lock:
            return max(self._ewma.values(), default=0.0)


def median(values):
    """Median of ``values`` (0.0 when empty): the straggler baseline, a
    rank is a straggler only relative to its peers."""
    vals = sorted(values)
    if not vals:
        return 0.0
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2.0


_tracker = None
_tracker_lock = threading.Lock()


def tracker() -> RttTracker:
    """The process's tracker (alpha read from the env on first use; a
    reconfiguration keeps its samples: the links did not change)."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = RttTracker()
        return _tracker
