"""Graceful drain: turn SIGTERM (the preemption notice) into a planned
departure instead of a crash (port of ``horovod_tpu/common/drain.py``).

The handler marks the process draining, and a notifier thread announces
the departure to the coordinator (``ControlPlane.request_drain`` ->
``DrainMsg``).  The coordinator exempts the rank from liveness blame,
plans a reconfiguration without it, waits for a collective boundary of
the eager plane, and publishes the drain-marked directive.  The
survivors re-form by the ordinary elastic path; the draining rank meets
the directive at its next collective, tears down, and leaves with
:class:`~horovod_tpu_torch.common.handles.HvdDrainedError`: exit 0 and
no ``HvdAbortedError`` anywhere.

When the coordinator refuses the drain (rank 0 without fail-over,
elastic off, too few survivors) the preemption is not survivable: the
process exits 143 (SIGTERM's conventional code), which the launcher
attributes as it would the real preemption's death.
"""

import os
import signal
import sys
import threading

from horovod_tpu_torch.common import busy

_requested = threading.Event()
_installed_lock = threading.Lock()
_installed = False


def requested() -> bool:
    """Whether this process has received its preemption notice."""
    return _requested.is_set()


def _notify(get_plane):
    # announcing and waiting for the coordinator's boundary can take
    # seconds: it must not read as death
    with busy.window():
        plane = get_plane()
        ok = False
        if plane is not None:
            try:
                ok = plane.request_drain()
            except Exception as exc:  # noqa: BLE001 — a dead coordinator
                # while this rank is preempted: nothing to drain into
                print(f"[hvd-drain] drain announce failed: {exc}",
                      file=sys.stderr, flush=True)
    if ok:
        print("[hvd-drain] departure announced; leaving at the next "
              "collective boundary", file=sys.stderr, flush=True)
        return
    print("[hvd-drain] drain refused/impossible; exiting as preempted",
          file=sys.stderr, flush=True)
    os._exit(143)


def install(get_plane) -> bool:
    """Install the SIGTERM handler (``hvd.init()`` calls it above one
    rank when ``HVD_TPU_DRAIN`` is on).  ``get_plane`` is resolved when
    the signal arrives: a reconfiguration replaces the control plane,
    and the drain must talk to the current one.  -> False when the
    handler could not be installed (not the main thread)."""
    global _installed
    with _installed_lock:
        if _installed:
            return True

        def _handler(signum, frame):
            if _requested.is_set():
                return  # a second notice: the drain is in flight
            _requested.set()
            # lifecycle: daemon, fire-and-forget; it returns after the
            # announce or ends the process itself
            threading.Thread(target=_notify, args=(get_plane,),
                             name="hvd-torch-drain", daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _handler)
        except ValueError:
            # not the main thread (an embedded init): no drain, SIGTERM
            # keeps its previous disposition
            return False
        _installed = True
        return True
