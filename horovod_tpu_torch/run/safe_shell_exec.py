"""Process-tree-safe command execution (port of
``horovod_tpu/run/safe_shell_exec.py``).

Reference: ``horovod/run/common/util/safe_shell_exec.py`` — spawn the child
in its own process group, stream stdout/stderr, and on termination (parent
death, interrupt, sibling failure) kill the WHOLE tree so no orphan workers
linger on remote hosts.
"""

import os
import signal
import subprocess
import threading
import time

from horovod_tpu_torch.utils import env as env_util

GRACEFUL_TERMINATION_TIME_S = 5


def termination_grace_seconds() -> float:
    """The SIGTERM->SIGKILL escalation window.  Read at escalation time
    (not import time) so HVD_TPU_TERM_GRACE set by the runner's config
    surface is honored."""
    return env_util.get_float(env_util.HVD_TPU_TERM_GRACE,
                              float(GRACEFUL_TERMINATION_TIME_S))


def _forward_stream(pipe, sink):
    for line in iter(pipe.readline, b""):
        sink.write(line.decode(errors="replace"))
        sink.flush()
    pipe.close()


def signal_process_group(proc, sig) -> bool:
    """Deliver ``sig`` to the child's process group without escalation.

    The launcher's drain path uses this to forward its own SIGTERM (the
    preemption notice) to workers that are expected to exit 0 on their
    own; returns False when the group is already gone."""
    if proc.poll() is not None:
        return False
    try:
        os.killpg(os.getpgid(proc.pid), sig)
        return True
    except ProcessLookupError:
        return False


def terminate_process_group(proc, grace=None):
    """SIGTERM the child's process group, escalate to SIGKILL after the
    grace window (HVD_TPU_TERM_GRACE, default 5s)."""
    if proc.poll() is not None:
        return
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    if grace is None:
        grace = termination_grace_seconds()
    try:
        os.killpg(pgid, signal.SIGTERM)
        proc.wait(timeout=grace)
    except (subprocess.TimeoutExpired, ProcessLookupError):
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def execute(command, env=None, stdout=None, stderr=None,
            events=None, stdin_data=None, info=None,
            term_events=None) -> int:
    """Run ``command`` (shell string or argv list) in a new process group.

    ``events``: optional list of ``threading.Event``; if any fires, the
    process tree is terminated (the launcher uses this to kill all ranks
    when one fails, reference: gloo_run.py:300-308).
    ``term_events``: like ``events`` but drain-grade — the fired event
    forwards ONE SIGTERM to the process group and does NOT escalate:
    the worker is trusted to drain and exit 0 on its own (the launcher's
    escalation timer, armed with the HVD_TPU_TERM_GRACE window, is the
    backstop).  Sets ``info["drained"]`` True when forwarded.
    ``stdin_data``: bytes written to the child's stdin then closed (used to
    ship the job secret to ssh-launched ranks without putting it on the
    remote command line).
    ``info``: optional dict; ``info["terminated_by_event"]`` is set True
    when the tree was killed by a fired event while still running — the
    launcher uses it to tell the CULPRIT rank (failed on its own) from
    the VICTIMS it subsequently terminated, so the job's reported
    failure names the rank that actually broke.  ``info["exit_ts"]`` is
    the monotonic time ``wait()`` observed the child dead — recorded
    BEFORE the stream forwarders drain (their joins take seconds under
    load), so the launcher can rank failures by when ranks actually
    died instead of by reap order.
    Returns the exit code.
    """

    shell = isinstance(command, str)
    proc = subprocess.Popen(
        command, shell=shell, env=env, start_new_session=True,
        stdin=subprocess.PIPE if stdin_data is not None else None,
        stdout=subprocess.PIPE if stdout is not None else None,
        stderr=subprocess.PIPE if stderr is not None else None)
    if stdin_data is not None:
        try:
            proc.stdin.write(stdin_data)
            proc.stdin.close()
        except BrokenPipeError:
            pass

    forwarders = []
    if stdout is not None:
        t = threading.Thread(target=_forward_stream,
                             args=(proc.stdout, stdout), daemon=True)
        t.start()
        forwarders.append(t)
    if stderr is not None:
        t = threading.Thread(target=_forward_stream,
                             args=(proc.stderr, stderr), daemon=True)
        t.start()
        forwarders.append(t)

    stop_watch = threading.Event()
    # monotonic time a drain SIGTERM was forwarded (None: never).  The
    # escalation watcher CLIPS its grace to what is left of the window
    # that started at this instant: without the clip, drain-then-
    # escalate granted the tree TWO full grace windows (one armed by
    # the launcher's timer after the forward, then a fresh one inside
    # terminate_process_group) — a preempted-but-wedged worker held the
    # whole job for 2x HVD_TPU_TERM_GRACE.
    term_state = {"ts": None}
    watchers = []
    for event in events or []:
        def watch(event=event):
            while not stop_watch.is_set():
                if event.wait(timeout=0.1):
                    if info is not None and proc.poll() is None:
                        info["terminated_by_event"] = True
                    grace = None
                    if term_state["ts"] is not None:
                        grace = max(0.0, term_state["ts"]
                                    + termination_grace_seconds()
                                    - time.monotonic())
                    terminate_process_group(proc, grace=grace)
                    return
        t = threading.Thread(target=watch, daemon=True)
        t.start()
        watchers.append(t)
    for event in term_events or []:
        def watch_term(event=event):
            while not stop_watch.is_set():
                if event.wait(timeout=0.1):
                    if signal_process_group(proc, signal.SIGTERM):
                        term_state["ts"] = time.monotonic()
                        if info is not None:
                            info["drained"] = True
                            info["term_ts"] = term_state["ts"]
                    return
        t = threading.Thread(target=watch_term, daemon=True)
        t.start()
        watchers.append(t)

    try:
        proc.wait()
    except KeyboardInterrupt:
        terminate_process_group(proc)
        raise
    finally:
        stop_watch.set()
        if info is not None:
            info["exit_ts"] = time.monotonic()
    for t in forwarders:
        t.join(timeout=5)
    return proc.returncode
