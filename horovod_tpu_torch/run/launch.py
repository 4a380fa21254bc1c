"""Per-rank process launch: local subprocesses or ssh fan-out (port of
``horovod_tpu/run/launch.py``).

Reference: ``horovod/run/gloo_run.py:237`` ``launch_gloo``: one thread per
rank runs the (possibly ssh-prefixed) command with the env contract
(``gloo_run.py:152-157,261-273``); the first nonzero exit terminates every
other rank.

Under ``elastic=True`` a rank's failure that the job survives (not rank
0's, unless ``coord_failover``; ``min_ranks`` left) does not fire the
kill fan-out: the workers re-form the world without it and the launcher
supervises the survivors to their end.  The job's own fault spec feeds
culprit attribution (``fault_crash_ranks``): a rank it arms with a crash
is blamed even when its peers exit first.
"""

import os
import shlex
import signal as signal_mod
import sys
import threading

from horovod_tpu_torch.run import safe_shell_exec
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils.logging import get_logger


def describe_exit(code) -> str:
    """Human-readable exit status: negative Popen codes are signal
    deaths and deserve the signal's name, not a bare '-9'."""
    if code < 0:
        try:
            name = signal_mod.Signals(-code).name
        except ValueError:
            name = f"signal {-code}"
        return f"killed by {name}"
    return f"exit code {code}"


LOCAL_HOSTS = ("localhost", "127.0.0.1")


class _Tee:
    """Write to a rank's output file AND the launcher console.

    Reference: ``gloo_run.py`` ``MultiFile``: ``--output-filename``
    captures per-rank files without silencing the console.  The file
    is the primary sink; a dead console (e.g. BrokenPipeError after
    ``hvdrun-torch ... | head`` exits) must not truncate the file
    capture."""

    def __init__(self, primary, *mirrors):
        self._primary = primary
        self._mirrors = mirrors

    def write(self, data):
        self._primary.write(data)
        for s in self._mirrors:
            try:
                s.write(data)
            except (OSError, ValueError):
                pass

    def flush(self):
        self._primary.flush()
        for s in self._mirrors:
            try:
                s.flush()
            except (OSError, ValueError):
                pass


def slot_env(slot, rendezvous_addr, rendezvous_port, extra_env=None):
    """The worker env contract for one rank."""
    env = {
        env_util.HVD_RANK: str(slot.rank),
        env_util.HVD_SIZE: str(slot.size),
        env_util.HVD_LOCAL_RANK: str(slot.local_rank),
        env_util.HVD_LOCAL_SIZE: str(slot.local_size),
        env_util.HVD_CROSS_RANK: str(slot.cross_rank),
        env_util.HVD_CROSS_SIZE: str(slot.cross_size),
        env_util.HVD_RENDEZVOUS_ADDR: rendezvous_addr,
        env_util.HVD_RENDEZVOUS_PORT: str(rendezvous_port),
    }
    if extra_env:
        env.update(extra_env)
    return env


SECRET_ENV_VARS = (env_util.HVD_SECRET_KEY,)


def fault_crash_ranks(extra_env):
    """Ranks the job's own fault spec arms with a ``crash``: when the
    launcher injected the failure itself, the culprit is known by
    construction and no timing evidence can outvote it."""
    spec_text = (extra_env or {}).get(env_util.HVD_TPU_FAULT_SPEC)
    if not spec_text:
        return frozenset()
    from horovod_tpu_torch.common.faults import parse_fault_spec

    try:
        specs = parse_fault_spec(spec_text)
    except ValueError:
        return frozenset()  # the workers will fail loudly at init
    # preempt counts: with the drain off it kills the rank just like a
    # crash, and with the drain on the rank exits 0 and never appears in
    # the failure list at all
    return frozenset(s.rank for s in specs
                     if s.action in ("crash", "preempt")
                     and s.rank is not None)


def pick_culprit(failures, crash_ranks=frozenset()):
    """(rank, code) of the rank that broke the job.

    ``failures``: [(rank, code, was_victim, exit_ts)] in REAP order,
    which under machine load is not death order.  Attribution ranks by
    evidence, not arrival:

    1. a rank that exited 0 is never the culprit (callers only record
       nonzero exits, so this guard is defensive);
    2. victims of the kill fan-out are never culprits (all-victims is a
       launcher-interrupt edge case: fall back to the full list);
    3. a rank in ``crash_ranks`` (armed by the job's own fault spec) is
       the culprit by construction;
    4. otherwise the earliest ``exit_ts`` wins: the child observed dead
       first is the closest thing to the true first death.
    """
    failures = [f for f in failures if f[1] != 0] or list(failures)
    candidates = [f for f in failures if not f[2]] or list(failures)
    armed = [f for f in candidates if f[0] in crash_ranks]
    pool = armed or candidates
    first = min(enumerate(pool),
                key=lambda item: (item[1][3] is None,
                                  item[1][3], item[0]))[1]
    return first[0], first[1]


def _ssh_command(slot, command, env, ssh_port=None):
    """Build the remote launch command.  Secrets never appear on the remote
    command line (visible in ps/verbose logs); they travel over ssh stdin
    into a `read -r` in the remote shell.  Returns (command, stdin_data)."""
    secrets = {k: v for k, v in env.items() if k in SECRET_ENV_VARS}
    public = {k: v for k, v in env.items() if k not in SECRET_ENV_VARS}
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in public.items())
    port = f"-p {ssh_port} " if ssh_port else ""
    stdin_lines = "".join(f"{k}={v}\n" for k, v in secrets.items())
    reads = "".join(
        f"IFS= read -r {k}; export {k}=\"${{{k}#{k}=}}\"; "
        for k in secrets)
    inner = (f"{reads}cd {shlex.quote(os.getcwd())} && "
             f"{exports} {command}")
    cmd = (f"ssh -o StrictHostKeyChecking=no {port}"
           f"{slot.hostname} {shlex.quote(inner)}")
    return cmd, stdin_lines.encode() if stdin_lines else None


def launch_job(slots, command, rendezvous_addr, rendezvous_port,
               extra_env=None, ssh_port=None, verbose=False,
               output_filename=None, elastic=False, min_ranks=1,
               coord_failover=False) -> int:
    """Launch one process per slot; kill everything on first failure.
    Returns the CULPRIT's exit code (or 0): the first rank that failed
    on its own; ranks the kill-on-first-failure fan-out subsequently
    terminated report as victims (they die with signal codes like -15
    that would mask the real error if arrival order decided).

    ``output_filename``: a directory; each rank's stdout and stderr go
    to ``<dir>/rank.<NN>/stdout|stderr`` (``NN`` zero-padded to the
    width of ``len(slots) - 1``) and to the console.

    With ``elastic=True`` a non-rank-0 failure does not fire the kill
    fan-out: the workers re-form the world around the survivors, and
    the launcher supervises them to their end.  The fan-out still fires
    when rank 0 dies (it hosts the coordinator) or when fewer than
    ``min_ranks`` workers remain.  With ``coord_failover=True`` a rank-0
    loss is survivable too: the workers elect a new coordinator at the
    rendezvous.

    A SIGTERM delivered to the launcher itself (the platform preempting
    the whole allocation) is forwarded once to every worker process
    group, so that the workers can drain; an escalation timer then fires
    the ordinary kill fan-out after the ``HVD_TPU_TERM_GRACE`` window for
    anything still running."""
    log = get_logger()
    failure = threading.Event()
    drain = threading.Event()
    # [(rank, code, was_victim, exit_ts)] in reap order; culprit
    # attribution re-ranks by evidence, see pick_culprit
    failures = []
    failures_lock = threading.Lock()
    alive = [len(slots)]  # guarded by failures_lock

    def run_rank(slot):
        info = {}
        try:
            env = slot_env(slot, rendezvous_addr, rendezvous_port,
                           extra_env)
            stdin_data = None
            full_env = dict(os.environ)
            if slot.hostname in LOCAL_HOSTS:
                # local: secrets ride the process env, never a command
                # line
                full_env.update(env)
                cmd = command
            else:
                cmd, stdin_data = _ssh_command(slot, command, env,
                                               ssh_port)
            if verbose:
                log.warning("launching rank %d on %s: %s", slot.rank,
                            slot.hostname, cmd)
            out_f = err_f = None
            stdout, stderr = sys.stdout, sys.stderr
            try:
                if output_filename:
                    # reference layout (gloo_run.py MultiFile)
                    pad = len(str(max(len(slots) - 1, 1)))
                    rank_dir = os.path.join(
                        output_filename, f"rank.{slot.rank:0{pad}d}")
                    os.makedirs(rank_dir, exist_ok=True)
                    out_f = open(os.path.join(rank_dir, "stdout"), "w")
                    err_f = open(os.path.join(rank_dir, "stderr"), "w")
                    stdout = _Tee(out_f, sys.stdout)
                    stderr = _Tee(err_f, sys.stderr)
                code = safe_shell_exec.execute(
                    cmd, env=full_env, stdout=stdout, stderr=stderr,
                    events=[failure], stdin_data=stdin_data, info=info,
                    term_events=[drain])
            finally:
                for f in (out_f, err_f):
                    if f is not None:
                        f.close()
        except Exception as exc:  # noqa: BLE001 — a thread dying
            # silently would record no failure (reported success) while
            # sibling ranks hang waiting for this one
            log.error("launching rank %d failed: %s", slot.rank, exc)
            code = 1
        if code != 0:
            with failures_lock:
                # a rank that died nonzero AFTER the launcher forwarded
                # its drain SIGTERM is a victim of that signal, not a
                # failure of its own
                failures.append((slot.rank, code,
                                 info.get("terminated_by_event", False)
                                 or info.get("drained", False),
                                 info.get("exit_ts")))
                alive[0] -= 1
                survivors = alive[0]
            if (elastic and (slot.rank != 0 or coord_failover)
                    and survivors >= min_ranks):
                # the workers re-form around the remaining ranks (rank
                # 0's loss only with fail-over armed): keep supervising
                log.warning(
                    "rank %d failed (%s); elastic mode: supervising "
                    "%d surviving rank(s)", slot.rank,
                    describe_exit(code), survivors)
            else:
                failure.set()
        else:
            with failures_lock:
                alive[0] -= 1

    escalation = []  # [threading.Timer] so the success path can cancel

    def _on_sigterm(signum, frame):
        grace = safe_shell_exec.termination_grace_seconds()
        log.warning("SIGTERM: forwarding to all ranks, escalating to "
                    "the kill fan-out in %.1fs", grace)
        drain.set()
        timer = threading.Timer(grace, failure.set)
        timer.daemon = True
        timer.start()
        escalation.append(timer)

    prev_sigterm = None
    try:
        # signal.signal only works on the main thread; a launcher
        # embedded somewhere else simply doesn't get drain forwarding
        prev_sigterm = signal_mod.signal(signal_mod.SIGTERM,
                                         _on_sigterm)
    except ValueError:
        pass

    threads = [threading.Thread(target=run_rank, args=(s,), daemon=True)
               for s in slots]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except KeyboardInterrupt:
        # the interrupt lands here (main thread), not in the launcher
        # threads; without this, the driver exits and every child
        # (started in its own session, so it never sees the terminal's
        # SIGINT) keeps running, holding cards and ports
        log.warning("interrupted: terminating all ranks")
        failure.set()
        for t in threads:
            t.join(timeout=15)
        raise
    finally:
        for timer in escalation:
            timer.cancel()
        if prev_sigterm is not None:
            try:
                signal_mod.signal(signal_mod.SIGTERM, prev_sigterm)
            except ValueError:
                pass

    if drain.is_set() and not failures:
        log.warning("all ranks exited cleanly after SIGTERM")
    if failures and elastic and not failure.is_set():
        # every loss was absorbed by a reconfiguration and the survivors
        # ran to their end: the job succeeded
        log.warning("%d rank(s) were lost but the surviving ranks "
                    "completed after elastic reconfiguration",
                    len(failures))
        return 0
    if failures:
        # name the culprit: the first rank that failed on its own, not a
        # victim the fan-out terminated, ranked by when each child was
        # observed dead (see pick_culprit)
        rank, code = pick_culprit(failures, fault_crash_ranks(extra_env))
        log.error("rank %d failed first (%s); %d other rank(s) were "
                  "terminated", rank, describe_exit(code),
                  len(failures) - 1)
        return code
    return 0
