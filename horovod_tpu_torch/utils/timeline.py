"""Chrome-tracing timeline of the collectives' lifecycles (port of
``horovod_tpu/utils/timeline.py``).

Enabled by ``HVD_TIMELINE=<file>``: one trace row (pid) per tensor name,
phases ``NEGOTIATE_<OP>`` (with a tick a rank as its submission shows up)
then ``<OP>``, ending with an output-size annotation; ``CYCLE`` marks
under ``HVD_TIMELINE_MARK_CYCLES``.  The records are the JAX package's,
so that a file written by either package merges with the other's code.
A writer thread drains an unbounded queue, so the hot path never blocks
on file IO.  Load the output in ``chrome://tracing`` or Perfetto.

What is new here is the card: a collective returns once it is *issued*
on a CUDA stream, so a span that ended there would record the host's
launch only.  :meth:`Timeline.span_after` hands a span to a completion
thread that waits, in submission order, for the event (or the gloo work)
the collective completes at, and only then writes the span, with the
begin time its caller took (Horovod's finalizer thread does the same).
That wait happens on that thread alone, never on the caller's or the
cycle's: it synchronises a CUDA event, or polls an asynchronous
``torch.distributed`` work's ``is_completed()`` (on the card a query of
the work's event).  A work is not waited on: on the H100 a side stream
made to ``wait()`` on each of ``DistributedOptimizer``'s buckets cost
its step about 13 ms, the polling 0.25 ms (PERF.md §6).

Each rank writes ``<path>.rank<r>``; at shutdown :func:`publish_and_merge`
uploads every rank's file to the launcher's KV (scope ``timeline``) and
rank 0 merges them into ``<path>``.
"""

import json
import queue
import threading
import time

# the completion thread polls a work this often
_POLL_S = 0.0005


class TimelineWriter:
    """Background JSON writer (reference: TimelineWriter, timeline.cc:47)."""

    def __init__(self, path):
        self._path = path
        self._queue = queue.Queue()
        self._file = open(path, "w")
        self._file.write("[\n")
        self._first = True
        # lifecycle: close() enqueues the None sentinel and joins it
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-torch-timeline-writer")
        self._running = True
        self._thread.start()

    def enqueue(self, record: dict):
        if self._running:
            self._queue.put(record)

    def _run(self):
        while True:
            record = self._queue.get()  # wakeable: close()'s None sentinel
            if record is None:
                break
            if not self._first:
                self._file.write(",\n")
            self._first = False
            self._file.write(json.dumps(record))
        self._file.write("\n]\n")
        self._file.close()

    def close(self):
        if self._running:
            self._running = False
            self._queue.put(None)
            self._thread.join(timeout=5)


class Timeline:
    """One process's recorder of per-tensor lifecycles; see the module
    docstring."""

    def __init__(self, path=None, mark_cycles=False):
        self.path = path
        self._writer = TimelineWriter(path) if path else None
        self._closed = False
        self._mark_cycles = mark_cycles
        self._lock = threading.Lock()
        self._pids = {}          # guarded by self._lock
        self._next_pid = 1       # guarded by self._lock
        self._start = time.monotonic()
        # deferred spans: (name, phase, begin ts, done, end args)
        self._pending = queue.Queue()
        self._waiter = None      # guarded by self._lock
        if self._writer is not None:
            # wall-clock epoch of ts == 0, so that a merge can align
            # traces of processes that started at different times
            self._writer.enqueue({
                "name": "hvd_epoch", "ph": "M", "pid": 0,
                "args": {"epoch_us": int(time.time() * 1e6)},
            })

    @property
    def enabled(self):
        return self._writer is not None and not self._closed

    def now(self):
        """Microseconds since this timeline started: the ``ts`` of a
        record."""
        return int((time.monotonic() - self._start) * 1e6)

    def _pid(self, tensor_name):
        with self._lock:
            pid = self._pids.get(tensor_name)
            if pid is None:
                pid = self._next_pid
                self._next_pid += 1
                self._pids[tensor_name] = pid
                self._writer.enqueue({
                    "name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": tensor_name},
                })
            return pid

    def begin(self, tensor_name, phase, ts=None):
        if not self.enabled:
            return
        self._writer.enqueue({"name": phase, "ph": "B",
                              "ts": self.now() if ts is None else ts,
                              "pid": self._pid(tensor_name), "tid": 0})

    def end(self, tensor_name, args=None, ts=None):
        if not self.enabled:
            return
        record = {"ph": "E", "ts": self.now() if ts is None else ts,
                  "pid": self._pid(tensor_name), "tid": 0}
        if args:
            record["args"] = args
        self._writer.enqueue(record)

    def instant(self, tensor_name, name):
        """A rank's tick during negotiation (reference:
        controller.cc:797-809, RecordNegotiate's ticks)."""
        if not self.enabled:
            return
        self._writer.enqueue({"name": name, "ph": "i", "ts": self.now(),
                              "pid": self._pid(tensor_name), "tid": 0,
                              "s": "p"})

    def mark_cycle(self):
        """A cycle mark (``HVD_TIMELINE_MARK_CYCLES``; reference:
        operations.cc:562-565)."""
        if self.enabled and self._mark_cycles:
            pid = self._pid("CYCLE")
            self._writer.enqueue({"name": "CYCLE", "ph": "i",
                                  "ts": self.now(), "pid": pid, "tid": 0,
                                  "s": "g"})

    def span_after(self, tensor_name, phase, begin_ts, done, args=None):
        """The span ``phase`` on ``tensor_name``'s row from ``begin_ts``
        (a :meth:`now`) to the moment ``done`` completes: a CUDA event,
        an asynchronous ``torch.distributed`` work (polled), or None
        (now).  Written by the completion thread, in the order of these
        calls."""
        if not self.enabled:
            return
        with self._lock:
            if self._waiter is None:
                # lifecycle: close() enqueues the None sentinel and joins it
                self._waiter = threading.Thread(
                    target=self._wait_loop, daemon=True,
                    name="hvd-torch-timeline-completion")
                self._waiter.start()
        self._pending.put((tensor_name, phase, begin_ts, done, args))

    def _wait_loop(self):
        while True:
            item = self._pending.get()  # wakeable: close()'s None sentinel
            if item is None:
                return
            name, phase, begin_ts, done, args = item
            _wait(done, lambda: self._closed)
            self.begin(name, phase, ts=begin_ts)
            self.end(name, args)

    def close(self):
        """Write what the completion thread holds, then close the file;
        joins both threads (a completion whose collective never ends is
        given up after 5 s)."""
        with self._lock:
            waiter = self._waiter
        if waiter is not None:
            self._pending.put(None)
            waiter.join(timeout=5)
        # a recorder thread may have passed its ``enabled`` check
        # already; the writer stays reachable (an enqueue after close is
        # a no-op)
        writer = self._writer
        if writer:
            self._closed = True
            writer.close()


def _wait(done, closed):
    """Block until ``done`` (a CUDA event, a work, or None) completes, or
    ``closed()`` turns true while polling a work."""
    if done is None:
        return
    if not hasattr(done, "is_completed"):
        done.synchronize()    # a CUDA event
        return
    while not done.is_completed() and not closed():
        time.sleep(_POLL_S)


def publish_and_merge(rank, size, base_path, timeline, scope="timeline"):
    """Close ``timeline`` and merge every rank's trace into ``base_path``
    (reference: rank 0 writes one timeline for all ranks,
    ``timeline.cc``): each rank uploads its file to the launcher's KV and
    rank 0 merges them.  One rank merges its own file without a KV;
    above one rank without a launcher rendezvous each rank keeps its
    own file."""
    from horovod_tpu_torch.run import http_client
    from horovod_tpu_torch.utils import env as env_util
    from horovod_tpu_torch.utils.logging import get_logger

    addr = env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR)
    timeline.close()
    if not base_path or (addr is None and size > 1):
        return
    try:
        with open(timeline.path) as f:
            content = f.read()
    except OSError:
        content = "[]"
    if size == 1:
        merge_timeline_contents({0: content}, base_path)
        return
    port = env_util.get_int(env_util.HVD_RENDEZVOUS_PORT, 0)
    try:
        http_client.put(addr, port, scope, str(rank), content.encode())
    except OSError as exc:
        get_logger().warning("timeline publish failed for rank %d: %s",
                             rank, exc)
        if rank != 0:
            return
        # rank 0 holds its own content: the merge of the others' traces
        # does not depend on this upload
    if rank == 0:
        contents = {0: content}
        for r in range(1, size):
            try:
                contents[r] = http_client.get(addr, port, scope, str(r),
                                              timeout=20).decode()
            except (OSError, TimeoutError, KeyError):
                get_logger().warning(
                    "timeline merge: rank %d trace unavailable", r)
        try:
            merge_timeline_contents(contents, base_path)
        except (ValueError, OSError) as exc:
            get_logger().warning("timeline merge failed: %s", exc)


def merge_timeline_contents(contents, out_path):
    """Merge per-rank chrome traces into one file (reference: rank 0
    writes a single timeline for all ranks, ``timeline.cc``).

    ``contents``: {rank: json_text}.  Rows (pids) are offset per rank and
    ``process_name`` metadata is prefixed with the rank, so that every
    rank's lifecycle shows side by side in chrome://tracing.
    """
    from horovod_tpu_torch.utils.logging import get_logger

    parsed = {}
    epochs = {}
    for rank in sorted(contents):
        try:
            events = json.loads(contents[rank])
        except json.JSONDecodeError:
            get_logger().warning(
                "timeline merge: rank %d trace is not valid JSON "
                "(truncated flush?) — omitted from the merged view",
                rank)
            continue
        parsed[rank] = events
        for event in events:
            if event.get("name") == "hvd_epoch":
                epochs[rank] = event.get("args", {}).get("epoch_us", 0)
                break
    base_epoch = min(epochs.values()) if epochs else 0

    merged = []
    for rank, events in parsed.items():
        offset = (rank + 1) * 100000
        # each rank's relative timestamps on the shared epoch, so that
        # concurrent events line up in the viewer
        shift = epochs.get(rank, base_epoch) - base_epoch
        for event in events:
            event = dict(event)
            if event.get("name") == "hvd_epoch":
                continue
            if "pid" in event:
                event["pid"] = event["pid"] + offset
            if "ts" in event:
                event["ts"] = event["ts"] + shift
            if event.get("name") == "process_name":
                args = dict(event.get("args") or {})
                args["name"] = f"rank {rank}: {args.get('name', '')}"
                event["args"] = args
            merged.append(event)
    with open(out_path, "w") as f:
        json.dump(merged, f)
