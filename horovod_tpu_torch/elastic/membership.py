"""Elastic membership planning on the coordinator's side, and the
rendezvous contract late joiners register through (port of
``horovod_tpu/elastic/membership.py``).

Membership is a list of stable worker ids (the launcher-assigned initial
ranks) in new-rank order.  The decision point is the coordinator's
``_initiate_abort`` (``ops/tcp_controller.py``): an attached
:class:`ElasticContext` rewrites a survivable failure into a
reconfiguration directive, which the abort's delivery (pending exchanges,
heartbeat replies) hands to every survivor.
"""

import json
import threading

from horovod_tpu_torch.common.handles import encode_reconfig_reason
from horovod_tpu_torch.utils.logging import get_logger

# rendezvous scopes shared with joiners: the coordinator publishes the
# admitted membership under ``elastic/membership``; a joiner registers
# its worker id as a key in ``elastic-join`` and polls the membership
# until it is admitted
ELASTIC_SCOPE = "elastic"
MEMBERSHIP_KEY = "membership"
JOIN_SCOPE = "elastic-join"

# an explicit ``hvd.abort()`` is a kill switch, never rescued
# (``common/basics.py::abort``'s default reason)
USER_ABORT_PREFIX = "aborted by user"


def encode_membership(epoch, members) -> bytes:
    return json.dumps({"epoch": epoch,
                       "members": list(members)}).encode()


def decode_membership(blob):
    d = json.loads(blob.decode())
    return int(d["epoch"]), [int(m) for m in d["members"]]


class ElasticContext:
    """Rank 0's membership planner, attached to the coordinator.

    ``plan(origin_rank, reason)`` decides whether a failure is
    survivable and, if so, returns the encoded reconfiguration directive
    (the rewritten abort reason).  Sticky: the first plan wins, and
    racing aborts read the cached directive, as the coordinator's own
    abort is sticky.
    """

    def __init__(self, members, epoch, min_ranks=1, max_ranks=0,
                 rendezvous=None, coord_failover=False):
        self._members = list(members)   # worker ids, current-rank order
        self._epoch = epoch
        self._min_ranks = min_ranks
        self._max_ranks = max_ranks
        self._rendezvous = rendezvous   # (addr, port) | None
        # with fail-over armed a rank-0 loss or drain is plannable like
        # any other: the survivors elect a new coordinator
        self._coord_failover = coord_failover
        self._lock = threading.Lock()
        # the encoded directive once planned (None: fatal); sticky once
        # ``_decided`` is set; guarded by self._lock
        self._planned = None
        self._decided = False
        self._log = get_logger()

    def plan(self, origin_rank, reason):
        with self._lock:
            if not self._decided:
                self._planned = self._plan_locked(origin_rank, reason)
                self._decided = True
            return self._planned

    def plan_drain(self, origin_rank, cause=None):
        """Plan a planned departure (a graceful drain after a preemption
        notice, or a straggler's exclusion): the survivors of
        :meth:`plan`, but the directive is drain-marked: nothing failed
        and nobody is blamed.  ``cause`` replaces the recorded reason
        (default: the preemption notice's wording).  A drain racing a
        decided plan is refused (None): the membership change in flight
        wins and the preempted rank leaves as an ordinary loss."""
        with self._lock:
            if self._decided:
                return None
            wid = (self._members[origin_rank]
                   if 0 <= origin_rank < len(self._members)
                   else origin_rank)
            if cause is None:
                cause = (f"worker {wid} drained after preemption "
                         f"notice (SIGTERM)")
            self._planned = self._plan_locked(origin_rank, cause,
                                              drain=True)
            self._decided = True
            return self._planned

    def _plan_locked(self, origin_rank, reason,
                     drain=False):  # holds: self._lock
        if isinstance(reason, str) \
                and reason.startswith(USER_ABORT_PREFIX):
            return None  # the kill switch: never rescued
        if not (0 <= origin_rank < len(self._members)):
            return None  # the loss names no member
        if origin_rank == 0 and not self._coord_failover:
            # rank 0 hosts the coordinator: unless fail-over is armed,
            # what would orchestrate the rescue is the casualty
            return None
        dead_wid = self._members[origin_rank]
        survivors = [w for w in self._members if w != dead_wid]
        if len(survivors) < self._min_ranks:
            self._log.error(
                "elastic: %d survivors < --min-ranks %d; failure of "
                "worker %d is fatal", len(survivors), self._min_ranks,
                dead_wid)
            return None
        joiners = self._registered_joiners(
            exclude=set(survivors) | {dead_wid})
        if self._max_ranks > 0:
            joiners = joiners[:max(0,
                                   self._max_ranks - len(survivors))]
        new_members = survivors + joiners
        new_epoch = self._epoch + 1
        self._publish(new_epoch, new_members, admitted=joiners)
        self._log.warning(
            "elastic: worker %d %s (%s); reconfiguring to epoch %d "
            "with members %s", dead_wid,
            "draining" if drain else "lost", reason, new_epoch,
            new_members)
        directive = encode_reconfig_reason(new_epoch, new_members,
                                           [dead_wid], reason,
                                           drain=drain)
        if origin_rank == 0:
            # the leaving coordinator records its directive at the
            # epoch's election key: a survivor that misses the delivery
            # and then races the fail-over election adopts it, and both
            # paths reach the same epoch N+1 world
            self._record_handoff(directive)
        return directive

    def _record_handoff(self, directive):
        """Best-effort CAS of a rank-0 departure's directive at the
        election key; a failure costs only the backstop: survivors that
        elect without it compute the same successor membership."""
        if self._rendezvous is None:
            return
        from horovod_tpu_torch.elastic import election
        from horovod_tpu_torch.run import http_client

        addr, port = self._rendezvous
        try:
            http_client.cas_put(addr, port, election.ELECTION_SCOPE,
                                election.election_key(self._epoch),
                                directive.encode(), retry_for=2.0)
        except Exception:  # noqa: BLE001 — see docstring
            self._log.warning(
                "elastic: could not record the coordinator handoff "
                "directive for epoch %d", self._epoch, exc_info=True)

    def _registered_joiners(self, exclude):
        """Worker ids registered under the join scope, admitted in
        sorted order (the same whatever order they registered in)."""
        if self._rendezvous is None:
            return []
        from horovod_tpu_torch.run import http_client

        addr, port = self._rendezvous
        try:
            names = http_client.list_keys(addr, port, JOIN_SCOPE,
                                          retry_for=2.0)
        except Exception:  # noqa: BLE001 — no joiners this window
            return []
        out = []
        for name in names:
            try:
                wid = int(name)
            except ValueError:
                continue
            if wid not in exclude:
                out.append(wid)
        return sorted(out)

    def _publish(self, epoch, members, admitted=()):
        """Publish the admitted membership for polling joiners.  A
        failure costs only this window's admissions: the survivors get
        the directive through the abort's delivery.  Admitted joiners'
        keys leave the join scope, so that a later reconfiguration
        cannot admit a member again."""
        if self._rendezvous is None:
            return
        from horovod_tpu_torch.run import http_client

        addr, port = self._rendezvous
        try:
            http_client.put(addr, port, ELASTIC_SCOPE, MEMBERSHIP_KEY,
                            encode_membership(epoch, members),
                            retry_for=5.0)
        except Exception:  # noqa: BLE001 — see docstring
            self._log.warning(
                "elastic: could not publish membership for epoch %d",
                epoch, exc_info=True)
        for wid in admitted:
            try:
                http_client.delete(addr, port, JOIN_SCOPE, str(wid),
                                   retry_for=2.0)
            except Exception:  # noqa: BLE001 — a stale join key is
                # filtered by the exclude set next window anyway
                pass
