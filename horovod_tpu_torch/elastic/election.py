"""Coordinator fail-over election (port of
``horovod_tpu/elastic/election.py``).

Rank 0 hosts the coordinator (``ops/tcp_controller.py``), so its loss is
fatal unless ``HVD_TPU_COORD_FAILOVER=1``.  Then the survivors rescue
themselves: the launcher's rendezvous KV (``run/http_server.py``)
outlives rank 0, and its atomic put-if-absent is enough for an
election:

- every survivor that finds the coordinator unreachable computes the
  same successor membership from its ``(epoch, members)``: the dead
  coordinator's worker id (``members[0]``) drops out, the survivors keep
  their order, so the new rank 0 is the lowest surviving worker id;
- each survivor posts its directive at ``election/e<epoch>``; the KV
  keeps the first value and answers every poster with it, so one
  proposal wins and every other survivor adopts it verbatim;
- the winning directive then takes the ordinary path
  (``HvdReconfigureError`` -> ``elastic.run`` -> ``_elastic_reinit``),
  and the new rank 0 hosts the new coordinator and the new
  ``torch.distributed`` store at epoch N+1.

The key holds the elector's epoch, so a straggler at epoch N-1 cannot
race epoch N's election.  The same key holds a draining rank 0's
handoff record (``ElasticContext._record_handoff``).
"""

from horovod_tpu_torch.common.handles import (RECONFIG_MARKER,
                                              encode_reconfig_reason)
from horovod_tpu_torch.utils.logging import get_logger

# rendezvous scope of the per-epoch election keys (key: ``e<epoch>``)
ELECTION_SCOPE = "election"


def election_key(epoch) -> str:
    return f"e{epoch}"


def propose_directive(epoch, members, reason, proposer_wid) -> str:
    """The directive this survivor installs if it wins: epoch N+1, the
    membership without the dead coordinator's worker id, in order.
    Every survivor computes the same world; only the cause (which names
    the proposer) differs, so the CAS has one identifiable winner."""
    dead_wid = members[0]
    survivors = list(members[1:])
    cause = (f"coordinator (worker {dead_wid}) lost: {reason}; "
             f"fail-over elected by worker {proposer_wid}")
    return encode_reconfig_reason(epoch + 1, survivors, [dead_wid],
                                  cause)


def elect(addr, port, epoch, members, reason, proposer_wid,
          timeout=10.0):
    """Race the epoch's CAS election and return the winning directive
    (this proposer's or an adopted one), or None when the election
    cannot be won: the KV unreachable within ``timeout``, or a recorded
    winner that is no directive.  None means the caller falls back to
    the fatal "coordinator unreachable" abort."""
    from horovod_tpu_torch.run import http_client

    log = get_logger()
    proposal = propose_directive(epoch, members, reason, proposer_wid)
    try:
        winner = http_client.cas_put(
            addr, port, ELECTION_SCOPE, election_key(epoch),
            proposal.encode(), retry_for=timeout).decode()
    except Exception as exc:  # noqa: BLE001 — no rendezvous, no quorum
        log.error("fail-over: election at epoch %d unreachable within "
                  "%gs (%s); falling back to fatal abort", epoch,
                  timeout, exc)
        return None
    if not winner.startswith(RECONFIG_MARKER):
        log.error("fail-over: election key e%d holds a malformed "
                  "directive; falling back to fatal abort", epoch)
        return None
    if winner == proposal:
        log.warning("fail-over: worker %d won the epoch-%d election; "
                    "re-forming without worker %d", proposer_wid,
                    epoch, members[0])
    else:
        log.warning("fail-over: worker %d adopted the epoch-%d "
                    "election result", proposer_wid, epoch)
    return winner
