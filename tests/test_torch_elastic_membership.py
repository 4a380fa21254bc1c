"""Elastic membership's pieces in the port (``horovod_tpu_torch``)
against the JAX package's, on the same inputs, in this process:

- the directive: ``encode_reconfig_reason`` byte for byte, and
  ``make_abort_error``'s decode (typed, malformed, drain-marked);
- ``ElasticContext``: ``plan``, ``plan_drain``, sticky decisions,
  ``min_ranks``, the ``max_ranks`` cap, joiners registered under
  ``elastic-join``, the published membership and the rank-0 handoff
  record, each side over a fresh ``RendezvousServer``;
- the fail-over election: ``propose_directive``, one CAS winner among
  racing electors, epoch-scoped keys;
- ``groups.reform`` on the same specs and memberships: explicit ranks,
  grids that still fit and grids that no longer do;
- the knobs: env names, defaults, ``Config`` fields, flags and YAML keys;
- the coordinator: the stale-epoch refusal, the drain's exemption from
  liveness blame and its pull-only delivery, the busy and RTT widening
  of the liveness window, the straggler verdict.
"""

import threading
import time

import pytest

from horovod_tpu.common import handles as jh
from horovod_tpu.elastic import election as jelection
from horovod_tpu.elastic import membership as jmembership

from horovod_tpu_torch.common import handles as th
from horovod_tpu_torch.elastic import election as telection
from horovod_tpu_torch.elastic import membership as tmembership
from horovod_tpu_torch.run import http_client
from horovod_tpu_torch.run.http_server import RendezvousServer


@pytest.fixture
def rendezvous():
    server = RendezvousServer()
    port = server.start()
    try:
        yield "127.0.0.1", port
    finally:
        server.stop()


# --------------------------------------------------------------- directive
@pytest.mark.parametrize("drain", [False, True])
def test_reconfig_reason_and_its_decode_match_jax(drain):
    args = (3, [0, 1, 3], [2], "rank 2 died")
    reason = th.encode_reconfig_reason(*args, drain=drain)
    assert reason == jh.encode_reconfig_reason(*args, drain=drain)
    assert th.is_drain_reason(reason) == jh.is_drain_reason(reason) == drain
    got, want = th.make_abort_error(2, reason), jh.make_abort_error(2, reason)
    assert isinstance(got, th.HvdReconfigureError)
    assert isinstance(got, th.HvdAbortedError)
    assert str(got) == str(want)
    for attr in ("origin_rank", "reason", "epoch", "members", "dead",
                 "cause", "drain"):
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("reason", [
    th.RECONFIG_MARKER + "not json {", th.RECONFIG_MARKER + '{"epoch": 2}',
    "ordinary reason", th.RECONFIG_MARKER + "[1, 2]"])
def test_malformed_directive_is_a_plain_abort_as_in_jax(reason):
    got, want = th.make_abort_error(1, reason), jh.make_abort_error(1, reason)
    assert type(got) is th.HvdAbortedError
    assert type(want) is jh.HvdAbortedError
    assert str(got) == str(want)
    assert th.is_drain_reason(reason) == jh.is_drain_reason(reason)
    assert th.RECONFIG_MARKER == jh.RECONFIG_MARKER
    assert str(th.HvdDrainedError(4)) == str(jh.HvdDrainedError(4))


# ----------------------------------------------------------------- planner
PLANS = {
    "loss": ({}, [("plan", 2, "presumed dead")], ()),
    "sticky": ({}, [("plan", 2, "presumed dead"), ("plan", 3, "also")], ()),
    "rank0": ({}, [("plan", 0, "rank 0 died")], ()),
    "rank0_armed": ({"coord_failover": True}, [("plan", 0, "died")], ()),
    "user_abort": ({}, [("plan", 1, "aborted by user")], ()),
    "min_ranks": ({"min_ranks": 4}, [("plan", 2, "died")], ()),
    "not_member": ({}, [("plan", 7, "died")], ()),
    "joiners": ({}, [("plan", 2, "died")], (9, 7)),
    "max_ranks": ({"max_ranks": 4}, [("plan", 2, "died")], (9, 7, 8)),
    "drain": ({}, [("drain", 1, None)], (7,)),
    "drain_rank0": ({}, [("drain", 0, None)], ()),
    "drain_rank0_armed": ({"coord_failover": True},
                          [("drain", 0, None)], ()),
    "drain_after_plan": ({}, [("plan", 2, "died"), ("drain", 1, None)], ()),
    "straggler": ({}, [("drain", 3, "rank 3 excluded as confirmed "
                                    "straggler")], ()),
}


def _plan(module, kw, calls, joiners):
    """The calls on one side's context over a fresh rendezvous; -> the
    directives, the published membership, the join scope left, and the
    handoff record of epoch 5."""
    server = RendezvousServer()
    port = server.start()
    try:
        for wid in joiners:
            http_client.put("127.0.0.1", port, tmembership.JOIN_SCOPE,
                            str(wid), b"1")
        ctx = module.ElasticContext(members=[0, 1, 2, 3], epoch=5,
                                    rendezvous=("127.0.0.1", port), **kw)
        out = [ctx.plan(o, r) if what == "plan" else ctx.plan_drain(o, r)
               for what, o, r in calls]
        published = server.get(tmembership.ELASTIC_SCOPE,
                               tmembership.MEMBERSHIP_KEY)
        left = http_client.list_keys("127.0.0.1", port,
                                     tmembership.JOIN_SCOPE)
        handoff = server.get(telection.ELECTION_SCOPE,
                             telection.election_key(5))
        return out, published, sorted(left), handoff
    finally:
        server.stop()


@pytest.mark.parametrize("case", sorted(PLANS))
def test_elastic_context_plans_as_jax(case):
    kw, calls, joiners = PLANS[case]
    got = _plan(tmembership, kw, calls, joiners)
    assert got == _plan(jmembership, kw, calls, joiners)
    directives = [d for d in got[0] if d is not None]
    for d in directives:
        exc = th.make_abort_error(0, d)
        assert exc.epoch == 6
    if case == "loss":
        assert th.make_abort_error(2, got[0][0]).members == [0, 1, 3]
    if case == "max_ranks":
        assert th.make_abort_error(2, got[0][0]).members == [0, 1, 3, 7]
    if case == "drain_rank0_armed":
        assert got[3] == got[0][0].encode()   # the handoff record


def test_membership_blob_matches_jax():
    blob = tmembership.encode_membership(4, [0, 2, 5])
    assert blob == jmembership.encode_membership(4, [0, 2, 5])
    assert tmembership.decode_membership(blob) == (4, [0, 2, 5])
    assert (tmembership.ELASTIC_SCOPE, tmembership.MEMBERSHIP_KEY,
            tmembership.JOIN_SCOPE, tmembership.USER_ABORT_PREFIX) == (
        jmembership.ELASTIC_SCOPE, jmembership.MEMBERSHIP_KEY,
        jmembership.JOIN_SCOPE, jmembership.USER_ABORT_PREFIX)


# ---------------------------------------------------------------- election
def test_propose_directive_matches_jax_and_is_the_same_world():
    members = [3, 5, 6, 9]
    for proposer in (5, 6, 9):
        got = telection.propose_directive(2, members, "gone", proposer)
        assert got == jelection.propose_directive(2, members, "gone",
                                                  proposer)
        exc = th.make_abort_error(0, got)
        assert (exc.epoch, exc.members, exc.dead) == (3, [5, 6, 9], [3])
    assert telection.election_key(7) == jelection.election_key(7) == "e7"


def test_racing_electors_have_one_winner(rendezvous):
    addr, port = rendezvous
    members, results = [0, 1, 2, 3, 4], {}
    barrier = threading.Barrier(4)

    def elect(wid, module):
        barrier.wait()
        results[wid] = module.elect(addr, port, 0, members, "lost", wid,
                                    timeout=5.0)

    threads = [threading.Thread(target=elect, args=(
        w, telection if w % 2 else jelection)) for w in (1, 2, 3, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(set(results.values())) == 1, results
    winner = next(iter(results.values()))
    exc = th.make_abort_error(0, winner)
    assert exc.members == [1, 2, 3, 4] and exc.dead == [0]
    # the next epoch's election is a key of its own
    other = telection.elect(addr, port, 1, [1, 2, 3, 4], "lost", 2)
    assert th.make_abort_error(0, other).members == [2, 3, 4]


def test_elect_without_rendezvous_is_none_as_in_jax():
    # a closed port: the election cannot be reached within its budget
    server = RendezvousServer()
    port = server.start()
    server.stop()
    assert telection.elect("127.0.0.1", port, 0, [0, 1], "x", 1,
                           timeout=0.5) is None


# ------------------------------------------------------------------ reform
def test_reform_matches_jax_on_the_same_specs(monkeypatch, jax_hvd):
    """Explicit ranks, a grid that still fits and one that no longer
    does, at 8 ranks on both sides (the port's registry without a
    ``torch.distributed`` world: its groups' torch groups stubbed)."""
    from horovod_tpu import groups as jg
    from horovod_tpu_torch import groups as tg
    from horovod_tpu_torch.common import basics as tb

    monkeypatch.setenv("HVD_TPU_GROUP_MAX", "100000")
    monkeypatch.setattr(tb, "size", lambda: 8)
    monkeypatch.setattr(tb, "members", lambda: list(range(8)))
    monkeypatch.setattr(tb, "_new_torch_groups", lambda ranks: (None, None))

    def make(hvd):
        exp = hvd.new_group([1, 2], name="reform.explicit")
        wide = hvd.new_group([0, 5, 7], name="reform.wide")
        g42 = hvd.grid(dp=4, tp=2)
        g222 = hvd.grid(dp=2, tp=2, pp=2)
        handles = {"exp": exp, "wide": wide}
        for grd, tag in ((g42, "g42"), (g222, "g222")):
            for axis in grd.axes:
                for r in range(8):
                    handles[f"{tag}.{axis}.{r}"] = grd.group(axis, r)
        return handles

    def table(mod, handles):
        out = {}
        for k, h in handles.items():
            try:
                out[k] = (h.gid, list(h.ranks))
            except mod.GroupUnsatisfiableError as exc:
                out[k] = (h.gid, ("unsatisfiable", exc.missing,
                                  exc.group_name))
        return out

    memberships = [list(range(1, 8)), [0, 2, 3, 4, 5, 6, 7],
                   [1, 2, 3, 4, 5, 6, 7, 0], [7, 6, 5, 4, 3, 2, 1, 0],
                   list(range(8))]
    tg.reset()
    try:
        ours = _fresh_thread(lambda: make(tg))
        theirs = _fresh_thread(lambda: make(jax_hvd))
        try:
            for m in memberships:
                tg.reform(m)
                jg.reform(m)
                assert table(tg, ours) == table(jg, theirs), m
        finally:
            jg.reform(list(range(8)))
    finally:
        tg.reset()


def _fresh_thread(fn):
    """``fn()`` on a new thread: both registries' auto-names count per
    thread, from 0."""
    box = {}
    t = threading.Thread(target=lambda: box.update(out=fn()))
    t.start()
    t.join(60)
    return box["out"]


@pytest.fixture(scope="session")
def jax_hvd():
    """The JAX package initialised as the session ``hvd`` fixture does (8
    device ranks)."""
    import horovod_tpu

    owned = not horovod_tpu.is_initialized()
    if owned:
        horovod_tpu.init()
    yield horovod_tpu
    if owned:
        horovod_tpu.shutdown()


# ------------------------------------------------------------------- knobs
KNOBS = {
    # Config field: (env var, runner arg, YAML path, flag argv)
    "elastic": ("HVD_TPU_ELASTIC", "elastic", "elastic.enabled",
                ["--elastic"]),
    "reconfig_timeout_seconds": ("HVD_TPU_RECONFIG_TIMEOUT",
                                 "reconfig_timeout",
                                 "elastic.reconfig_timeout",
                                 ["--reconfig-timeout", "7.5"]),
    "min_ranks": ("HVD_TPU_MIN_RANKS", "min_ranks", "elastic.min_ranks",
                  ["--min-ranks", "2"]),
    "max_ranks": ("HVD_TPU_MAX_RANKS", "max_ranks", "elastic.max_ranks",
                  ["--max-ranks", "6"]),
    "coord_failover": ("HVD_TPU_COORD_FAILOVER", "coord_failover",
                       "elastic.coord_failover", ["--coord-failover"]),
    "election_timeout_seconds": ("HVD_TPU_ELECTION_TIMEOUT",
                                 "election_timeout",
                                 "elastic.election_timeout",
                                 ["--election-timeout", "3"]),
    "drain": ("HVD_TPU_DRAIN", "drain", "fault_tolerance.drain",
              ["--no-drain"]),
    "rtt_alpha": ("HVD_TPU_RTT_ALPHA", "rtt_alpha",
                  "fault_tolerance.rtt_alpha", ["--rtt-alpha", "0.5"]),
    "straggler_factor": ("HVD_TPU_STRAGGLER_FACTOR", "straggler_factor",
                         "fault_tolerance.straggler_factor",
                         ["--straggler-factor", "3"]),
    "straggler_windows": ("HVD_TPU_STRAGGLER_WINDOWS", "straggler_windows",
                          "fault_tolerance.straggler_windows",
                          ["--straggler-windows", "5"]),
    "straggler_exclude": ("HVD_TPU_STRAGGLER_EXCLUDE", "straggler_exclude",
                          "fault_tolerance.straggler_exclude",
                          ["--straggler-exclude"]),
}


@pytest.mark.parametrize("field", sorted(KNOBS))
def test_knob_surface_matches_jax(field, monkeypatch):
    from horovod_tpu.common.config import Config as JConfig
    from horovod_tpu.run import config_parser as jparser
    from horovod_tpu.run import runner as jrunner
    from horovod_tpu.utils import env as jenv

    from horovod_tpu_torch.common.config import Config as TConfig
    from horovod_tpu_torch.run import config_parser as tparser
    from horovod_tpu_torch.run import runner as trunner
    from horovod_tpu_torch.utils import env as tenv

    var, arg, path, argv = KNOBS[field]
    assert getattr(tenv, var) == getattr(jenv, var) == var
    for name in list(__import__("os").environ):
        if name.startswith("HVD_"):
            monkeypatch.delenv(name)
    assert getattr(TConfig(), field) == getattr(JConfig(), field)
    assert getattr(TConfig.from_env(), field) == \
        getattr(JConfig.from_env(), field)
    if arg in jparser._PARAMS:
        assert tparser._PARAMS[arg] == jparser._PARAMS[arg] == (var, path)
    targs = trunner.make_parser().parse_args(argv + ["true"])
    jargs = jrunner.make_parser().parse_args(argv + ["true"])
    got = tparser.env_from_args(targs)
    assert got[var] == jparser.env_from_args(jargs)[var]
    monkeypatch.setenv(var, got[var])
    assert getattr(TConfig.from_env(), field) == \
        getattr(JConfig.from_env(), field)


def test_yaml_keys_reach_the_env_as_in_jax(tmp_path):
    from horovod_tpu.run import config_parser as jparser
    from horovod_tpu_torch.run import config_parser as tparser

    path = tmp_path / "c.yaml"
    path.write_text("elastic:\n  enabled: true\n  min_ranks: 2\n"
                    "  max_ranks: 5\n  reconfig_timeout: 9\n"
                    "  coord_failover: true\n  election_timeout: 4\n"
                    "fault_tolerance:\n  drain: false\n  rtt_alpha: 0.3\n"
                    "  straggler_factor: 6\n  straggler_windows: 2\n"
                    "  straggler_exclude: true\n")
    got = tparser.load_config_file(str(path))
    want = jparser.load_config_file(str(path))
    assert got == {k: v for k, v in want.items() if k in got}
    assert len(got) == 11


# ------------------------------------------------------------- coordinator
def _coordinator(size=4, **kw):
    from horovod_tpu_torch.ops import tcp_controller
    from horovod_tpu_torch.run.service import secret

    return tcp_controller.CoordinatorService(
        size, secret.make_secret_key(), host="127.0.0.1", **kw)


def test_stale_epoch_cycle_is_refused():
    from horovod_tpu_torch.ops import tcp_controller

    svc = _coordinator(1, epoch=2)
    try:
        replies = []
        svc._handle_deferred(tcp_controller.CycleMsg(0, 0, b"x", epoch=1),
                             None, replies.append)
        assert "stale membership epoch 1" in replies[0].error
        assert not svc._cycles
        svc._handle_deferred(tcp_controller.CycleMsg(0, 0, b"x", epoch=2),
                             None, replies.append)
        assert replies[1].msgs == [b"x"]
    finally:
        svc.shutdown()


def test_liveness_window_widens_as_in_jax():
    """A busy rank's window doubles, a reported RTT adds a capped slack,
    a draining rank is never blamed: the JAX coordinator's numbers."""
    from horovod_tpu.ops import tcp_controller as jtcp
    from horovod_tpu.run.service import network as jnet
    from horovod_tpu.run.service import secret as jsecret
    from horovod_tpu_torch.run.service import network as tnet

    ours = _coordinator(4, liveness_timeout_sec=2.0, straggler_factor=4.0)
    theirs = jtcp.CoordinatorService(4, jsecret.make_secret_key(),
                                      liveness_timeout_sec=2.0,
                                      straggler_factor=4.0)
    try:
        beats = [dict(busy=False), dict(busy=True), dict(rtt=0.05),
                 dict(busy=True, rtt=10.0)]
        for svc, net in ((ours, tnet), (theirs, jnet)):
            for r, kw in enumerate(beats):
                svc._handle(net.HeartbeatMsg(r, **kw), None)
        with ours._cv, theirs._cv:
            for r in range(4):
                assert ours._deadline_for_locked(r) == \
                    theirs._deadline_for_locked(r)
            assert [ours._deadline_for_locked(r) for r in range(4)] == \
                [2.0, 4.0, 2.2, 12.0]
        ours._draining.add(0)
        ours._last_seen[0] -= 100.0
        ours._last_liveness_scan = 0.0
        ours._check_liveness()
        assert ours.abort_state() is None   # a draining rank's silence
        ours._last_seen[2] -= 100.0
        ours._last_liveness_scan = 0.0
        ours._check_liveness()
        assert ours.abort_state() == (
            2, "rank 2 sent no heartbeat for more than 2.2s (presumed dead)")
    finally:
        ours.shutdown()
        theirs.shutdown()


def test_straggler_verdict_after_its_windows():
    svc = _coordinator(4, liveness_timeout_sec=30.0, straggler_factor=4.0,
                       straggler_windows=3)
    try:
        with svc._cv:
            svc._peer_rtt.update({0: 0.01, 1: 0.012, 2: 0.011, 3: 0.5})
            for _ in range(2):
                assert svc._straggler_scan_locked() is None
            assert svc._straggler_scan_locked() is None  # report only
        verdict = svc.straggler_verdicts()[3]
        assert verdict["rank"] == 3 and verdict["factor"] == 4.0
        assert set(svc.straggler_verdicts()) == {3}
    finally:
        svc.shutdown()


def test_drain_is_planned_pulled_and_refused_without_elastic():
    """A drain announcement: refused without a planner; with one, the
    drain-marked directive is set without rank 0's local abort pushed,
    and the draining rank is exempt from liveness blame."""
    from horovod_tpu_torch.ops import tcp_controller

    pushed = []
    svc = _coordinator(4, on_abort=lambda *a: pushed.append(a))
    try:
        ack = svc._handle(tcp_controller.DrainMsg(2), None)
        assert not ack.ok and "elastic disabled" in ack.reason
        assert svc.abort_state() is None and not svc._draining
    finally:
        svc.shutdown()
    svc = _coordinator(4, on_abort=lambda *a: pushed.append(a),
                       elastic=tmembership.ElasticContext([0, 1, 2, 3], 0))
    try:
        ack = svc._handle(tcp_controller.DrainMsg(2), None)
        assert ack.ok
        origin, reason = svc.abort_state()
        exc = th.make_abort_error(origin, reason)
        assert exc.drain and exc.members == [0, 1, 3] and origin == 2
        assert svc._draining == {2}
        time.sleep(0.1)
        assert pushed == []
        # a second drain (or a failure) after it is refused
        assert not svc._handle(tcp_controller.DrainMsg(1), None).ok
    finally:
        svc.shutdown()


def test_survivable_loss_is_rewritten_and_pushed():
    pushed = []
    svc = _coordinator(4, on_abort=lambda *a: pushed.append(a),
                       elastic=tmembership.ElasticContext([0, 1, 2, 3], 0))
    try:
        svc._initiate_abort(3, "rank 3 sent no heartbeat", dead=True)
        origin, reason = svc.abort_state()
        exc = th.make_abort_error(origin, reason)
        assert isinstance(exc, th.HvdReconfigureError)
        assert (exc.epoch, exc.members, exc.dead) == (1, [0, 1, 2], [3])
        for _ in range(50):
            if pushed:
                break
            time.sleep(0.02)
        assert pushed == [(3, reason)]
    finally:
        svc.shutdown()


def test_nccl_abort_takes_the_default_group_first(monkeypatch):
    """ROADMAP C.14: aborting an initialized NCCL communicator waits for
    the card, which the default group's hung gradient allreduce holds;
    torch's own order aborts the default group last and never returns.
    The port aborts the default group's communicator first."""
    import torch.distributed as dist

    from horovod_tpu_torch.common import basics

    c10d = dist.distributed_c10d
    calls = []

    class Default:
        def abort(self):
            calls.append("default")

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(c10d, "_get_default_group", Default)
    monkeypatch.setattr(c10d, "_abort_process_group",
                        lambda group=None: calls.append("every group"))
    basics._abort_communicators(2, "rank 2 died")
    assert calls == ["default", "every group"]
