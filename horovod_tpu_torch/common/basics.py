"""Process model on ``torch.distributed``: ``init`` / ``rank`` / ``size`` / ...

Port of ``horovod_tpu/common/basics.py``.  One process is one rank.  The
rank layout comes from ``common/topology.py::from_env``: the launcher
contract (``HVD_RANK``, ``HVD_SIZE``, ``HVD_LOCAL_RANK``,
``HVD_LOCAL_SIZE``, ``HVD_CROSS_*``), else the MPI runtime's placement
under ``hvdrun-torch --launcher mpirun|jsrun``; without either the job
is one rank.  The knobs below are read once, through
``common/config.py::Config``.

Rendezvous, in order of precedence:

- ``store_path``: a ``FileStore`` on a file every rank can see;
- ``HVD_RENDEZVOUS_ADDR`` / ``HVD_RENDEZVOUS_PORT``: the launcher's KV
  server (``run/http_server.py``), as in the reference's contract
  (``horovod_tpu/common/distributed.py:75-95``): rank 0 reserves a free
  port, publishes ``host:port`` under the scope ``torchdist`` and hosts a
  ``TCPStore`` there; the other ranks read the address from the KV,
  waiting up to ``HVD_START_TIMEOUT`` seconds (default 120);
- world size 1: an in-process ``HashStore``.

The job key signs the bytes that ranks unpickle from each other (the
eager plane's cycle messages, ``broadcast_object``): ``HVD_SECRET_KEY``
(base64; the launcher sets it), else, on a loopback rendezvous, under
``store_path`` or at one rank, a key derived from the rendezvous
location.  A rendezvous on another address without ``HVD_SECRET_KEY``
raises: a key anyone can derive from public values would let whoever
reaches the port drive the unpickler (reference:
``ops/global_controller.py:676-695``).

The backend is NCCL on the card (the default) and gloo only when the
caller asks for the CPU.  Asking for the card on a machine without one
raises.  ``HVD_TPU_COMPRESSION`` (none, bf16, fp16 or int8) is read once
here: the compression of every reduction whose ``compression`` is
``None``; a name it does not know raises.  So is
``HVD_TPU_ZERO_MIN_SIZE`` (default 1024): the flat parameter count below
which ``ZeroDistributedOptimizer`` keeps the update replicated; a
negative value raises.

Elastic membership (``HVD_TPU_ELASTIC``, ``elastic/``): each process has
a stable worker id (its launch rank, :func:`worker_id`) and the world is
a membership epoch: the worker ids in rank order (:func:`members`).  A
survivable loss reaches every survivor as ``HvdReconfigureError``, and
:func:`_elastic_reinit` moves the process to the directive's epoch: it
waits for the abort's listeners, synchronises the card (the work a hung
collective held back has been released by the communicator abort), stops
the old epoch's cycle thread and control plane, leaves the aborted
``torch.distributed`` world, rendezvous again under keys of the new
epoch (``store.e<epoch>`` at the KV, ``<store_path>.e<epoch>`` as a
``FileStore``, ``hvd_torch/coordinator.e<epoch>`` in the store), and
makes the default group, the control plane with the coordinator at the
new rank 0, the eager plane's group and executor, the process groups
(``groups.reform``) and the hierarchy and sequence grids, in one order
on every member.  The process keeps its card: a survivor's tensors stay
where they are, and a late joiner (:func:`_elastic_join_init`, through
``elastic.wait_for_membership``) takes its card from its launch-assigned
``HVD_LOCAL_RANK``, not from its admitted rank.  ``_State`` is replaced
whole, under ``_state_lock``.  Above one rank ``init`` also installs the
graceful drain's SIGTERM handler (``common/drain.py``, ``HVD_TPU_DRAIN``)
unless the program installed a handler of its own.

``init`` arms the fault injector (``common/faults.py``,
``HVD_TPU_FAULT_SPEC``) before anything else runs, then starts the
control plane (``ops/tcp_controller.py``): above one rank, rank 0 hosts
the coordinator, bound on the address the others are told
(``_my_address``) and published in ``torch.distributed``'s store; every
rank registers with it and runs a heartbeat thread.  Then the eager
collective plane (``ops/controller.py``): a data group of its own (NCCL
on the card), made in the same order on every rank, and its cycle
thread, which negotiates through the coordinator.  ``init`` returns
once every rank has reached its end (a barrier through the coordinator,
within ``HVD_START_TIMEOUT``): a rank that fails right after it cannot
break a peer that is still making its groups.

An abort of the job (a rank dead or silent past
``HVD_TPU_LIVENESS_TIMEOUT``, the stall shutdown, a lost coordinator,
``abort()``) first aborts every ``torch.distributed`` communicator of
this process (``_abort_communicators``: the default group, the plane's,
every process group's two, the sequence, tp, ep and pp groups), so that
a collective that a dead peer left hanging on the card returns, then
fails the eager plane's handles; from then on the plane, the optimizer
and the model-parallel collectives raise the typed
:class:`~horovod_tpu_torch.common.handles.HvdAbortedError`
(:func:`raise_if_aborted`, :func:`collective_error`), and ``shutdown``
returns without touching the aborted communicators.
``DistributedOptimizer`` keeps the default group, used from the
caller's thread: two threads sharing one NCCL
communicator could issue their collectives in different orders on
different ranks and deadlock.  Two communicators need the same order of
launches on every rank too: the optimizer waits for the plane to issue
what this rank submitted before each of its collectives
(``Controller.drain``).  ``shutdown`` stops the plane (a negotiated step:
every rank calls it) before it destroys the groups.

``HVD_ADASUM_HIERARCHICAL`` turns the eager plane's Adasum hierarchical
over ``HVD_HIER_LOCAL_SIZE`` (default ``HVD_LOCAL_SIZE``) ranks a fast
group: ``init`` then makes the ``(cross, local)`` grid of the hierarchy
(``groups.grid``, before the sequence grid, in the same order on every
rank) for the plane's executor.  A local size that gives no two-level
hierarchy with a power-of-two cross size leaves Adasum flat, with a
warning when it was set (reference: ``xla_executor.py:102-137``).

``HVD_HIERARCHICAL_ALLREDUCE`` and ``HVD_HIERARCHICAL_ALLGATHER`` (or
``HVD_AUTOTUNE``, whose walk tries both) make the same grid for the
plane's two-level allreduce and allgather when ``1 < L < size`` and
``size % L == 0``, with no condition on the cross size; another ``L``
leaves them flat, with the JAX package's warning when it was set.  One
grid serves Adasum and these when both are on.

``HVD_TIMELINE`` opens this process's trace, ``<path>.rank<worker id>``
(``.e<epoch>`` added after a reconfiguration), before the eager plane
starts; ``shutdown`` merges every rank's into ``<path>`` through the
launcher's KV (``utils/timeline.py::publish_and_merge``), and an
elastic reconfiguration closes it (both of its threads joined) and opens
the next epoch's.

``HVD_TPU_EXECUTOR`` (``psum``, the default, or ``mesh``) picks the
plane's executor: ``mesh`` runs it over a mesh's ``dp`` axis
(``sharding/mesh_executor.py``); any other value raises.

Process groups (``horovod_tpu_torch.groups``) add communicators: each
group is two ``torch.distributed`` groups over its ranks, one for the
eager plane's cycle thread and one for the collectives the caller's
thread issues.  So beside the default group (``DistributedOptimizer``)
and the plane's, every axis of a grid has communicators of its own: the
sequence axis ``sp`` of ring, zigzag and Ulysses attention (a one-axis
grid over the world, made last in ``init``, unless the caller passes a
mesh's ``sp`` group), the tensor axis ``tp`` (the Megatron allreduces of
``parallel/tensor_parallel.py``), the expert axis ``ep``
(``parallel/moe.py``), the pipeline axis ``pp`` (the hops of
``parallel/pipeline.py``) and the data axis ``dp`` of
``DistributedOptimizer(group=)``.  Their collectives run inside the
forward and backward passes, where ``DistributedOptimizer``'s hooks start
their allreduces; a causal ring or a pipeline stage builds a different
graph on every rank.  On one communicator the two could be launched in
different orders on different ranks, and NCCL would deadlock.  On
communicators of their own (each with NCCL streams of its own), every
rank launches each communicator's operations in the same order, but two
communicators may still interleave differently from rank to rank, and
NCCL does not promise progress then (ROADMAP C.9).  What shows them
finishing is a run: ``chip_smoke.py`` phase 9's causal-ring training
(``sp`` beside the default group) and phase 10's tp, ep and pp training
under ``DistributedOptimizer(group=dp)`` on four cards (see
``parallel/_comm.py``).
"""

import base64
import binascii
import contextlib
import dataclasses
import hashlib
import logging
import signal
import socket
import threading
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from horovod_tpu_torch import groups
from horovod_tpu_torch.common import faults, topology
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.handles import HvdError, make_abort_error
from horovod_tpu_torch.ops.controller import Controller
from horovod_tpu_torch.ops.nccl_executor import Executor
from horovod_tpu_torch.ops.tcp_controller import ControlPlane
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils.timeline import Timeline, publish_and_merge

_state = None
_state_lock = threading.Lock()
# inits this process has made: each publishes rank 0's store under its
# own key, so that a later init never reads an earlier one's address
_generation = 0
# the same for the coordinator's address in the store (every init)
_inits = 0

STORE_SCOPE = "torchdist"
LOOPBACK = ("localhost", "127.0.0.1", "::1")


@dataclasses.dataclass(frozen=True)
class _State:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    device: torch.device
    controller: object   # ops.controller.Controller, the eager plane
    plane: object        # ops.tcp_controller.ControlPlane
    compression: str     # the job's default (HVD_TPU_COMPRESSION)
    zero_min_size: int   # HVD_TPU_ZERO_MIN_SIZE
    key: bytes           # the job key (HVD_SECRET_KEY or derived)
    # the default sequence axis (parallel/_comm.py): the ``sp`` group of
    # a one-axis grid over the world, a groups.ProcessGroup
    sequence_group: object = None
    # elastic membership: the epoch, this process's worker id and the
    # worker ids in rank order
    epoch: int = 0
    worker_id: int = 0
    members: tuple = ()
    # what a reconfiguration makes the next epoch's world from
    config: object = None
    store_path: object = None
    timeout: timedelta = timedelta(seconds=300)
    # the runtime's own grids (the hierarchy, the sequence axis), made
    # afresh at each epoch
    grids: tuple = ()
    # this epoch's trace (utils/timeline.py) under HVD_TIMELINE, or None
    timeline: object = None


def resolve_device(device=None):
    """``None`` means the card.  A CUDA device on a machine without one
    raises: the port never falls back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return device


def init(device=None, store_path=None, timeout=timedelta(seconds=300)):
    """Join the job.  ``device`` is ``"cuda"`` (default) or ``"cpu"``."""
    global _state
    with _state_lock:
        if _state is not None:
            return
        device = resolve_device(device)
        topo = topology.from_env()
        if topo is None:
            rank, size, local_rank, local_size = 0, 1, 0, 1
            cross_rank, cross_size = 0, 1
        else:
            rank, size = topo.rank, topo.size
            local_rank, local_size = topo.local_rank, topo.local_size
            cross_rank, cross_size = topo.cross_rank, topo.cross_size
        if not 0 <= rank < size:
            raise ValueError(f"HVD_RANK={rank} outside HVD_SIZE={size}")
        config = Config.from_env()
        # arm the injector before any controller or transport code runs
        faults.configure(config.fault_spec, rank=rank)
        key = job_key(store_path, size)
        device = _card(device, local_rank)
        groups.reset()
        _form_world(
            _State(rank, size, local_rank, local_size, cross_rank,
                   cross_size, device, None, None, config.compression,
                   config.zero_min_size, key, worker_id=rank,
                   members=tuple(range(size)), config=config,
                   store_path=store_path, timeout=timeout),
            config.start_timeout_seconds)
        _maybe_install_drain(config)


def _card(device, local_rank):
    """The card of this process: ``device``, else ``cuda:<local_rank %
    cards>``, made current."""
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank
                                  % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def _form_world(state, start_timeout):
    """Make the world of ``state`` (its rank, size, epoch and members):
    the store, the default group, the control plane, the eager plane,
    the hierarchy and sequence grids; then wait for every rank at the
    coordinator (``start_timeout`` seconds).  Sets ``_state``; the
    caller holds ``_state_lock``."""
    global _state, _inits
    rank, size, config = state.rank, state.size, state.config
    backend = "nccl" if state.device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        store = _store(state, start_timeout)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=size, timeout=state.timeout)
    if state.epoch == 0:
        _inits += 1
    plane = _start_control_plane(rank, size, config, state.key,
                                 state.epoch, state.members)
    timeline = None
    if config.timeline_path:
        path = f"{config.timeline_path}.rank{state.worker_id}"
        timeline = Timeline(
            path if state.epoch == 0 else f"{path}.e{state.epoch}",
            config.timeline_mark_cycles)
    controller = _start_eager_plane(rank, size, state.device, backend,
                                    config, state.key, plane, timeline)
    _state = dataclasses.replace(state, controller=controller, plane=plane,
                                 timeline=timeline)
    if state.epoch > 0:
        # the process groups before the runtime's own grids: a joiner
        # has none, and makes only the latter
        groups.reform(state.members)
    grids = []
    adasum_local = _adasum_local_size(size, state.local_size, config)
    hier_local = _hier_local_size(size, state.local_size, config)
    local = adasum_local or hier_local
    if local is not None:
        hier = groups.grid(cross=size // local, local=local)
        grids.append(hier)
        pair = tuple(groups.plane_group(hier.group(axis).gid)
                     for axis in ("local", "cross"))
        if adasum_local is not None:
            controller._executor.hierarchy = pair
        if hier_local is not None:
            controller._executor.hier = pair + (local,)
    seq = groups.grid(sp=size)
    grids.append(seq)
    _state = dataclasses.replace(_state, sequence_group=seq.group("sp"),
                                 grids=tuple(grids))
    plane.barrier(start_timeout)


def _store(state, start_timeout):
    """``torch.distributed``'s store for ``state``'s world: a
    ``FileStore`` at ``store_path`` (``<store_path>.e<epoch>`` after
    epoch 0), the launcher's KV rendezvous, or one rank's
    ``HashStore``."""
    global _generation
    size = state.size
    addr = env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR)
    if state.store_path is not None:
        path = str(state.store_path)
        return dist.FileStore(
            path if state.epoch == 0 else f"{path}.e{state.epoch}", size)
    if addr is not None and size > 1:
        if state.epoch == 0:
            _generation += 1
            name = f"store.{_generation}"
        else:
            # keyed by the epoch, which a joiner shares with the
            # survivors; a process's own count of inits it does not
            name = f"store.e{state.epoch}"
        return _kv_rendezvous(
            addr, env_util.get_int(env_util.HVD_RENDEZVOUS_PORT),
            state.rank, size, start_timeout, state.timeout, name)
    if size == 1:
        return dist.HashStore()
    raise RuntimeError(
        f"HVD_SIZE={size} needs a rendezvous: pass store_path= "
        f"or start the ranks with the launcher "
        f"(python -m horovod_tpu_torch.run)")


def _maybe_install_drain(config):
    """The SIGTERM -> graceful drain handler (``common/drain.py``) above
    one rank with ``HVD_TPU_DRAIN`` on, unless the program has a SIGTERM
    handler of its own, which is kept."""
    if not (config.drain and _state is not None and _state.size > 1
            and signal.getsignal(signal.SIGTERM) is signal.SIG_DFL):
        return
    from horovod_tpu_torch.common import drain as drain_mod

    # resolved when the signal comes: a reconfiguration replaces the
    # control plane
    drain_mod.install(lambda: _state.plane if _state is not None else None)


def job_key(store_path=None, size=1):
    """The job key: ``HVD_SECRET_KEY`` (base64), else derived from the
    rendezvous location where that is safe (a loopback rendezvous, a
    ``store_path``, one rank); a rendezvous on another address without
    the variable raises."""
    supplied = env_util.get_str(env_util.HVD_SECRET_KEY)
    if supplied:
        try:
            return base64.b64decode(supplied, validate=True)
        except binascii.Error as exc:
            raise ValueError(
                f"{env_util.HVD_SECRET_KEY} is not base64: {exc}") from None
    addr = env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR)
    if store_path is not None:
        seed = f"file:{store_path}"
    elif addr is None or addr in LOOPBACK or size == 1:
        seed = (f"{addr or 'local'}:"
                f"{env_util.get_str(env_util.HVD_RENDEZVOUS_PORT, '0')}")
    else:
        raise RuntimeError(
            f"the rendezvous {addr} is not loopback and "
            f"{env_util.HVD_SECRET_KEY} is not set: refusing to derive the "
            f"job key from public values (the launcher, python -m "
            f"horovod_tpu_torch.run, sets {env_util.HVD_SECRET_KEY})")
    return hashlib.sha256(seed.encode()).digest()


def _reserve_port():
    """Bind a free port and keep the socket open; the caller closes it
    just before the store binds the port, so the window in which another
    process can take it is microseconds (reference:
    ``horovod_tpu/common/distributed.py:27-36``)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("", 0))
    return s, s.getsockname()[1]


def _my_address():
    """The address the other ranks use to reach rank 0's store: the
    address of ``HVD_IFACE`` if set, loopback under a loopback
    rendezvous, else the host name's (reference:
    ``horovod_tpu/common/distributed.py:39-55``)."""
    iface = env_util.get_str(env_util.HVD_IFACE)
    if iface:
        from horovod_tpu_torch.run.service import network
        ip = network.local_interfaces().get(iface)
        if ip:
            return ip
    if env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR, "") in LOOPBACK:
        return "127.0.0.1"
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _kv_rendezvous(addr, port, rank, size, start_timeout, timeout, name):
    """``torch.distributed``'s store through the launcher's KV: rank 0
    hosts a ``TCPStore`` on a port it reserved and publishes its address
    under ``STORE_SCOPE``/``name``; the others read it (waiting up to
    ``start_timeout`` seconds) and connect."""
    from horovod_tpu_torch.run import http_client

    if rank == 0:
        reserved, store_port = _reserve_port()
        host = _my_address()
        http_client.put(addr, port, STORE_SCOPE, name,
                        f"{host}:{store_port}".encode())
        reserved.close()
        return dist.TCPStore(host, store_port, size, is_master=True,
                             timeout=timeout)
    try:
        where = http_client.get(addr, port, STORE_SCOPE, name,
                                timeout=start_timeout).decode()
    except KeyError:
        raise TimeoutError(
            f"rank {rank}: rank 0 published no store address at the "
            f"rendezvous {addr}:{port} within {start_timeout:g} s "
            f"({env_util.HVD_START_TIMEOUT})") from None
    host, _, store_port = where.rpartition(":")
    return dist.TCPStore(host, int(store_port), size, is_master=False,
                         timeout=timeout)


def default_compression():
    """``HVD_TPU_COMPRESSION``'s canonical name (``"none"`` when unset),
    as ``Config`` reads it: a typo raises ``ValueError`` rather than
    leaving every reduction uncompressed."""
    return Config.from_env().compression


def _adasum_local_size(size, local_size, config):
    """The local size of hierarchical Adasum, or None for the flat path:
    ``HVD_ADASUM_HIERARCHICAL`` unset, or a local size ``L`` (explicit
    ``HVD_HIER_LOCAL_SIZE``, else the launcher's local size) that is not
    ``1 < L < size`` with ``size / L`` a power of two."""
    if not config.adasum_hierarchical:
        return None
    explicit = config.hier_local_size or None
    local = explicit or local_size
    if 1 < local < size and size % local == 0:
        cross = size // local
        if cross & (cross - 1) == 0:
            return local
    if explicit is not None:
        logging.getLogger("horovod_tpu_torch").warning(
            "HVD_HIER_LOCAL_SIZE=%s does not define a two-level hierarchy "
            "over %d ranks with a power-of-two cross size; hierarchical "
            "Adasum will run the flat path", explicit, size)
    return None


def _hier_local_size(size, local_size, config):
    """The local size of the hierarchical allreduce and allgather, or None
    for the flat path: none of ``HVD_HIERARCHICAL_ALLREDUCE``,
    ``HVD_HIERARCHICAL_ALLGATHER`` and ``HVD_AUTOTUNE`` on, or a local
    size ``L`` (explicit ``HVD_HIER_LOCAL_SIZE``, else the launcher's)
    that is not ``1 < L < size`` with ``size % L == 0``; an explicit one
    that fails warns in the JAX executor's words
    (``xla_executor.py:120-138``)."""
    if not (config.hierarchical_allreduce or config.hierarchical_allgather
            or config.autotune):
        return None
    explicit = config.hier_local_size or None
    local = explicit or local_size
    log = logging.getLogger("horovod_tpu_torch")
    if 1 < local < size:
        if size % local == 0:
            return local
        if explicit is not None:
            log.warning(
                "ignoring HVD_HIER_LOCAL_SIZE=%s: %s — hierarchical "
                "collectives will run the flat path", explicit,
                f"{size} devices not divisible by local_size {explicit}")
    elif explicit is not None:
        log.warning(
            "HVD_HIER_LOCAL_SIZE=%s does not define a two-level hierarchy "
            "over %d ranks; hierarchical collectives will run the flat "
            "path", explicit, size)
    return None


def _start_control_plane(rank, size, config, key, epoch=0, members=None):
    """The control plane (``ops/tcp_controller.py``); above one rank,
    rank 0's coordinator first, its address through the store (keys of
    the process's init count at epoch 0, of the epoch after it)."""
    plane = ControlPlane(rank, size, key, config, epoch=epoch,
                         members=members)
    plane.add_listener(_abort_communicators)
    if size == 1:
        return plane
    store = dist.distributed_c10d._get_default_store()
    tag = _inits if epoch == 0 else f"e{epoch}"
    where = f"hvd_torch/coordinator.{tag}"

    def client_key(r):
        return f"hvd_torch/client.{tag}.{r}"

    def rank_of_client(address):
        """The rank whose exchange connection comes from ``address``."""
        wanted = f"{address[0]}:{address[1]}"
        for r in range(size):
            try:
                if store.check([client_key(r)]) and store.get(
                        client_key(r)).decode() == wanted:
                    return r
            except Exception:  # noqa: BLE001 — a name, best effort
                return None
        return None

    if rank == 0:
        host = _my_address()
        addr = env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR)
        rendezvous = (None if addr is None else
                      (addr, env_util.get_int(env_util.HVD_RENDEZVOUS_PORT)))
        port = plane.serve(host, rank_of_client, rendezvous)
        store.set(where, f"{host}:{port}")
    host, _, port = store.get(where).decode().rpartition(":")
    plane.start((host, int(port)), lambda a: store.set(client_key(rank), a))
    return plane


# aborted gloo process groups and the works a wait left behind, kept
# alive: destroying one joins its worker thread, which a collective that
# a live peer will never finish holds (gloo's abort closes no connection)
_aborted_groups = []
# the communicator abort (an abort listener's thread) and shutdown's
# destroy of the same groups (the caller's, woken by the abort) exclude
# each other: an NCCL abort takes a while, and a destroy under it
# crashes the process
_comm_lock = threading.Lock()


def _abort_communicators(origin_rank, reason):
    """Abort every ``torch.distributed`` communicator of this process
    (NCCL's ends the collectives a dead peer left hanging on the card)
    and forget them, so that ``shutdown`` does not wait on them.  The
    default group's first: aborting an NCCL communicator frees its
    memory, which waits for the card, and the gradient allreduce a dead
    peer left hanging there holds it until its own communicator is
    aborted (``torch.distributed``'s order, the last group made first,
    deadlocks on it: ROADMAP C.14)."""
    with _comm_lock:
        if not dist.is_initialized():
            return
        c10d = dist.distributed_c10d
        if dist.get_backend() == "gloo":
            _aborted_groups.extend(c10d._world.pg_names)
        else:
            c10d._get_default_group().abort()
        c10d._abort_process_group()


def wait_work(work):
    """``work.wait()`` for a collective of the caller's thread.  On the
    card the host does not block (the caller's stream waits).  On the CPU
    the wait is polled, so that the job's abort ends it with the typed
    error: a gloo collective waiting for a live peer that has left it
    does not return when the communicators are aborted."""
    state = _state
    if state is None or state.device.type == "cuda":
        work.wait()
        return
    while not work.is_completed():
        if state.plane.await_abort(0.002) is not None:
            _aborted_groups.append(work)
            raise make_abort_error(*state.plane.abort_state())
    work.wait()


def _start_eager_plane(rank, size, device, backend, config, key, plane,
                       timeline=None):
    data = dist.new_group(backend=backend)
    if config.executor == "mesh":
        from horovod_tpu_torch.sharding.mesh_executor import MeshExecutor
        cls = MeshExecutor
    else:
        cls = Executor
    controller = Controller(rank, size, plane, cls(data, rank, size, device),
                            key, config, timeline)
    plane.add_listener(controller.abort)
    controller.start()
    return controller


def shutdown():
    global _state
    with _state_lock:
        if _state is None:
            return
        _state.controller.shutdown()
        _finish_timeline(_state)
        _state.plane.shutdown()
        groups.reset()
        with _comm_lock:
            if dist.is_initialized():
                dist.destroy_process_group()
        _state = None


def _finish_timeline(state):
    """At shutdown: merge every rank's trace into ``HVD_TIMELINE``'s path
    (after an abort, only close this rank's)."""
    timeline = state.timeline
    if timeline is None:
        return
    if state.plane.abort_state() is not None:
        timeline.close()
        return
    publish_and_merge(
        state.rank, state.size, state.config.timeline_path, timeline,
        scope="timeline" if state.epoch == 0 else f"timeline.e{state.epoch}")


def timeline():
    """This process's ``utils/timeline.py::Timeline`` under
    ``HVD_TIMELINE``, else None (also before ``init``)."""
    state = _state
    return None if state is None else state.timeline


def worker_id():
    """This process's stable elastic identity: its launch rank,
    unchanged by reconfiguration (``rank()`` is re-keyed at every
    membership epoch)."""
    return _get_state().worker_id


def members():
    """The worker ids in rank order at this membership epoch: position r
    holds the worker serving rank r (the identity before any
    reconfiguration).  Process groups record these ids."""
    state = _get_state()
    return list(state.members) or list(range(state.size))


def _leave_epoch(state):
    """Tear down ``state``'s world so that the next epoch's can be made:
    wait for the abort's listeners (the communicator abort releases what
    a dead peer left hanging), synchronise the card, stop the cycle
    thread, close the control plane without job-end messages, and leave
    the aborted ``torch.distributed`` world."""
    budget = max(state.config.abort_timeout_seconds, 5.0)
    state.plane.await_abort(budget)
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    state.controller.shutdown(timeout=budget)
    if state.timeline is not None:
        state.timeline.close()
    state.plane.close_for_reconfig()
    _abort_communicators(None, None)


def _elastic_reinit(epoch, members):
    """Move this surviving process to membership epoch ``epoch`` with
    ``members`` (worker ids in new-rank order); a stale directive
    (``epoch`` not past this process's) is ignored.  -> the seconds of
    the teardown and of the rendezvous (with the groups and the planes),
    or None."""
    global _state
    with _state_lock:
        state = _get_state()
        wid = state.worker_id
        if wid not in members:
            raise ValueError(
                f"worker {wid} is not part of membership {members}")
        if epoch <= state.epoch:
            return None
        t0 = time.perf_counter()
        _leave_epoch(state)
        for grid_ in state.grids:
            groups._discard(grid_)
        t1 = time.perf_counter()
        new_rank, new_size = members.index(wid), len(members)
        # the global and local axes are re-keyed densely, the cross
        # axis keeps its launch value (one host); the card stays
        _state = None
        _form_world(
            dataclasses.replace(
                state, rank=new_rank, size=new_size, local_rank=new_rank,
                local_size=new_size, controller=None, plane=None,
                sequence_group=None, grids=(), timeline=None, epoch=epoch,
                members=tuple(members)),
            state.config.reconfig_timeout_seconds)
        logging.getLogger("horovod_tpu_torch").warning(
            "elastic: worker %d re-formed at epoch %d as rank %d/%d",
            wid, epoch, new_rank, new_size)
        return {"teardown_s": t1 - t0,
                "rendezvous_s": time.perf_counter() - t1}


def _elastic_join_init(epoch, members, device=None):
    """``init`` of a late joiner, straight at the admitted epoch (it
    never belonged to epoch 0).  ``device`` as ``init``'s; its card comes
    from its launch-assigned ``HVD_LOCAL_RANK``, its worker id from
    ``HVD_RANK``."""
    with _state_lock:
        if _state is not None:
            raise RuntimeError(
                "horovod_tpu_torch is already initialized; joiners call "
                "hvd.elastic.wait_for_membership() instead of hvd.init()")
        config = Config.from_env()
        wid = env_util.get_int(env_util.HVD_RANK, 0)
        faults.configure(config.fault_spec, rank=wid)
        rank, size = members.index(wid), len(members)
        device = _card(resolve_device(device),
                       env_util.get_int(env_util.HVD_LOCAL_RANK, 0))
        key = job_key(None, size)
        groups.reset()
        _form_world(
            _State(rank, size, rank, size, 0, 1, device, None, None,
                   config.compression, config.zero_min_size, key,
                   epoch=epoch, worker_id=wid, members=tuple(members),
                   config=config),
            config.reconfig_timeout_seconds)
        _maybe_install_drain(config)
        logging.getLogger("horovod_tpu_torch").warning(
            "elastic: worker %d joined at epoch %d as rank %d/%d",
            wid, epoch, rank, size)


def _drained_teardown():
    """Take this process out of the runtime after a granted drain: it
    has left the membership, so there is no job-end negotiation."""
    global _state
    with _state_lock:
        if _state is None:
            return
        try:
            _leave_epoch(_state)
        except Exception:  # noqa: BLE001 — leaving a world that has
            # already re-formed without this rank
            logging.getLogger("horovod_tpu_torch").debug(
                "drain teardown error", exc_info=True)
        groups.reset()
        _state = None


def abort(reason="aborted by user"):
    """Abort the job (reference: ``horovod_tpu/common/basics.py:363``):
    every rank, ranks blocked inside a collective included, raises
    :class:`~horovod_tpu_torch.common.handles.HvdAbortedError` naming
    this rank within ``HVD_TPU_ABORT_TIMEOUT``.  For a rank that detects
    an unrecoverable condition and wants the whole job to unwind
    together rather than leave its peers hanging."""
    state = _get_state()
    state.plane.abort(state.rank, reason)


def raise_if_aborted():
    """Raise the typed abort error once the job has aborted."""
    state = _state
    abort = None if state is None else state.plane.abort_state()
    if abort is not None:
        raise make_abort_error(*abort)


def wait_for_abort():
    """Block until the job aborts, then raise its typed error (the
    caller's part of a collective was dropped by a fault spec)."""
    _get_state().plane.await_abort()
    raise_if_aborted()


@contextlib.contextmanager
def abortable():
    """Around a ``torch.distributed`` call of the caller's thread: a
    failure once the job has aborted, or a broken communication that the
    coordinator's verdict turns into an abort, raises the typed abort
    error; anything else the backend's own error, at once."""
    try:
        yield
    except HvdError:
        raise
    except Exception as exc:
        err = collective_error(exc)
        if err is exc:
            raise
        raise err from exc


def collective_error(exc):
    """The error to raise for ``exc``, which a collective of this rank
    raised: the job's abort, waiting for the coordinator's verdict first
    when ``exc`` is a broken communication (a survivor names the rank
    that died, not itself), else ``exc``."""
    state = _state
    verdict = None if state is None else state.plane.verdict(exc)
    return exc if verdict is None else make_abort_error(*verdict)


def _new_torch_groups(ranks):
    """Two ``torch.distributed`` groups over ``ranks`` on the default
    group's backend, for a process group (``groups``): the caller's and
    the eager plane's.  Every rank calls it, in the same order."""
    backend = dist.get_backend()
    return (dist.new_group(ranks, backend=backend),
            dist.new_group(ranks, backend=backend))


def is_initialized():
    return _state is not None


def _get_state():
    if _state is None:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
    return _state


def rank():
    return _get_state().rank


def size():
    return _get_state().size


def local_rank():
    return _get_state().local_rank


def local_size():
    return _get_state().local_size


def cross_rank():
    return _get_state().cross_rank


def cross_size():
    return _get_state().cross_size


def device():
    """The device this rank computes on (``cuda:<local_rank>`` or cpu)."""
    return _get_state().device


# the reference's build probes (``basics.py``), which the framework
# bindings re-export: the data plane is torch.distributed's
def mpi_built() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def xla_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    """No MPI data plane, so False; raises before ``init`` as the
    reference does."""
    _get_state()
    return False


def is_homogeneous() -> bool:
    """Every host runs the same number of ranks."""
    state = _get_state()
    return state.size == state.local_size * state.cross_size
