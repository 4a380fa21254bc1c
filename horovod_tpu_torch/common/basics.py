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
import socket
import threading
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
    global _state, _generation, _inits
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
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", local_rank
                                      % torch.cuda.device_count())
            torch.cuda.set_device(device)
        backend = "nccl" if device.type == "cuda" else "gloo"

        if not dist.is_initialized():
            addr = env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR)
            if store_path is not None:
                store = dist.FileStore(str(store_path), size)
            elif addr is not None and size > 1:
                _generation += 1
                store = _kv_rendezvous(
                    addr, env_util.get_int(env_util.HVD_RENDEZVOUS_PORT),
                    rank, size, config.start_timeout_seconds, timeout)
            elif size == 1:
                store = dist.HashStore()
            else:
                raise RuntimeError(
                    f"HVD_SIZE={size} needs a rendezvous: pass store_path= "
                    f"or start the ranks with the launcher "
                    f"(python -m horovod_tpu_torch.run)")
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size, timeout=timeout)
        groups.reset()
        _inits += 1
        plane = _start_control_plane(rank, size, config, key)
        controller = _start_eager_plane(rank, size, device, backend,
                                        config, key, plane)
        _state = _State(rank, size, local_rank, local_size, cross_rank,
                        cross_size, device, controller, plane,
                        config.compression, config.zero_min_size, key)
        local = _adasum_local_size(size, local_size, config)
        if local is not None:
            hier = groups.grid(cross=size // local, local=local)
            controller._executor.hierarchy = tuple(
                groups.plane_group(hier.group(axis).gid)
                for axis in ("local", "cross"))
        _state = dataclasses.replace(
            _state, sequence_group=groups.grid(sp=size).group("sp"))
        plane.barrier(config.start_timeout_seconds)


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


def _kv_rendezvous(addr, port, rank, size, start_timeout, timeout):
    """``torch.distributed``'s store through the launcher's KV: rank 0
    hosts a ``TCPStore`` on a port it reserved and publishes its address
    under ``STORE_SCOPE``; the others read it (waiting up to
    ``start_timeout`` seconds) and connect."""
    from horovod_tpu_torch.run import http_client

    name = f"store.{_generation}"
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


def _start_control_plane(rank, size, config, key):
    """The control plane (``ops/tcp_controller.py``); above one rank,
    rank 0's coordinator first, its address through the store."""
    plane = ControlPlane(rank, size, key, config)
    plane.add_listener(_abort_communicators)
    if size == 1:
        return plane
    store = dist.distributed_c10d._get_default_store()
    where = f"hvd_torch/coordinator.{_inits}"

    def client_key(r):
        return f"hvd_torch/client.{_inits}.{r}"

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
        store.set(where, f"{host}:{plane.serve(host, rank_of_client)}")
    host, _, port = store.get(where).decode().rpartition(":")
    plane.start((host, int(port)), lambda a: store.set(client_key(rank), a))
    return plane


def _abort_communicators(origin_rank, reason):
    """Abort every ``torch.distributed`` communicator of this process
    (NCCL's ends the collectives a dead peer left hanging on the card)
    and forget them, so that ``shutdown`` does not wait on them."""
    if dist.is_initialized():
        dist.distributed_c10d._abort_process_group()


def _start_eager_plane(rank, size, device, backend, config, key, plane):
    data = dist.new_group(backend=backend)
    if config.executor == "mesh":
        from horovod_tpu_torch.sharding.mesh_executor import MeshExecutor
        cls = MeshExecutor
    else:
        cls = Executor
    controller = Controller(rank, size, plane, cls(data, rank, size, device),
                            key, config)
    plane.add_listener(controller.abort)
    controller.start()
    return controller


def shutdown():
    global _state
    with _state_lock:
        if _state is None:
            return
        _state.controller.shutdown()
        _state.plane.shutdown()
        groups.reset()
        if dist.is_initialized():
            dist.destroy_process_group()
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
