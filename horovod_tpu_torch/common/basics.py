"""Process model on ``torch.distributed``: ``init`` / ``rank`` / ``size`` / ...

Port of ``horovod_tpu/common/basics.py``.  One process is one rank.  The
rank layout comes from the launcher contract (``HVD_RANK``, ``HVD_SIZE``,
``HVD_LOCAL_RANK``, ``HVD_LOCAL_SIZE``, ``HVD_CROSS_*``); without it the
job is one rank.

Rendezvous, in order of precedence:

- ``store_path``: a ``FileStore`` on a file every rank can see;
- ``HVD_RENDEZVOUS_ADDR`` / ``HVD_RENDEZVOUS_PORT``: rank 0 hosts a
  ``TCPStore`` there;
- world size 1: an in-process ``HashStore``.

The backend is NCCL on the card (the default) and gloo only when the
caller asks for the CPU.  Asking for the card on a machine without one
raises.  ``HVD_TPU_COMPRESSION`` (none, bf16, fp16 or int8) is read once
here: the compression of every reduction whose ``compression`` is
``None``; a name it does not know raises.  So is
``HVD_TPU_ZERO_MIN_SIZE`` (default 1024): the flat parameter count below
which ``ZeroDistributedOptimizer`` keeps the update replicated; a
negative value raises.

``init`` also starts the eager collective plane (``ops/controller.py``):
two process groups of its own, made in the same order on every rank (a
gloo group for the negotiation's metadata and a data group, NCCL on the
card), and its cycle thread.  ``DistributedOptimizer`` keeps the default
group, used from the caller's thread: two threads sharing one NCCL
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

import dataclasses
import logging
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

from horovod_tpu_torch import groups
from horovod_tpu_torch.common.compression import resolve_compression
from horovod_tpu_torch.ops.controller import Controller
from horovod_tpu_torch.ops.nccl_executor import Executor
from horovod_tpu_torch.utils import env as env_util

_state = None
_state_lock = threading.Lock()


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
    compression: str     # the job's default (HVD_TPU_COMPRESSION)
    zero_min_size: int   # HVD_TPU_ZERO_MIN_SIZE
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
    global _state
    with _state_lock:
        if _state is not None:
            return
        device = resolve_device(device)
        rank = env_util.get_int(env_util.HVD_RANK, 0)
        size = env_util.get_int(env_util.HVD_SIZE, 1)
        local_rank = env_util.get_int(env_util.HVD_LOCAL_RANK, rank)
        local_size = env_util.get_int(env_util.HVD_LOCAL_SIZE, size)
        cross_rank = env_util.get_int(env_util.HVD_CROSS_RANK, 0)
        cross_size = env_util.get_int(env_util.HVD_CROSS_SIZE, 1)
        if not 0 <= rank < size:
            raise ValueError(f"HVD_RANK={rank} outside HVD_SIZE={size}")
        compression = default_compression()
        executor = _validated_executor(env_util.get_str(
            env_util.HVD_TPU_EXECUTOR, "psum"))
        zero_min_size = _validated_nonneg(env_util.HVD_TPU_ZERO_MIN_SIZE,
                                          env_util.DEFAULT_ZERO_MIN_SIZE)
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
                store = dist.TCPStore(
                    addr, env_util.get_int(env_util.HVD_RENDEZVOUS_PORT),
                    size, is_master=rank == 0, timeout=timeout)
            elif size == 1:
                store = dist.HashStore()
            else:
                raise RuntimeError(
                    f"HVD_SIZE={size} needs a rendezvous: pass store_path= "
                    f"or set {env_util.HVD_RENDEZVOUS_ADDR}/"
                    f"{env_util.HVD_RENDEZVOUS_PORT}")
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size, timeout=timeout)
        groups.reset()
        controller = _start_eager_plane(rank, size, device, backend,
                                        executor)
        _state = _State(rank, size, local_rank, local_size, cross_rank,
                        cross_size, device, controller, compression,
                        zero_min_size)
        local = _adasum_local_size(size, local_size)
        if local is not None:
            hier = groups.grid(cross=size // local, local=local)
            controller._executor.hierarchy = tuple(
                groups.plane_group(hier.group(axis).gid)
                for axis in ("local", "cross"))
        _state = dataclasses.replace(
            _state, sequence_group=groups.grid(sp=size).group("sp"))


def default_compression():
    """``HVD_TPU_COMPRESSION``'s canonical name (``"none"`` when unset);
    a typo raises ``ValueError`` rather than leaving every reduction
    uncompressed (reference: ``common/config.py:_validated_compression``)."""
    return resolve_compression(
        env_util.get_str(env_util.HVD_TPU_COMPRESSION, "none"))


def _validated_nonneg(name, default):
    """A negative count raises at ``init`` (reference:
    ``common/config.py:_validated_nonneg``)."""
    value = env_util.get_int(name, default)
    if value < 0:
        raise ValueError(f"{name} must be >= 0, got {value}")
    return value


def _adasum_local_size(size, local_size):
    """The local size of hierarchical Adasum, or None for the flat path:
    ``HVD_ADASUM_HIERARCHICAL`` unset, or a local size ``L`` (explicit
    ``HVD_HIER_LOCAL_SIZE``, else the launcher's local size) that is not
    ``1 < L < size`` with ``size / L`` a power of two."""
    if not env_util.get_bool(env_util.HVD_ADASUM_HIERARCHICAL):
        return None
    explicit = env_util.get_int(env_util.HVD_HIER_LOCAL_SIZE, 0) or None
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


def _validated_executor(name):
    """An ``HVD_TPU_EXECUTOR`` typo must not silently run the default
    plane (reference: ``common/config.py:_validated_executor``)."""
    if name not in ("psum", "mesh"):
        raise ValueError(
            f"HVD_TPU_EXECUTOR must be 'psum' or 'mesh', got {name!r}")
    return name


def _start_eager_plane(rank, size, device, backend, executor="psum"):
    meta = dist.new_group(backend="gloo")
    data = dist.new_group(backend=backend)
    if executor == "mesh":
        from horovod_tpu_torch.sharding.mesh_executor import MeshExecutor
        cls = MeshExecutor
    else:
        cls = Executor
    controller = Controller(rank, size, meta, cls(data, rank, size, device))
    controller.start()
    return controller


def shutdown():
    global _state
    with _state_lock:
        if _state is None:
            return
        _state.controller.shutdown()
        groups.reset()
        if dist.is_initialized():
            dist.destroy_process_group()
        _state = None


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
