"""Process groups: concurrent sub-communicators (port of
``horovod_tpu/groups/__init__.py``).

A :class:`ProcessGroup` is a named subset of the world with a
negotiation namespace of its own: the group id joins every request
signature, response-cache key and fusion bucket key of the eager plane
(``ops/controller.py``), so collectives of different groups never fuse,
never collide in the cache, and can be in flight at once.  :class:`Grid`
(``hvd.grid(dp=..., tp=..., pp=...)``) lays the world out in C order
over named axes and makes one group per line of each axis, the same
layout ``parallel.mesh.make_mesh`` gives.

Each group is backed by two ``torch.distributed`` groups over its ranks
(NCCL on the card, gloo on the CPU), each an NCCL communicator with
streams of its own: one for the eager plane's cycle thread
(:func:`plane_group`) and one for the collectives the caller's thread
issues directly (:func:`torch_group`: tensor, expert and pipeline
parallelism, ``DistributedOptimizer(group=)``).  Two threads never share
a communicator.

**Every rank creates every group, in the same order.**
``torch.distributed.new_group`` requires it, non-members included, so
``new_group`` and ``grid`` are collective calls here: every rank runs
them at the same point of its program.  The reference's registry needs
no such agreement (its groups are a pure function of the membership and
need no communication).  The group ids are the reference's: a hash of
the name and the member ids, the same on every rank.

Not ported: ``reform`` and the sticky unsatisfiable state it creates,
which belong to elastic reconfiguration (ROADMAP A.13); the port's
membership is the world of ``hvd.init()``, and a worker id is its rank.
"""

import hashlib
import threading

import numpy as np

from horovod_tpu_torch.common.handles import HvdError
from horovod_tpu_torch.utils import env as env_util


class GroupUnsatisfiableError(HvdError):
    """An explicit-rank group references a departed worker: the spec
    cannot be satisfied by the surviving membership, so the group is
    dead — typed, so callers can tell "re-create me" from a hang."""

    def __init__(self, name, missing):
        self.group_name = name
        self.missing = tuple(sorted(missing))
        super().__init__(
            f"process group '{name}' is unsatisfiable after "
            f"reconfiguration: worker id(s) {list(self.missing)} "
            f"departed (explicit rank lists do not re-plan; re-create "
            f"the group from the surviving membership)")


class ProcessGroup:
    """Handle of a sub-communicator, accepted through ``group=`` by every
    collective; its identity is the deterministic ``gid``."""

    __slots__ = ("gid", "name")

    def __init__(self, gid, name):
        self.gid = gid
        self.name = name

    @property
    def ranks(self):
        return live_ranks(self.gid)

    @property
    def size(self):
        return len(self.ranks)

    def rank(self, global_rank=None):
        """Group-local rank of ``global_rank`` (default: the calling
        rank), or -1 when it is not a member."""
        if global_rank is None:
            from horovod_tpu_torch.common import basics
            global_rank = basics.rank()
        ranks = self.ranks
        try:
            return ranks.index(int(global_rank))
        except ValueError:
            return -1

    def __contains__(self, global_rank):
        return int(global_rank) in self.ranks

    def __repr__(self):
        return (f"ProcessGroup(name={self.name!r}, gid={self.gid!r}, "
                f"ranks={list(live_ranks(self.gid, strict=False) or ())})")


# ------------------------------------------------------------- registry
_lock = threading.RLock()
_live = {}           # gid -> tuple(ranks)
_torch = {}          # gid -> (caller's torch group, eager plane's)
_tl = threading.local()   # per-thread auto-name counters
_stats_lock = threading.Lock()
_max_inflight = 0    # high-water mark of distinct groups in flight


def _auto_seq(key):
    """Per-thread sequence number for ``key``: every rank's n-th creation
    of the same spec names the same group."""
    counters = getattr(_tl, "counters", None)
    if counters is None:
        counters = _tl.counters = {}
    n = counters.get(key, 0)
    counters[key] = n + 1
    return n


def _gid(name, wids):
    return hashlib.sha1(
        f"{name}|{','.join(str(w) for w in wids)}".encode()
    ).hexdigest()[:12]


def _max_groups():
    return env_util.get_int(env_util.HVD_TPU_GROUP_MAX,
                            env_util.DEFAULT_GROUP_MAX)


def _register(gid, ranks):
    """Record a new group and make its two ``torch.distributed`` groups
    (every rank, in the same order)."""
    from horovod_tpu_torch.common import basics

    _live[gid] = ranks
    _torch[gid] = basics._new_torch_groups(list(ranks))


def new_group(ranks, name=None):
    """Create (or return) the process group over ``ranks``.  Every rank
    calls it, members or not, in the same order (see the module
    docstring)."""
    from horovod_tpu_torch.common import basics

    world = basics.size()
    rank_list = tuple(sorted({int(r) for r in ranks}))
    if not rank_list:
        raise HvdError("new_group: empty rank list")
    if rank_list[0] < 0 or rank_list[-1] >= world:
        raise HvdError(
            f"new_group: ranks {list(rank_list)} out of range for "
            f"world size {world}")
    wids = rank_list   # a worker id is its rank until A.13
    if name is None:
        name = f"group.{rank_list[0]}-{rank_list[-1]}" \
               f".{_auto_seq(('ranks', rank_list))}"
    gid = _gid(name, wids)
    with _lock:
        if gid not in _live:
            if len(_live) >= _max_groups():
                raise HvdError(
                    f"new_group: more than {_max_groups()} live "
                    f"process groups (HVD_TPU_GROUP_MAX); groups leak "
                    f"— create them once, not per step")
            _register(gid, rank_list)
    return ProcessGroup(gid, name)


class Grid:
    """DP x TP x PP (x anything) rank grid: world ranks arranged C-order
    over the named axes — the layout ``parallel.mesh.make_mesh`` gives,
    so ``grid.group(axis)`` and the mesh axis of the same name name the
    same peers."""

    __slots__ = ("name", "sizes", "_groups")

    def __init__(self, name, sizes, groups):
        self.name = name
        self.sizes = sizes          # ordered (axis, size) tuple
        self._groups = groups       # axis -> {coords: ProcessGroup}

    @property
    def axes(self):
        return tuple(a for a, _ in self.sizes)

    def group(self, axis, rank=None):
        """The ``axis`` group containing ``rank`` (default: caller)."""
        if rank is None:
            from horovod_tpu_torch.common import basics
            rank = basics.rank()
        coords = self.coords(rank)
        key = tuple(c for (a, _), c in zip(self.sizes, coords)
                    if a != axis)
        try:
            return self._groups[axis][key]
        except KeyError:
            raise HvdError(
                f"grid '{self.name}': no {axis!r} group for rank "
                f"{rank}") from None

    def coords(self, rank):
        """(axis coords) of ``rank`` in C-order, mirroring make_mesh."""
        shape = tuple(s for _, s in self.sizes)
        return tuple(int(c) for c in np.unravel_index(int(rank), shape))

    def mesh_axes(self):
        """Axis-shape dict for ``make_mesh`` (insertion order kept)."""
        return dict(self.sizes)


def grid(**axes):
    """``hvd.grid(dp=..., tp=..., pp=...)``: partition the world into one
    group per line of each named axis.  Axis order follows the kwargs
    (C-order, as ``make_mesh``); the sizes must multiply to the world
    size.  Every rank calls it, in the same order."""
    from horovod_tpu_torch.common import basics

    world = basics.size()
    sizes = tuple((str(a), int(s)) for a, s in axes.items() if s)
    if not sizes:
        raise HvdError("grid: at least one axis size is required")
    total = 1
    for _, s in sizes:
        if s <= 0:
            raise HvdError(f"grid: axis sizes must be positive: {axes}")
        total *= s
    if total != world:
        raise HvdError(
            f"grid: axis sizes {dict(sizes)} multiply to {total}, but "
            f"the world has {world} ranks")
    gname = f"grid.{'x'.join(f'{a}{s}' for a, s in sizes)}" \
            f".{_auto_seq(('grid', sizes))}"
    return Grid(gname, sizes, _plan_grid(gname, sizes))


def _plan_grid(gname, sizes):
    """Form every axis group of a grid, axis by axis, line by line: the
    same order on every rank."""
    shape = tuple(s for _, s in sizes)
    arr = np.arange(int(np.prod(shape))).reshape(shape)
    groups = {}
    with _lock:
        for i, (axis, _) in enumerate(sizes):
            per_axis = {}
            moved = np.moveaxis(arr, i, -1)
            flat = moved.reshape(-1, shape[i])
            other_shape = moved.shape[:-1]
            for j in range(flat.shape[0]):
                coords = tuple(
                    int(c) for c in np.unravel_index(j, other_shape)) \
                    if other_shape else ()
                ranks = tuple(int(r) for r in flat[j])
                name = f"{gname}.{axis}." \
                       f"{'-'.join(str(c) for c in coords) or '0'}"
                gid = _gid(name, ranks)
                if gid not in _live:
                    _register(gid, ranks)
                per_axis[coords] = ProcessGroup(gid, name)
            groups[axis] = per_axis
    return groups


def live_ranks(gid, strict=True):
    """Current global ranks of group ``gid`` (``strict=False``: None for
    an unknown id instead of raising)."""
    with _lock:
        cur = _live.get(gid)
    if cur is None:
        if strict:
            raise HvdError(f"unknown process group id {gid!r} (created "
                           f"before the last hvd.init()?)")
        return None
    return list(cur)


def resolve(group):
    """(gid, ranks) for a ``group=`` argument: ("", None) for the world
    (None), else the group's id and member ranks."""
    if group is None:
        return "", None
    if not isinstance(group, ProcessGroup):
        raise HvdError(
            f"group= expects a ProcessGroup from hvd.new_group()/"
            f"hvd.grid(), got {type(group).__name__}")
    return group.gid, tuple(live_ranks(group.gid))


def _torch_pair(gid):
    with _lock:
        pair = _torch.get(gid)
    if pair is None:
        raise HvdError(f"unknown process group id {gid!r} (created "
                       f"before the last hvd.init()?)")
    return pair


def torch_group(group):
    """The ``torch.distributed`` group of a :class:`ProcessGroup` for
    collectives issued from the caller's thread (``None``: the default
    group)."""
    if group is None:
        return None
    return _torch_pair(resolve(group)[0])[0]


def plane_group(gid):
    """The eager plane's ``torch.distributed`` group of group ``gid``."""
    return _torch_pair(gid)[1]


def reform(members):
    """Re-forming groups for a new membership belongs to elastic
    reconfiguration, which is not ported yet."""
    raise NotImplementedError(
        "groups.reform: elastic reconfiguration is not ported yet "
        "(ROADMAP A.13)")


def reset():
    """Forget every group (``hvd.init``/``shutdown`` boundary: groups
    belong to one job; their ``torch.distributed`` groups die with the
    default group)."""
    global _max_inflight
    with _lock:
        _live.clear()
        _torch.clear()
    _tl.counters = {}
    with _stats_lock:
        _max_inflight = 0


def note_inflight(gids):
    """Record the number of distinct sub-groups with negotiation entries
    open right now (the eager plane's cycle calls it).  The world ("") is
    excluded: ``max_concurrent_groups >= 2`` certifies two real groups in
    flight at once."""
    global _max_inflight
    n = len({g for g in gids if g})
    if n:
        with _stats_lock:
            if n > _max_inflight:
                _max_inflight = n


def stats():
    with _stats_lock:
        return {"max_concurrent_groups": _max_inflight}
