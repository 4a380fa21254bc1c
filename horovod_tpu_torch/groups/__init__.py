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
no such agreement (its groups need no communication).  The group ids are
the reference's: a hash of the name and the member worker ids, the same
on every rank.

Groups are a pure function of their spec and the membership, as in the
reference: the registry records each group's member **worker ids** (the
launcher-assigned initial ranks, ``basics.members()``), and an elastic
reconfiguration re-forms every group at the new epoch (:func:`reform`):
an explicit rank list keeps its workers at their new ranks, or becomes
the sticky typed :class:`GroupUnsatisfiableError` when one of them
left; a grid re-plans its shape over the survivors in C order, or turns
unsatisfiable when the shape no longer fits.  Each surviving group's
two ``torch.distributed`` groups are made again over its new ranks, in
the registry's order, on every rank.  A handle reads the current
incarnation, so one made before a reconfiguration works after it, or
fails typed.  A late joiner (``elastic.wait_for_membership``) starts
with an empty registry: a job that admits joiners makes its process
groups again after the admission.
"""

import hashlib
import threading

import numpy as np
import torch.distributed as dist

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


class _Spec:
    """What a group is, whatever the membership: the worker ids (or the
    grid shape) it was made from.  ``reform`` derives the live
    incarnation from (spec, members) and nothing else."""

    __slots__ = ("gid", "name", "kind", "wids", "sizes", "axis",
                 "coords")

    def __init__(self, gid, name, kind, wids=None, sizes=None,
                 axis=None, coords=None):
        self.gid = gid
        self.name = name
        self.kind = kind          # "ranks" | "grid"
        self.wids = wids          # tuple of worker ids ("ranks")
        self.sizes = sizes        # ordered (axis, size) tuple ("grid")
        self.axis = axis          # the grid axis this group runs along
        self.coords = coords      # its coords on the other axes


# ------------------------------------------------------------- registry
_lock = threading.RLock()
_specs = {}          # gid -> _Spec
_live = {}           # gid -> tuple(ranks) | GroupUnsatisfiableError
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


def _members():
    """The worker ids in rank order (the identity before any elastic
    reconfiguration)."""
    from horovod_tpu_torch.common import basics

    return basics.members()


def _max_groups():
    return env_util.get_int(env_util.HVD_TPU_GROUP_MAX,
                            env_util.DEFAULT_GROUP_MAX)


def _register(spec, ranks):
    """Record a new group and make its two ``torch.distributed`` groups
    (every rank, in the same order)."""
    from horovod_tpu_torch.common import basics

    _specs[spec.gid] = spec
    _live[spec.gid] = ranks
    _torch[spec.gid] = basics._new_torch_groups(list(ranks))


def new_group(ranks, name=None):
    """Create (or return) the process group over ``ranks``, the current
    global ranks; the registry records their worker ids.  Every rank
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
    members = _members()
    wids = tuple(members[r] for r in rank_list)
    if name is None:
        name = f"group.{rank_list[0]}-{rank_list[-1]}" \
               f".{_auto_seq(('ranks', rank_list))}"
    gid = _gid(name, wids)
    with _lock:
        if gid not in _specs:
            if len(_specs) >= _max_groups():
                raise HvdError(
                    f"new_group: more than {_max_groups()} live "
                    f"process groups (HVD_TPU_GROUP_MAX); groups leak "
                    f"— create them once, not per step")
            _register(_Spec(gid, name, "ranks", wids=wids), rank_list)
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
    size.  Every rank calls it, in the same order.  A grid re-plans at
    an elastic reconfiguration (:func:`reform`)."""
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
    return Grid(gname, sizes, _plan_grid(gname, sizes, _members()))


def _plan_grid(gname, sizes, members):
    """Form every axis group of a grid over ``members`` (rank i is
    worker ``members[i]``), axis by axis, line by line: the same order
    on every rank."""
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
                wids = tuple(members[r] for r in ranks)
                gid = _gid(name, wids)
                if gid not in _specs:
                    _register(_Spec(gid, name, "grid", wids=wids,
                                    sizes=sizes, axis=axis,
                                    coords=coords), ranks)
                per_axis[coords] = ProcessGroup(gid, name)
            groups[axis] = per_axis
    return groups


def live_ranks(gid, strict=True):
    """Current global ranks of group ``gid``.  Raises the group's sticky
    :class:`GroupUnsatisfiableError` when a reconfiguration made it
    unsatisfiable (``strict=False``: None for that and for an unknown
    id, instead of raising)."""
    with _lock:
        cur = _live.get(gid)
    if cur is None:
        if strict:
            raise HvdError(f"unknown process group id {gid!r} (created "
                           f"before the last hvd.init()?)")
        return None
    if isinstance(cur, GroupUnsatisfiableError):
        if strict:
            raise cur
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
    """Re-form every registered group for the membership ``members``
    (worker ids in new-rank order; the elastic reconfiguration calls it
    under the state lock, once the new world is up).  A group is a pure
    function of (spec, members): an explicit rank list keeps exactly its
    recorded workers (a missing one makes it the sticky typed
    :class:`GroupUnsatisfiableError`); a grid re-plans the same shape
    over the survivors when it still fits.  Then, when a
    ``torch.distributed`` world is up, each satisfiable group's two
    ``torch.distributed`` groups are made again over its new ranks, in
    the registry's order (every rank, the same order)."""
    members = list(members)
    pos = {w: r for r, w in enumerate(members)}
    with _lock:
        grids_replanned = set()
        for gid, spec in list(_specs.items()):
            if spec.kind == "ranks":
                missing = [w for w in spec.wids if w not in pos]
                if missing:
                    _live[gid] = GroupUnsatisfiableError(spec.name,
                                                         missing)
                else:
                    _live[gid] = tuple(sorted(pos[w]
                                              for w in spec.wids))
            else:    # grid: re-plan the shape over the new membership
                base = spec.name.rsplit(f".{spec.axis}.", 1)[0]
                shape_total = 1
                for _, s in spec.sizes:
                    shape_total *= s
                if (base, spec.sizes) in grids_replanned:
                    continue
                grids_replanned.add((base, spec.sizes))
                if shape_total != len(members):
                    err = GroupUnsatisfiableError(
                        base, [w for w in spec.wids if w not in pos])
                    for g2, s2 in _specs.items():
                        if s2.kind == "grid" and s2.sizes == spec.sizes \
                                and s2.name.startswith(base + "."):
                            _live[g2] = err
                    continue
                # the same shape over the survivors, C order: each gid
                # keeps its (axis, coords) slot with the new ranks
                shape = tuple(s for _, s in spec.sizes)
                arr = np.arange(shape_total).reshape(shape)
                for g2, s2 in _specs.items():
                    if s2.kind != "grid" or s2.sizes != spec.sizes \
                            or not s2.name.startswith(base + "."):
                        continue
                    i = [a for a, _ in s2.sizes].index(s2.axis)
                    moved = np.moveaxis(arr, i, -1)
                    other_shape = moved.shape[:-1]
                    j = int(np.ravel_multi_index(s2.coords,
                                                 other_shape)) \
                        if other_shape else 0
                    ranks = tuple(
                        int(r) for r in moved.reshape(-1, shape[i])[j])
                    _live[g2] = ranks
                    _specs[g2] = _Spec(
                        g2, s2.name, "grid",
                        wids=tuple(members[r] for r in ranks),
                        sizes=s2.sizes, axis=s2.axis, coords=s2.coords)
        if dist.is_available() and dist.is_initialized():
            from horovod_tpu_torch.common import basics

            for gid in _specs:
                cur = _live[gid]
                if isinstance(cur, GroupUnsatisfiableError):
                    _torch.pop(gid, None)
                else:
                    _torch[gid] = basics._new_torch_groups(list(cur))


def _discard(grid_):
    """Drop ``grid_``'s groups from the registry and give its auto-name
    back to the calling thread: the elastic reconfiguration makes the
    runtime's own grids (the hierarchy, the sequence axis) afresh, named
    as a joiner's first ``init`` names them."""
    with _lock:
        for per_axis in grid_._groups.values():
            for g in per_axis.values():
                _specs.pop(g.gid, None)
                _live.pop(g.gid, None)
                _torch.pop(g.gid, None)
    counters = getattr(_tl, "counters", None) or {}
    key = ("grid", grid_.sizes)
    if counters.get(key, 0) > 0:
        counters[key] -= 1


def reset():
    """Forget every group (``hvd.init``/``shutdown`` boundary: groups
    belong to one job; their ``torch.distributed`` groups die with the
    default group)."""
    global _max_inflight
    with _lock:
        _specs.clear()
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
