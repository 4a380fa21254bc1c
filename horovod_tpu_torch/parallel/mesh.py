"""The rank mesh (port of ``horovod_tpu/parallel/mesh.py``).

The JAX package expresses every kind of parallelism as sharding over the
named axes of a ``jax.sharding.Mesh`` of devices.  A torch process is
one rank on one card, so the port's :class:`Mesh` lays the world's
ranks out in C order over named axes, and an axis becomes a process
group: ``mesh.group(axis)`` is the group of the ranks that differ from
this one only along ``axis``.  It is a view of ``hvd.grid(...)``'s
:class:`~horovod_tpu_torch.groups.Grid` of the same axes, so
``make_mesh({"dp": 2, "tp": 2}).group("tp")`` and ``hvd.grid(dp=2,
tp=2).group("tp")`` name the same peers.

Canonical axis names (used by ``horovod_tpu_torch.parallel`` and the
models):

- ``dp``     data parallelism (``DistributedOptimizer(group=)``)
- ``fsdp``   fully-sharded data parallelism (parameters split over dp)
- ``tp``     tensor parallelism (Megatron column and row splits)
- ``pp``     pipeline parallelism (one stage a rank)
- ``sp``     sequence parallelism (ring, zigzag and Ulysses attention)
- ``ep``     expert parallelism (switch MoE)

A mesh made by :func:`make_mesh` forms its grid's process groups at the
first call of :meth:`Mesh.group`, a collective call (every rank makes it
at the same point of its program); its shape and :meth:`Mesh.coords`
need no communication, and no ``hvd.init()`` when ``devices`` is given.

Not ported: ``shard_global_batch``.  It assembles one global
``jax.Array`` from every process's local rows; a torch process never
holds a global tensor, and its rows on its own card are already its
shard.
"""

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    DP = "dp"
    FSDP = "fsdp"
    TP = "tp"
    PP = "pp"
    SP = "sp"
    EP = "ep"
    HVD = "hvd"  # the flat rank axis used by the eager collective path


class Mesh:
    """Ranks laid out over named axes (``devices``: the rank array, named
    as the JAX mesh's devices)."""

    def __init__(self, devices, axis_names, grid=None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self._grid = grid

    @property
    def shape(self):
        """``{axis: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self, rank):
        """``{axis: coordinate}`` of ``rank``."""
        where = np.argwhere(self.devices == int(rank))
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        return dict(zip(self.axis_names, (int(c) for c in where[0])))

    def grid(self):
        """The process-group grid of this mesh (made at the first call,
        on every rank)."""
        if self._grid is None:
            from horovod_tpu_torch import groups
            from horovod_tpu_torch.common import basics

            if list(self.devices.flat) != list(range(basics.size())):
                raise ValueError(
                    f"mesh {self.shape} over ranks "
                    f"{list(self.devices.flat)}: process groups need the "
                    f"world's ranks in order")
            self._grid = groups.grid(**self.shape)
        return self._grid

    def group(self, axis, rank=None):
        """The ``axis`` process group of ``rank`` (default: the caller)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        return self.grid().group(axis, rank)

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(axis_shapes=None, *, devices=None) -> Mesh:
    """Build a mesh from ``{axis_name: size}``; one axis may be -1 to
    absorb the remaining ranks (like a reshape).

    ``make_mesh()`` is the flat data-parallel mesh over all ranks.  Axis
    order follows the insertion order of ``axis_shapes`` (C order, as
    ``hvd.grid``).  ``devices``: the ranks (default: the world's, in
    order).
    """
    if devices is None:
        from horovod_tpu_torch.common import basics
        devices = range(basics.size())
    devices = list(devices)
    n = len(devices)
    if not axis_shapes:
        axis_shapes = {MeshAxes.DP: n}
    names = list(axis_shapes.keys())
    sizes = list(axis_shapes.values())
    for name, s in zip(names, sizes):
        if not isinstance(s, int) or isinstance(s, bool):
            raise ValueError(
                f"mesh axis {name!r} size must be an int, got {s!r}")
        if s < 1 and s != -1:
            raise ValueError(
                f"mesh axis {name!r} size must be a positive int (or -1 "
                f"to absorb the remaining devices), got {s}")
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known != 0:
            raise ValueError(
                f"{n} devices not divisible by fixed axes product {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} need "
            f"{math.prod(sizes)} devices, have {n}")
    return Mesh(np.array(devices).reshape(sizes), names)


def data_parallel_mesh(devices=None) -> Mesh:
    return make_mesh({MeshAxes.DP: -1}, devices=devices)


def grid_mesh(grid) -> Mesh:
    """The mesh of a process-group :class:`~horovod_tpu_torch.groups.Grid`:
    the same axis order and C-order layout, and the grid's own groups."""
    shape = tuple(s for _, s in grid.sizes)
    return Mesh(np.arange(math.prod(shape)).reshape(shape), grid.axes,
                grid=grid)


def as_mesh(mesh_or_grid) -> Mesh:
    """Resolve a ``mesh=`` argument that may be a :class:`Mesh` or a
    process-group ``Grid``."""
    if isinstance(mesh_or_grid, Mesh):
        return mesh_or_grid
    if hasattr(mesh_or_grid, "mesh_axes"):
        return grid_mesh(mesh_or_grid)
    raise TypeError(
        f"expected a horovod_tpu_torch Mesh or hvd.grid(...) Grid, got "
        f"{type(mesh_or_grid).__name__}")


def hierarchical_mesh(local_size=None, devices=None) -> Mesh:
    """2-D (cross, local) mesh of the hierarchical allreduce's topology:
    ``local`` ranks share a host.  ``local_size`` defaults to
    ``HVD_LOCAL_SIZE`` (``hvd.local_size()``), where the JAX package
    counts the devices of one process."""
    if devices is None:
        from horovod_tpu_torch.common import basics
        devices = range(basics.size())
    devices = list(devices)
    if local_size is None:
        from horovod_tpu_torch.common import basics
        local_size = basics.local_size()
    if len(devices) % local_size != 0:
        raise ValueError(
            f"{len(devices)} devices not divisible by local_size "
            f"{local_size}")
    return make_mesh({"cross": len(devices) // local_size,
                      "local": local_size}, devices=devices)
