"""The rank model of a process-mode job (port of
``horovod_tpu/common/topology.py:27-124``).

- ``rank``: the global worker id, one process a card;
- ``local_rank``: the card's index on this host (the reference's
  shared-memory communicator);
- ``cross_rank``: the host's index (the reference's cross communicator).

Sources, in order: the launcher's ``HVD_*`` contract (``hvdrun-torch``,
``run/launch.py::slot_env``); under ``--launcher mpirun|jsrun``, the
exact rank-block layout ``HVD_HOST_SLOTS`` with the MPI runtime's rank
and size, else the MPI runtime's own local variables.  The reference's
``from_devices`` (its single-controller device-rank mode, where one
process drives every chip of a host) is not ported: a torch process
drives one card.
"""

import dataclasses
import os

from horovod_tpu_torch.utils import env as env_util


@dataclasses.dataclass(frozen=True)
class Topology:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    mode: str  # "process" (the reference's "device" is not ported)

    @property
    def is_homogeneous(self) -> bool:
        return self.size == self.local_size * self.cross_size


def _mpi_placed() -> "Topology | None":
    """Placement under ``hvdrun-torch --launcher mpirun|jsrun``: the
    per-rank values come from the MPI runtime (OpenMPI's
    OMPI_COMM_WORLD_* or the PMI set), since one mpirun command line
    cannot export per-rank values.

    Gated on the delegation contract (the rendezvous address the
    launcher exports): a script under plain mpirun without the launcher
    stays a one-rank job."""
    if env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR) is None:
        return None
    rank = os.environ.get("OMPI_COMM_WORLD_RANK",
                          os.environ.get("PMI_RANK"))
    size = os.environ.get("OMPI_COMM_WORLD_SIZE",
                          os.environ.get("PMI_SIZE"))
    if rank is None or size is None:
        return None
    rank, size = int(rank), int(size)
    placed = _from_host_slots(rank, size)
    if placed is not None:
        return placed
    local_rank = int(os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK",
                                    os.environ.get("MPI_LOCALRANKID", 0)))
    local_size = int(os.environ.get("OMPI_COMM_WORLD_LOCAL_SIZE",
                                    os.environ.get("MPI_LOCALNRANKS", 1)))
    # uniform slots and block placement (mpirun's default --map-by
    # slot fills hosts in rank blocks); the delegation drivers export
    # HVD_HOST_SLOTS so that unequal allocations never reach this
    cross_size = max(size // max(local_size, 1), 1)
    return Topology(rank, size, local_rank, local_size,
                    cross_rank=rank // max(local_size, 1),
                    cross_size=cross_size, mode="process")


def _from_host_slots(rank, size) -> "Topology | None":
    """Exact placement from ``HVD_HOST_SLOTS`` (``"h1:n1,h2:n2"``,
    host-major in rank-block order, as the jsrun rank file and ``mpirun
    -H --map-by slot`` place ranks), right also where hosts carry
    unequal slot counts."""
    spec = env_util.get_str(env_util.HVD_HOST_SLOTS)
    if not spec:
        return None
    counts = []
    for part in spec.split(","):
        host, _, n = part.rpartition(":")
        if not host or not n.isdigit():
            return None
        counts.append(int(n))
    if sum(counts) != size:
        return None  # a stale or foreign layout: the MPI variables
    base = 0
    for cross_rank, n in enumerate(counts):
        if rank < base + n:
            return Topology(rank, size,
                            local_rank=rank - base, local_size=n,
                            cross_rank=cross_rank,
                            cross_size=len(counts), mode="process")
        base += n
    return None


def from_env() -> "Topology | None":
    """The launcher's ``HVD_*`` contract if present, else the MPI
    runtime's placement under a delegated launch; None outside both (a
    one-rank job)."""
    if env_util.get_str(env_util.HVD_RANK) is None:
        return _mpi_placed()
    rank = env_util.get_int(env_util.HVD_RANK, 0)
    size = env_util.get_int(env_util.HVD_SIZE, 1)
    local_rank = env_util.get_int(env_util.HVD_LOCAL_RANK, rank)
    local_size = env_util.get_int(env_util.HVD_LOCAL_SIZE, size)
    cross_rank = env_util.get_int(env_util.HVD_CROSS_RANK, 0)
    cross_size = env_util.get_int(env_util.HVD_CROSS_SIZE, 1)
    return Topology(rank, size, local_rank, local_size, cross_rank,
                    cross_size, mode="process")
