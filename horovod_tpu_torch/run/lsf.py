"""LSF allocation discovery (port of ``horovod_tpu/run/lsf.py``; reference: ``horovod/run/util/lsf.py`` —
derive the host list and process count from the LSF batch environment
so ``hvdrun-torch`` needs no ``-H`` inside an LSF job)."""

import collections
import os


def using_lsf() -> bool:
    return "LSB_JOBID" in os.environ


def get_compute_hosts():
    """Ordered unique compute hosts of this allocation.

    Prefers ``LSB_MCPU_HOSTS`` ("host1 ncores1 host2 ncores2 ...");
    falls back to ``LSB_HOSTS`` (one entry per slot).  The first host is
    commonly the batch/launch node when it appears with zero compute
    slots — LSF already excludes it from these variables when so.
    """
    mcpu = os.environ.get("LSB_MCPU_HOSTS", "")
    if mcpu:
        fields = mcpu.split()
        return [fields[i] for i in range(0, len(fields) - 1, 2)]
    hosts = os.environ.get("LSB_HOSTS", "").split()
    return list(collections.OrderedDict.fromkeys(hosts))


def get_slots_per_host():
    """host -> slot count from the LSF env (for ``-H host:slots``)."""
    mcpu = os.environ.get("LSB_MCPU_HOSTS", "")
    if mcpu:
        fields = mcpu.split()
        return {fields[i]: int(fields[i + 1])
                for i in range(0, len(fields) - 1, 2)}
    counts = collections.Counter(os.environ.get("LSB_HOSTS", "").split())
    return dict(counts)


def get_num_processes():
    """Total slots in the allocation."""
    return sum(get_slots_per_host().values()) or None


def host_spec():
    """The ``hvdrun-torch -H`` string for this allocation, or None outside LSF."""
    slots = get_slots_per_host()
    if not slots:
        return None
    return ",".join(f"{h}:{n}" for h, n in slots.items())
