"""Host and slot allocation: map ranks onto hosts (port of
``horovod_tpu/run/allocate.py``).

Reference: ``horovod/run/gloo_run.py:54`` ``_allocate``: parse
``host:slots`` specs and assign rank, local_rank and cross_rank to each
process, and ``runner.py``'s hostfile parsing.  A slot is one card.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass(frozen=True)
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def parse_hosts(hosts: str):
    """Parse ``"h1:4,h2:4"`` (slots default 1)."""
    out = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            out.append(HostInfo(name, int(slots)))
        else:
            out.append(HostInfo(part, 1))
    if not out:
        raise ValueError(f"no hosts found in spec '{hosts}'")
    return out


def parse_hostfile(path: str):
    """Hostfile format: one ``hostname slots=N`` (or ``hostname:N``) per
    line; '#' comments."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "slots=" in line:
                name, _, slots = line.partition("slots=")
                hosts.append(HostInfo(name.strip(), int(slots)))
            elif ":" in line:
                name, _, slots = line.rpartition(":")
                hosts.append(HostInfo(name, int(slots)))
            else:
                hosts.append(HostInfo(line, 1))
    if not hosts:
        raise ValueError(f"hostfile '{path}' contains no hosts")
    return hosts


def allocate(hosts, np_total: int):
    """Assign ``np_total`` ranks round-filling hosts in order; returns one
    SlotInfo per rank (reference: _allocate fills each host's slots before
    moving on)."""
    # coalesce duplicate hostnames (their slots add up) and drop
    # zero-slot entries: bookkeeping below keys by hostname, so
    # duplicates would double-bind local_ranks to one device, and a
    # drained 0-slot host would become a phantom cross-peer that no
    # process owns (hanging cross collectives)
    merged = {}
    order = []
    for h in hosts:
        if h.slots <= 0:
            continue
        if h.hostname in merged:
            merged[h.hostname] = HostInfo(
                h.hostname, merged[h.hostname].slots + h.slots)
        else:
            merged[h.hostname] = h
            order.append(h.hostname)
    hosts = [merged[name] for name in order]
    if not hosts:
        raise ValueError("no hosts with available slots")
    capacity = sum(h.slots for h in hosts)
    if np_total > capacity:
        raise ValueError(
            f"requested {np_total} processes but hosts only provide "
            f"{capacity} slots")
    # which hosts actually get ranks (for cross_size)
    assignments = []  # (host, local_rank)
    remaining = np_total
    used_hosts = []
    for host in hosts:
        if remaining <= 0:
            break
        n = min(host.slots, remaining)
        used_hosts.append((host, n))
        for local_rank in range(n):
            assignments.append((host, local_rank))
        remaining -= n
    cross_size = len(used_hosts)
    host_index = {h.hostname: i for i, (h, _) in enumerate(used_hosts)}
    host_local_size = {h.hostname: n for h, n in used_hosts}

    slots = []
    for rank, (host, local_rank) in enumerate(assignments):
        slots.append(SlotInfo(
            hostname=host.hostname,
            rank=rank,
            size=np_total,
            local_rank=local_rank,
            local_size=host_local_size[host.hostname],
            cross_rank=host_index[host.hostname],
            cross_size=cross_size,
        ))
    return slots
