"""Steady-state signature cache (port of
``horovod_tpu/common/response_cache.py``; reference:
``horovod/common/response_cache.cc``): an LRU of validated tensor
signatures, each under a small integer id.

Every rank holds the same cache: each feeds it the same negotiated
signatures in the same order.  So a rank that resubmits a name with the
signature it was last validated with sends the entry's id in its cycle
message instead of the name and the signature (the reference's cache
bit), and every rank reads the id back from its own copy; a name whose
every rank repeats that signature skips validation.
"""

from collections import OrderedDict


class SignatureCache:
    """name -> (id, last validated signature), LRU-bounded.

    The sender asks :meth:`id_of`; every rank resolves an id with
    :meth:`entry` before the cycle changes the cache, then calls
    :meth:`check` (True == HIT: skip validation) and, on a MISS,
    :meth:`store` once the name has validated.
    """

    def __init__(self, capacity=1024):
        self._entries = OrderedDict()   # name -> (id, signature)
        self._names = {}                # id -> name
        self._next_id = 0
        self._capacity = capacity
        self.hits = 0
        # off (the autotuner's candidate): no ids are sent and every
        # name validates; every rank flips it at the same cycle
        self.enabled = True

    def id_of(self, name, sig):
        """The id to send for this rank's request, or None when the
        cache holds another signature, or none, for the name.  Read only:
        the LRU order changes on every rank alike, in :meth:`check`."""
        cached = self._entries.get(name) if self.enabled else None
        return cached[0] if cached is not None and cached[1] == sig else None

    def entry(self, cache_id):
        """-> (name, signature) of an id a rank sent."""
        name = self._names[cache_id]
        return name, self._entries[name][1]

    def check(self, name, sigs) -> bool:
        """True iff every rank's signature agrees and matches the cached
        one.  ``sigs`` is an iterable of per-rank signatures."""
        sigs = set(sigs)
        if len(sigs) != 1 or not self.enabled:
            return False
        cached = self._entries.get(name)
        if cached is not None and cached[1] == next(iter(sigs)):
            self._entries.move_to_end(name)
            self.hits += 1
            return True
        return False

    def store(self, name, sigs):
        """Record a validated round's signature under a new id; only when
        all ranks agreed (a mixed set means per-rank shapes legitimately
        differ, e.g. variable-dim0 allgather)."""
        sigs = set(sigs)
        if len(sigs) != 1 or not self.enabled:
            return
        old = self._entries.pop(name, None)
        if old is not None:
            del self._names[old[0]]
        self._entries[name] = (self._next_id, next(iter(sigs)))
        self._names[self._next_id] = name
        self._next_id += 1
        while len(self._entries) > self._capacity:
            _, (cache_id, _) = self._entries.popitem(last=False)
            del self._names[cache_id]

    def __len__(self):
        return len(self._entries)
