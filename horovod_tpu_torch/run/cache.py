"""On-disk memo for launcher-side checks (port of
``horovod_tpu/run/cache.py``; reference:
``horovod/run/util/cache.py`` — 60-minute cache of ssh reachability and
NIC discovery results so repeated ``horovodrun`` invocations skip the
slow probes)."""

import json
import os
import threading
import time

DEFAULT_TTL_SECONDS = 60 * 60


class Cache:
    def __init__(self, path=None, ttl_seconds=DEFAULT_TTL_SECONDS,
                 parameters_hash=""):
        if path is None:
            # one file per parameter set: alternating configurations
            # (e.g. different ssh ports) must not clobber each other
            import hashlib
            tag = hashlib.md5(parameters_hash.encode()).hexdigest()[:8]
            path = os.path.join(os.path.expanduser("~"),
                                ".horovod_tpu_torch", f"cache-{tag}.json")
        self._path = path
        self._ttl = ttl_seconds
        self._params = parameters_hash
        self._lock = threading.Lock()
        self._content = self._load()

    def _load(self):
        try:
            with open(self._path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        # a changed parameter set (e.g. different ssh port) invalidates
        # everything, like the reference's parameters-hash guard
        if data.get("__params__") != self._params:
            return {}
        return data

    def get(self, key):
        with self._lock:
            entry = self._content.get(key)
            if entry is None:
                return None
            value, ts = entry
            if time.time() - ts > self._ttl:
                del self._content[key]
                return None
            return value

    def put(self, key, value):
        with self._lock:
            self._content[key] = (value, time.time())
            self._content["__params__"] = self._params
            try:
                os.makedirs(os.path.dirname(self._path), exist_ok=True)
                tmp = f"{self._path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(self._content, f)
                os.replace(tmp, self._path)
            except OSError:
                pass  # cache is best-effort
