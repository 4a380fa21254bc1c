"""Rendezvous KV client (port of ``horovod_tpu/run/http_client.py``;
reference: ``horovod/run/http/http_client.py``).

Every verb rides the same bounded transient-failure retry with
exponential backoff + jitter: a single TCP blip (driver briefly
saturated, RST mid-handshake) must not lose a worker's result after
hours of training, and the jitter keeps N ranks that hit the same blip
from re-knocking in lockstep (a thundering herd the fixed-interval
retry used to produce).
"""

import time
import urllib.error
import urllib.request

from horovod_tpu_torch.run.service import network

DEFAULT_RETRY_FOR = 30.0


def _backoff_delay(attempt):
    # one jitter policy for the whole transport layer
    return network.backoff_delay(attempt, cap=1.0)


def request(method, addr, port, scope, key, data=None,
            retry_for=DEFAULT_RETRY_FOR) -> bytes:
    """One KV request with bounded transient-failure retry (any verb).

    HTTP errors are NOT retried — the server spoke, so the failure is
    semantic (404 missing key, 400 bad path) and the caller owns it.
    """
    url = f"http://{addr}:{port}/{scope}/{key}"
    deadline = time.monotonic() + retry_for
    attempt = 0
    while True:
        req = urllib.request.Request(url, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.read()
        except urllib.error.HTTPError:
            raise
        except (urllib.error.URLError, OSError):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise
            time.sleep(min(_backoff_delay(attempt), max(remaining, 0.0)))
            attempt += 1


def put(addr, port, scope, key, value: bytes, retry_for=DEFAULT_RETRY_FOR):
    request("PUT", addr, port, scope, key, data=value, retry_for=retry_for)


def delete(addr, port, scope, key, retry_for=DEFAULT_RETRY_FOR):
    request("DELETE", addr, port, scope, key, retry_for=retry_for)


def delete_scope(addr, port, scope, retry_for=DEFAULT_RETRY_FOR):
    """Drop ``scope`` and every key in it — the server's
    ``/__scope__/<scope>`` purge endpoint (dead-epoch rendezvous
    cleanup, docs/elastic.md)."""
    request("DELETE", addr, port, "__scope__", scope, retry_for=retry_for)


def list_keys(addr, port, scope, retry_for=DEFAULT_RETRY_FOR):
    """Key names currently present in ``scope`` (may be empty) — the
    server's ``/__list__/<scope>`` enumeration endpoint."""
    body = request("GET", addr, port, "__list__", scope, retry_for=retry_for)
    return [name for name in body.decode().split("\n") if name]


def cas_put(addr, port, scope, key, value: bytes,
            retry_for=DEFAULT_RETRY_FOR) -> bytes:
    """Atomic put-if-absent returning the WINNING value — the server's
    POST endpoint (coordinator fail-over election, docs/elastic.md).

    The first value posted under ``scope/key`` sticks; every caller
    gets the winner back, so ``cas_put(...) == value`` means this
    caller won the race.  Safe to retry across transport blips: a
    replayed POST of the winner's own value reads it straight back.
    """
    return request("POST", addr, port, scope, key, data=value,
                   retry_for=retry_for)


def get(addr, port, scope, key, timeout=None, retry_for=DEFAULT_RETRY_FOR):
    """GET; if ``timeout`` is set, poll until the key appears.

    Two independent budgets: ``retry_for`` bounds transport-blip
    retries inside each attempt, ``timeout`` bounds the 404 wait for a
    key another rank has not published yet.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        # clip the transport-retry budget to the caller's deadline: a
        # poll bounded by HVD_START_TIMEOUT must not overshoot it just
        # because the server is unreachable rather than missing the key
        budget = retry_for if deadline is None else max(
            0.0, min(retry_for, deadline - time.monotonic()))
        try:
            return request("GET", addr, port, scope, key,
                           retry_for=budget)
        except urllib.error.HTTPError as exc:
            if exc.code != 404:
                raise
            if deadline is None or time.monotonic() > deadline:
                raise KeyError(f"{scope}/{key} not found in rendezvous")
            time.sleep(0.05)
