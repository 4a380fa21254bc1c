"""Rendezvous key-value HTTP server (port of
``horovod_tpu/run/http_server.py``).

Reference: ``horovod/run/http/http_server.py`` (``KVStoreHandler`` :36,
``RendezvousServer`` :179) — a threaded HTTP server storing values under
``/scope/key``, used by workers for address exchange (rank 0 publishes its
``torch.distributed`` store there, ``common/basics.py``) and by the
programmatic ``run()`` API for the function and its results.  The verbs
and status codes are the reference's: PUT 200; GET 200 or 404;
``GET /__list__/<scope>`` 200 with the names; DELETE 200 (``/__scope__/
<scope>`` drops a scope); POST put-if-absent answering the winner, with
``X-Hvd-Created``; a path without a key 400.
"""

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from horovod_tpu_torch.utils.logging import get_logger


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _split(self):
        parts = self.path.strip("/").split("/", 1)
        if len(parts) != 2:
            return None, None
        return parts[0], parts[1]

    def do_PUT(self):
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        if scope is None:
            self.send_response(400)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        with self.server.kv_lock:
            self.server.kv.setdefault(scope, {})[key] = value
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_POST(self):
        # atomic compare-and-set, put-if-absent flavor (coordinator
        # fail-over election, docs/elastic.md#coordinator-fail-over):
        # the FIRST value posted under /scope/key sticks; every POST —
        # winner and loser alike — answers with the winning value, and
        # X-Hvd-Created says whether THIS request created it.  A
        # replayed winner's POST therefore reads back its own value
        # (created: false) — retry-idempotent by construction.
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        if scope is None:
            self.send_response(400)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        with self.server.kv_lock:
            bucket = self.server.kv.setdefault(scope, {})
            created = key not in bucket
            if created:
                bucket[key] = value
            winner = bucket[key]
        self.send_response(200)
        self.send_header("Content-Length", str(len(winner)))
        self.send_header("X-Hvd-Created", "true" if created else "false")
        self.end_headers()
        self.wfile.write(winner)

    def do_GET(self):
        scope, key = self._split()
        if scope == "__list__":
            # key enumeration for a scope (reference analog: the elastic
            # driver's discovered-hosts poll): newline-joined key names,
            # 200 + empty body when the scope holds nothing — callers
            # distinguish "no keys yet" from a dead server
            with self.server.kv_lock:
                names = sorted(self.server.kv.get(key, {}))
            body = "\n".join(names).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        with self.server.kv_lock:
            value = self.server.kv.get(scope, {}).get(key)
        if value is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_DELETE(self):
        scope, key = self._split()
        with self.server.kv_lock:
            if scope == "__scope__":
                # whole-scope purge (mirrors the __list__ enumeration
                # spelling): elastic reconfiguration drops the dead
                # epochs' suffixed scopes in one request per scope
                self.server.kv.pop(key, None)
            else:
                self.server.kv.get(scope, {}).pop(key, None)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, fmt, *args):  # quiet by default
        get_logger().debug("rendezvous: " + fmt, *args)


class RendezvousServer:
    """Threaded KV server; bind to an ephemeral port and share the address
    with workers through the env contract."""

    def __init__(self, host="0.0.0.0"):
        self._server = ThreadingHTTPServer((host, 0), _KVHandler)
        self._server.kv = {}
        self._server.kv_lock = threading.Lock()
        self._thread = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="hvd-rendezvous")
        self._thread.start()
        return self.port

    def get(self, scope, key):
        with self._server.kv_lock:
            return self._server.kv.get(scope, {}).get(key)

    def scope_size(self, scope) -> int:
        with self._server.kv_lock:
            return len(self._server.kv.get(scope, {}))

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
