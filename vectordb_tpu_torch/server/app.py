"""HTTP serving: AppState + a stdlib threaded HTTP server.

Port of ``vectordb_tpu/server/app.py`` (reference src/server/mod.rs:13-51):
``AppState`` holds the store and metrics behind a readers-writer lock;
``start_flat`` builds the state and serves over the stdlib
``ThreadingHTTPServer``; ``serve`` takes any store's state, e.g. a PQ
store's (``VectorStore.with_index(PqFlatIndex(metric))``, as the CLI's
``--index pq serve`` builds it; the ``refine`` knob reaches it through
the routes); ``start_durable`` serves a WAL-backed ``StorageEngine``.
Route logic lives in routes.Api, which the in-process tests drive
directly.

Not in this slice: the native epoll front-end (``backend="native"``,
ROADMAP queue 1 item 8), the query batcher (``batch_window_ms > 0``,
same item), and HNSW serving (item 10).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import unquote

from ..distance import DistanceMetric
from ..metrics import MetricsCollector
from ..store import VectorStore
from ..utils.locks import RwLock
from .routes import Api


class VdbHTTPServer(ThreadingHTTPServer):
    """Threaded server tuned for bursty concurrent clients: the stdlib
    default listen backlog of 5 drops connections the moment requests
    queue."""
    request_queue_size = 256
    daemon_threads = True


class AppState:
    """Shared server state (reference: src/server/mod.rs:13-16)."""

    def __init__(self, store: "VectorStore",
                 metrics: Optional[MetricsCollector] = None):
        self.store = store
        self.metrics = metrics or MetricsCollector()
        self.lock = RwLock()


def _make_handler(api: Api):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _read_body(self):
            length = int(self.headers.get("Content-Length") or 0)
            if length == 0:
                return None
            raw = self.rfile.read(length)
            try:
                return json.loads(raw)
            except json.JSONDecodeError:
                return ValueError("invalid JSON body")

        def _respond(self, status: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _dispatch(self) -> None:
            body = self._read_body()
            if isinstance(body, ValueError):
                self._respond(400, {"error": str(body)})
                return
            # strip the query string and URL-decode (so /vectors/some%20id
            # matches the literal ID, like the reference's Path extractor)
            path = unquote(self.path.partition("?")[0])
            try:
                status, payload = api.handle(self.command, path, body)
            except Exception as e:  # defense in depth: never kill the worker
                status, payload = 500, {"error": str(e)}
            self._respond(status, payload)

        do_GET = do_POST = do_DELETE = do_PUT = _dispatch

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def _check_serving_options(batch_window_ms: float, backend: str) -> None:
    if backend == "native":
        raise NotImplementedError(
            "the native HTTP front-end is not ported yet (ROADMAP queue 1 "
            "item 8); use backend='python'")
    if backend not in ("auto", "python"):
        raise ValueError(f"unknown backend: {backend!r}")
    if batch_window_ms and batch_window_ms > 0:
        raise NotImplementedError(
            "the query batcher (batch_window_ms > 0) is not ported yet "
            "(ROADMAP queue 1 item 8)")


def serve(addr: str, state: AppState,
          ready_event: Optional[threading.Event] = None,
          batch_window_ms: float = 0.0, backend: str = "auto") -> None:
    """Bind and serve forever (reference: src/server/mod.rs:27-29) on the
    stdlib threaded server ("auto" resolves to it in this slice)."""
    _check_serving_options(batch_window_ms, backend)
    host, port = _split_addr(addr)
    server = VdbHTTPServer((host, port), _make_handler(Api(state)))
    print(f"vectordb-tpu-torch server listening on "
          f"{host}:{server.server_address[1]}", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        server.serve_forever()
    finally:
        server.server_close()


def start_server_background(addr: str, state: AppState
                            ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Non-blocking serve for tests/embedding; returns (server, thread).
    Stop it with ``server.shutdown(); server.server_close()``."""
    host, port = _split_addr(addr)
    server = VdbHTTPServer((host, port), _make_handler(Api(state)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    if not host:
        host, port = addr, "3000"
    return host, int(port)


def start_flat(addr: str, metric: DistanceMetric,
               batch_window_ms: float = 0.0, backend: str = "auto",
               search_mode: str = "exact", device="cuda",
               storage: str = "f32") -> None:
    """Serve an in-memory flat-index store (reference:
    src/server/mod.rs:19-31) with its device state on ``device``."""
    _check_serving_options(batch_window_ms, backend)
    serve(addr,
          AppState(VectorStore.with_flat_index(metric,
                                               search_mode=search_mode,
                                               storage=storage,
                                               device=device)),
          batch_window_ms=batch_window_ms, backend=backend)


def start_durable(addr: str, data_dir, config=None,
                  batch_window_ms: float = 0.0,
                  backend: str = "auto") -> None:
    """Serve a WAL-backed persistent store (beyond the reference, which
    rejects serve + --data-dir: src/main.rs:100-102). Every HTTP insert and
    delete is durable in the WAL before the response is sent (routes hold
    the write lock across the engine call, so appends serialize); reads go
    to the recovered store; POST /checkpoint forces a snapshot and a WAL
    truncate. ``config.device`` (default "cuda") places the index."""
    _check_serving_options(batch_window_ms, backend)
    from ..persistence import StorageEngine
    with StorageEngine.open(data_dir, config) as engine:
        serve(addr, AppState(engine), batch_window_ms=batch_window_ms,
              backend=backend)


__all__ = ["AppState", "serve", "start_durable", "start_flat",
           "start_server_background"]
