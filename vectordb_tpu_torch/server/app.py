"""HTTP serving: AppState + the native C++ front end or a stdlib server.

Port of ``vectordb_tpu/server/app.py`` (reference src/server/mod.rs:13-51):
``AppState`` holds the store and metrics behind a readers-writer lock;
``serve`` binds one of three backends: "native" (the C++ epoll front end,
``native_http.NativeHttpServer``, whose drained job batches become one
device search each), "python" (the stdlib ``ThreadingHTTPServer``) or
"auto" (native unless ``VDB_TPU_NO_NATIVE`` is set, as in the JAX
package). ``batch_window_ms > 0`` puts the query batcher
(``batcher.QueryBatcher``) behind the routes. ``start_flat``,
``start_hnsw`` and ``start_durable`` build a store and serve it. Route
logic lives in routes.Api, which the in-process tests drive directly.

The JAX package's ``serve`` also turns on XLA's persistent compile cache;
the port has no such cache (its kernels build once per source hash).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import unquote

from ..distance import DistanceMetric
from ..index.hnsw import HnswIndex, HnswParams
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
    """Shared server state (reference: src/server/mod.rs:13-16).

    ``store`` is anything exposing the VectorStore surface: an in-memory
    VectorStore or a persistence.StorageEngine (durable serving).
    ``server`` is the front end ``serve`` bound for it (None before), so
    an embedding caller can read its port and stop it with
    ``server.shutdown()``."""

    def __init__(self, store: "VectorStore",
                 metrics: Optional[MetricsCollector] = None):
        self.store = store
        self.metrics = metrics or MetricsCollector()
        self.lock = RwLock()
        self.server = None


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


def _make_api(state: AppState, batch_window_ms: float) -> Api:
    if batch_window_ms and batch_window_ms > 0:
        from .batcher import QueryBatcher
        batcher = QueryBatcher(state.store, state.lock,
                               window_ms=batch_window_ms)
        return Api(state, batcher=batcher)
    return Api(state)


def serve(addr: str, state: AppState,
          ready_event: Optional[threading.Event] = None,
          batch_window_ms: float = 0.0, backend: str = "auto") -> None:
    """Bind and serve until stopped (reference: src/server/mod.rs:27-29).

    ``backend``: "native" = the C++ epoll front end (httpcore.cpp) with
    drain-batched searches; "python" = the stdlib threaded server; "auto"
    (default) = native when the library is available. ``state.server``
    is the bound server once ``ready_event`` is set."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend: {backend!r}")
    host, port = _split_addr(addr)
    api = _make_api(state, batch_window_ms)
    if backend == "auto":
        from .native_http import native_http_available
        backend = "native" if native_http_available() else "python"
    try:
        if backend == "native":
            from .native_http import NativeHttpServer
            server = NativeHttpServer(api, host, port)
            state.server = server
            print(f"vectordb-tpu-torch server (native) listening on "
                  f"{host}:{server.port}", flush=True)
            if ready_event is not None:
                ready_event.set()
            try:
                server.serve_forever()
            finally:
                server.shutdown()
            return
        server = VdbHTTPServer((host, port), _make_handler(api))
        state.server = server
        print(f"vectordb-tpu-torch server listening on "
              f"{host}:{server.server_address[1]}", flush=True)
        if ready_event is not None:
            ready_event.set()
        try:
            server.serve_forever()
        finally:
            server.server_close()
    finally:
        if api.batcher is not None:
            api.batcher.close()


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
               search_mode: str = "exact", storage: str = "f32",
               device="cuda") -> None:
    """Serve an in-memory flat-index store (reference:
    src/server/mod.rs:19-31) with its device state on ``device``."""
    serve(addr,
          AppState(VectorStore.with_flat_index(metric,
                                               search_mode=search_mode,
                                               storage=storage,
                                               device=device)),
          batch_window_ms=batch_window_ms, backend=backend)


def start_hnsw(addr: str, metric: DistanceMetric,
               params: Optional[HnswParams] = None,
               batch_window_ms: float = 0.0, backend: str = "auto",
               device="cuda") -> None:
    """Serve an in-memory HNSW store (reference: src/server/mod.rs:34-51);
    its graph lives on the host, its device build on ``device``."""
    index = HnswIndex(metric, params or HnswParams(), device=device)
    serve(addr, AppState(VectorStore.with_index(index)),
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
    from ..persistence import StorageEngine
    with StorageEngine.open(data_dir, config) as engine:
        serve(addr, AppState(engine), batch_window_ms=batch_window_ms,
              backend=backend)


__all__ = ["AppState", "serve", "start_durable", "start_flat",
           "start_hnsw", "start_server_background"]
