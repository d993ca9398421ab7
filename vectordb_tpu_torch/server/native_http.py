"""Python worker for the native C++ HTTP front-end (httpcore.cpp).

Port of ``vectordb_tpu/server/native_http.py`` over the port's build of
``httpcore.cpp`` (``persistence/native_lib.py``: the JAX package's source,
read by path). The C++ epoll loop owns the sockets and HTTP/1.1 framing;
this module pulls drained job batches through ctypes, executes them
against the store, and pushes the bodies back (search bodies formatted in
C++). The drain is the dynamic batcher: every POST /search that arrived
while the previous device call was in flight lands in one batch here and
becomes ONE fused device search (``search_batch_submit``), collected on a
thread of its own while the worker submits the next cycle.

Endpoint semantics are identical to routes.Api (which handles every
non-search job unchanged); grouped searches replicate Api.search's
behavior: k defaults to 10, optional filter, one latency sample per
request (reference src/server/routes.rs:235-282).

``VDB_HTTP_DEPTH`` (the JAX package's variable) sets how many drain cycles
may be in flight; its default and the merge windows were re-read on the
H100 (``PERF.md`` §5, ``chip_smoke.py`` phase 11).
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import queue
import struct
import threading
import time
from typing import List, Optional, Tuple
from urllib.parse import unquote

import numpy as np

from ..errors import VectorDbError
from ..persistence.native_lib import get_native
from ..vector import Vector
from .routes import Api, _parse_filter, _parse_knobs, _parse_vector

_METHODS = {0: "GET", 1: "POST", 2: "DELETE", 3: "PUT", 4: "OTHER",
            5: "SEARCH_FAST",    # POST /search pre-parsed in C++
            6: "BATCH_FAST"}     # POST /search/batch pre-parsed in C++
_BUF_CAP = 64 * 1024 * 1024
# drain cycles in flight by default (VDB_HTTP_DEPTH overrides). 2 on the
# H100: in tools/serving_sweep.py's two passes over 64, 256 and 512
# closed-loop clients depth 2 served as many requests/s as depth 1 or
# more at every count (PERF.md §5); the JAX package's 1 was picked on a
# TPU behind a ~25 ms relay
DEFAULT_DEPTH = 2
# post-drain merge windows, in seconds (serve_forever): with nothing in
# flight a straggler catch of last_cycle / STRAGGLER_DIV up to
# STRAGGLER_MAX; with cycles in flight a batching window of last_cycle /
# depth, clamped to [PIPELINED_MIN, PIPELINED_MAX]; none under
# WINDOW_FLOOR. Module constants, not options: tools/serving_sweep.py
# sets them to read the windows on the card (PERF.md §5)
STRAGGLER_DIV = 10.0
STRAGGLER_MAX = 0.003
PIPELINED_MIN = 0.001
PIPELINED_MAX = 0.03
WINDOW_FLOOR = 0.0005


def native_http_available() -> bool:
    lib = get_native()
    return lib is not None and hasattr(lib, "vdb_http_start")


class NativeHttpServer:
    """Drives the C++ front-end with one Python worker thread, which parses
    and submits, and one collector thread, which waits on the device and
    sends the search responses (device waits release the GIL)."""

    def __init__(self, api: Api, host: str, port: int,
                 pipeline_depth: Optional[int] = None):
        if pipeline_depth is None:
            # the environment sets it for same-window comparisons; the
            # default is read from the depth x clients sweep on the card
            # (PERF.md §5, chip_smoke.py phase 11)
            pipeline_depth = int(os.environ.get("VDB_HTTP_DEPTH",
                                                str(DEFAULT_DEPTH)))
        self._lib = get_native()
        if self._lib is None:
            raise RuntimeError("native core unavailable")
        self.api = api
        self._handle = self._lib.vdb_http_start(host.encode(), int(port))
        if not self._handle:
            raise OSError(f"could not bind {host}:{port}")
        self.port = int(self._lib.vdb_http_port(self._handle))
        self._buf = (ctypes.c_uint8 * _BUF_CAP)()
        self._running = True
        # drain cycles allowed in flight before submits backpressure: the
        # collector thread overlaps cycle i's device wait and responses
        # with cycle i+1's parse and submit
        self._depth = max(1, int(pipeline_depth))
        self._completions: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._last_cycle = 0.0
        # clear while the drain loop runs: shutdown waits for it before
        # the C++ server is freed (the loop reads the handle)
        self._loop_done = threading.Event()
        self._loop_done.set()
        self._thread: Optional[threading.Thread] = None
        self._stop_lock = threading.Lock()
        # per drain cycle: the number of requests it drained (read by the
        # serving phase of chip_smoke.py; bounded)
        self.drain_sizes: "collections.deque" = collections.deque(
            maxlen=1 << 16)

    # -- job plumbing --------------------------------------------------------

    def _parse_jobs(self, raw: bytes) -> List[Tuple[int, str, str, bytes]]:
        jobs = []
        off = 0
        n = len(raw)
        while off < n:
            conn_id, = struct.unpack_from("<Q", raw, off); off += 8
            method = _METHODS.get(raw[off], "OTHER"); off += 1
            plen, = struct.unpack_from("<H", raw, off); off += 2
            path = raw[off:off + plen].decode("utf-8", "replace"); off += plen
            blen, = struct.unpack_from("<I", raw, off); off += 4
            body = raw[off:off + blen]; off += blen
            jobs.append((conn_id, method, path, body))
        return jobs

    def _pack_results(self, flat_results):
        """(ids_bytes, lens_arr, dists_arr, n) for the C++ formatter."""
        enc = [r.id.encode() for r in flat_results]
        n = len(enc)
        ids = b"".join(enc)
        lens = (ctypes.c_uint32 * n)(*(len(e) for e in enc))
        dd = (ctypes.c_double * n)(*(r.distance for r in flat_results))
        return ids, lens, dd, n

    def _respond_search(self, conn_id: int, results) -> None:
        """Search response formatted in C++ (JSON body assembly, escaping
        and shortest-round-trip doubles), byte-equal to the Python
        router's json.dumps."""
        if not self._handle:   # shutdown raced: nothing to deliver to
            return
        ids, lens, dd, n = self._pack_results(results)
        self._lib.vdb_http_respond_search(
            self._handle, ctypes.c_uint64(conn_id), 200,
            ctypes.cast(ctypes.c_char_p(ids),
                        ctypes.POINTER(ctypes.c_uint8)),
            lens, dd, n)

    def _respond_search_batch(self, conn_id: int, batches) -> None:
        if not self._handle:
            return
        flat = [r for batch in batches for r in batch]
        ids, lens, dd, n = self._pack_results(flat)
        sizes = (ctypes.c_int32 * len(batches))(*(len(b) for b in batches))
        self._lib.vdb_http_respond_search_batch(
            self._handle, ctypes.c_uint64(conn_id), 200,
            ctypes.cast(ctypes.c_char_p(ids),
                        ctypes.POINTER(ctypes.c_uint8)),
            lens, dd, sizes, len(batches))

    def _respond(self, conn_id: int, status: int, payload) -> None:
        if not self._handle:
            return
        body = json.dumps(payload).encode()
        self._lib.vdb_http_respond(
            self._handle, ctypes.c_uint64(conn_id), int(status),
            ctypes.cast(ctypes.c_char_p(body),
                        ctypes.POINTER(ctypes.c_uint8)),
            len(body))

    # -- request handling ----------------------------------------------------

    def _handle_batch(self, jobs) -> None:
        for complete in self._submit_batch(jobs):
            complete()

    def _submit_batch(self, jobs) -> list:
        """Answer non-search jobs inline, LAUNCH grouped /search device
        work, and return completion closures (collect + respond). The
        drain loop hands completions to the collector thread and keeps
        up to pipeline_depth cycles in flight — cycle i's collect RPC
        and response formatting run under the submit RPC and device
        compute of cycles i+1..i+depth-1."""
        searches = []
        for conn_id, method, path, body in jobs:
            if method == "SEARCH_FAST":
                searches.append((conn_id, body, True))
                continue
            if method == "BATCH_FAST":
                self._batch_search_fast(conn_id, body)
                continue
            path = unquote(path.partition("?")[0])
            if method == "POST" and path.rstrip("/") == "/search":
                searches.append((conn_id, body, False))
                continue
            try:
                parsed = json.loads(body) if body else None
            except json.JSONDecodeError:
                self._respond(conn_id, 400, {"error": "invalid JSON body"})
                continue
            try:
                status, payload = self.api.handle(method, path, parsed)
            except Exception as e:  # never kill the worker
                status, payload = 500, {"error": str(e)}
            self._respond(conn_id, status, payload)
        if searches:
            return self._submit_searches(searches)
        return []

    def _batch_search_fast(self, conn_id: int, body: bytes) -> None:
        """POST /search/batch pre-parsed in C++ (method 6): packed
        [nq u32] + nq x [k i32][len u32] + f32 floats. Same semantics as
        routes.Api.batch_search: per-query k (default 10), one latency
        sample for the whole batch."""
        state = self.api.state
        try:
            nq, = struct.unpack_from("<I", body, 0)
            off = 4
            metas = []
            for _ in range(nq):
                k, ln = struct.unpack_from("<iI", body, off)
                off += 8
                metas.append((k, ln))
            queries = []
            for k, ln in metas:
                arr = np.frombuffer(body, np.float32, count=ln, offset=off)
                off += ln * 4
                queries.append((Vector(arr), k))
        except Exception as e:
            self._respond(conn_id, 400, {"error": str(e)})
            return
        start = time.perf_counter()
        try:
            with state.lock.read():
                all_results = state.store.search_batch(queries)
        except Exception as e:
            status = 400 if isinstance(e, (VectorDbError, ValueError,
                                           KeyError, TypeError)) else 500
            self._respond(conn_id, status, {"error": str(e)})
            return
        # one latency sample for the whole batch (routes.rs:365-369)
        state.metrics.record_query(time.perf_counter() - start)
        self._respond_search_batch(conn_id, all_results)

    def _submit_searches(self, searches) -> list:
        """Group compatible /search requests, launch one fused device call
        per group, and return completion closures. Filtered searches (rare
        on the hot path) are answered synchronously during submit."""
        state = self.api.state
        # parse first; invalid ones answered immediately
        groups: dict = {}  # (k, ef, nprobe, refine) -> [(conn_id, Vector)]
        singles = []       # (conn_id, Vector, k, filter)
        for conn_id, body, pre_parsed in searches:
            try:
                if pre_parsed:
                    # C++ packed [k i32][n u32][f32*n] (httpcore.cpp)
                    k, n = struct.unpack_from("<iI", body, 0)
                    query = Vector(np.frombuffer(body, np.float32,
                                                 count=n, offset=8))
                    flt = ef = nprobe = refine = None
                else:
                    parsed = json.loads(body) if body else None
                    if not isinstance(parsed, dict) or "vector" not in parsed:
                        self._respond(conn_id, 400,
                                      {"error": "'vector' is required"})
                        continue
                    if parsed.get("radius") is not None:
                        # range query: rare path, full Api semantics
                        status, payload = self.api.handle(
                            "POST", "/search", parsed)
                        self._respond(conn_id, status, payload)
                        continue
                    query = _parse_vector(parsed["vector"])
                    raw_k = parsed.get("k")
                    k = 10 if raw_k is None else int(raw_k)
                    flt = _parse_filter(parsed.get("filter"))
                    ef, nprobe, refine = _parse_knobs(parsed)
            except Exception as e:
                self._respond(conn_id, 400, {"error": str(e)})
                continue
            if flt is None:
                groups.setdefault((k, ef, nprobe, refine), []).append(
                    (conn_id, query))
            else:
                # filtered (optionally knobbed) searches: synchronous
                # masked path during submit (rare on the hot path)
                singles.append((conn_id, query, k, flt,
                                ef, nprobe, refine))

        completions = []
        for (k, ef, nprobe, refine), members in groups.items():
            start = time.perf_counter()
            try:
                with state.lock.read():
                    handle = state.store.search_batch_submit(
                        [(query, k) for _, query in members],
                        ef=ef, nprobe=nprobe, refine=refine)
            except Exception as e:
                self._respond_group_error(members, e)
                continue
            completions.append(
                lambda h=handle, m=members, s=start: self._complete_group(
                    h, m, s))

        for conn_id, query, k, flt, ef, nprobe, refine in singles:
            start = time.perf_counter()
            try:
                with state.lock.read():
                    results = state.store.search_with_filter(
                        query, k, flt, ef=ef, nprobe=nprobe, refine=refine)
            except Exception as e:
                status = 400 if isinstance(e, (VectorDbError, ValueError,
                                               KeyError, TypeError)) else 500
                self._respond(conn_id, status, {"error": str(e)})
                continue
            state.metrics.record_query(time.perf_counter() - start)
            self._respond_search(conn_id, results)
        return completions

    def _complete_group(self, handle, members, start) -> None:
        """Collect one in-flight search group and send its responses.
        One latency sample per request, covering submit->response
        (reference src/server/routes.rs:242-271 semantics)."""
        state = self.api.state
        try:
            all_results = handle.collect()
        except Exception as e:
            self._respond_group_error(members, e)
            return
        elapsed = time.perf_counter() - start
        self._last_cycle = elapsed   # feeds the straggler-catch window
        for (conn_id, _), results in zip(members, all_results):
            state.metrics.record_query(elapsed)
            self._respond_search(conn_id, results)

    def _respond_group_error(self, members, e: Exception) -> None:
        status = 400 if isinstance(e, (VectorDbError, ValueError,
                                       KeyError, TypeError)) else 500
        for conn_id, _ in members:
            self._respond(conn_id, status, {"error": str(e)})

    # -- lifecycle -----------------------------------------------------------

    def _collector_loop(self) -> None:
        """Dedicated completion thread: collects in-flight search groups
        and sends their responses. The collect waits on the device (the
        stream its submit launched on) with the GIL released, so it runs
        under the worker thread's next parse and submit instead of after
        it. The C++ respond path is resp_mu-protected (httpcore.cpp), so
        both threads may answer connections."""
        while True:
            complete = self._completions.get()
            if complete is None:
                self._completions.task_done()
                return
            try:
                complete()
            except Exception:
                pass  # per-group errors already answered inside
            finally:
                self._completions.task_done()

    def serve_forever(self) -> None:
        # Depth-N pipelined drain (N = pipeline_depth): each iteration
        # drains whatever arrived, SUBMITS its device work, and hands the
        # completion to the collector thread. Submits backpressure once N
        # cycles are in flight (bounded queue), so client latency stays
        # bounded. Idle with nothing in flight the drain parks on the
        # 500 ms wait.
        #
        # Post-drain merge window. Unpipelined (nothing in flight): a
        # straggler catch of last_cycle / 10, at most 3 ms: clients
        # answered by the previous cycle re-send shortly after and would
        # otherwise miss this drain and wait a whole extra cycle; when
        # cycles are fast the window collapses to zero. Pipelined: a
        # batching window of last_cycle / depth (1 to 30 ms): next_jobs
        # returns at the first arriving job, and submitting such dribbles
        # splits a closed-loop client pool into undersized device batches.
        if self._thread is None:
            self._thread = threading.current_thread()
            self._loop_done.clear()
        collector = threading.Thread(target=self._collector_loop,
                                     daemon=True)
        collector.start()
        try:
            while self._running:
                busy = self._completions.unfinished_tasks > 0
                n = self._lib.vdb_http_next_jobs(self._handle, self._buf,
                                                 _BUF_CAP,
                                                 1 if busy else 500)
                if n < 0:
                    break
                if n == 0:
                    continue
                raw = ctypes.string_at(self._buf, n)
                if busy:
                    catch = min(max(self._last_cycle / self._depth,
                                    PIPELINED_MIN), PIPELINED_MAX)
                else:
                    catch = min(self._last_cycle / STRAGGLER_DIV,
                                STRAGGLER_MAX)
                if catch > WINDOW_FLOOR:
                    time.sleep(catch)
                    n2 = self._lib.vdb_http_next_jobs(
                        self._handle, self._buf, _BUF_CAP, 0)
                    if n2 > 0:
                        raw += ctypes.string_at(self._buf, n2)
                try:
                    jobs = self._parse_jobs(raw)
                    self.drain_sizes.append(len(jobs))
                    new_pending = self._submit_batch(jobs)
                except Exception:
                    # a malformed frame must not kill the worker loop
                    new_pending = []
                for complete in new_pending:
                    # blocks at pipeline_depth in flight: backpressure
                    self._completions.put(complete)
        finally:
            self._completions.put(None)
            collector.join()
            self._thread = None
            self._loop_done.set()

    def start_background(self) -> threading.Thread:
        thread = threading.Thread(target=self.serve_forever, daemon=True)
        # from here on shutdown waits for this loop
        self._thread = thread
        self._loop_done.clear()
        thread.start()
        return thread

    def shutdown(self) -> None:
        """Stop serving. From another thread than the drain loop's, wait
        for the loop (it leaves within one 500 ms wait) and its collector
        before the C++ server is freed: the JAX package frees it at once,
        under a loop that may still be waiting inside it."""
        self._running = False
        if self._thread is not threading.current_thread():
            self._loop_done.wait()
        # serve()'s own shutdown may race an embedding caller's: the
        # handle is freed once
        with self._stop_lock:
            handle, self._handle = self._handle, None
        if handle:
            self._lib.vdb_http_stop(handle)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.vdb_http_stop(self._handle)
        except Exception:
            pass


__all__ = ["NativeHttpServer", "native_http_available"]
