"""Serving in the port, on the CPU: the native C++ front end, the query
batcher, the readers-writer lock and the ``serve`` backends.

Mirrors tests/test_native_http.py (its 13 cases), tests/test_batcher.py
(6), tests/test_concurrency.py (4) and the batcher, HTTP and flat cases of
tests/test_review_regressions.py, over port stores with ``device="cpu"``.
Parity: the same request sequence sent to a JAX native server and to a
port native server gives the same parsed bodies, and examples/demo.sh's
requests (the script is left as it is) answer the same from
``python -m vectordb_tpu_torch serve`` as from the JAX package's server.
"""

import http.client
import inspect
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import vectordb_tpu as J
from vectordb_tpu.server import app as japp
from vectordb_tpu.server.native_http import NativeHttpServer as JNative
from vectordb_tpu.server.routes import Api as JApi

from vectordb_tpu_torch import (BatchInsertItem, DistanceMetric, FlatIndex,
                                HnswIndex, HnswParams, Metadata,
                                MetadataFilter, Vector, VectorStore)
from vectordb_tpu_torch.errors import (DimensionMismatchError,
                                       InvalidVectorError)
from vectordb_tpu_torch.server import app
from vectordb_tpu_torch.server import test_api as make_test_api
from vectordb_tpu_torch.server.app import (AppState, serve,
                                           start_server_background)
from vectordb_tpu_torch.server.batcher import QueryBatcher, _Pending
from vectordb_tpu_torch.server.native_http import (NativeHttpServer,
                                                   native_http_available)
from vectordb_tpu_torch.server.routes import Api
from vectordb_tpu_torch.utils.locks import RwLock

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
EUC = DistanceMetric.EUCLIDEAN


def flat_store(metric=EUC):
    return VectorStore.with_flat_index(metric, device="cpu")


@pytest.fixture
def server():
    srv = NativeHttpServer(Api(AppState(flat_store())), "127.0.0.1", 0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _req(srv, method, path, payload=None):
    return _req_port(srv.port, method, path, payload)


def _req_port(port, method, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- the native front end (tests/test_native_http.py) ----------------------

def test_native_http_available():
    assert native_http_available()


def test_all_nine_endpoints(server):
    status, body = _req(server, "POST", "/vectors",
                        {"id": "a", "vector": [1.0, 2.0, 3.0],
                         "metadata": {"cat": "x"}})
    assert (status, body["status"]) == (201, "inserted")
    status, body = _req(server, "POST", "/vectors/batch", {"vectors": [
        {"id": "b", "vector": [1.0, 2.0, 4.0]},
        {"id": "c", "vector": [9.0, 9.0, 9.0], "metadata": {"cat": "y"}}]})
    assert (status, body["inserted"]) == (201, 2)
    status, body = _req(server, "GET", "/vectors/a")
    assert status == 200 and body["vector"] == [1.0, 2.0, 3.0]
    assert body["metadata"] == {"cat": "x"}
    status, body = _req(server, "GET", "/vectors/b")
    assert status == 200 and "metadata" not in body
    status, body = _req(server, "GET", "/vectors")
    assert status == 200 and sorted(body) == ["a", "b", "c"]
    status, body = _req(server, "POST", "/search",
                        {"vector": [1.0, 2.0, 3.1], "k": 2})
    assert status == 200 and [r["id"] for r in body] == ["a", "b"]
    status, body = _req(server, "POST", "/search",
                        {"vector": [1.0, 2.0, 3.1], "k": 3,
                         "filter": {"op": "eq", "field": "cat",
                                    "value": "y"}})
    assert status == 200 and [r["id"] for r in body] == ["c"]
    status, body = _req(server, "POST", "/search/batch", {"queries": [
        {"vector": [1.0, 2.0, 3.0], "k": 1},
        {"vector": [9.0, 9.0, 9.0], "k": 1}]})
    assert status == 200
    assert [[r["id"] for r in q] for q in body] == [["a"], ["c"]]
    status, body = _req(server, "DELETE", "/vectors/b")
    assert (status, body["status"]) == (200, "deleted")
    status, _ = _req(server, "GET", "/vectors/b")
    assert status == 404
    status, body = _req(server, "GET", "/health")
    assert status == 200 and body == {"status": "ok", "vector_count": 2}
    status, body = _req(server, "GET", "/metrics")
    assert status == 200 and body["total_queries"] >= 3


def test_error_statuses(server):
    assert _req(server, "POST", "/vectors", {"id": "x"})[0] == 400
    assert _req(server, "GET", "/vectors/missing")[0] == 404
    assert _req(server, "POST", "/nope", {})[0] == 404
    assert _req(server, "POST", "/search", {"vector": "bad"})[0] == 400


def test_invalid_json_body(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    conn.request("POST", "/search", body=b"{not json",
                 headers={"Content-Type": "application/json"})
    assert conn.getresponse().status == 400
    conn.close()


def test_keep_alive_reuses_connection(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    for i in range(5):
        conn.request("POST", "/vectors",
                     body=json.dumps({"id": f"k{i}",
                                      "vector": [float(i), 0.0]}).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 201
        resp.read()
    conn.request("GET", "/health")
    assert json.loads(conn.getresponse().read())["vector_count"] == 5
    conn.close()


def test_url_encoded_ids(server):
    assert _req(server, "POST", "/vectors",
                {"id": "has space", "vector": [1.0]})[0] == 201
    status, body = _req(server, "GET", "/vectors/has%20space")
    assert status == 200 and body["id"] == "has space"


def _load(server, n, d, seed, prefix):
    data = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    items = [{"id": f"{prefix}{i}", "vector": [float(x) for x in data[i]]}
             for i in range(n)]
    assert _req(server, "POST", "/vectors/batch", {"vectors": items})[0] \
        == 201
    return data


def _run_threads(targets):
    threads = [threading.Thread(target=fn, args=args) for fn, args in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)


def test_concurrent_searches_drain_batch(server):
    data = _load(server, 512, 16, 0, "v")
    errors, results = [], {}

    def worker(qi):
        try:
            status, body = _req(server, "POST", "/search",
                                {"vector": [float(x) for x in data[qi]],
                                 "k": 1})
            assert status == 200, body
            results[qi] = body[0]["id"]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    _run_threads([(worker, (qi,)) for qi in range(64)])
    assert not errors, errors
    assert all(results[qi] == f"v{qi}" for qi in range(64))
    # the drain grouped what arrived together
    assert sum(server.drain_sizes) >= 65


def test_sustained_pipeline_depth(server):
    data = _load(server, 256, 16, 3, "p")
    errors = []

    def worker(tid):
        try:
            for rep in range(10):
                qi = (tid * 10 + rep) % 256
                status, body = _req(
                    server, "POST", "/search",
                    {"vector": [float(x) for x in data[qi]], "k": 1})
                assert status == 200, body
                assert body[0]["id"] == f"p{qi}", (qi, body)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    _run_threads([(worker, (t,)) for t in range(16)])
    assert not errors, errors


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_depths_answer_every_request(depth):
    """Depth N keeps N drain cycles in flight (the collector thread
    collects while the worker submits): every answer still matches."""
    srv = NativeHttpServer(Api(AppState(flat_store())), "127.0.0.1", 0,
                           pipeline_depth=depth)
    srv.start_background()
    try:
        data = _load(srv, 128, 8, 9, "d")
        errors = []

        def worker(tid):
            try:
                for rep in range(6):
                    qi = (tid * 7 + rep) % 128
                    status, body = _req(srv, "POST", "/search", {
                        "vector": [float(x) for x in data[qi]], "k": 2})
                    assert status == 200 and body[0]["id"] == f"d{qi}"
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        _run_threads([(worker, (t,)) for t in range(12)])
        assert not errors, errors
    finally:
        srv.shutdown()


def test_depth_from_environment(monkeypatch):
    from vectordb_tpu_torch.server import native_http
    monkeypatch.setenv("VDB_HTTP_DEPTH", "3")
    srv = NativeHttpServer(Api(AppState(flat_store())), "127.0.0.1", 0)
    assert srv._depth == 3
    srv.shutdown()
    monkeypatch.delenv("VDB_HTTP_DEPTH")
    srv = NativeHttpServer(Api(AppState(flat_store())), "127.0.0.1", 0)
    assert srv._depth == native_http.DEFAULT_DEPTH
    srv.shutdown()


def test_large_batch_insert_roundtrip(server):
    data = np.random.default_rng(1).standard_normal((800, 64)).astype(
        np.float32)
    items = [{"id": f"big{i}", "vector": [float(x) for x in data[i]]}
             for i in range(800)]
    status, body = _req(server, "POST", "/vectors/batch", {"vectors": items})
    assert (status, body["inserted"]) == (201, 800)
    assert _req(server, "GET", "/health")[1]["vector_count"] == 800


def test_fast_path_equivalence_and_fallback(server):
    rng = np.random.default_rng(7)
    for i in range(50):
        _req(server, "POST", "/vectors",
             {"id": f"r{i}", "vector": rng.standard_normal(8).tolist(),
              "metadata": {"grp": str(i % 2)}})
    q = rng.standard_normal(8).tolist()
    s1, r1 = _req(server, "POST", "/search", {"vector": q, "k": 5})
    assert s1 == 200 and len(r1) == 5
    assert _req(server, "POST", "/search",
                {"vector": q, "k": 5, "unknown_key": 1}) == (s1, r1)
    assert _req(server, "POST", "/search",
                {"vector": q, "k": 5, "filter": None}) == (s1, r1)
    s4, r4 = _req(server, "POST", "/search",
                  {"vector": q, "k": 50,
                   "filter": {"op": "eq", "field": "grp", "value": "1"}})
    assert s4 == 200 and r4 and all(int(rr["id"][1:]) % 2 == 1 for rr in r4)
    exotic = [1, -2.5, 3e-2, -4E1, 0.125, 0, 7e2, -0.0]
    _req(server, "POST", "/vectors", {"id": "exo", "vector": exotic})
    s5, r5 = _req(server, "POST", "/search", {"vector": exotic, "k": 1})
    assert s5 == 200 and r5[0]["id"] == "exo"
    assert r5[0]["distance"] == 0.0
    assert _req(server, "POST", "/search",
                {"vector": ["x", "y"], "k": 1})[0] == 400
    assert _req(server, "POST", "/search",
                {"vector": q, "k": 5.0})[0] in (200, 400)


def test_batch_fast_path_equivalence(server):
    rng = np.random.default_rng(11)
    for i in range(30):
        _req(server, "POST", "/vectors",
             {"id": f"b{i}", "vector": rng.standard_normal(6).tolist(),
              "metadata": {"grp": str(i % 2)}})
    q1, q2 = (rng.standard_normal(6).tolist() for _ in range(2))
    body = {"queries": [{"vector": q1, "k": 3}, {"vector": q2}]}
    s1, r1 = _req(server, "POST", "/search/batch", body)
    assert s1 == 200 and [len(r) for r in r1] == [3, 10]
    assert _req(server, "POST", "/search/batch", {**body, "zz": 1}) == \
        (s1, r1)
    s3, r3 = _req(server, "POST", "/search/batch",
                  {**body, "filter": {"op": "eq", "field": "grp",
                                      "value": "0"}})
    assert s3 == 200 and len(r3) == 2
    assert _req(server, "POST", "/search/batch",
                {"queries": [{"k": 3}]})[0] == 400
    assert _req(server, "GET", "/metrics")[1]["total_queries"] == 3


def test_cxx_response_bytes_match_python_route(server):
    def raw(path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}",
            data=json.dumps(payload).encode(), method="POST")
        req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.read()

    _req(server, "POST", "/vectors",
         {"id": "café \U0001f680", "vector": [1.0, 2.0]})
    _req(server, "POST", "/vectors", {"id": "plain", "vector": [4.0, 6.0]})
    q = {"vector": [1.0, 2.0], "k": 2}
    fast = raw("/search", q)
    slow = raw("/search", {**q, "unknown_key": 1})
    assert fast == slow, (fast, slow)
    assert b"0.0" in fast and b"\\u00e9" in fast and b"\\ud83d" in fast


def test_pipelined_search_insert_interleave(server):
    base = _load(server, 32, 8, 5, "v")
    for step in range(8):
        vec = [float(x) for x in (base[step] + 100.0 * (step + 1))]
        assert _req(server, "POST", "/vectors",
                    {"id": f"new{step}", "vector": vec})[0] == 201
        status, body = _req(server, "POST", "/search", {"vector": vec,
                                                         "k": 1})
        assert status == 200 and body[0]["id"] == f"new{step}"
        assert _req(server, "DELETE", f"/vectors/new{step}")[0] == 200
        status, body = _req(server, "POST", "/search", {"vector": vec,
                                                         "k": 1})
        assert status == 200 and body[0]["id"] != f"new{step}"


def test_search_knobs_through_native_server():
    state = AppState(VectorStore(HnswIndex(EUC, HnswParams(seed=3))))
    srv = NativeHttpServer(Api(state), "127.0.0.1", 0)
    srv.start_background()
    try:
        items = [{"id": f"v{i}", "vector": [float(i), float(i % 5)]}
                 for i in range(40)]
        assert _req(srv, "POST", "/vectors/batch", {"vectors": items})[0] \
            == 201
        status, body = _req(srv, "POST", "/search",
                            {"vector": [7.0, 2.0], "k": 2, "ef": 128})
        assert status == 200 and body[0]["id"] == "v7", body
        status, body = _req(srv, "POST", "/search",
                            {"vector": [7.0, 2.0], "nprobe": 2})
        assert status == 400 and "nprobe" in body["error"]
        flt = {"op": "eq", "field": "x", "value": "1"}
        assert _req(srv, "POST", "/search", {"vector": [7.0, 2.0], "ef": 8,
                                             "filter": flt}) == (200, [])
        assert _req(srv, "POST", "/vectors",
                    {"id": "tagged", "vector": [7.0, 2.0],
                     "metadata": {"x": "1"}})[0] == 201
        status, body = _req(srv, "POST", "/search",
                            {"vector": [7.0, 2.0], "ef": 64, "filter": flt})
        assert status == 200 and [h["id"] for h in body] == ["tagged"]
    finally:
        srv.shutdown()


def test_refine_knob_through_native_server():
    """PQ's per-query refine rides the grouped submit (refine is in the
    group key) and answers as the routes do."""
    from vectordb_tpu_torch.index.pq import PqFlatIndex
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((400, 16)).astype(np.float32)
    store = VectorStore.with_index(PqFlatIndex(EUC, m=4, ksub=16,
                                               device="cpu"))
    store.insert_batch([BatchInsertItem(f"r{i}", Vector(rows[i]))
                        for i in range(400)])
    store.index.train()
    state = AppState(store)
    srv = NativeHttpServer(Api(state), "127.0.0.1", 0)
    srv.start_background()
    try:
        body = {"vector": rows[5].tolist(), "k": 3, "refine": 32}
        got = _req(srv, "POST", "/search", body)
        assert got == Api(state).handle("POST", "/search", body)
        assert got[1][0]["id"] == "r5"
    finally:
        srv.shutdown()


def test_shutdown_waits_for_the_drain_loop():
    """shutdown() from another thread frees the C++ server only after the
    drain loop has left it (no use after free), and is idempotent."""
    for _ in range(5):
        srv = NativeHttpServer(Api(AppState(flat_store())), "127.0.0.1", 0)
        thread = srv.start_background()
        srv.shutdown()
        assert not thread.is_alive()
        srv.shutdown()


# -- the query batcher (tests/test_batcher.py) ------------------------------

@pytest.fixture
def setup(rng):
    store = flat_store()
    data = rng.standard_normal((100, 8)).astype(np.float32)
    for i in range(100):
        store.insert_with_metadata(f"v{i}", Vector(data[i]),
                                   Metadata({"par": str(i % 2)}))
    state = AppState(store)
    batcher = QueryBatcher(store, state.lock, window_ms=5.0)
    yield store, state, batcher, data
    batcher.close()


def test_batcher_single_search(setup):
    _, _, batcher, data = setup
    hits = batcher.search(Vector(data[7]), 3)
    assert hits[0].id == "v7" and len(hits) == 3


def test_batcher_concurrent_searches_all_correct(setup):
    _, _, batcher, data = setup
    results, errors = {}, []

    def worker(i):
        try:
            results[i] = batcher.search(Vector(data[i]), 1)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    _run_threads([(worker, (i,)) for i in range(32)])
    assert not errors
    assert all(results[i][0].id == f"v{i}" for i in range(32))


def test_batcher_mixed_ks(setup):
    _, _, batcher, data = setup
    out = {}

    def worker(i, k):
        out[i] = batcher.search(Vector(data[i]), k)

    _run_threads([(worker, (i, 1 + i % 5)) for i in range(10)])
    for i in range(10):
        assert len(out[i]) == 1 + i % 5 and out[i][0].id == f"v{i}"


def test_batcher_filtered_search(setup):
    _, _, batcher, data = setup
    hits = batcher.search(Vector(data[3]), 5, MetadataFilter.eq("par", "1"))
    assert hits[0].id == "v3"
    assert all(int(h.id[1:]) % 2 == 1 for h in hits)


def test_batcher_bad_dimension_fails_alone(setup):
    _, _, batcher, data = setup
    outcome = {}

    def good(i):
        outcome[i] = batcher.search(Vector(data[i]), 1)

    def bad():
        try:
            batcher.search(Vector([1.0, 2.0]), 1)
            outcome["bad"] = "no-error"
        except DimensionMismatchError:
            outcome["bad"] = "dim-error"

    _run_threads([(good, (i,)) for i in range(4)] + [(bad, ())])
    assert outcome["bad"] == "dim-error"
    assert all(outcome[i][0].id == f"v{i}" for i in range(4))


def test_api_with_batcher(setup):
    _, state, batcher, data = setup
    api = Api(state, batcher=batcher)
    status, hits = api.handle("POST", "/search", {
        "vector": [float(x) for x in data[5]], "k": 2})
    assert status == 200 and hits[0]["id"] == "v5"
    status, payload = api.handle("POST", "/search", {"vector": [1.0]})
    assert status == 400 and "Dimension mismatch" in payload["error"]


def test_batcher_zero_norm_cosine_fails_alone(rng):
    store = flat_store(DistanceMetric.COSINE)
    data = rng.standard_normal((20, 4)).astype(np.float32) + 2.0
    for i in range(20):
        store.insert(f"v{i}", Vector(data[i]))
    state = AppState(store)
    batcher = QueryBatcher(store, state.lock, window_ms=10.0)
    outcome = {}

    def good(i):
        outcome[i] = batcher.search(Vector(data[i]), 1)

    def bad():
        try:
            batcher.search(Vector([0.0, 0.0, 0.0, 0.0]), 1)
            outcome["bad"] = "no-error"
        except InvalidVectorError:
            outcome["bad"] = "zero-error"

    _run_threads([(good, (i,)) for i in range(3)] + [(bad, ())])
    batcher.close()
    assert outcome["bad"] == "zero-error"
    assert all(outcome[i][0].id == f"v{i}" for i in range(3))


def test_batcher_structural_filter_grouping(rng):
    store = flat_store()
    data = rng.standard_normal((20, 4)).astype(np.float32)
    for i in range(20):
        store.insert_with_metadata(f"v{i}", Vector(data[i]),
                                   Metadata({"par": str(i % 2)}))
    batcher = QueryBatcher(store, AppState(store).lock, window_ms=5.0)
    calls = []
    orig = store.search_batch_with_filter

    def counting(queries, flt):
        calls.append(len(queries))
        return orig(queries, flt)

    store.search_batch_with_filter = counting
    items = [_Pending(query=Vector(data[i]), k=1,
                      filter=MetadataFilter.eq("par", "0"))
             for i in range(4)]
    batcher._execute(items)
    batcher.close()
    assert calls == [4]
    assert all(item.results is not None for item in items)


def test_batcher_answers_equal_the_jax_batcher(rng):
    """The same queries through both packages' batchers: same ids and
    distances (rtol 2e-5)."""
    from vectordb_tpu.server.batcher import QueryBatcher as JBatcher
    data = rng.standard_normal((200, 12)).astype(np.float32)
    jstore = J.VectorStore.with_flat_index(J.DistanceMetric.EUCLIDEAN)
    tstore = flat_store()
    for i in range(200):
        jstore.insert(f"v{i}", J.Vector(data[i]))
        tstore.insert(f"v{i}", Vector(data[i]))
    jb = JBatcher(jstore, japp.AppState(jstore).lock, window_ms=2.0)
    tb = QueryBatcher(tstore, AppState(tstore).lock, window_ms=2.0)
    try:
        queries = rng.standard_normal((24, 12)).astype(np.float32)
        for q in queries:
            jr = jb.search(J.Vector(q), 5)
            tr = tb.search(Vector(q), 5)
            assert [r.id for r in jr] == [r.id for r in tr]
            np.testing.assert_allclose([r.distance for r in tr],
                                       [r.distance for r in jr], rtol=2e-5)
    finally:
        jb.close()
        tb.close()


# -- readers-writer lock and threaded stress (tests/test_concurrency.py) ----

class TestRwLock:
    def test_readers_share(self):
        lock = RwLock()
        inside = []
        barrier = threading.Barrier(3)

        def reader():
            with lock.read():
                barrier.wait(timeout=5)
                inside.append(1)

        _run_threads([(reader, ()) for _ in range(3)])
        assert len(inside) == 3

    def test_writer_excludes_readers(self):
        lock = RwLock()
        log = []

        def writer():
            with lock.write():
                log.append("w-start")
                time.sleep(0.05)
                log.append("w-end")

        def reader():
            time.sleep(0.01)
            with lock.read():
                log.append("r")

        _run_threads([(writer, ()), (reader, ())])
        assert log == ["w-start", "w-end", "r"]

    def test_writers_exclusive(self):
        lock = RwLock()
        counter = {"v": 0}

        def writer():
            for _ in range(50):
                with lock.write():
                    counter["v"] += 1

        _run_threads([(writer, ()) for _ in range(4)])
        assert counter["v"] == 200


def test_threaded_api_stress():
    api, _ = make_test_api(device="cpu")
    dim = 8
    vectors = np.random.default_rng(0).standard_normal((200, dim)).astype(
        np.float32)
    errors = []

    def inserter(base):
        try:
            for i in range(50):
                status, _ = api.handle("POST", "/vectors", {
                    "id": f"t{base}-{i}",
                    "vector": [float(x) for x in
                               vectors[(base * 50 + i) % 200]],
                    "metadata": {"thread": str(base)}})
                assert status == 201
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def searcher():
        try:
            for _ in range(50):
                status, hits = api.handle("POST", "/search", {
                    "vector": [0.0] * dim, "k": 5})
                assert status == 200
                dists = [h["distance"] for h in hits]
                assert dists == sorted(dists)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def deleter():
        try:
            for i in range(25):
                api.handle("DELETE", f"/vectors/t0-{i}")
        except Exception as e:  # pragma: no cover
            errors.append(e)

    _run_threads([(inserter, (b,)) for b in range(3)]
                 + [(searcher, ()) for _ in range(2)] + [(deleter, ())])
    assert not errors, errors
    status, payload = api.handle("GET", "/health")
    assert status == 200 and 125 <= payload["vector_count"] <= 150
    _, ids = api.handle("GET", "/vectors")
    assert len(ids) == payload["vector_count"]
    for vid in ids[:10]:
        assert api.handle("GET", f"/vectors/{vid}")[0] == 200


# -- review regressions: HTTP and flat surfaces -----------------------------

def test_explicit_k_zero_returns_empty():
    api, _ = make_test_api(device="cpu")
    api.handle("POST", "/vectors", {"id": "a", "vector": [1.0]})
    assert api.handle("POST", "/search", {"vector": [1.0], "k": 0}) == \
        (200, [])
    _, batches = api.handle("POST", "/search/batch", {
        "queries": [{"vector": [1.0], "k": 0}, {"vector": [1.0]}]})
    assert batches[0] == [] and len(batches[1]) == 1


def test_http_url_decoding_and_query_strings():
    server, _ = start_server_background("127.0.0.1:0",
                                        AppState(flat_store()))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(
            f"{base}/vectors", method="POST",
            data=json.dumps({"id": "some id", "vector": [1.0]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 201
        with urllib.request.urlopen(f"{base}/vectors/some%20id") as resp:
            assert json.loads(resp.read())["id"] == "some id"
        with urllib.request.urlopen(f"{base}/health?verbose=1") as resp:
            assert json.loads(resp.read())["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()


def test_concurrent_writes_do_not_invalidate_inflight_reads(rng):
    idx = FlatIndex(EUC, device="cpu")
    data = rng.standard_normal((400, 16)).astype(np.float32)
    for i in range(100):
        idx.add(i, Vector(data[i]))
    errors = []

    def writer():
        try:
            for i in range(100, 400):
                idx.add(i, Vector(data[i]))
                if i % 7 == 0:
                    idx.remove(i - 50)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def reader():
        try:
            for _ in range(60):
                assert all(len(r) > 0 for r in idx.search_batch(data[:8], 5))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    _run_threads([(writer, ())] + [(reader, ()) for _ in range(3)])
    assert not errors, errors


def test_insert_batch_duplicate_ids_no_phantom_rows():
    store = flat_store()
    v1, v2 = Vector([0.0, 0.0]), Vector([9.0, 9.0])
    store.insert_batch([BatchInsertItem("a", v1), BatchInsertItem("a", v2)])
    assert len(store) == 1 and store.get("a") == v2
    hits = store.search(v1, 2)
    assert len(hits) == 1 and hits[0].id == "a"
    assert store.search_with_filter(v1, 5,
                                    MetadataFilter.exists("nothing")) == []


def test_insert_batch_duplicate_ids_with_metadata():
    store = flat_store()
    store.insert_batch([
        BatchInsertItem("a", Vector([1.0]), Metadata({"v": "old"})),
        BatchInsertItem("b", Vector([2.0]), Metadata({"v": "keep"})),
        BatchInsertItem("a", Vector([3.0]), Metadata({"v": "new"})),
    ])
    assert len(store) == 2
    assert store.get_metadata("a").get("v") == "new"
    assert store.search_with_filter(Vector([1.0]), 5,
                                    MetadataFilter.eq("v", "old")) == []


def test_vector_does_not_alias_caller_array():
    arr = np.array([1.0, 0.0], dtype=np.float32)
    v = Vector(arr)
    arr[0] = 999.0
    assert v.as_list() == [1.0, 0.0]


# -- serve(): the three backends --------------------------------------------

def _serve_in_thread(state, **kw):
    ready = threading.Event()
    thread = threading.Thread(target=serve, args=("127.0.0.1:0", state),
                              kwargs={"ready_event": ready, **kw},
                              daemon=True)
    thread.start()
    assert ready.wait(60)
    server = state.server
    port = getattr(server, "port", None) or server.server_address[1]
    return thread, server, port


@pytest.mark.parametrize("backend,kind", [("auto", NativeHttpServer),
                                          ("native", NativeHttpServer),
                                          ("python", app.VdbHTTPServer)])
def test_serve_backends(backend, kind):
    state = AppState(flat_store())
    thread, server, port = _serve_in_thread(state, backend=backend)
    try:
        assert isinstance(server, kind)
        assert _req_port(port, "POST", "/vectors",
                         {"id": "a", "vector": [1.0, 2.0]})[0] == 201
        status, hits = _req_port(port, "POST", "/search",
                                 {"vector": [1.0, 2.0], "k": 1})
        assert status == 200 and hits[0]["id"] == "a"
    finally:
        server.shutdown()
        thread.join(30)
    assert not thread.is_alive()


def test_serve_auto_takes_python_without_native(monkeypatch):
    monkeypatch.setenv("VDB_TPU_NO_NATIVE", "1")
    assert not native_http_available()
    state = AppState(flat_store())
    thread, server, _ = _serve_in_thread(state, backend="auto")
    server.shutdown()
    thread.join(30)
    assert isinstance(server, app.VdbHTTPServer)


@pytest.mark.parametrize("backend", ["native", "python"])
def test_serve_with_batch_window(backend, rng):
    """batch_window_ms > 0 puts the query batcher behind the routes: on
    the stdlib server it serves every /search; concurrent clients get
    their own answers, a bad query fails alone."""
    data = rng.standard_normal((64, 8)).astype(np.float32)
    store = flat_store()
    for i in range(64):
        store.insert(f"v{i}", Vector(data[i]))
    state = AppState(store)
    thread, server, port = _serve_in_thread(state, backend=backend,
                                            batch_window_ms=2.0)
    try:
        out, errors = {}, []

        def worker(i):
            try:
                out[i] = _req_port(port, "POST", "/search",
                                   {"vector": data[i].tolist(), "k": 1})
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        _run_threads([(worker, (i,)) for i in range(16)])
        assert not errors, errors
        assert all(out[i] == (200, [{"id": f"v{i}", "distance":
                                     out[i][1][0]["distance"]}])
                   for i in range(16))
        assert _req_port(port, "POST", "/search",
                         {"vector": [1.0], "k": 1})[0] == 400
    finally:
        server.shutdown()
        thread.join(30)


def test_serve_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        serve("127.0.0.1:0", AppState(flat_store()), backend="gpu")


def test_start_flat_and_start_hnsw_reach_serve(monkeypatch):
    seen = []
    monkeypatch.setattr(app, "serve", lambda addr, state, **kw:
                        seen.append((addr, type(state.store.index), kw)))
    app.start_flat("h:1", EUC, 0.0, "python", "exact", "bf16", "cpu")
    app.start_hnsw("h:2", EUC, HnswParams(seed=1), 2.0, "native")
    assert seen[0][0] == "h:1" and seen[0][1] is FlatIndex
    assert seen[1] == ("h:2", HnswIndex,
                       {"batch_window_ms": 2.0, "backend": "native"})


# -- parity with the JAX package's native server ---------------------------

_SEQUENCE = [
    ("POST", "/vectors", {"id": "a", "vector": [1.0, 2.0, 3.0],
                          "metadata": {"cat": "x"}}),
    ("POST", "/vectors/batch", {"vectors": [
        {"id": "b", "vector": [1.0, 2.0, 4.0]},
        {"id": "c", "vector": [9.0, 9.0, 9.0], "metadata": {"cat": "y"}},
        {"id": "d e", "vector": [0.5, -1.0, 2.0]}]}),
    ("GET", "/vectors", None),
    ("GET", "/vectors/a", None),
    ("GET", "/vectors/d%20e", None),
    ("POST", "/search", {"vector": [1.0, 2.0, 3.1], "k": 2}),
    ("POST", "/search", {"vector": [1.0, 2.0, 3.1]}),
    ("POST", "/search", {"vector": [1.0, 2.0, 3.1], "k": 3,
                         "filter": {"op": "eq", "field": "cat",
                                    "value": "y"}}),
    ("POST", "/search", {"vector": [1.0, 2.0, 3.0], "radius": 1.5,
                         "limit": 5}),
    ("POST", "/search/batch", {"queries": [
        {"vector": [1.0, 2.0, 3.0], "k": 1}, {"vector": [9.0, 9.0, 9.0]}]}),
    ("POST", "/search/batch", {"queries": [{"vector": [1.0, 2.0, 3.0]}],
                               "filter": {"op": "exists",
                                          "field": "cat"}}),
    ("POST", "/search", {"vector": [1.0, 2.0], "k": 1}),
    ("POST", "/search", {"vector": "bad"}),
    ("POST", "/search", {"vector": [1.0, 2.0, 3.0], "ef": 10}),
    ("POST", "/vectors", {"id": "x"}),
    ("GET", "/vectors/missing", None),
    ("DELETE", "/vectors/b", None),
    ("DELETE", "/vectors/b", None),
    ("POST", "/nope", {}),
    ("POST", "/checkpoint", None),
    ("GET", "/health", None),
]


def test_same_requests_same_bodies_as_the_jax_native_server():
    jstate = japp.AppState(J.VectorStore.with_flat_index(
        J.DistanceMetric.EUCLIDEAN))
    jsrv = JNative(JApi(jstate), "127.0.0.1", 0)
    jsrv.start_background()
    tsrv = NativeHttpServer(Api(AppState(flat_store())), "127.0.0.1", 0)
    tsrv.start_background()
    try:
        for method, path, body in _SEQUENCE:
            js, jb = _req_port(jsrv.port, method, path, body)
            ts, tb = _req_port(tsrv.port, method, path, body)
            assert ts == js, (method, path, jb, tb)
            if path.startswith("/search") and ts == 200:
                flat_j = jb if path == "/search" else sum(jb, [])
                flat_t = tb if path == "/search" else sum(tb, [])
                assert [h["id"] for h in flat_t] == [h["id"] for h in flat_j]
                np.testing.assert_allclose(
                    [h["distance"] for h in flat_t],
                    [h["distance"] for h in flat_j], rtol=2e-5, atol=1e-6)
            else:
                assert tb == jb, (method, path)
        jm = _req_port(jsrv.port, "GET", "/metrics", None)[1]
        tm = _req_port(tsrv.port, "GET", "/metrics", None)[1]
        assert set(tm) == set(jm)
        assert tm["total_queries"] == jm["total_queries"]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


# -- examples/demo.sh against the port's CLI server -------------------------

_CURL = re.compile(
    r"curl -s(?: -X (?P<method>[A-Z]+))? \"\$(?P<base>BASE2?)(?P<path>/[^\"]*)\""
    r"(?: -H '[^']*')?(?: \\\n\s*-d '(?P<body>[^']*)')?")


def _demo_requests():
    """(base, method, path, body) of every request demo.sh makes with a
    literal body (its health polls use ``curl -sf`` and are not taken);
    the HNSW part's insert loop is a shell loop, rebuilt here."""
    text = (ROOT / "examples" / "demo.sh").read_text()
    reqs = []
    for m in _CURL.finditer(text):
        body = json.loads(m["body"]) if m["body"] else None
        method = m["method"] or ("POST" if body is not None else "GET")
        reqs.append((m["base"], method, m["path"], body))
    loop = [("BASE2", "POST", "/vectors",
             {"id": f"p{i}", "vector": [float(i), 1.0],
              "metadata": {"parity": "even" if i % 2 == 0 else "odd"}})
            for i in range(20)]
    first2 = next(i for i, r in enumerate(reqs) if r[0] == "BASE2")
    return reqs[:first2] + loop + reqs[first2:]


def _spawn_port_server(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "vectordb_tpu_torch", "--device", "cpu",
         *args, "serve", "--addr", "127.0.0.1:0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    line = proc.stdout.readline()
    m = re.search(r"\(native\) listening on 127\.0\.0\.1:(\d+)", line)
    if m is None:
        proc.kill()
        raise AssertionError(f"no listening line: {line!r} "
                             f"{proc.stderr.read()}")
    return proc, int(m.group(1))


def _stop(proc):
    proc.send_signal(2)
    try:
        proc.wait(30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def test_demo_requests_against_the_port_cli_server():
    reqs = _demo_requests()
    assert len(reqs) >= 20
    flat_proc, flat_port = _spawn_port_server()
    hnsw_proc, hnsw_port = _spawn_port_server("--index", "hnsw")
    jflat = japp.AppState(J.VectorStore.with_flat_index(
        J.DistanceMetric.EUCLIDEAN))
    from vectordb_tpu.index.hnsw import HnswIndex as JHnsw
    from vectordb_tpu.index.hnsw import HnswParams as JParams
    jhnsw = japp.AppState(J.VectorStore.with_index(
        JHnsw(J.DistanceMetric.EUCLIDEAN, JParams())))
    jsrv = {"BASE": JNative(JApi(jflat), "127.0.0.1", 0),
            "BASE2": JNative(JApi(jhnsw), "127.0.0.1", 0)}
    for s in jsrv.values():
        s.start_background()
    ports = {"BASE": flat_port, "BASE2": hnsw_port}
    try:
        for base, method, path, body in reqs:
            js, jb = _req_port(jsrv[base].port, method, path, body)
            ts, tb = _req_port(ports[base], method, path, body)
            assert ts == js, (path, body, jb, tb)
            if path == "/metrics":
                assert set(tb) == set(jb)
                assert tb["total_queries"] == jb["total_queries"]
            elif path.startswith("/search"):
                flat_j = jb if path == "/search" else sum(jb, [])
                flat_t = tb if path == "/search" else sum(tb, [])
                assert [h["id"] for h in flat_t] == [h["id"] for h in flat_j]
                np.testing.assert_allclose(
                    [h["distance"] for h in flat_t],
                    [h["distance"] for h in flat_j], rtol=2e-5, atol=1e-6)
            else:
                assert tb == jb, (path, body)
    finally:
        for s in jsrv.values():
            s.shutdown()
        _stop(flat_proc)
        _stop(hnsw_proc)
    assert flat_proc.returncode is not None


# -- public signatures ------------------------------------------------------

def _params(fn):
    """(name, default) pairs; an enum default compares by its value (the
    two packages have their own DistanceMetric)."""
    return [(p.name, getattr(p.default, "value", p.default)) for p in
            inspect.signature(fn).parameters.values()]


def _sig_pairs():
    from vectordb_tpu.index.flat import FlatIndex as JFlat
    from vectordb_tpu.index.hnsw import HnswIndex as JHnsw
    from vectordb_tpu.index.hnsw_graph import HnswParams as JParams
    from vectordb_tpu.index.ivf import IvfFlatIndex as JIvf
    from vectordb_tpu.persistence import EngineConfig as JEngineConfig
    from vectordb_tpu.server.batcher import QueryBatcher as JBatcher
    from vectordb_tpu.utils import profiling as jprof

    from vectordb_tpu_torch.index.ivf import IvfFlatIndex
    from vectordb_tpu_torch.persistence import EngineConfig
    from vectordb_tpu_torch.utils import profiling
    return {
        "EngineConfig": (JEngineConfig, EngineConfig, ["device"]),
        "FlatIndex.__init__": (JFlat.__init__, FlatIndex.__init__,
                               ["device"]),
        "start_flat": (japp.start_flat, app.start_flat, ["device"]),
        "start_hnsw": (japp.start_hnsw, app.start_hnsw, ["device"]),
        "start_durable": (japp.start_durable, app.start_durable, []),
        "serve": (japp.serve, app.serve, []),
        "HnswIndex.__init__": (JHnsw.__init__, HnswIndex.__init__,
                               ["device"]),
        "IvfFlatIndex.__init__": (JIvf.__init__, IvfFlatIndex.__init__,
                                  ["device"]),
        "HnswParams": (JParams, HnswParams, []),
        "QueryBatcher.__init__": (JBatcher.__init__, QueryBatcher.__init__,
                                  []),
        "NativeHttpServer.__init__": (JNative.__init__,
                                      NativeHttpServer.__init__, []),
        "profiling.trace": (jprof.trace, profiling.trace, []),
    }


@pytest.mark.parametrize("name", sorted(_sig_pairs()))
def test_signature_matches_the_jax_package(name):
    """The JAX package's parameters, in its order and with its defaults,
    then the port's own parameters."""
    ref, port, extra = _sig_pairs()[name]
    ref_params, port_params = _params(ref), _params(port)
    assert port_params[:len(ref_params)] == ref_params
    assert [n for n, _ in port_params[len(ref_params):]] == extra


def test_engine_config_positional_like_jax():
    from vectordb_tpu.persistence import EngineConfig as JEngineConfig

    from vectordb_tpu_torch.persistence import EngineConfig
    args = (1000, DistanceMetric.EUCLIDEAN, "flat", None, None, "fast")
    assert EngineConfig(*args).search_mode == "fast"
    jargs = (1000, J.DistanceMetric.EUCLIDEAN, "flat", None, None, "fast")
    assert JEngineConfig(*jargs).search_mode == "fast"
    assert EngineConfig(*args).storage == "f32"


def test_flat_index_positional_and_mesh():
    from vectordb_tpu_torch.parallel import make_mesh
    idx = FlatIndex(EUC, "exact", None, "shard", "bf16", None, "cpu")
    assert idx.storage == "bf16"
    # the mesh, positionally as in the JAX package: rows shard over it
    mesh = make_mesh(2, devices=["cpu"] * 2)
    idx = FlatIndex(EUC, "exact", mesh, "shard", "int8", None, "cpu")
    assert idx._mesh is mesh and idx.storage == "int8"
    idx.add(0, Vector([1.0, 2.0]))
    assert idx.capacity == 2048
    assert idx.search(Vector([1.0, 2.0]), 1)[0][0] == 0
    with pytest.raises(ValueError, match="parallel.Mesh"):
        FlatIndex(EUC, mesh=object(), device="cpu")


def test_trace_takes_logdir(tmp_path):
    from vectordb_tpu_torch.utils.profiling import trace
    out = tmp_path / "t.json"
    with trace(logdir=str(out)):
        torch.ones(4).sum()
    assert out.exists()


def test_batch_search_ef_through_native_server(rng):
    """POST /search/batch with a top-level ef (the pre-parsed batch path
    leaves it to the routes) answers as the in-process store at that ef."""
    data = rng.standard_normal((300, 16)).astype(np.float32)
    served = VectorStore(HnswIndex(EUC, HnswParams(seed=2)))
    local = VectorStore(HnswIndex(EUC, HnswParams(seed=2)))
    for store in (served, local):
        for c0 in range(0, 300, 100):
            store.insert_batch([BatchInsertItem(str(i), Vector(data[i]))
                                for i in range(c0, c0 + 100)])
    srv = NativeHttpServer(Api(AppState(served)), "127.0.0.1", 0)
    srv.start_background()
    try:
        qs = rng.standard_normal((20, 16)).astype(np.float32)
        for ef in (4, 64):
            status, got = _req(srv, "POST", "/search/batch", {
                "queries": [{"vector": q.tolist(), "k": 5} for q in qs],
                "ef": ef})
            want = local.search_batch([(Vector(q), 5) for q in qs], ef=ef)
            assert status == 200
            assert [[h["id"] for h in row] for row in got] == \
                [[r.id for r in row] for row in want]
        low = local.search_batch([(Vector(q), 5) for q in qs], ef=1)
        high = local.search_batch([(Vector(q), 5) for q in qs], ef=256)
        assert low != high       # the knob changes answers on this data
    finally:
        srv.shutdown()
