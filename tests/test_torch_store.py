"""The whole slice: a JAX ``VectorStore`` carried across into the port
(convert.store_from_reference) must answer the same: same ids, distances
at rtol 2e-5 / atol 2e-5, same certified flags — through upserts,
deletes, filters, radius search, fast mode, an in-flight search, the
HTTP routes and the CLI (with its --storage modes).

The JAX side runs as its own tests run it on the CPU: Pallas in interpret
mode and the 1-pass tier's capacity gate lowered to 512 rows
(tests/test_exact1p.py), so both packages take tier 1. d=32 keeps the
JAX refine on its XLA gather path (its DMA kernel needs d % 128 == 0 and
is slow in interpret mode). The port runs its plain kernel versions on
CPU tensors.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectordb_tpu as J
from vectordb_tpu.index import flat as jflat
from vectordb_tpu.ops import coarse_kernel as jck
from vectordb_tpu.ops import topk as jtopk
from vectordb_tpu.server import test_api as jax_test_api

import vectordb_tpu_torch as T
from vectordb_tpu_torch import cli
from vectordb_tpu_torch.convert import store_from_reference
from vectordb_tpu_torch.ops import coarse_kernel as tck
from vectordb_tpu_torch.ops import topk as ttopk
from vectordb_tpu_torch.server import test_api as torch_test_api
from vectordb_tpu_torch.server.app import AppState, start_server_background

# One intra-op thread: these tests are small, and an OpenMP pool left
# behind in a pytest worker perturbs the thread timing of tests that
# share it (the parallel native HNSW build in tests/test_recall.py).
torch.set_num_threads(1)

N, D = 2000, 32
METRICS = ["euclidean", "cosine", "dot_product"]


@pytest.fixture(autouse=True)
def _tiers(monkeypatch):
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jtopk, "_EXACT1P_MIN_N", 512)
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 512)


def _pair(metric, seed=0, search_mode="exact"):
    """(jax store, port store, rng): N rows with metadata, 10% deleted,
    carried across by the exported packed arrays."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    js = J.VectorStore.with_flat_index(J.DistanceMetric(metric),
                                       search_mode=search_mode)
    js.insert_batch([J.BatchInsertItem(str(i), J.Vector(rows[i]),
                                       J.Metadata({"g": str(i % 4)}))
                     for i in range(N)])
    for i in rng.choice(N, N // 10, replace=False):
        js.delete(str(i))
    vecs, valid, ids = js.index.packed_arrays()
    id_map = js.internal_to_string_ids()
    meta = {iid: js.get_metadata(sid).fields() for iid, sid in id_map.items()}
    ts = store_from_reference(vecs, valid, ids, id_map,
                              T.DistanceMetric(metric), device="cpu",
                              search_mode=search_mode, metadata=meta)
    return js, ts, rng


def _queries(rng, q=8):
    return rng.standard_normal((q, D)).astype(np.float32)


def _same(jres, tres):
    """Per-query SearchResult lists: equal ids, close distances."""
    assert [[r.id for r in row] for row in tres] == \
        [[r.id for r in row] for row in jres]
    jd = np.array([r.distance for row in jres for r in row])
    td = np.array([r.distance for row in tres for r in row])
    np.testing.assert_allclose(td, jd, rtol=2e-5, atol=2e-5)


def _batch(js_or_ts, qs, k, mod):
    return js_or_ts.search_batch([(mod.Vector(q), k) for q in qs])


@pytest.mark.parametrize("metric", METRICS)
def test_converted_store_answers_the_same(metric):
    js, ts, rng = _pair(metric)
    assert len(ts) == len(js) and ts.index.capacity == js.index.capacity
    qs = _queries(rng)
    _same(_batch(js, qs, 10, J), _batch(ts, qs, 10, T))
    _same([js.search(J.Vector(qs[0]), 5)], [ts.search(T.Vector(qs[0]), 5)])


@pytest.mark.parametrize("metric", METRICS)
def test_certified_flags_match(metric):
    js, ts, rng = _pair(metric, seed=1)
    qs = _queries(rng)
    jd = dict(js.index._sync_device())
    with ts.index._lock:
        td = dict(ts.index._sync_device())
    jout = jck.coarse_search_1p(
        jnp.asarray(qs), jd["db"], jd["sq_norms"], jd["norms"], jd["valid"],
        jd["hi"], jd["elo_max"], J.DistanceMetric(metric), 10)
    tout = tck.coarse_search_1p(
        torch.from_numpy(qs), td["db"], td["sq_norms"], td["norms"],
        td["valid"], td["hi"], td["elo_max"], T.DistanceMetric(metric), 10)
    assert np.array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert np.array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_allclose(float(td["elo_max"]), float(jd["elo_max"]),
                               rtol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_mutations_keep_answers_equal(metric):
    js, ts, rng = _pair(metric, seed=2)
    qs = _queries(rng)
    _batch(ts, qs, 5, T)            # device state built; writes now scatter
    _batch(js, qs, 5, J)
    fresh = rng.standard_normal((30, D)).astype(np.float32)
    for s in (js, ts):
        mod = J if s is js else T
        for j in range(10):         # upserts of live ids: fresh internal ids
            s.insert(str(N - 1 - 3 * j), mod.Vector(fresh[j]))
        for j in range(10):
            if s.get(str(j * 7 + 1)) is not None:
                s.delete(str(j * 7 + 1))
        s.insert_batch([mod.BatchInsertItem(f"n{j}", mod.Vector(fresh[j]))
                        for j in range(10, 30)])
    assert len(ts) == len(js)
    _same(_batch(js, qs, 10, J), _batch(ts, qs, 10, T))
    np.testing.assert_array_equal(ts.get("n12").as_array(),
                                  js.get("n12").as_array())


def test_huge_elo_max_falls_back_and_stays_exact():
    js, ts, rng = _pair("euclidean", seed=3)
    qs = _queries(rng)
    with ts.index._lock:
        state = dict(ts.index._sync_device())
    state["elo_max"] = torch.tensor(1e9)
    got_d, got_i = ttopk.flat_search_batched(qs, state,
                                             T.DistanceMetric.EUCLIDEAN, 5)
    exact = {k: v for k, v in state.items()
             if k not in ("hi", "lo", "elo_max")}
    want_d, want_i = ttopk.flat_search_batched(qs, exact,
                                               T.DistanceMetric.EUCLIDEAN, 5)
    assert np.array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_filters_match(metric):
    js, ts, rng = _pair(metric, seed=4)
    qs = _queries(rng, 4)
    for flt in ({"op": "eq", "field": "g", "value": "1"},
                {"op": "or", "filters": [
                    {"op": "eq", "field": "g", "value": "0"},
                    {"op": "ne", "field": "g", "value": "2"}]}):
        jf, tf = J.MetadataFilter.from_dict(flt), T.MetadataFilter.from_dict(
            flt)
        _same([js.search_with_filter(J.Vector(qs[0]), 7, jf)],
              [ts.search_with_filter(T.Vector(qs[0]), 7, tf)])
        _same(js.search_batch_with_filter(
                  [(J.Vector(q), 5) for q in qs], jf),
              ts.search_batch_with_filter(
                  [(T.Vector(q), 5) for q in qs], tf))


@pytest.mark.parametrize("metric", METRICS)
def test_radius_matches(metric):
    js, ts, rng = _pair(metric, seed=5)
    q = _queries(rng, 1)[0]
    ref = ts.search(T.Vector(q), 12)
    radius = ref[-1].distance
    _same([js.search_radius(J.Vector(q), radius, limit=50)],
          [ts.search_radius(T.Vector(q), radius, limit=50)])
    flt = {"op": "eq", "field": "g", "value": "3"}
    _same([js.search_radius(J.Vector(q), radius, limit=50,
                            filter=J.MetadataFilter.from_dict(flt))],
          [ts.search_radius(T.Vector(q), radius, limit=50,
                            filter=T.MetadataFilter.from_dict(flt))])


@pytest.mark.parametrize("metric", METRICS)
def test_fast_mode_matches(metric):
    js, ts, rng = _pair(metric, seed=6, search_mode="fast")
    qs = _queries(rng)
    _same(_batch(js, qs, 10, J), _batch(ts, qs, 10, T))


def test_in_flight_search_sees_its_snapshot():
    """A delete and an upsert that land between submit and collect do not
    change the collected results (the port scatters into copies while a
    search is in flight), as in the JAX package."""
    js, ts, rng = _pair("euclidean", seed=7)
    qs = _queries(rng, 2)
    results = []
    for s, mod in ((js, J), (ts, T)):
        s.search_batch([(mod.Vector(q), 5) for q in qs])   # state built
        handle = s.search_batch_submit([(mod.Vector(q), 5) for q in qs])
        top = s.search(mod.Vector(qs[0]), 1)[0].id
        s.delete(top)
        s.insert("late", mod.Vector(qs[1]))
        results.append(handle.collect())
        assert top in [r.id for r in results[-1][0]]
        assert "late" not in [r.id for r in results[-1][1]]
    _same(*results)


def test_convert_rejects_a_mismatched_id_map():
    js, _, _ = _pair("euclidean", seed=8)
    vecs, valid, ids = js.index.packed_arrays()
    id_map = js.internal_to_string_ids()
    id_map.pop(next(iter(id_map)))
    with pytest.raises(ValueError):
        store_from_reference(vecs, valid, ids, id_map,
                             T.DistanceMetric.EUCLIDEAN, device="cpu")


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 2e-5 * abs(b) + 2e-5
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_close, a, b))
    return a == b


def _route_script(rng):
    rows = rng.standard_normal((40, 8)).astype(np.float32).tolist()
    return [
        ("POST", "/vectors/batch", {"vectors": [
            {"id": f"v{i}", "vector": rows[i],
             "metadata": {"g": str(i % 3)}} for i in range(40)]}),
        ("POST", "/vectors", {"id": "x", "vector": rows[3]}),
        ("POST", "/search", {"vector": rows[5], "k": 4}),
        ("POST", "/search", {"vector": rows[5], "k": 4,
                             "filter": {"op": "eq", "field": "g",
                                        "value": "1"}}),
        ("POST", "/search", {"vector": rows[6], "radius": 3.0}),
        ("POST", "/search/batch", {"queries": [
            {"vector": rows[1], "k": 2}, {"vector": rows[2]}]}),
        ("GET", "/vectors/v7", None),
        ("DELETE", "/vectors/v7", None),
        ("GET", "/vectors/v7", None),
        ("DELETE", "/vectors/nope", None),
        ("POST", "/vectors", {"id": "bad", "vector": [1.0, 2.0]}),
        ("POST", "/search", {"vector": rows[7], "k": 3}),
        ("POST", "/search", {"vector": rows[7], "ef": 3}),
        ("POST", "/checkpoint", None),
        ("GET", "/health", None),
    ]


def test_routes_answer_like_the_jax_server():
    rng = np.random.default_rng(9)
    japi, _ = jax_test_api()
    tapi, _ = torch_test_api(device="cpu")
    for method, path, body in _route_script(rng):
        want = japi.handle(method, path, body)
        got = tapi.handle(method, path, body)
        assert got[0] == want[0], (method, path, got, want)
        assert _close(got[1], want[1]), (method, path, got, want)
    got_ids = sorted(tapi.handle("GET", "/vectors")[1])
    assert got_ids == sorted(japi.handle("GET", "/vectors")[1])
    assert tapi.handle("GET", "/metrics")[1]["total_queries"] == \
        japi.handle("GET", "/metrics")[1]["total_queries"]


def test_http_server_on_a_socket():
    state = AppState(T.VectorStore.with_flat_index(
        T.DistanceMetric.EUCLIDEAN, device="cpu"))
    server, thread = start_server_background("127.0.0.1:0", state)
    port = server.server_address[1]

    def call(method, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())

    try:
        assert call("POST", "/vectors/batch", {"vectors": [
            {"id": "a", "vector": [1.0, 0.0]},
            {"id": "b", "vector": [0.0, 1.0]}]})[0] == 201
        status, hits = call("POST", "/search", {"vector": [0.9, 0.1]})
        assert status == 200 and hits[0]["id"] == "a"
        assert call("GET", "/health")[1] == {"status": "ok",
                                             "vector_count": 2}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serving_options_not_ported_refuse():
    """The native front end and the batcher window, once refused, serve
    now (tests/test_torch_serving.py drives them); an unknown backend is
    still refused."""
    import threading

    from vectordb_tpu_torch.server.app import serve
    from vectordb_tpu_torch.server.native_http import NativeHttpServer
    for kw in ({"backend": "native"}, {"batch_window_ms": 2.0}):
        state = AppState(T.VectorStore.with_flat_index(
            T.DistanceMetric.EUCLIDEAN, device="cpu"))
        ready = threading.Event()
        thread = threading.Thread(target=serve, args=("127.0.0.1:0", state),
                                  kwargs={"ready_event": ready, **kw},
                                  daemon=True)
        thread.start()
        assert ready.wait(60)
        assert isinstance(state.server, NativeHttpServer)
        state.server.shutdown()
        thread.join(30)
        assert not thread.is_alive()
    with pytest.raises(ValueError, match="backend"):
        serve("127.0.0.1:0", state, backend="gpu")


def test_cli_in_memory_verbs(capsys):
    assert cli.main(["--device", "cpu", "insert", "a", "--vector",
                     "1,2,3"]) == 0
    assert "Inserted vector with ID: a" in capsys.readouterr().out
    assert cli.main(["--device", "cpu", "search", "1,2,3"]) == 0
    assert "No results found" in capsys.readouterr().out
    assert cli.main(["--device", "cpu", "list"]) == 0


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_cli_storage_insert_then_search(storage, monkeypatch, capsys):
    made = []
    real = cli.VectorStore.with_flat_index

    def capture(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]
    monkeypatch.setattr(cli.VectorStore, "with_flat_index", capture)
    assert cli.main(["--device", "cpu", "--storage", storage, "insert", "a",
                     "--vector", "1.1,2.3,3.7"]) == 0
    assert "Inserted vector with ID: a" in capsys.readouterr().out
    store = made[-1]
    assert store.index.storage == storage
    store.insert("b", T.Vector([9.0, 9.0, 9.0]))
    args = cli.build_parser().parse_args(
        ["--device", "cpu", "--storage", storage, "search", "1.1,2.3,3.7"])
    assert cli._run_commands(store, args) == 0
    out = capsys.readouterr().out
    assert "Top 2 results:" in out and "1. a (distance:" in out
    stored = store.get("a").as_array()
    want = {"bf16": jflat._quantize_bf16,
            "int8": jflat._quantize_int8}[storage](
        np.array([1.1, 2.3, 3.7], np.float32))
    np.testing.assert_array_equal(stored, want)


@pytest.mark.parametrize("argv", [
    ["--index", "ivfpq", "list"], ["--index", "ivf", "list"],
    ["--index", "ivf", "serve", "--http", "native"],
    ["--index", "ivfpq", "serve", "--batch-window-ms", "2"]])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    assert cli.main(["--device", "cpu", *argv]) == 1
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("verb", ["list", "serve"])
def test_cli_runs_data_dir_and_durable_dir(verb, tmp_path, monkeypatch,
                                           capsys):
    """Once refused: ``--data-dir`` runs the verbs against a durable store
    and ``serve --durable-dir`` serves one (start_durable, stubbed here;
    tests/test_torch_durable.py drives it over a socket)."""
    d = str(tmp_path / "db")
    if verb == "list":
        assert cli.main(["--device", "cpu", "--data-dir", d, "insert", "a",
                         "--vector", "1,2"]) == 0
        assert cli.main(["--device", "cpu", "--data-dir", d, "list"]) == 0
        assert "  - a" in capsys.readouterr().out
        return
    from vectordb_tpu_torch.server import app
    seen = []
    monkeypatch.setattr(app, "start_durable",
                        lambda addr, data_dir, config, **kw: seen.append(
                            (data_dir, config.device)))
    assert cli.main(["--device", "cpu", "serve", "--durable-dir", d]) == 0
    assert seen == [(d, "cpu")]
