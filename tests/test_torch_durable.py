"""Durable serving and the CLI's ``--data-dir`` in the port, on the CPU.

Mirrors tests/test_durable_serving.py (its HNSW case waits for the HNSW
slice) and the ``--data-dir`` cases of tests/test_cli.py: the HTTP Api
over a StorageEngine-backed AppState (WAL-first writes, POST /checkpoint),
a real socket across a restart, ``serve --durable-dir`` as a process, and
the persistent CLI verbs. The durable answers are held to the in-memory
store's and, on a directory the JAX package's durable server wrote, to
the JAX package's.
"""

import json
import os
import select
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from vectordb_tpu.persistence import EngineConfig as JEngineConfig
from vectordb_tpu.persistence import StorageEngine as JStorageEngine
from vectordb_tpu.server.app import AppState as JAppState
from vectordb_tpu.server.routes import Api as JApi

from vectordb_tpu_torch import cli
from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine
from vectordb_tpu_torch.server import test_api as make_memory_api
from vectordb_tpu_torch.server.app import (AppState, start_durable,
                                           start_server_background)
from vectordb_tpu_torch.server.routes import Api

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def make_api(data_dir, **cfg):
    engine = StorageEngine.open(data_dir, EngineConfig(device="cpu", **cfg))
    return Api(AppState(engine)), engine


def insert(api, vid, vec, metadata=None):
    body = {"id": vid, "vector": vec}
    if metadata:
        body["metadata"] = metadata
    return api.handle("POST", "/vectors", body)


def request(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


class TestDurableCrud:
    def test_insert_survives_reopen(self, tmp_path):
        api, engine = make_api(tmp_path)
        status, _ = insert(api, "a", [1.0, 2.0], {"kind": "x"})
        assert status == 201
        engine.close()
        api2, engine2 = make_api(tmp_path)
        status, payload = api2.handle("GET", "/vectors/a")
        assert status == 200
        assert payload["vector"] == [1.0, 2.0]
        assert payload["metadata"] == {"kind": "x"}
        engine2.close()

    def test_delete_survives_reopen(self, tmp_path):
        api, engine = make_api(tmp_path)
        insert(api, "a", [1.0, 2.0])
        insert(api, "b", [3.0, 4.0])
        assert api.handle("DELETE", "/vectors/a")[0] == 200
        engine.close()
        api2, engine2 = make_api(tmp_path)
        assert api2.handle("GET", "/vectors/a")[0] == 404
        assert api2.handle("GET", "/vectors/b")[0] == 200
        engine2.close()

    def test_batch_insert_survives_reopen(self, tmp_path):
        api, engine = make_api(tmp_path)
        status, payload = api.handle("POST", "/vectors/batch", {
            "vectors": [{"id": f"v{i}", "vector": [float(i), 0.0]}
                        for i in range(20)]})
        assert status == 201 and payload == {"inserted": 20}
        engine.close()
        api2, engine2 = make_api(tmp_path)
        status, ids = api2.handle("GET", "/vectors")
        assert status == 200 and len(ids) == 20
        engine2.close()

    def test_unclean_close_recovers_from_wal(self, tmp_path):
        api, engine = make_api(tmp_path)
        insert(api, "a", [1.0, 0.0])
        insert(api, "b", [0.0, 1.0])
        api.handle("DELETE", "/vectors/a")
        api2, engine2 = make_api(tmp_path)
        assert api2.handle("GET", "/vectors") == (200, ["b"])
        engine2.close()
        engine.close()


class TestDurableSearch:
    def test_search_endpoints_match_memory_store(self, tmp_path):
        api, engine = make_api(tmp_path)
        mem_api, _ = make_memory_api(device="cpu")
        rows = [("a", [0.0, 0.0], {"kind": "x"}),
                ("b", [1.0, 0.0], {"kind": "y"}),
                ("c", [0.0, 2.0], {"kind": "x"}),
                ("d", [3.0, 3.0], None)]
        for vid, vec, meta in rows:
            insert(api, vid, vec, meta)
            insert(mem_api, vid, vec, meta)
        for body in (
            {"vector": [0.1, 0.1], "k": 3},
            {"vector": [0.1, 0.1], "k": 2,
             "filter": {"op": "eq", "field": "kind", "value": "x"}},
            {"vector": [0.0, 0.0], "radius": 1.5},
            {"vector": [0.0, 0.0], "radius": 1.5, "limit": 1,
             "filter": {"op": "eq", "field": "kind", "value": "x"}},
        ):
            assert api.handle("POST", "/search", body) == \
                mem_api.handle("POST", "/search", body), body
        batch = {"queries": [{"vector": [0.1, 0.1], "k": 2},
                             {"vector": [3.0, 3.0]}]}
        assert api.handle("POST", "/search/batch", batch) == \
            mem_api.handle("POST", "/search/batch", batch)
        batch["filter"] = {"op": "exists", "field": "kind"}
        assert api.handle("POST", "/search/batch", batch) == \
            mem_api.handle("POST", "/search/batch", batch)
        engine.close()

    def test_health_and_list(self, tmp_path):
        api, engine = make_api(tmp_path)
        insert(api, "a", [1.0])
        assert api.handle("GET", "/health") == (
            200, {"status": "ok", "vector_count": 1})
        assert api.handle("GET", "/vectors") == (200, ["a"])
        engine.close()

    def test_pq_engine_behind_api(self, tmp_path):
        """The PQ-Flat engine serves the same routes (the refine knob
        included) and answers the same after a reopen."""
        api, engine = make_api(tmp_path, index_type="pq")
        for i in range(40):
            insert(api, f"v{i}", [float(i), float(i % 3)])
        body = {"vector": [5.0, 2.0], "k": 3, "refine": 8}
        status, hits = api.handle("POST", "/search", body)
        assert status == 200 and hits[0]["id"] == "v5"
        engine.close()
        api2, engine2 = make_api(tmp_path, index_type="pq")
        assert api2.handle("POST", "/search", body) == (200, hits)
        engine2.close()

    def test_jax_written_directory_serves_the_same(self, tmp_path):
        """A directory the JAX package's durable Api wrote, served by the
        port's: the same answers on every search route."""
        rows = np.random.default_rng(5).standard_normal((44, 3)).tolist()
        jeng = JStorageEngine.open(tmp_path, JEngineConfig())
        japi = JApi(JAppState(jeng))
        for i in range(30):
            insert(japi, f"v{i}", rows[i], {"p": str(i % 2)})
        japi.handle("POST", "/checkpoint")
        for i in range(30, 40):
            insert(japi, f"v{i}", rows[i])
        japi.handle("DELETE", "/vectors/v3")
        bodies = [("/search", {"vector": rows[40], "k": 5}),
                  ("/search", {"vector": rows[41], "k": 4, "filter":
                               {"op": "eq", "field": "p", "value": "1"}}),
                  ("/search/batch", {"queries": [
                      {"vector": rows[42], "k": 3}, {"vector": rows[43]}]})]
        want = [japi.handle("POST", p, b) for p, b in bodies]
        jeng.close()
        api, engine = make_api(tmp_path)
        for (p, b), w in zip(bodies, want):
            got = api.handle("POST", p, b)
            assert got[0] == w[0] == 200
            assert _close(got[1], w[1]), (p, b)
        assert api.handle("GET", "/vectors/v3")[0] == 404
        engine.close()


def _close(a, b):
    """Same ids, distances at rtol 2e-5 (nested route payloads)."""
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a["id"] == b["id"] and \
        abs(a["distance"] - b["distance"]) <= 2e-5 * abs(b["distance"]) + 2e-5


class TestCheckpointEndpoint:
    def test_checkpoint_truncates_wal(self, tmp_path):
        api, engine = make_api(tmp_path)
        for i in range(8):
            insert(api, f"v{i}", [float(i), 1.0])
        assert (tmp_path / "wal.log").stat().st_size > 0
        status, payload = api.handle("POST", "/checkpoint")
        assert status == 200
        assert payload == {"status": "checkpointed", "vector_count": 8}
        assert engine._wal_count == 0
        engine.close()
        api2, engine2 = make_api(tmp_path)
        status, ids = api2.handle("GET", "/vectors")
        assert status == 200 and len(ids) == 8
        engine2.close()

    def test_checkpoint_404_on_memory_store(self):
        api, _ = make_memory_api(device="cpu")
        assert api.handle("POST", "/checkpoint")[0] == 404

    def test_checkpoint_wrong_method_404(self, tmp_path):
        api, engine = make_api(tmp_path)
        assert api.handle("GET", "/checkpoint")[0] == 404
        engine.close()


class TestDurableSocket:
    def test_real_socket_durable_roundtrip(self, tmp_path):
        engine = StorageEngine.open(tmp_path, EngineConfig(device="cpu"))
        server, _ = start_server_background("127.0.0.1:0", AppState(engine))
        try:
            status, _ = request(server.server_address[1], "POST", "/vectors",
                                {"id": "a", "vector": [1.0, 2.0]})
            assert status == 201
        finally:
            server.shutdown()
            server.server_close()
            engine.close()
        engine2 = StorageEngine.open(tmp_path, EngineConfig(device="cpu"))
        server2, _ = start_server_background("127.0.0.1:0",
                                             AppState(engine2))
        port2 = server2.server_address[1]
        try:
            status, payload = request(port2, "GET", "/vectors/a")
            assert status == 200 and payload["vector"] == [1.0, 2.0]
            status, hits = request(port2, "POST", "/search",
                                   {"vector": [1.0, 2.0], "k": 1})
            assert status == 200 and hits[0]["id"] == "a"
        finally:
            server2.shutdown()
            server2.server_close()
            engine2.close()

    def test_start_durable_serves_the_engine(self, tmp_path, monkeypatch):
        """start_durable opens the directory's engine with the config and
        serves it; the engine closes when serving ends."""
        from vectordb_tpu_torch.server import app
        seen = {}

        def fake_serve(addr, state, **kw):
            seen.update(addr=addr, state=state, kw=kw)
            state.store.insert("a", cli.Vector([1.0, 2.0]))

        monkeypatch.setattr(app, "serve", fake_serve)
        start_durable("127.0.0.1:0", tmp_path, EngineConfig(device="cpu"))
        assert isinstance(seen["state"].store, StorageEngine)
        assert seen["state"].store.wal._handle is None and \
            seen["state"].store.wal._file is None          # closed
        with StorageEngine.open(tmp_path, EngineConfig(device="cpu")) as e:
            assert e.list_ids() == ["a"]
        with pytest.raises(NotImplementedError, match="item 8"):
            start_durable("127.0.0.1:0", tmp_path,
                          EngineConfig(device="cpu"), backend="native")

    def test_cli_serve_durable_dir_process(self, tmp_path):
        """``serve --durable-dir`` as its own process: a write, a stop by
        SIGINT, a second process on the same directory reads it back."""
        env = dict(os.environ, PYTHONPATH=str(ROOT))

        def start():
            proc = subprocess.Popen(
                [sys.executable, "-m", "vectordb_tpu_torch", "--device",
                 "cpu", "serve", "--durable-dir", str(tmp_path), "--addr",
                 "127.0.0.1:0"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            ready, _, _ = select.select([proc.stdout], [], [], 120)
            if not ready:
                proc.kill()
                proc.wait()
                pytest.fail("the server printed nothing in 120 s")
            line = proc.stdout.readline()
            assert "listening on" in line, line
            return proc, int(line.strip().rsplit(":", 1)[1])

        def stop(proc):
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.stdout.close()

        proc, port = start()
        try:
            assert request(port, "POST", "/vectors",
                           {"id": "a", "vector": [1.0, 2.0]})[0] == 201
            assert request(port, "POST", "/checkpoint")[0] == 200
            assert request(port, "POST", "/vectors",
                           {"id": "b", "vector": [3.0, 4.0]})[0] == 201
        finally:
            stop(proc)
        proc, port = start()
        try:
            status, hits = request(port, "POST", "/search",
                                   {"vector": [3.0, 4.1], "k": 2})
            assert status == 200 and [h["id"] for h in hits] == ["b", "a"]
        finally:
            stop(proc)


# ---------------------------------------------------------------------------
# the CLI (tests/test_cli.py's --data-dir cases, tests/test_durable_serving
# TestCliFlag)
# ---------------------------------------------------------------------------

def run(capsys, *argv):
    code = cli.main(["--device", "cpu", *argv])
    out = capsys.readouterr()
    return code, out.out, out.err


def test_persistent_workflow(capsys, tmp_path):
    d = str(tmp_path / "db")
    assert run(capsys, "--data-dir", d, "insert", "a",
               "--vector", "1.0,0.0")[0] == 0
    assert run(capsys, "--data-dir", d, "insert", "b",
               "--vector", "0.0,1.0")[0] == 0
    code, out, _ = run(capsys, "--data-dir", d, "search", "1.0,0.1",
                       "-k", "1")
    assert code == 0
    assert "Top 1 results:" in out and "1. a (distance:" in out
    _, out, _ = run(capsys, "--data-dir", d, "list")
    assert "Vector IDs (2 total):" in out
    assert "  - a" in out and "  - b" in out
    _, out, _ = run(capsys, "--data-dir", d, "delete", "a")
    assert "Deleted vector with ID: a" in out
    _, out, _ = run(capsys, "--data-dir", d, "list")
    assert "Vector IDs (1 total):" in out


def test_delete_missing_errors_with_data_dir(capsys, tmp_path):
    code, _, err = run(capsys, "--data-dir", str(tmp_path), "delete",
                       "ghost")
    assert code == 1 and "Vector not found: ghost" in err


def test_serve_with_data_dir_rejected(capsys, tmp_path):
    code, _, err = run(capsys, "--data-dir", str(tmp_path), "serve")
    assert code == 1
    assert "not supported with --data-dir" in err


def test_k_default_is_5(capsys, tmp_path):
    d = str(tmp_path / "db")
    for i in range(8):
        run(capsys, "--data-dir", d, "insert", f"v{i}",
            "--vector", f"{i}.0,0.0")
    code, out, _ = run(capsys, "--data-dir", d, "search", "0.0,0.0")
    assert code == 0 and "Top 5 results:" in out


def test_metric_flag(capsys, tmp_path):
    d = str(tmp_path / "db")
    run(capsys, "--data-dir", d, "--metric", "dot_product",
        "insert", "big", "--vector", "10.0,10.0")
    run(capsys, "--data-dir", d, "--metric", "dot_product",
        "insert", "small", "--vector", "0.1,0.1")
    _, out, _ = run(capsys, "--data-dir", d, "--metric", "dot_product",
                    "search", "1.0,1.0", "-k", "1")
    assert "1. big" in out


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_data_dir_storage_is_the_jax_packages(capsys, tmp_path, storage):
    """--storage with --data-dir: the port's directory reads back in the
    JAX package with the same stored (quantized) values."""
    d = tmp_path / "db"
    assert run(capsys, "--data-dir", str(d), "--storage", storage,
               "insert", "a", "--vector", "1.1,2.3,3.7")[0] == 0
    _, out, _ = run(capsys, "--data-dir", str(d), "--storage", storage,
                    "search", "1.1,2.3,3.7", "-k", "1")
    assert "1. a (distance:" in out
    with StorageEngine.open(d, EngineConfig(device="cpu",
                                            storage=storage)) as e:
        mine = e.get("a").as_list()
    with JStorageEngine.open(d, JEngineConfig(storage=storage)) as e:
        assert e.get("a").as_list() == mine


def test_data_dir_index_pq(capsys, tmp_path):
    d = str(tmp_path / "db")
    for i in range(5):
        assert run(capsys, "--data-dir", d, "--index", "pq", "insert",
                   f"v{i}", "--vector", f"{i}.0,1.0")[0] == 0
    code, out, _ = run(capsys, "--data-dir", d, "--index", "pq", "search",
                       "3.1,1.0", "-k", "1")
    assert code == 0 and "1. v3 (distance:" in out


def test_parser_accepts_durable_dir():
    args = cli.build_parser().parse_args(
        ["serve", "--durable-dir", "/tmp/x", "--addr", "127.0.0.1:0"])
    assert args.durable_dir == "/tmp/x"


def test_serve_durable_dir_builds_the_engine_config(monkeypatch, tmp_path):
    from vectordb_tpu_torch.server import app
    seen = {}
    monkeypatch.setattr(app, "start_durable",
                        lambda addr, d, config, **kw: seen.update(
                            addr=addr, d=d, config=config, kw=kw))
    assert cli.main(["--device", "cpu", "--storage", "int8",
                     "--search-mode", "fast", "serve", "--durable-dir",
                     str(tmp_path), "--addr", "127.0.0.1:0"]) == 0
    c = seen["config"]
    assert (c.device, c.storage, c.search_mode, c.index_type) == \
        ("cpu", "int8", "fast", "flat")
    assert seen["d"] == str(tmp_path) and seen["addr"] == "127.0.0.1:0"
