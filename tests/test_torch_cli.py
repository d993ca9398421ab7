"""The port's CLI and whole-workflow cases, on the CPU.

Mirrors tests/test_cli.py (the cases tests/test_torch_durable.py does not
hold already), tests/test_integration.py (its flat, engine and CLI cases;
its device-HNSW case waits for ROADMAP queue 1 item 10b and is held to
the error that names it) and the flat, PQ, persistence and CLI cases of
tests/test_review_regressions.py, over the port with ``--device cpu``.
"""

import numpy as np
import pytest
import torch

from vectordb_tpu_torch import (BatchInsertItem, DistanceMetric, FlatIndex,
                                HnswIndex, HnswParams, Metadata,
                                MetadataFilter, Vector, VectorStore, cli)
from vectordb_tpu_torch.errors import DimensionMismatchError
from vectordb_tpu_torch.index.pq import PqFlatIndex
from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN


def run(capsys, *argv):
    code = cli.main(["--device", "cpu", *argv])
    out = capsys.readouterr()
    return code, out.out, out.err


# -- tests/test_cli.py -------------------------------------------------------

def test_insert_in_memory(capsys):
    code, out, _ = run(capsys, "insert", "a", "--vector", "1.0,2.0")
    assert code == 0 and "Inserted vector with ID: a" in out


def test_search_empty_store(capsys):
    code, out, _ = run(capsys, "search", "1.0,2.0")
    assert code == 0 and "No results found (store is empty)" in out


def test_delete_missing_errors(capsys):
    code, _, err = run(capsys, "delete", "ghost")
    assert code == 1 and "Vector not found: ghost" in err


def test_invalid_vector_errors(capsys):
    code, _, err = run(capsys, "insert", "a", "--vector", "1.0,zzz")
    assert code == 1 and "Invalid float" in err


def test_hnsw_index_flag(capsys):
    code, out, _ = run(capsys, "--index", "hnsw", "insert", "a",
                       "--vector", "1.0,2.0")
    assert code == 0 and "Inserted" in out


def test_cli_storage_bf16(capsys):
    assert run(capsys, "--storage", "bf16", "insert", "a",
               "--vector", "1.1,2.2,3.3")[0] == 0
    assert FlatIndex(EUC, storage="bf16", device="cpu").storage == "bf16"


def test_search_knobs(capsys, tmp_path):
    d = str(tmp_path / "db")
    for i in range(8):
        assert run(capsys, "--data-dir", d, "--index", "hnsw", "insert",
                   f"v{i}", "--vector", f"{i}.0,1.0")[0] == 0
    code, out, _ = run(capsys, "--data-dir", d, "--index", "hnsw",
                       "search", "3.1,1.0", "-k", "1", "--ef", "64")
    assert code == 0 and "1. v3 (distance:" in out
    code, _, err = run(capsys, "--data-dir", d, "--index", "hnsw",
                       "search", "3.1,1.0", "--nprobe", "2")
    assert code == 1 and "nprobe" in err
    code, _, err = run(capsys, "--data-dir", d, "--index", "hnsw",
                       "search", "3.1,1.0", "--refine", "8")
    assert code == 1 and "refine" in err


def test_search_knobs_on_flat_and_pq(capsys, tmp_path):
    """--ef on a flat store and --nprobe on PQ are errors, as in the JAX
    package; --refine reaches a PQ store."""
    d = str(tmp_path / "flat")
    run(capsys, "--data-dir", d, "insert", "a", "--vector", "1.0,2.0")
    code, _, err = run(capsys, "--data-dir", d, "search", "1.0,2.0",
                       "--ef", "16")
    assert code == 1 and "'ef' requires an HNSW index" in err
    p = str(tmp_path / "pq")
    for i in range(6):
        run(capsys, "--data-dir", p, "--index", "pq", "insert", f"v{i}",
            "--vector", f"{i}.0,1.0")
    code, out, _ = run(capsys, "--data-dir", p, "--index", "pq", "search",
                       "2.1,1.0", "-k", "1", "--refine", "4")
    assert code == 0 and "1. v2 (distance:" in out
    code, _, err = run(capsys, "--data-dir", p, "--index", "pq", "search",
                       "2.1,1.0", "--nprobe", "2")
    assert code == 1 and "nprobe" in err


def test_knobs_with_radius_rejected(capsys, tmp_path):
    d = str(tmp_path / "db")
    run(capsys, "--data-dir", d, "--index", "hnsw", "insert", "a",
        "--vector", "1.0,2.0")
    code, _, err = run(capsys, "--data-dir", d, "--index", "hnsw", "search",
                       "1.0,2.0", "--radius", "1.0", "--ef", "8")
    assert code == 1 and "--radius" in err


def test_hnsw_data_dir_matches_the_jax_cli(capsys, tmp_path):
    """--index hnsw --data-dir: the JAX CLI reads the port's directory
    (and its graph) and answers the same search."""
    from vectordb_tpu.cli import main as jmain
    d = str(tmp_path / "db")
    for i in range(12):
        assert run(capsys, "--data-dir", d, "--index", "hnsw", "insert",
                   f"v{i}", "--vector", f"{i}.0,{i % 3}.0")[0] == 0
    with StorageEngine.open(d, EngineConfig(index_type="hnsw",
                                            device="cpu")) as eng:
        eng.checkpoint()
    _, out, _ = run(capsys, "--data-dir", d, "--index", "hnsw", "search",
                    "4.2,1.0", "-k", "3", "--ef", "32")
    assert jmain(["--data-dir", d, "--index", "hnsw", "search", "4.2,1.0",
                  "-k", "3", "--ef", "32"]) == 0
    assert capsys.readouterr().out == out


def test_hnsw_seed_flag_reaches_the_params(capsys, monkeypatch):
    from vectordb_tpu_torch.server import app
    seen = []
    monkeypatch.setattr(app, "start_hnsw",
                        lambda addr, metric, params, **kw: seen.append(
                            (addr, params, kw)))
    assert cli.main(["--index", "hnsw", "--hnsw-seed", "5", "serve",
                     "--addr", "127.0.0.1:0", "--http", "native",
                     "--batch-window-ms", "1.5"]) == 0
    assert seen == [("127.0.0.1:0", HnswParams(seed=5),
                     {"batch_window_ms": 1.5, "backend": "native"})]


@pytest.mark.parametrize("index", ["flat", "pq"])
def test_serve_passes_http_and_window(index, monkeypatch):
    from vectordb_tpu_torch.server import app
    seen = []
    monkeypatch.setattr(app, "start_flat",
                        lambda addr, metric, **kw: seen.append(kw))
    monkeypatch.setattr(app, "serve",
                        lambda addr, state, **kw: seen.append(kw))
    assert cli.main(["--device", "cpu", "--index", index, "serve", "--http",
                     "python", "--batch-window-ms", "3"]) == 0
    assert seen[0]["backend"] == "python"
    assert seen[0]["batch_window_ms"] == 3.0


def test_serve_durable_hnsw_config(monkeypatch, tmp_path):
    from vectordb_tpu_torch.server import app
    seen = []
    monkeypatch.setattr(app, "start_durable",
                        lambda addr, d, config, **kw: seen.append(config))
    assert cli.main(["--device", "cpu", "--index", "hnsw", "--hnsw-seed",
                     "2", "serve", "--durable-dir", str(tmp_path)]) == 0
    assert seen[0].index_type == "hnsw"
    assert seen[0].hnsw_params == HnswParams(seed=2)


# -- tests/test_integration.py -----------------------------------------------

def test_full_workflow():
    store = VectorStore.new(EUC, device="cpu")
    store.insert("a", Vector([1.0, 0.0]))
    store.insert("b", Vector([0.0, 1.0]))
    store.insert("c", Vector([1.0, 1.0]))
    results = store.search(Vector([0.9, 0.1]), 2)
    assert results[0].id == "a" and len(results) == 2
    assert store.delete("a") == Vector([1.0, 0.0])
    assert store.search(Vector([0.9, 0.1]), 2)[0].id != "a"
    assert len(store) == 2


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_all_metrics_workflow(metric):
    store = VectorStore.new(metric, device="cpu")
    store.insert("x", Vector([1.0, 0.2]))
    store.insert("y", Vector([0.2, 1.0]))
    results = store.search(Vector([1.0, 0.1]), 2)
    assert len(results) == 2
    assert results[0].distance <= results[1].distance


def test_persistent_lifecycle_with_filters(tmp_path):
    with StorageEngine.open(tmp_path, EngineConfig(device="cpu")) as eng:
        eng.insert_with_metadata("a", Vector([1.0, 0.0]),
                                 Metadata({"cat": "x"}))
        eng.insert_with_metadata("b", Vector([0.0, 1.0]),
                                 Metadata({"cat": "y"}))
        eng.checkpoint()
    with StorageEngine.open(tmp_path, EngineConfig(device="cpu")) as eng:
        hits = eng.store.search_with_filter(
            Vector([1.0, 0.0]), 5, MetadataFilter.eq("cat", "y"))
        assert [h.id for h in hits] == ["b"]


def test_store_with_device_hnsw_batch(rng):
    """Store over HNSW: the host traversal answers each stored row with
    itself; the device traversal waits for item 10b and says so."""
    data = rng.random((300, 16)).astype(np.float32)
    idx = HnswIndex(EUC, HnswParams(seed=8))
    store = VectorStore.with_index(idx)
    for i in range(300):
        store.insert(f"v{i}", Vector(data[i]))
    for qi in range(4):
        assert store.search(Vector(data[qi]), 3, ef=60)[0].id == f"v{qi}"
    with pytest.raises(NotImplementedError, match="item 10b"):
        idx.search_batch_device(data[:4], 3, ef=60)


def test_cli_server_roundtrip_in_process():
    from vectordb_tpu_torch.server import test_api
    api, state = test_api(device="cpu")
    api.handle("POST", "/vectors", {"id": "a", "vector": [1.0, 2.0]})
    with state.lock.read():
        assert state.store.get("a") == Vector([1.0, 2.0])
    status, hits = api.handle("POST", "/search", {"vector": [1.0, 2.0]})
    assert status == 200 and hits[0]["id"] == "a"


# -- tests/test_review_regressions.py: persistence, CLI, flat, PQ -----------

def test_rejected_insert_does_not_poison_wal(tmp_path):
    with StorageEngine.open(tmp_path, EngineConfig(device="cpu")) as eng:
        eng.insert("a", Vector([1.0, 2.0, 3.0]))
        with pytest.raises(DimensionMismatchError):
            eng.insert("bad", Vector([1.0, 2.0]))
        assert len(eng) == 1
    with StorageEngine.open(tmp_path, EngineConfig(device="cpu")) as eng:
        assert eng.list_ids() == ["a"]


def test_cli_search_mode_reaches_persistent_engine(tmp_path, capsys):
    d = str(tmp_path / "db")
    assert run(capsys, "--data-dir", d, "--search-mode", "fast", "insert",
               "a", "--vector", "1.0,2.0")[0] == 0
    code, out, _ = run(capsys, "--data-dir", d, "--search-mode", "fast",
                       "search", "1.0,2.1", "-k", "1")
    assert code == 0 and "1. a" in out


def test_bf16_storage_exact_off_the_first_tier(rng):
    """bf16 storage below tier 1's gate serves from the widening scan,
    exact over the stored values (never a bf16x3 pass with an aliased lo
    mirror)."""
    from vectordb_tpu_torch.index.flat import _quantize_bf16
    n, d, k = 2048, 32, 8
    db = rng.standard_normal((n, d)).astype(np.float32)
    idx = FlatIndex(EUC, storage="bf16", device="cpu")
    idx.add_batch([(i, db[i]) for i in range(n)])
    stored = _quantize_bf16(db)
    res = idx.search_batch(db[:8], k)
    for qi in range(8):
        exact = np.linalg.norm(stored - db[qi], axis=1)
        for rid, dv in res[qi]:
            assert abs(dv - float(exact[rid])) < 2e-3
        assert abs(res[qi][-1][1] - float(np.sort(exact)[k - 1])) < 2e-3


def _intrinsic(rng, n, d, idim=8):
    basis = rng.standard_normal((idim, d)).astype(np.float32)
    return (rng.standard_normal((n, idim)).astype(np.float32) @ basis
            / np.float32(idim ** 0.5))


def test_host_backing_shared_dir_no_clobber(tmp_path):
    rng = np.random.default_rng(0)
    a = FlatIndex(EUC, host_backing=str(tmp_path), device="cpu")
    b = FlatIndex(EUC, host_backing=str(tmp_path), device="cpu")
    ra = rng.standard_normal((32, 8)).astype(np.float32)
    rb = rng.standard_normal((32, 8)).astype(np.float32) + 100.0
    for i in range(32):
        a.add(i, Vector(ra[i]))
        b.add(i, Vector(rb[i]))
    got_a, got_b = a.search(Vector(ra[7]), 1), b.search(Vector(rb[9]), 1)
    assert got_a[0][0] == 7 and got_a[0][1] < 1e-4
    assert got_b[0][0] == 9 and got_b[0][1] < 1e-4


def test_bulk_load_stream_dim_mismatch_typed_error():
    idx = FlatIndex(EUC, device="cpu")
    idx.add(0, Vector([1.0, 2.0, 3.0, 4.0]))
    idx.remove(0)
    with pytest.raises(DimensionMismatchError):
        idx.bulk_load_stream(2, 8, iter([np.zeros((2, 8), np.float32)]))


def test_engine_stale_pq_state_with_empty_store_does_not_wedge(tmp_path):
    rng = np.random.default_rng(1)
    config = EngineConfig(checkpoint_interval=10 ** 9, metric=EUC,
                          index_type="pq", device="cpu")
    db = rng.standard_normal((300, 8)).astype(np.float32)
    with StorageEngine.open(tmp_path, config) as eng:
        for i in range(300):
            eng.insert(f"v{i}", Vector(db[i]))
        eng.store.index.train()
        eng.checkpoint()
    assert (tmp_path / StorageEngine.PQ_FILE).exists()
    (tmp_path / "snapshot.bin").unlink()
    (tmp_path / "wal.log").unlink()
    with StorageEngine.open(tmp_path, config) as eng:
        assert len(eng) == 0
        eng.insert("a", Vector([1.0, 2.0, 3.0, 4.0]))
        assert eng.search(Vector([1.0, 2.0, 3.0, 4.0]), 1)[0].id == "a"


def test_pq_masked_selective_filter_exact_full_k():
    rng = np.random.default_rng(2)
    d, n, k = 16, 3000, 10
    db = _intrinsic(rng, n, d)
    idx = PqFlatIndex(EUC, m=4, ksub=16, refine=32, device="cpu")
    for i in range(n):
        idx.add(i, Vector(db[i]))
    idx.train()
    mask = np.zeros(idx.capacity, dtype=bool)
    mask[1000:1100] = True
    qs = _intrinsic(rng, 8, d)
    got = idx.search_batch(qs, k, slot_mask=mask)
    elig = db[1000:1100]
    for qi, row in enumerate(got):
        assert len(row) == k
        want_d = np.sqrt(np.einsum("nd,nd->n", elig - qs[qi],
                                   elig - qs[qi]))
        order = np.argsort(want_d, kind="stable")[:k]
        assert [i for i, _ in row] == [int(1000 + j) for j in order]
        for (_, gd), j in zip(row, order):
            assert abs(gd - float(want_d[j])) < 1e-5


def test_pq_masked_large_filter_returns_full_k():
    rng = np.random.default_rng(3)
    d, n, k = 16, 6000, 10
    db = _intrinsic(rng, n, d)
    idx = PqFlatIndex(EUC, m=4, ksub=16, refine=16, device="cpu")
    for i in range(n):
        idx.add(i, Vector(db[i]))
    idx.train()
    mask = np.zeros(idx.capacity, dtype=bool)
    mask[500:3100] = True
    got = idx.search_batch(_intrinsic(rng, 8, d), k, slot_mask=mask)
    assert all(len(row) == k for row in got)
    for row in got:
        assert all(500 <= iid < 3100 for iid, _ in row)


def test_pq_masked_large_filter_distances_exact():
    rng = np.random.default_rng(3)
    d, n, k = 16, 6000, 10
    db = _intrinsic(rng, n, d)
    idx = PqFlatIndex(EUC, m=4, ksub=16, refine=16, device="cpu")
    for i in range(n):
        idx.add(i, Vector(db[i]))
    idx.train()
    mask = np.zeros(idx.capacity, dtype=bool)
    mask[500:3100] = True
    qs = _intrinsic(rng, 8, d)
    for qi, row in enumerate(idx.search_batch(qs, k, slot_mask=mask)):
        for iid, dist in row:
            diff = db[iid] - qs[qi]
            assert abs(dist - float(np.sqrt(diff @ diff))) < 1e-5


def test_pq_encode_batch_size_invariant():
    rng = np.random.default_rng(4)
    db = _intrinsic(rng, 1024, 16)
    idx = PqFlatIndex(EUC, m=4, ksub=16, device="cpu")
    for i in range(256):
        idx.add(i, Vector(db[i]))
    idx.train()
    assert np.array_equal(idx._encode_rows(db[:3]),
                          idx._encode_rows(db)[:3])


def test_engine_insert_batch_bad_dim_logs_only_prefix(tmp_path):
    with StorageEngine.open(tmp_path, EngineConfig(device="cpu")) as eng:
        with pytest.raises(DimensionMismatchError):
            eng.insert_batch([BatchInsertItem("a", Vector([1.0, 0.0])),
                              BatchInsertItem("bad", Vector([1.0])),
                              BatchInsertItem("c", Vector([2.0, 0.0]))])
        assert eng.list_ids() == ["a"]
    with StorageEngine.open(tmp_path, EngineConfig(device="cpu")) as eng:
        assert eng.list_ids() == ["a"]
