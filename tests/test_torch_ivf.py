"""IVF-Flat in the port, on the CPU: k-means training, the balanced
repack, cluster-pruned search refined by K2's plain version, the exact
flat fallback, calibration, the engine's ``ivf_state.npz`` and the CLI,
server and store knobs.

Mirrors tests/test_ivf.py, tests/test_ivf_hier.py, the three IVF cases of
tests/test_review_regressions.py, the two IVF cases of tests/test_filters.py,
``test_radius::test_ivf_smoke``,
``test_routes::test_nprobe_on_ivf_search_and_batch`` and
``test_store::test_nprobe_reaches_ivf``, each on the port's own training.
The port's generator cannot reproduce ``jax.random``, so the scans are held
to the JAX package's on ITS trained centroids and layout, carried across by
``import_trained_state``: ids exactly on tie-free data, distances at rtol
2e-5. k-means is held on quality, and, from the same initial centroids, a
Lloyd run to the JAX package's at rtol 1e-5. ``ivf_state.npz`` is the JAX
package's bytes, and each package reopens the other's directory without
retraining. The JAX side runs as its own tests run it on the CPU (Pallas
in interpret mode, ``_EXACT1P_MIN_N`` lowered on both sides).
"""

import numpy as np
import pytest
import torch

import vectordb_tpu as J
from vectordb_tpu.index.ivf import IvfFlatIndex as JIvf
from vectordb_tpu.ops import topk as jtopk

from vectordb_tpu_torch import (BatchInsertItem, DistanceMetric, FlatIndex,
                                IvfFlatIndex, Metadata, MetadataFilter,
                                Vector, VectorStore)
from vectordb_tpu_torch import cli
from vectordb_tpu_torch.convert import ivf_store_from_reference
from vectordb_tpu_torch.errors import (DimensionMismatchError,
                                       IndexOpError, InvalidVectorError)
from vectordb_tpu_torch.index import ivf as ivf_mod
from vectordb_tpu_torch.ops import ivf as ops_ivf
from vectordb_tpu_torch.ops import topk as ttopk
from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN
METRICS = list(DistanceMetric)
STORAGES = ["f32", "bf16", "int8"]


@pytest.fixture(autouse=True)
def _tiers(monkeypatch):
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jtopk, "_EXACT1P_MIN_N", 512)
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 512)


def Ivf(metric=EUC, **kw):
    return IvfFlatIndex(metric, device="cpu", **kw)


def _clustered(rng, n, d, n_centers=32, scale=0.15):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    which = rng.integers(0, n_centers, n)
    return (centers[which]
            + scale * rng.standard_normal((n, d)).astype(np.float32))


def _np_dists(queries, db, metric):
    q, x = queries.astype(np.float64), db.astype(np.float64)
    dots = q @ x.T
    if metric is DistanceMetric.DOT_PRODUCT:
        return -dots
    if metric is DistanceMetric.EUCLIDEAN:
        sq = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2 * dots
        return np.sqrt(np.maximum(sq, 0.0))
    den = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(x, axis=1)
    return 1.0 - np.clip(dots / den, -1.0, 1.0)


def _flat_topk(queries, db, metric, k):
    return np.argsort(_np_dists(queries, db, metric), axis=1,
                      kind="stable")[:, :k]


def _ids(rows):
    return [[i for i, _ in r] for r in rows]


def _assert_same(got, want):
    """Same ids, distances at the parity suite's rtol / atol 2e-5. The
    queries of these comparisons are not near-duplicates of stored rows:
    there |q|^2 + |x|^2 - 2 q.x cancels to f32 rounding in both packages,
    each summing the dot in its own order."""
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose([d for r in got for _, d in r],
                               [d for r in want for _, d in r], rtol=2e-5,
                               atol=2e-5)


# -- tests/test_ivf.py --------------------------------------------------------

def test_train_and_recall_euclidean(rng):
    n, d, q, k = 5000, 32, 40, 10
    db = _clustered(rng, n, d)
    idx = Ivf(nlist=64, nprobe=8, seed=1)
    idx.add_batch([(i, db[i]) for i in range(n)])
    assert not idx.is_trained
    idx.train()
    assert idx.is_trained
    queries = db[rng.choice(n, q, replace=False)] + 0.01
    results = idx.search_batch(queries, k)
    want = _flat_topk(queries, db, EUC, k)
    recall = np.mean([len({i for i, _ in got} & set(w.tolist())) / k
                      for got, w in zip(results, want)])
    assert recall >= 0.9, recall
    for qi, got in enumerate(results[:5]):
        for rid, dist in got:
            ref = float(np.linalg.norm(queries[qi] - db[rid]))
            assert abs(dist - ref) < 1e-3
    for got in results:
        dd = [dv for _, dv in got]
        assert dd == sorted(dd)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_distances_per_metric(rng, metric):
    n, d, q, k = 2000, 16, 8, 5
    db = _clustered(rng, n, d, n_centers=16)
    if metric is DistanceMetric.COSINE:
        db = db + 3.0
    idx = Ivf(metric, nlist=32, nprobe=32, seed=2)    # probe all
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    queries = _clustered(rng, q, d, n_centers=4)
    if metric is DistanceMetric.COSINE:
        queries = queries + 3.0
    results = idx.search_batch(queries, k)
    want = _flat_topk(queries, db, metric, k)
    dists = _np_dists(queries, db, metric)
    for qi, got in enumerate(results):
        assert [i for i, _ in got] == [int(w) for w in want[qi]]
        np.testing.assert_allclose([dv for _, dv in got],
                                   np.sort(dists[qi])[:k], rtol=1e-4,
                                   atol=1e-4)


def test_nprobe_knob_monotone_recall(rng):
    n, d, k = 4000, 24, 10
    db = _clustered(rng, n, d)
    idx = Ivf(nlist=64, nprobe=1, seed=3)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    queries = db[:30] + 0.01
    want = _flat_topk(queries, db, EUC, k)

    def recall(npb):
        idx.nprobe = npb
        res = idx.search_batch(queries, k)
        return np.mean([len({i for i, _ in got} & set(w.tolist())) / k
                        for got, w in zip(res, want)])

    r1, r8, r64 = recall(1), recall(8), recall(64)
    assert r1 <= r8 + 0.05 and r8 <= r64 + 1e-9
    assert r64 >= 0.999


def test_crud_after_training(rng):
    n, d, k = 3000, 16, 5
    db = _clustered(rng, n, d)
    idx = Ivf(nlist=32, nprobe=8, seed=4)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    new = db[123] + 0.001
    idx.add(99999, Vector(new))
    assert idx.search(Vector(new), k)[0][0] == 99999
    moved = db[2000] + 0.001
    idx.add(99999, Vector(moved))
    assert idx.search(Vector(moved), 1)[0][0] == 99999
    assert len(idx) == n + 1
    idx.remove(99999)
    assert idx.search(Vector(moved), 1)[0][0] != 99999
    assert len(idx) == n
    idx.remove(99999)
    assert len(idx) == n


def test_spill_exhaustion_triggers_retrain(rng):
    n, d = 640, 8
    db = _clustered(rng, n, d, n_centers=8)
    idx = Ivf(nlist=8, nprobe=8, spill_frac=0.005, seed=5)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    base = db[0]
    for j in range(500):
        idx.add(10_000 + j, Vector(base + 0.001 * j))
    assert len(idx) == n + 500
    assert idx.is_trained
    got = idx.search(Vector(base), 3)
    assert got and got[0][1] < 0.1


def test_auto_train_on_search(rng):
    n, d = 4500, 12
    db = _clustered(rng, n, d)
    idx = Ivf(nlist=16, nprobe=16, auto_train_min=4096, seed=6)
    idx.add_batch([(i, db[i]) for i in range(n)])
    assert not idx.is_trained
    idx.search_batch(db[:4] + 0.01, 3)
    assert idx.is_trained


def test_untrained_small_index_is_exact_flat(rng):
    n, d, k = 300, 8, 5
    db = rng.standard_normal((n, d)).astype(np.float32)
    idx = Ivf(seed=7)
    idx.add_batch([(i, db[i]) for i in range(n)])
    res = idx.search_batch(db[:6] + 0.001, k)
    want = _flat_topk(db[:6] + 0.001, db, EUC, k)
    for got, w in zip(res, want):
        assert [i for i, _ in got] == [int(x) for x in w]


def test_store_with_ivf_and_exact_filters(rng):
    n, d, k = 3000, 16, 5
    db = _clustered(rng, n, d)
    store = VectorStore.with_index(Ivf(nlist=32, nprobe=8, seed=8))
    store.insert_batch([BatchInsertItem(f"v{i}", Vector(db[i]),
                                        Metadata({"grp": str(i % 4)}))
                        for i in range(n)])
    store.index.train()
    assert store.search(Vector(db[7] + 0.001), k)[0].id == "v7"
    flt = MetadataFilter.eq("grp", "2")
    fres = store.search_with_filter(Vector(db[6] + 0.001), k, flt)
    assert fres and all(int(r.id[1:]) % 4 == 2 for r in fres)
    pool = [i for i in range(n) if i % 4 == 2]
    d2 = np.linalg.norm(db[pool] - (db[6] + 0.001), axis=1)
    assert [int(r.id[1:]) for r in fres] == \
        [pool[j] for j in np.argsort(d2, kind="stable")[:k]]


def test_filtered_search_does_not_auto_train(rng):
    n, d, k = 4500, 12, 5
    db = _clustered(rng, n, d)
    store = VectorStore.with_index(Ivf(nlist=16, nprobe=16,
                                       auto_train_min=4096, seed=9))
    store.insert_batch([BatchInsertItem(f"v{i}", Vector(db[i]),
                                        Metadata({"grp": str(i % 3)}))
                        for i in range(n)])
    assert not store.index.is_trained
    flt = MetadataFilter.eq("grp", "1")
    fres = store.search_with_filter(Vector(db[4] + 0.001), k, flt)
    assert not store.index.is_trained
    pool = [i for i in range(n) if i % 3 == 1]
    d2 = np.linalg.norm(db[pool] - (db[4] + 0.001), axis=1)
    want = [pool[j] for j in np.argsort(d2, kind="stable")[:k]]
    assert [int(r.id[1:]) for r in fres] == want
    store.index.train()
    fres2 = store.search_with_filter(Vector(db[4] + 0.001), k, flt)
    assert [int(r.id[1:]) for r in fres2] == want


def test_k_larger_than_candidate_pool_falls_back_exact(rng):
    n, d = 2000, 16
    db = _clustered(rng, n, d, n_centers=16)
    idx = Ivf(nlist=32, nprobe=1, seed=10)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    k = idx._t_c * 16 + 50
    res = idx.search_batch(db[:3] + 0.001, k)
    want = _flat_topk(db[:3] + 0.001, db, EUC, k)
    for got, w in zip(res, want):
        assert [i for i, _ in got] == [int(x) for x in w]
    assert idx.search_with_nprobe(Vector(db[0]), 3, 0)


def test_cosine_zero_vector_raises_after_training(rng):
    n, d = 2000, 8
    db = _clustered(rng, n, d) + 3.0
    idx = Ivf(DistanceMetric.COSINE, nlist=16, nprobe=4, seed=11)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    with pytest.raises(InvalidVectorError):
        idx.search_batch(np.zeros((1, d), np.float32), 3)


def test_bulk_load_applies_prefix_on_dimension_error(rng):
    idx = Ivf()
    good = rng.standard_normal((5, 8)).astype(np.float32)
    bad = rng.standard_normal(4).astype(np.float32)
    with pytest.raises(DimensionMismatchError):
        idx.add_batch([(0, good[0]), (1, good[1]), (2, bad), (3, good[3])])
    assert len(idx) == 2
    assert idx.get_vector(1) is not None and idx.get_vector(2) is None


def test_engine_ivf_mode_roundtrip(rng, tmp_path):
    cfg = EngineConfig(checkpoint_interval=100, metric=EUC,
                       index_type="ivf", device="cpu")
    db = _clustered(rng, 300, 8)
    with StorageEngine.open(tmp_path, cfg) as eng:
        for i in range(300):
            eng.insert(f"v{i}", Vector(db[i]))
        assert eng.search(Vector(db[5] + 0.001), 3)[0].id == "v5"
    with StorageEngine.open(tmp_path, cfg) as eng:
        assert len(eng) == 300
        assert eng.search(Vector(db[5] + 0.001), 3)[0].id == "v5"
        eng.store.index.train()
        assert eng.search(Vector(db[7] + 0.001), 1)[0].id == "v7"


def test_cli_index_ivf(tmp_path, capsys):
    d = str(tmp_path / "data")
    assert cli.main(["--device", "cpu", "--index", "ivf", "--data-dir", d,
                     "insert", "a", "--vector", "1,2,3"]) == 0
    assert cli.main(["--device", "cpu", "--index", "ivf", "--data-dir", d,
                     "search", "1,2,3", "-k", "1", "--nprobe", "2"]) == 0
    assert "1. a (distance: 0.0000)" in capsys.readouterr().out


def test_concurrent_search_during_train(rng):
    import threading
    n, d, k = 4000, 16, 5
    db = _clustered(rng, n, d)
    idx = Ivf(nlist=32, nprobe=32, seed=12)
    idx.add_batch([(i, db[i]) for i in range(n)])
    queries = db[:8] + 0.001
    want = [int(w) for w in _flat_topk(queries, db, EUC, 1)[:, 0]]
    errors = []
    stop = threading.Event()

    def searcher():
        while not stop.is_set():
            try:
                got = [row[0][0] for row in idx.search_batch(queries, k)]
                if got != want:
                    errors.append(("mismatch", got))
            except Exception as e:   # pragma: no cover
                errors.append(("raised", repr(e)))

    threads = [threading.Thread(target=searcher) for _ in range(3)]
    for t in threads:
        t.start()
    idx.train()
    idx.train()
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors[:3]


def test_huge_nprobe_falls_back_to_exact_scan(rng, monkeypatch):
    n, d, k = 3000, 16, 5
    db = _clustered(rng, n, d)
    idx = Ivf(nlist=32, seed=13)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    monkeypatch.setattr(ivf_mod, "_MAX_CANDIDATES", 256)
    res = idx.search_batch(db[:3] + 0.001, k, nprobe=32)
    want = _flat_topk(db[:3] + 0.001, db, EUC, k)
    for got, w in zip(res, want):
        assert [i for i, _ in got] == [int(x) for x in w]


def test_engine_ivf_trained_state_persists(rng, tmp_path, monkeypatch):
    cfg = EngineConfig(checkpoint_interval=10 ** 9, metric=EUC,
                       index_type="ivf", device="cpu")
    n, d, k = 400, 8, 5
    db = _clustered(rng, n, d, n_centers=8)
    queries = db[rng.choice(n, 10, replace=False)] + 0.01
    with StorageEngine.open(tmp_path, cfg) as eng:
        for i in range(n):
            eng.insert(f"v{i}", Vector(db[i]))
        eng.store.index.train()
        before = [[(r.id, r.distance) for r in eng.search(Vector(q), k)]
                  for q in queries]
        cent_before = eng.store.index._centroids.copy()
        slots_before = eng.store.index._id_of_slot.copy()
        eng.checkpoint()

    def boom(self):
        raise AssertionError("reopen must not retrain")

    monkeypatch.setattr(IvfFlatIndex, "train", boom)
    with StorageEngine.open(tmp_path, cfg) as eng:
        idx = eng.store.index
        assert idx.is_trained
        np.testing.assert_array_equal(idx._centroids, cent_before)
        np.testing.assert_array_equal(idx._id_of_slot, slots_before)
        after = [[(r.id, r.distance) for r in eng.search(Vector(q), k)]
                 for q in queries]
        # single inserts (np.dot norms, as the import computes them):
        # the same ids in the same order and the same distances
        assert after == before
        eng.insert("new", Vector(db[0] * 0.5))
        assert eng.search(Vector(db[0] * 0.5), 1)[0].id == "new"
        eng.delete("new")


def test_engine_ivf_batch_loaded_reopens_within_ulps(rng, tmp_path,
                                                    monkeypatch):
    """A store loaded by insert_batch (the WAL's group commit: einsum
    norms) reopens from ivf_state.npz (np.dot norms, as the JAX package
    recomputes them) with the writer's ids and its distances within f32
    ulps of |x|^2 (ROADMAP queue 3: shared with the JAX package)."""
    cfg = EngineConfig(checkpoint_interval=10 ** 9, metric=EUC,
                       index_type="ivf", device="cpu")
    db = _clustered(rng, 600, 8, n_centers=8)
    queries = rng.standard_normal((12, 8)).astype(np.float32)
    with StorageEngine.open(tmp_path, cfg) as eng:
        eng.insert_batch([BatchInsertItem(f"v{i}", Vector(db[i]))
                          for i in range(600)])
        eng.store.index.train()
        before = [[(r.id, r.distance) for r in eng.search(Vector(q), 5,
                                                          nprobe=3)]
                  for q in queries]
        eng.checkpoint()
    monkeypatch.setattr(IvfFlatIndex, "train", lambda self: 1 / 0)
    with StorageEngine.open(tmp_path, cfg) as eng:
        after = [[(r.id, r.distance) for r in eng.search(Vector(q), 5,
                                                         nprobe=3)]
                 for q in queries]
    assert [[i for i, _ in r] for r in after] == \
        [[i for i, _ in r] for r in before]
    sq = float(np.max(np.einsum("ij,ij->i", db, db)))
    moved = [abs(a[1] ** 2 - b[1] ** 2) for ra, rb in zip(after, before)
             for a, b in zip(ra, rb)]
    assert max(moved) <= 4 * 8 * 2.0 ** -24 * sq


def test_engine_ivf_stale_state_falls_back(rng, tmp_path):
    cfg = EngineConfig(checkpoint_interval=10 ** 9, metric=EUC,
                       index_type="ivf", device="cpu")
    db = _clustered(rng, 200, 8, n_centers=4)
    with StorageEngine.open(tmp_path, cfg) as eng:
        for i in range(200):
            eng.insert(f"v{i}", Vector(db[i]))
        eng.store.index.train()
        eng.checkpoint()
    state_path = tmp_path / StorageEngine.IVF_FILE
    raw = bytearray(state_path.read_bytes())
    raw[-1] ^= 0xFF
    state_path.write_bytes(bytes(raw))
    with StorageEngine.open(tmp_path, cfg) as eng:
        assert len(eng) == 200
        assert eng.search(Vector(db[3] + 0.001), 1)[0].id == "v3"


def test_ivf_bf16_storage_composes(rng):
    idx = Ivf(nlist=4, nprobe=4, seed=0, auto_train_min=10 ** 9,
              storage="bf16")
    data = rng.standard_normal((300, 16)).astype(np.float32)
    idx.add_batch(list(enumerate(data)))
    idx.train()
    assert idx._vectors.dtype == np.float32        # f32 host rows
    assert idx._sync_device()["db"].dtype == torch.bfloat16
    queries = data[:8] + np.float32(0.01)
    got = idx.search_batch(queries, 5)
    want = FlatIndex.search_batch(idx, queries, 5)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([d for _, d in g], [d for _, d in w],
                                   rtol=1e-3, atol=1e-4)


def test_ivf_int8_storage_composes(rng):
    from vectordb_tpu_torch.index.flat import _quantize_int8
    idx = Ivf(nlist=4, nprobe=4, seed=0, auto_train_min=10 ** 9,
              storage="int8")
    data = rng.standard_normal((300, 16)).astype(np.float32) * \
        np.exp(rng.uniform(-4, 4, (300, 1))).astype(np.float32)
    idx.add_batch(list(enumerate(data)))
    idx.train()
    dev = idx._sync_device()
    assert dev["db"].dtype == torch.int8 and "scales" in dev
    queries = data[:8] + np.float32(0.01)
    got = idx.search_batch(queries, 5)
    want = FlatIndex.search_batch(idx, queries, 5)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([d for _, d in g], [d for _, d in w],
                                   rtol=2e-3, atol=5e-3)
    new = rng.standard_normal(16).astype(np.float32)
    idx.add(7777, new)
    assert idx.search_batch(np.asarray([_quantize_int8(new)]),
                            1)[0][0][0] == 7777


def test_ivf_int8_hier_assignment(rng):
    idx = Ivf(nlist=32, nprobe=32, seed=1, auto_train_min=10 ** 9,
              storage="int8", assign_mode="hier")
    data = rng.standard_normal((600, 12)).astype(np.float32) * \
        np.exp(rng.uniform(-5, 5, (600, 1))).astype(np.float32)
    idx.add_batch(list(enumerate(data)))
    idx.train()
    queries = data[:6] + np.float32(0.001)
    got = idx.search_batch(queries, 3)
    want = FlatIndex.search_batch(idx, queries, 3)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]


def test_ivf_int8_masked_search_exact(rng):
    idx = Ivf(nlist=8, nprobe=8, seed=2, auto_train_min=10 ** 9,
              storage="int8")
    data = rng.standard_normal((400, 16)).astype(np.float32)
    idx.add_batch(list(enumerate(data)))
    idx.train()
    mask = np.zeros(idx.capacity, bool)
    for iid in range(0, 400, 2):
        mask[idx.slot_of(iid)] = True
    queries = data[:5] + np.float32(0.01)
    got = idx.search_batch(queries, 6, slot_mask=mask,
                           mask_layout_version=idx.slot_layout_version)
    stored = np.stack([idx.get_vector(i).as_array() for i in range(400)])
    d = _np_dists(queries, stored, EUC)
    d[:, 1::2] = np.inf
    want = np.argsort(d, axis=1, kind="stable")[:, :6]
    for qi in range(5):
        ids = [i for i, _ in got[qi]]
        assert all(i % 2 == 0 for i in ids)
        assert ids == list(want[qi])


class TestCalibrateNprobe:
    def test_meets_target_and_sets_default(self, rng):
        db = _clustered(rng, 4000, 32)
        idx = Ivf(nlist=32, nprobe=1, seed=4)
        idx.add_batch([(i, db[i]) for i in range(4000)])
        idx.train()
        out = idx.calibrate_nprobe(0.95, k=10, sample=64)
        assert out["recall"] >= 0.95
        assert idx.nprobe == out["nprobe"]
        assert out["nprobe"] in out["curve"]
        tried = sorted(out["curve"])
        vals = [out["curve"][t] for t in tried]
        assert all(b >= a - 0.05 for a, b in zip(vals, vals[1:]))

    def test_external_queries_and_no_default(self, rng):
        db = _clustered(rng, 4000, 16)
        idx = Ivf(nlist=16, seed=4)
        idx.add_batch([(i, db[i]) for i in range(4000)])
        idx.train()
        before = idx.nprobe
        qs = db[rng.choice(4000, 32, replace=False)] + 0.02
        out = idx.calibrate_nprobe(0.9, queries=qs, set_default=False)
        assert idx.nprobe == before
        assert 0.0 <= out["recall"] <= 1.0

    def test_untrained_too_small_raises(self):
        idx = Ivf(nlist=8)
        idx.add_batch([(i, np.ones(4, np.float32) * i) for i in range(8)])
        with pytest.raises(IndexOpError):
            idx.calibrate_nprobe(0.9)

    def test_untrained_enough_rows_trains(self, rng):
        db = _clustered(rng, 600, 8, n_centers=8)
        idx = Ivf(nlist=8, seed=1)
        idx.add_batch([(i, db[i]) for i in range(600)])
        assert not idx.is_trained
        out = idx.calibrate_nprobe(0.5, k=5, sample=32)
        assert idx.is_trained and out["nprobe"] >= 1

    def test_bad_target_raises(self):
        with pytest.raises(IndexOpError):
            Ivf(nlist=8).calibrate_nprobe(1.5)

    def test_same_curve_as_the_jax_package_on_its_layout(self, rng):
        """On the JAX package's trained layout, the same sample gives the
        same recall curve and the same choice."""
        db = _clustered(rng, 3000, 16)
        j = JIvf(J.DistanceMetric.EUCLIDEAN, nlist=32, nprobe=1, seed=4)
        j.add_batch([(i, db[i]) for i in range(3000)])
        j.train()
        t = _import_jax_layout(j, EUC, nprobe=1)
        qs = db[rng.choice(3000, 48, replace=False)] + 0.02
        want = j.calibrate_nprobe(0.97, queries=qs)
        got = t.calibrate_nprobe(0.97, queries=qs)
        assert got == want


class TestBalancedKmeans:
    def test_penalty_changes_centroids(self, rng):
        data = torch.from_numpy(_clustered(rng, 4096, 32, n_centers=16,
                                           scale=0.2))
        a = ops_ivf.kmeans_fit(data, 0, 64, 10, balance_weight=0.0)
        b = ops_ivf.kmeans_fit(data, 0, 64, 10, balance_weight=0.1)
        assert not torch.equal(a, b)

    def test_weight_zero_matches_legacy(self, rng):
        data = torch.from_numpy(_clustered(rng, 1024, 16, n_centers=8))
        a = ops_ivf.kmeans_fit(data, 3, 16, 5)
        b = ops_ivf.kmeans_fit(data, 3, 16, 5, balance_weight=0.0)
        assert torch.equal(a, b)

    def test_index_recall_holds_with_balance(self, rng):
        n, d, k = 6000, 24, 10
        db = _clustered(rng, n, d, n_centers=12)
        queries = db[rng.choice(n, 64, replace=False)] \
            + 0.01 * rng.standard_normal((64, d)).astype(np.float32)
        want = _flat_topk(queries, db, EUC, k)
        idx = Ivf(nlist=32, nprobe=8, seed=0, kmeans_balance=0.1)
        idx.add_batch([(i, db[i]) for i in range(n)])
        idx.train()
        got = idx.search_batch(queries, k)
        recall = np.mean([len(set(i for i, _ in g) & set(w.tolist())) / k
                          for g, w in zip(got, want)])
        assert recall >= 0.9

    def test_negative_weight_rejected(self):
        with pytest.raises(ValueError):
            Ivf(kmeans_balance=-0.1)


# -- tests/test_ivf_hier.py ---------------------------------------------------

def _hier_fixture(n=6000, d=32, nlist=128, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    data = (centers[rng.integers(0, 64, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    db = torch.from_numpy(data)
    return data, db, ops_ivf.kmeans_fit(db, seed, nlist, 8)


def test_hier_matches_flat_top1():
    data, db, cents = _hier_fixture()
    flat = ops_ivf.assign_preferences(db, cents, 8, 4096)
    hier = ops_ivf.assign_preferences_hier(db, cents, 8, 4096, 7,
                                           n_super=16, s_top=6)
    assert float(np.mean(flat[:, 0] == hier[:, 0])) >= 0.95
    for row in hier[:: len(hier) // 50]:
        assert np.unique(row).size == row.size


def test_hier_small_nlist_falls_back():
    data, db, cents = _hier_fixture(nlist=16)
    np.testing.assert_array_equal(
        ops_ivf.assign_preferences_hier(db, cents, 4, 4096, 7, n_super=16),
        ops_ivf.assign_preferences(db, cents, 4, 4096))


@pytest.mark.parametrize("mode", ["flat", "hier"])
def test_train_recall_by_mode(mode):
    rng = np.random.default_rng(3)
    n, d, k = 8000, 48, 10
    centers = rng.standard_normal((32, d)).astype(np.float32)
    data = (centers[rng.integers(0, 32, n)]
            + 0.25 * rng.standard_normal((n, d)).astype(np.float32))
    idx = Ivf(nlist=64, nprobe=8, assign_mode=mode, seed=1)
    idx.add_batch(list(enumerate(data)))
    idx.train()
    queries = (centers[rng.integers(0, 32, 30)]
               + 0.25 * rng.standard_normal((30, d)).astype(np.float32))
    oracle = FlatIndex(EUC, device="cpu")
    oracle.add_batch(list(enumerate(data)))
    truth = oracle.search_batch(queries, k)
    got = idx.search_batch(queries, k)
    rec = np.mean([len({i for i, _ in got[q]} & {i for i, _ in truth[q]})
                   / k for q in range(len(queries))])
    assert rec >= 0.95, (mode, rec)
    for q in range(3):
        od = dict(truth[q])
        for i, dv in got[q]:
            if i in od:
                assert abs(od[i] - dv) < 1e-3


def test_invalid_assign_mode():
    with pytest.raises(ValueError):
        Ivf(assign_mode="bogus")


def test_hier_empty_neighborhood_falls_back_flat(monkeypatch):
    d, nlist = 8, 64
    rng = np.random.default_rng(5)
    cents = torch.from_numpy(
        10.0 + 0.1 * rng.standard_normal((nlist, d)).astype(np.float32))
    db = torch.from_numpy(0.1 * rng.standard_normal((256, d)).astype(
        np.float32))

    def fake_kmeans_fit(points, key, k, iters):
        sup = points[:k].clone()
        sup[0] = 0.0
        return sup

    monkeypatch.setattr(ops_ivf, "kmeans_fit", fake_kmeans_fit)
    np.testing.assert_array_equal(
        ops_ivf.assign_preferences_hier(db, cents, 4, 4096, 1, n_super=16,
                                        s_top=1),
        ops_ivf.assign_preferences(db, cents, 4, 4096))


# -- tests/test_review_regressions.py -----------------------------------------

def test_ivf_trained_add_batch_routes_through_clusters(rng):
    n, d = 800, 16
    db = rng.standard_normal((n, d)).astype(np.float32)
    idx = Ivf(nlist=8, nprobe=8, seed=3)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    cap_before = idx.capacity
    new = rng.standard_normal((16, d)).astype(np.float32)
    idx.add_batch([(n + i, new[i]) for i in range(16)])
    assert idx.capacity == cap_before
    assert [r[0][0] for r in idx.search_batch(new, 1)] == \
        [n + i for i in range(16)]
    for i in range(16):
        idx.remove(n + i)
    assert len(idx) == n


def test_filtered_search_survives_concurrent_retrain(rng, monkeypatch):
    from vectordb_tpu_torch.metadata import ColumnarMetadata
    n, d, k = 600, 8, 5
    db = rng.standard_normal((n, d)).astype(np.float32)
    store = VectorStore.with_index(Ivf(nlist=4, nprobe=4,
                                       auto_train_min=10 ** 9, seed=2))
    for i in range(n):
        store.insert_with_metadata(
            f"v{i}", Vector(db[i]),
            Metadata({"group": "a" if i % 3 == 0 else "b"}))
    store.index.train()
    ver0 = store.index.slot_layout_version
    calls = {"n": 0}
    orig = ColumnarMetadata.compile_mask

    def train_after_compiling(self, filt):
        mask = orig(self, filt)
        if calls["n"] < 2:
            calls["n"] += 1
            store.index.train()
        return mask

    monkeypatch.setattr(ColumnarMetadata, "compile_mask",
                        train_after_compiling)
    filt = MetadataFilter.from_dict({"op": "eq", "field": "group",
                                     "value": "a"})
    res = store.search_with_filter(Vector(db[0]), k, filt)
    assert store.index.slot_layout_version >= ver0 + 2
    assert calls["n"] == 2
    ids_a = np.array([i for i in range(n) if i % 3 == 0])
    exact = np.linalg.norm(db[ids_a] - db[0], axis=1)
    want = [f"v{ids_a[j]}" for j in np.argsort(exact, kind="stable")[:k]]
    assert [r.id for r in res] == want
    calls["n"] = 0
    bres = store.search_batch_with_filter([(Vector(db[0]), k)], filt)
    assert [r.id for r in bres[0]] == want


def test_ivf_probed_path_honors_any_k_with_sparse_clusters(rng):
    d = 8
    blob0 = rng.standard_normal((40, d)).astype(np.float32) * 0.05
    blob1 = (rng.standard_normal((472, d)).astype(np.float32) * 0.05
             + np.float32(10.0))
    db = np.concatenate([blob0, blob1])
    idx = Ivf(nlist=2, nprobe=1, auto_train_min=10 ** 9, seed=4)
    idx.add_batch([(i, db[i]) for i in range(len(db))])
    idx.train()
    for i in range(35):
        idx.remove(i)
    res = idx.search_batch(np.zeros((1, d), np.float32), 20)
    assert len(res[0]) == 20
    dd = [dv for _, dv in res[0]]
    assert dd == sorted(dd)
    assert {rid for rid, _ in res[0][:5]} == set(range(35, 40))


# -- tests/test_filters.py, test_radius.py, test_routes.py, test_store.py ------

def _meta(**kw):
    return Metadata({k: str(v) for k, v in kw.items()})


def test_ivf_probed_masked_exact(rng):
    """On the JAX package's trained layout (its recall floor at nprobe 4
    is a property of its clusters): exact at full probe, eligible-only and
    the JAX package's answers at partial probe."""
    data = rng.standard_normal((600, 8)).astype(np.float32)
    j = JIvf(J.DistanceMetric.EUCLIDEAN, nlist=8, nprobe=8, seed=0,
             auto_train_min=10 ** 9)
    js = J.VectorStore.with_index(j)
    for i in range(600):
        js.insert_with_metadata(f"v{i}", J.Vector(data[i]),
                                J.Metadata({"par": str(i % 2)}))
    j.train()
    state = j.export_trained_state()
    rows = {int(i): j.get_vector(int(i)).as_array()
            for i in state["id_of_slot"][state["id_of_slot"] >= 0]}
    store = ivf_store_from_reference(
        state, rows, js.internal_to_string_ids(), EUC, device="cpu",
        metadata={i: {"par": str(i % 2)} for i in range(600)}, nprobe=8)
    idx = store.index
    flt = MetadataFilter.eq("par", "0")
    elig = [i for i in range(600) if i % 2 == 0]
    for qi in (3, 44, 101):
        d2 = np.sum((data[elig] - data[qi]) ** 2, axis=1)
        want = [f"v{elig[j]}" for j in np.argsort(d2)[:5]]
        assert [r.id for r in store.search_with_filter(
            Vector(data[qi]), 5, flt)] == want
    idx.nprobe = j.nprobe = 4
    hits = 0
    for qi in (3, 44, 101):
        d2 = np.sum((data[elig] - data[qi]) ** 2, axis=1)
        want = {f"v{elig[j]}" for j in np.argsort(d2)[:5]}
        got = store.search_with_filter(Vector(data[qi]), 5, flt)
        assert all(int(r.id[1:]) % 2 == 0 for r in got)
        assert [r.id for r in got] == [r.id for r in js.search_with_filter(
            J.Vector(data[qi]), 5, J.MetadataFilter.eq("par", "0"))]
        hits += len({r.id for r in got} & want)
    assert hits >= 12


def test_ivf_masked_shortfall_falls_back_exact(rng):
    idx = Ivf(nlist=8, nprobe=1, seed=0, auto_train_min=10 ** 9)
    store = VectorStore.with_index(idx)
    data = rng.standard_normal((500, 8)).astype(np.float32)
    rare = {11, 222, 444}
    for i in range(500):
        store.insert_with_metadata(
            f"v{i}", Vector(data[i]),
            _meta(tag="rare" if i in rare else "common"))
    idx.train()
    got = store.search_with_filter(Vector(data[0]), 5,
                                   MetadataFilter.eq("tag", "rare"))
    assert {r.id for r in got} == {f"v{i}" for i in rare}


def test_ivf_radius_smoke():
    store = VectorStore(Ivf())
    store.insert_batch([
        BatchInsertItem(id=f"v{i}", vector=Vector([float(i), 0.0]),
                        metadata=Metadata({"parity": str(i % 2)}))
        for i in range(5)])
    hits = store.search_radius(Vector([0.0, 0.0]), 2.5)
    assert [h.id for h in hits] == ["v0", "v1", "v2"]


def _ivf_api():
    from vectordb_tpu_torch.server.app import AppState
    from vectordb_tpu_torch.server.routes import Api
    idx = Ivf(nlist=4, auto_train_min=10 ** 9)
    api = Api(AppState(VectorStore(idx)))
    rng = np.random.default_rng(0)
    items = [{"id": f"v{i}", "vector": [float(x) for x in row]}
             for i, row in enumerate(
                 rng.standard_normal((64, 8)).astype("float32"))]
    status, _ = api.handle("POST", "/vectors/batch", {"vectors": items})
    assert status == 201
    idx.train()
    return api, items


def test_nprobe_on_ivf_search_and_batch():
    api, items = _ivf_api()
    q = items[5]["vector"]
    status, payload = api.handle("POST", "/search",
                                 {"vector": q, "k": 1, "nprobe": 4})
    assert status == 200 and payload[0]["id"] == "v5"
    status, payload = api.handle("POST", "/search/batch", {
        "queries": [{"vector": q, "k": 1}], "nprobe": 2})
    assert status == 200 and payload[0][0]["id"] == "v5"


def test_nprobe_composes_with_filter_on_routes():
    api, items = _ivf_api()
    for i, item in enumerate(items):
        assert api.handle("POST", "/vectors", {
            **item, "metadata": {"par": str(i % 2)}})[0] == 201
    flt = {"op": "eq", "field": "par", "value": "0"}
    status, payload = api.handle("POST", "/search", {
        "vector": items[6]["vector"], "k": 3, "nprobe": 4, "filter": flt})
    assert status == 200 and payload[0]["id"] == "v6"
    assert all(int(h["id"][1:]) % 2 == 0 for h in payload)


def test_nprobe_reaches_ivf(monkeypatch):
    idx = Ivf(nlist=4, auto_train_min=10 ** 9)
    store = VectorStore(idx)
    rows = np.random.default_rng(1).standard_normal((64, 8)).astype(
        np.float32)
    store.insert_batch([BatchInsertItem(id=f"v{i}", vector=Vector(rows[i]))
                        for i in range(len(rows))])
    idx.train()
    seen = []
    real = IvfFlatIndex.search_batch

    def spy(self, queries, k, slot_mask=None, nprobe=None,
            mask_layout_version=None):
        seen.append(nprobe)
        return real(self, queries, k, slot_mask, nprobe,
                    mask_layout_version)

    monkeypatch.setattr(IvfFlatIndex, "search_batch", spy)
    assert store.search(Vector(rows[9]), 1, nprobe=4)[0].id == "v9"
    batch = store.search_batch([(Vector(rows[9]), 1),
                                (Vector(rows[3]), 2)], nprobe=3)
    assert batch[0][0].id == "v9" and batch[1][0].id == "v3"
    assert len(batch[1]) == 2
    assert 4 in seen and 3 in seen


def test_nprobe_over_the_native_front_end(rng):
    """The nprobe knob reaches the index through the native front end's
    grouped submit as it does through the routes."""
    import json
    import threading
    import urllib.request

    from vectordb_tpu_torch.server.app import AppState, serve
    idx = Ivf(nlist=8, nprobe=1, auto_train_min=10 ** 9, seed=3)
    store = VectorStore(idx)
    data = _clustered(rng, 800, 8, n_centers=8)
    store.insert_batch([BatchInsertItem(f"v{i}", Vector(data[i]))
                        for i in range(800)])
    idx.train()
    state = AppState(store)
    ready = threading.Event()
    t = threading.Thread(target=serve, args=("127.0.0.1:0", state),
                         kwargs={"ready_event": ready, "backend": "native"},
                         daemon=True)
    t.start()
    assert ready.wait(60)
    try:
        port = state.server.port

        def post(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        q = (data[11] + 0.01).tolist()
        for npb in (1, 8):
            want = [r.id for r in store.search(Vector(q), 5, nprobe=npb)]
            assert [h["id"] for h in post("/search", {
                "vector": q, "k": 5, "nprobe": npb})] == want
            got = post("/search/batch", {"queries": [{"vector": q, "k": 5}],
                                         "nprobe": npb})
            assert [h["id"] for h in got[0]] == want
    finally:
        state.server.shutdown()
        t.join(timeout=30)


# -- the port against the JAX package, on ITS trained state -------------------

def _import_jax_layout(j, metric, storage="f32", nprobe=8):
    state = j.export_trained_state()
    rows = {int(i): np.asarray(j.get_vector(int(i)).as_array(), np.float32)
            for i in state["id_of_slot"][state["id_of_slot"] >= 0]}
    t = Ivf(metric, nprobe=nprobe, storage=storage)
    t.import_trained_state(state, rows, len(next(iter(rows.values()))))
    return t


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_scans_equal_the_jax_packages_on_its_layout(metric, storage):
    rng = np.random.default_rng(1)
    n, d = 3000, 32
    data = (rng.standard_normal((n, d))
            + 3 * rng.standard_normal((n, 1))).astype(np.float32)
    j = JIvf(J.DistanceMetric(metric.value), nlist=32, nprobe=4,
             storage=storage, seed=1)
    j.add_batch([(i, data[i]) for i in range(n)])
    j.train()
    for i in range(0, n, 37):          # deletes: dead slots in clusters
        j.remove(i)
    t = _import_jax_layout(j, metric, storage, nprobe=4)
    queries = rng.standard_normal((40, d)).astype(np.float32)
    for npb in (1, 4, 32):
        _assert_same(t.search_batch(queries, 10, nprobe=npb),
                     j.search_batch(queries, 10, nprobe=npb))
    mask = rng.random(t.capacity) < 0.5
    _assert_same(t.search_batch(queries, 7, slot_mask=mask, nprobe=2),
                 j.search_batch(queries, 7, slot_mask=mask, nprobe=2))
    # the exact flat path over the same layout
    _assert_same(FlatIndex.search_batch(t, queries, 10),
                 J.FlatIndex.search_batch(j, queries, 10))


def test_ivf_store_from_reference_carries_the_store():
    rng = np.random.default_rng(8)
    data = rng.standard_normal((1500, 16)).astype(np.float32)
    js = J.VectorStore.with_index(JIvf(J.DistanceMetric.EUCLIDEAN, nlist=16,
                                       nprobe=2, seed=8))
    js.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]))
                     for i in range(1500)])
    js.index.train()
    state = js.index.export_trained_state()
    rows = {int(i): js.index.get_vector(int(i)).as_array()
            for i in state["id_of_slot"][state["id_of_slot"] >= 0]}
    ts = ivf_store_from_reference(state, rows, js.internal_to_string_ids(),
                                  EUC, device="cpu", nprobe=2)
    qs = rng.standard_normal((16, 16)).astype(np.float32)
    queries = [(Vector(q), 5) for q in qs]
    jq = [(J.Vector(q), 5) for q in qs]
    for npb in (1, 2, 16):
        got = ts.search_batch(queries, nprobe=npb)
        want = js.search_batch(jq, nprobe=npb)
        _assert_same([[(r.id, r.distance) for r in row] for row in got],
                     [[(r.id, r.distance) for r in row] for row in want])


def test_lloyd_equals_the_jax_packages_from_the_same_start(rng):
    """From the same initial centroids (the JAX package's draw), Lloyd's
    iterations agree at rtol 1e-5, with and without the size penalty."""
    import jax

    from vectordb_tpu.ops.ivf import kmeans_fit as jfit
    data = _clustered(rng, 3000, 16, n_centers=12, scale=0.3)
    key = jax.random.PRNGKey(5)
    init_idx = np.asarray(jax.random.choice(key, 3000, shape=(24,),
                                            replace=False))
    for iters, bw in ((1, 0.0), (4, 0.0), (3, 0.1)):
        want = np.asarray(jfit(data, key, 24, iters, balance_weight=bw))
        got = ops_ivf.kmeans_fit(torch.from_numpy(data), None, 24, iters,
                                 balance_weight=bw,
                                 init=data[init_idx]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_kmeans_quality(rng):
    """The port's own training (its generator, not JAX's) reaches the JAX
    package's clustering quality: inertia within 5% on the same data."""
    import jax

    from vectordb_tpu.ops.ivf import kmeans_fit as jfit

    def inertia(c):
        d = _np_dists(data, c, EUC)
        return float((d.min(axis=1) ** 2).mean())

    data = _clustered(rng, 4000, 16, n_centers=16, scale=0.3)
    want = inertia(np.asarray(jfit(data, jax.random.PRNGKey(0), 32, 10)))
    got = inertia(ops_ivf.kmeans_fit(torch.from_numpy(data), 0, 32,
                                     10).numpy())
    assert got <= 1.05 * want


def test_preferences_equal_the_jax_packages():
    """Flat and hierarchical preference lists on the same centroids (the
    hierarchy's supers given to both), slot for slot."""
    import jax.numpy as jnp

    import vectordb_tpu.ops.ivf as jops
    data, db, cents = _hier_fixture(n=3000, nlist=128)
    cents_np = cents.numpy()
    flat_j = np.asarray(jops.assign_preferences(jnp.asarray(data),
                                                jnp.asarray(cents_np), 8,
                                                1024))
    np.testing.assert_array_equal(
        ops_ivf.assign_preferences(db, cents, 8, 1024), flat_j)
    supers = cents_np[::8][:16].copy()
    orig_j, orig_t = jops.kmeans_fit, ops_ivf.kmeans_fit
    try:
        jops.kmeans_fit = lambda *a, **k: jnp.asarray(supers)
        ops_ivf.kmeans_fit = lambda *a, **k: torch.from_numpy(supers)
        hj = np.asarray(jops.assign_preferences_hier(
            jnp.asarray(data), jnp.asarray(cents_np), 8, 1024, None,
            n_super=16, s_top=4))
        ht = ops_ivf.assign_preferences_hier(db, cents, 8, 1024, None,
                                             n_super=16, s_top=4)
    finally:
        jops.kmeans_fit, ops_ivf.kmeans_fit = orig_j, orig_t
    np.testing.assert_array_equal(ht, hj)


def test_constants_are_the_jax_packages():
    import vectordb_tpu.index.ivf as jmod
    import vectordb_tpu.ops.ivf as jops
    for name in ("SUB", "_MAX_CANDIDATES", "_TRAIN_SAMPLE_MAX",
                 "_BALANCE_SLACK", "_CANDIDATE_CLUSTERS"):
        assert getattr(ivf_mod, name) == getattr(jmod, name), name
    assert IvfFlatIndex._HIER_AUTO_NLIST == JIvf._HIER_AUTO_NLIST
    for name in ("_REFINE_BYTES", "_HIER_N_SUPER", "_HIER_S_TOP"):
        assert getattr(ops_ivf, name) == getattr(jops, name), name
    assert Ivf()._auto_nlist(1 << 20) == JIvf(
        J.DistanceMetric.EUCLIDEAN)._auto_nlist(1 << 20) == 8192


def test_probed_refine_runs_k2(rng, monkeypatch):
    """The probed refine goes through coarse_kernel._refine_dots (K2),
    once per query chunk, with tile indices probe * t_c + offset."""
    from vectordb_tpu_torch.ops import coarse_kernel
    calls = []
    real = coarse_kernel._refine_dots

    def spy(tile_idx, queries, db, m, scales=None):
        calls.append((tuple(tile_idx.shape), m, scales is not None))
        return real(tile_idx, queries, db, m, scales)

    monkeypatch.setattr(coarse_kernel, "_refine_dots", spy)
    idx = Ivf(nlist=8, nprobe=3, storage="int8", auto_train_min=10 ** 9)
    data = _clustered(rng, 500, 8, n_centers=8)
    idx.add_batch(list(enumerate(data)))
    idx.train()
    idx.search_batch(data[:5], 4)
    assert calls == [((5, 3 * idx._t_c), 3 * idx._t_c, True)]
    monkeypatch.setattr(ops_ivf, "_REFINE_BYTES", 1)
    calls.clear()
    idx.search_batch(np.repeat(data[:1], 130, axis=0), 4)
    assert [c[0][0] for c in calls] == [32, 32, 32, 32, 2]


# -- ivf_state.npz: the JAX package's bytes, read by both ---------------------

def test_ivf_state_bytes_and_cross_read(tmp_path, monkeypatch):
    """The JAX engine trains and checkpoints; the port reopens its
    directory without retraining and answers the same; the port's own
    checkpoint of that state writes the same ivf_state.npz bytes; the JAX
    engine reopens the port's directory without retraining."""
    from vectordb_tpu.persistence import EngineConfig as JCfg
    from vectordb_tpu.persistence import StorageEngine as JEngine
    rng = np.random.default_rng(6)
    data = _clustered(rng, 700, 8, n_centers=8)
    queries = rng.standard_normal((14, 8)).astype(np.float32)
    jcfg = JCfg(checkpoint_interval=10 ** 9,
                metric=J.DistanceMetric.EUCLIDEAN, index_type="ivf")
    tcfg = EngineConfig(checkpoint_interval=10 ** 9, metric=EUC,
                        index_type="ivf", device="cpu")
    with JEngine.open(tmp_path, jcfg) as eng:
        eng.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]),
                                            J.Metadata({"g": str(i % 3)}))
                          for i in range(700)])
        eng.store.index.train()
        eng.checkpoint()
        want = [[(r.id, r.distance) for r in eng.search(J.Vector(q), 5,
                                                        nprobe=2)]
                for q in queries]
    jbytes = (tmp_path / "ivf_state.npz").read_bytes()

    def boom(self):
        raise AssertionError("reopen must not retrain")

    monkeypatch.setattr(IvfFlatIndex, "train", boom)
    monkeypatch.setattr(JIvf, "train", boom)
    with StorageEngine.open(tmp_path, tcfg) as eng:
        assert eng.store.index.is_trained
        got = [[(r.id, r.distance) for r in eng.search(Vector(q), 5,
                                                       nprobe=2)]
               for q in queries]
        _assert_same(got, want)
        eng.checkpoint()
    assert (tmp_path / "ivf_state.npz").read_bytes() == jbytes
    with JEngine.open(tmp_path, jcfg) as eng:
        assert eng.store.index.is_trained
        again = [[r.id for r in eng.search(J.Vector(q), 5, nprobe=2)]
                 for q in queries]
        assert again == [[i for i, _ in r] for r in want]


def test_engines_write_identical_ivf_state(tmp_path):
    """Both engines checkpoint the same trained layout into the same
    bytes: snapshot and ivf_state.npz."""
    from vectordb_tpu.persistence import EngineConfig as JCfg
    from vectordb_tpu.persistence import StorageEngine as JEngine
    rng = np.random.default_rng(2)
    data = _clustered(rng, 400, 8, n_centers=4)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    with JEngine.open(jdir, JCfg(checkpoint_interval=10 ** 9,
                                 index_type="ivf")) as eng:
        for i in range(400):
            eng.insert(f"v{i}", J.Vector(data[i]))
        eng.store.index.train()
        state = eng.store.index.export_trained_state()
        eng.checkpoint()
    with StorageEngine.open(tdir, EngineConfig(
            checkpoint_interval=10 ** 9, index_type="ivf",
            device="cpu")) as eng:
        for i in range(400):
            eng.insert(f"v{i}", Vector(data[i]))
        idx = eng.store.index
        rows = {i: data[i] for i in range(400)}
        idx.import_trained_state(state, rows, 8)
        eng.checkpoint()
    for name in ("snapshot.bin", "ivf_state.npz"):
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


def test_untrained_checkpoint_removes_stale_state(tmp_path, rng):
    cfg = EngineConfig(checkpoint_interval=10 ** 9, index_type="ivf",
                       device="cpu")
    data = _clustered(rng, 100, 4, n_centers=4)
    with StorageEngine.open(tmp_path, cfg) as eng:
        for i in range(100):
            eng.insert(f"v{i}", Vector(data[i]))
        eng.store.index.train()
        eng.checkpoint()
        assert (tmp_path / "ivf_state.npz").exists()
    with StorageEngine.open(tmp_path / "u", cfg) as eng:
        eng.insert("a", Vector([1.0, 2.0, 3.0, 4.0]))
        (tmp_path / "u" / "ivf_state.npz").write_bytes(b"stale")
        eng.checkpoint()
        assert not (tmp_path / "u" / "ivf_state.npz").exists()


@pytest.mark.parametrize("argv", [
    ["--index", "ivf", "list"],
    ["--index", "ivf", "--storage", "bf16", "search", "1,2", "-k", "1"]])
def test_cli_ivf_in_memory(argv, capsys):
    assert cli.main(["--device", "cpu", *argv]) == 0


def test_cli_ivf_serve_builds_an_ivf_store(monkeypatch):
    from vectordb_tpu_torch.server import app
    seen = []
    monkeypatch.setattr(app, "serve", lambda addr, state, **kw:
                        seen.append(state.store.index))
    assert cli.main(["--device", "cpu", "--index", "ivf", "--storage",
                     "int8", "serve", "--addr", "127.0.0.1:0"]) == 0
    assert isinstance(seen[0], IvfFlatIndex) and seen[0].storage == "int8"
    got = []
    monkeypatch.setattr(app, "start_durable",
                        lambda addr, d, cfg, **kw: got.append(cfg))
    assert cli.main(["--device", "cpu", "--index", "ivf", "serve",
                     "--durable-dir", "/nonexistent"]) == 0
    assert got[0].index_type == "ivf" and got[0].device == "cpu"
