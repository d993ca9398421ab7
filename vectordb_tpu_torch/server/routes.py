"""Route handlers for the HTTP API.

Endpoint-for-endpoint parity with reference src/server/routes.rs:102-431:

    POST   /vectors        insert one vector (201 / 400)
    GET    /vectors        list all IDs
    POST   /vectors/batch  bulk insert (201 / 400)
    GET    /vectors/{id}   fetch vector + metadata (404 if missing)
    DELETE /vectors/{id}   delete (404 if missing)
    POST   /search         k-NN search, k defaults to 10, optional filter
    POST   /search/batch   batched search, optional shared filter
    GET    /health         {"status": "ok", "vector_count": n}
    GET    /metrics        query/insert/delete totals + latency percentiles

Same JSON shapes as the reference DTOs (routes.rs:21-98): search hits are
{"id", "distance"}; GET /vectors/{id} omits "metadata" when empty
(routes.rs:74); batch search records ONE latency sample for the whole batch
(routes.rs:365-369).

Carried over unchanged from ``vectordb_tpu/server/routes.py``. POST
/checkpoint forces a snapshot and a WAL truncate on a durable store
(``start_durable``) and answers 404 on an in-memory one, keeping the
9-endpoint surface identical.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Tuple

from ..errors import VectorDbError, VectorNotFoundError
from ..metadata import Metadata, MetadataFilter
from ..store import BatchInsertItem
from ..utils.profiling import annotate
from ..vector import Vector

Json = Any
Response = Tuple[int, Json]


def _bad_request(msg: str) -> Response:
    return 400, {"error": str(msg)}


def _not_found(msg: str) -> Response:
    return 404, {"error": str(msg)}


def _parse_metadata(raw) -> Metadata:
    meta = Metadata()
    if raw:
        if not isinstance(raw, dict):
            raise ValueError("metadata must be an object of string fields")
        for k, v in raw.items():
            meta.insert(str(k), str(v))
    return meta


def _parse_vector(raw) -> Vector:
    if not isinstance(raw, list):
        raise ValueError("'vector' must be an array of numbers")
    return Vector([float(x) for x in raw])


def _parse_filter(raw) -> Optional[MetadataFilter]:
    if raw is None:
        return None
    return MetadataFilter.from_dict(raw)


def _parse_knobs(body: dict):
    """Optional per-request recall knobs: 'ef' (HNSW) / 'nprobe' (IVF) /
    'refine' (PQ). Type errors raise ValueError -> 400 via Api.handle's
    except clause; knob-vs-index mismatches raise IndexOpError in the
    store -> 400."""
    ef, nprobe, refine = (body.get("ef"), body.get("nprobe"),
                          body.get("refine"))
    return (None if ef is None else int(ef),
            None if nprobe is None else int(nprobe),
            None if refine is None else int(refine))


class Api:
    """The router: dispatches (method, path, body) to handlers.

    With a ``batcher`` (server/batcher.py), concurrent POST /search
    requests coalesce into one fused device call."""

    def __init__(self, state, batcher=None):
        self.state = state
        self.batcher = batcher

    # -- dispatch -----------------------------------------------------------

    def handle(self, method: str, path: str, body: Json = None) -> Response:
        method = method.upper()
        path = path.rstrip("/") or "/"
        try:
            if path == "/vectors":
                if method == "POST":
                    return self.insert_vector(body)
                if method == "GET":
                    return self.list_vectors()
            elif path == "/vectors/batch" and method == "POST":
                return self.batch_insert(body)
            elif path.startswith("/vectors/"):
                vector_id = path[len("/vectors/"):]
                if method == "GET":
                    return self.get_vector(vector_id)
                if method == "DELETE":
                    return self.delete_vector(vector_id)
            elif path == "/search" and method == "POST":
                return self.search(body)
            elif path == "/search/batch" and method == "POST":
                return self.batch_search(body)
            elif path == "/checkpoint" and method == "POST":
                return self.checkpoint()
            elif path == "/health" and method == "GET":
                return self.health()
            elif path == "/metrics" and method == "GET":
                return self.get_metrics()
            return _not_found("Not found")
        except VectorNotFoundError as e:
            return _not_found(str(e))
        except (VectorDbError, ValueError, KeyError, TypeError) as e:
            return _bad_request(str(e))

    # -- handlers (reference: src/server/routes.rs:134-431) ------------------

    def insert_vector(self, body: Json) -> Response:
        if not isinstance(body, dict):
            return _bad_request("request body must be a JSON object")
        if "id" not in body or "vector" not in body:
            return _bad_request("'id' and 'vector' are required")
        vector_id = str(body["id"])
        vector = _parse_vector(body["vector"])
        metadata = _parse_metadata(body.get("metadata"))
        with self.state.lock.write():
            self.state.store.insert_with_metadata(vector_id, vector, metadata)
        self.state.metrics.record_insert()
        return 201, {"id": vector_id, "status": "inserted"}

    def get_vector(self, vector_id: str) -> Response:
        with self.state.lock.read():
            vector = self.state.store.get(vector_id)
            if vector is None:
                return _not_found(f"Vector not found: {vector_id}")
            metadata = self.state.store.get_metadata(vector_id)
        payload = {
            "id": vector_id,
            "dimension": vector.dimension,
            "vector": vector.as_list(),
        }
        if metadata is not None and not metadata.is_empty():
            payload["metadata"] = metadata.fields()
        return 200, payload

    def delete_vector(self, vector_id: str) -> Response:
        with self.state.lock.write():
            self.state.store.delete(vector_id)
        self.state.metrics.record_delete()
        return 200, {"id": vector_id, "status": "deleted"}

    def search(self, body: Json) -> Response:
        if not isinstance(body, dict) or "vector" not in body:
            return _bad_request("'vector' is required")
        query = _parse_vector(body["vector"])
        raw_k = body.get("k")
        k = 10 if raw_k is None else int(raw_k)  # explicit k=0 means 0
        flt = _parse_filter(body.get("filter"))
        ef, nprobe, refine = _parse_knobs(body)
        knobbed = (ef is not None or nprobe is not None
                   or refine is not None)
        raw_radius = body.get("radius")
        if raw_radius is not None:
            # range query (beyond the reference): all results within
            # 'radius', capped at 'limit' (default 100)
            if raw_k is not None:
                return _bad_request("'k' and 'radius' are mutually "
                                    "exclusive")
            if knobbed:
                return _bad_request(
                    "'ef'/'nprobe'/'refine' cannot be combined with "
                    "'radius'")
            limit = int(body.get("limit", 100))
            start = time.perf_counter()
            with self.state.lock.read():
                results = self.state.store.search_radius(
                    query, float(raw_radius), limit=limit, filter=flt)
            self.state.metrics.record_query(time.perf_counter() - start)
            return 200, [{"id": r.id, "distance": r.distance}
                         for r in results]
        start = time.perf_counter()
        with annotate("vdb/http.search"):
            if knobbed:
                with self.state.lock.read():
                    results = self.state.store.search(
                        query, k, ef=ef, nprobe=nprobe, refine=refine,
                        filter=flt)
            elif self.batcher is not None:
                results = self.batcher.search(query, k, flt)
            else:
                with self.state.lock.read():
                    if flt is not None:
                        results = self.state.store.search_with_filter(
                            query, k, flt)
                    else:
                        results = self.state.store.search(query, k)
        self.state.metrics.record_query(time.perf_counter() - start)
        return 200, [{"id": r.id, "distance": r.distance} for r in results]

    def batch_insert(self, body: Json) -> Response:
        if not isinstance(body, dict) or "vectors" not in body:
            return _bad_request("'vectors' is required")
        raw_items = body["vectors"]
        if not isinstance(raw_items, list):
            return _bad_request("'vectors' must be an array")
        items = []
        for raw in raw_items:
            if not isinstance(raw, dict) or "id" not in raw or "vector" not in raw:
                return _bad_request("each item needs 'id' and 'vector'")
            items.append(BatchInsertItem(
                id=str(raw["id"]),
                vector=_parse_vector(raw["vector"]),
                metadata=_parse_metadata(raw.get("metadata")),
            ))
        with self.state.lock.write():
            self.state.store.insert_batch(items)
        self.state.metrics.record_insert(len(items))
        return 201, {"inserted": len(items)}

    def batch_search(self, body: Json) -> Response:
        if not isinstance(body, dict) or "queries" not in body:
            return _bad_request("'queries' is required")
        raw_queries = body["queries"]
        if not isinstance(raw_queries, list):
            return _bad_request("'queries' must be an array")
        queries = []
        for raw in raw_queries:
            if not isinstance(raw, dict) or "vector" not in raw:
                return _bad_request("each query needs a 'vector'")
            raw_k = raw.get("k")
            queries.append((_parse_vector(raw["vector"]),
                            10 if raw_k is None else int(raw_k)))
        flt = _parse_filter(body.get("filter"))
        ef, nprobe, refine = _parse_knobs(body)
        start = time.perf_counter()
        with self.state.lock.read():
            if flt is not None:
                # knobs compose with the filter through the masked
                # probed/scan index paths (store.search_batch_with_filter)
                all_results = self.state.store.search_batch_with_filter(
                    queries, flt, ef=ef, nprobe=nprobe, refine=refine)
            else:
                all_results = self.state.store.search_batch(
                    queries, ef=ef, nprobe=nprobe, refine=refine)
        # one latency sample for the whole batch (routes.rs:365-369)
        self.state.metrics.record_query(time.perf_counter() - start)
        return 200, [[{"id": r.id, "distance": r.distance} for r in batch]
                     for batch in all_results]

    def list_vectors(self) -> Response:
        with self.state.lock.read():
            ids = self.state.store.list_ids()
        return 200, ids

    def checkpoint(self) -> Response:
        """Force a durability checkpoint: snapshot save + WAL truncate.
        Only meaningful when the server is engine-backed (``serve
        --durable-dir``, beyond the reference); an in-memory store
        answers 404 so the reference's 9-endpoint surface is unchanged."""
        fn = getattr(self.state.store, "checkpoint", None)
        if fn is None:
            return _not_found("Not found")
        with self.state.lock.write():
            fn()
            count = len(self.state.store)
        return 200, {"status": "checkpointed", "vector_count": count}

    def health(self) -> Response:
        with self.state.lock.read():
            count = len(self.state.store)
        return 200, {"status": "ok", "vector_count": count}

    def get_metrics(self) -> Response:
        return 200, self.state.metrics.snapshot()


__all__ = ["Api"]
