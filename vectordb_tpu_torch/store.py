"""VectorStore: string-ID CRUD + metadata + filtered/batch search over any index.

Port of ``vectordb_tpu/store.py``, with the hooks the storage engine's
recovery calls (``reserve``, ``restore_snapshot_chunk``,
``next_internal_id``, ``restore_next_internal_id``). Capability parity
with reference src/storage.rs:83-348, preserving its observable
semantics:

  * upsert: re-inserting an existing string ID removes the old entry and
    assigns a *fresh* internal ID (src/storage.rs:157-168);
  * the first insert fixes the store dimension; later mismatches raise
    (src/storage.rs:144-154) and the dimension never resets;
  * delete returns the removed vector; missing IDs raise VectorNotFound
    (src/storage.rs:175-192);
  * searching an empty store returns [] *before* any dimension check
    (src/storage.rs:218-220);
  * insert_batch applies items in order and stops at the first error,
    leaving earlier inserts applied (src/storage.rs:293-298).

Filtered search is *exact* when the index supports masked search (FlatIndex):
the filter AST compiles to a columnar slot mask applied before top-k. For
indexes without masked search (HNSW) it falls back to the reference's 3x
over-fetch + post-filter strategy (src/storage.rs:268-287).

Hits are ``SearchResult``s, a native type the collector does not track:
importing this module (so the package) builds one small C module,
``csrc/search_result.c``, with ``gcc`` into ``_build/`` (``utils/cext.py``),
as the persistence core is built, and a failed build raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .distance import DistanceMetric
from .errors import (DimensionMismatchError, IndexOpError,
                     StaleSlotMaskError, VectorNotFoundError)
from .index.base import HitColumns, Index
from .index.flat import FlatIndex
from .metadata import ColumnarMetadata, Metadata, MetadataFilter
from .utils import cext
from .utils.profiling import annotate
from .vector import Vector, as_f32_array

# Bounded retries when a concurrent slot repack invalidates a compiled
# filter mask mid-search; past this the over-fetch fallback serves.
_MASK_RETRIES = 4


# (string id, distance) search hit (reference: src/storage.rs:13-16): a
# native type the cyclic collector does not track (csrc/search_result.c),
# built and loaded here at the first import
SearchResult = cext.load("search_result").SearchResult


@dataclass
class BatchInsertItem:
    """One item of a batch insert (reference: src/storage.rs:74-79)."""
    id: str
    vector: Vector
    metadata: Metadata = field(default_factory=Metadata)


class _InflightIdMap:
    """Copy-on-write internal→string id column snapshot for one in-flight
    search_batch_submit. ``map`` stays None (collect reads the live
    store column) until a mutation lands while the handle is in flight;
    the mutation freezes a copy of the pre-mutation column here so
    collect() maps the device snapshot's internal ids against the ids
    that existed at submit time (matching the index side's copy-scatter
    snapshot)."""

    __slots__ = ("map",)

    def __init__(self):
        self.map: Optional[np.ndarray] = None


class StoreSearchHandle:
    """An in-flight store-level batched search (search_batch_submit);
    ``collect()`` blocks on the device and returns the mapped
    SearchResults (idempotent — the result is cached)."""

    __slots__ = ("_fn", "_has_result", "_result", "_release")

    def __init__(self, fn, release=None):
        self._fn = fn
        self._has_result = False
        self._result = None
        self._release = release

    @classmethod
    def ready(cls, result) -> "StoreSearchHandle":
        handle = cls(None)
        handle._result = result
        handle._has_result = True
        return handle

    def collect(self) -> List[List[SearchResult]]:
        if not self._has_result:
            try:
                self._result = self._fn()
            finally:
                self._do_release()
            self._has_result = True
        return self._result

    def _do_release(self) -> None:
        release, self._release = self._release, None
        if release is not None:
            release()

    def __del__(self):
        # an abandoned handle must not leave its id-map snapshot holder
        # registered forever (every later mutation would copy the map)
        try:
            self._do_release()
        except Exception:
            pass


class VectorStore:
    """In-memory vector store with a pluggable search index."""

    def __init__(self, index: Index):
        self._index = index
        self._id_to_internal: Dict[str, int] = {}
        # internal -> string id: an object column indexed by internal id,
        # None where no row holds the id. 8 bytes for each internal id
        # ever allocated (ids are never reused); grows geometrically
        self._ids = np.empty(0, dtype=object)
        self._metadata: Dict[int, Metadata] = {}
        self._next_id = 0
        self._dimension: Optional[int] = None
        self._columnar = ColumnarMetadata(0)
        self._columnar_layout = 0   # index slot-layout version mirrored
        self._inflight_id_maps: List[_InflightIdMap] = []

    # -- constructors (reference: src/storage.rs:97-127) --------------------

    @classmethod
    def new(cls, metric: DistanceMetric, device="cuda") -> "VectorStore":
        return cls.with_flat_index(metric, device=device)

    @classmethod
    def with_flat_index(cls, metric: DistanceMetric,
                        search_mode: str = "exact", storage: str = "f32",
                        device="cuda") -> "VectorStore":
        """A store over a ``FlatIndex`` whose device state lives on
        ``device`` (a CUDA device runs the hand-written kernels; "cpu"
        runs their plain versions). ``storage="bf16"`` halves the bytes
        per row and ``"int8"`` quarters them; vectors are quantized at
        insert and search is certified-exact over the stored values."""
        return cls(FlatIndex(metric, search_mode=search_mode,
                             storage=storage, device=device))

    @classmethod
    def with_index(cls, index: Index) -> "VectorStore":
        return cls(index)

    @classmethod
    def with_sharded_flat_index(cls, metric: DistanceMetric, mesh,
                                row_axis: str = "shard",
                                storage: str = "f32") -> "VectorStore":
        """Full store semantics (string ids, metadata, exact filtered
        search) over a ``FlatIndex`` whose packed rows shard over the row
        axis of ``mesh`` (parallel.make_mesh): each search runs the
        per-shard certified pipeline on each shard's device and merges
        the shards' top-k (the sharded exact scan for uncertified
        queries). ``storage="bf16"`` halves the bytes per shard and
        ``"int8"`` quarters them; search stays exact over the stored
        values."""
        return cls(FlatIndex(metric, mesh=mesh, row_axis=row_axis,
                             storage=storage))

    # -- insert -------------------------------------------------------------

    def insert(self, id: str, vector: Vector) -> None:
        self.insert_with_metadata(id, vector, Metadata())

    def insert_with_metadata(self, id: str, vector: Vector,
                             metadata: Metadata) -> None:
        id = str(id)
        dim = vector.dimension
        self._check_or_fix_dimension(dim)
        self._remove_existing(id)
        internal_id = self._alloc_internal(id)
        self._index.add(internal_id, vector)
        self._record_metadata(internal_id, metadata)

    def _check_or_fix_dimension(self, dim: int) -> None:
        if self._dimension is not None:
            if dim != self._dimension:
                raise DimensionMismatchError(self._dimension, dim)
        else:
            self._dimension = dim

    def _cow_inflight_id_maps(self) -> None:
        """Freeze the internal→string map for in-flight search handles
        before a removal mutates it (see _InflightIdMap). New-id inserts
        need no freeze: internal ids are monotonic, so a newer id cannot
        appear in an older device snapshot's results."""
        for holder in self._inflight_id_maps:
            if holder.map is None:
                holder.map = self._ids.copy()

    def _fit_ids(self, n: int) -> None:
        """Room in the id column for internal ids below ``n``."""
        if n > len(self._ids):
            col = np.empty(max(n, 2 * len(self._ids)), dtype=object)
            col[:len(self._ids)] = self._ids
            self._ids = col

    def _remove_existing(self, id: str) -> None:
        old_internal = self._id_to_internal.get(id)
        if old_internal is None:
            return
        self._cow_inflight_id_maps()
        self._clear_columnar(old_internal)
        self._index.remove(old_internal)
        self._metadata.pop(old_internal, None)
        self._ids[old_internal] = None

    def _alloc_internal(self, id: str) -> int:
        internal_id = self._next_id
        self._next_id += 1
        self._id_to_internal[id] = internal_id
        self._fit_ids(self._next_id)
        self._ids[internal_id] = id
        return internal_id

    def _ensure_columnar_current(self) -> None:
        """Rebuild the slot-addressed columnar mirror if the index has
        reordered its slot layout (IVF repack bumps slot_layout_version)."""
        ver = getattr(self._index, "slot_layout_version", 0)
        if ver == self._columnar_layout:
            return
        self._columnar = ColumnarMetadata(self._index.capacity)
        for iid, meta in self._metadata.items():
            if meta.is_empty():
                continue
            slot = self._index.slot_of(iid)
            if slot is not None:
                self._columnar.set_slot(slot, meta)
        self._columnar_layout = ver

    def _record_metadata(self, internal_id: int, metadata: Metadata) -> None:
        self._metadata[internal_id] = metadata
        slot = self._index.slot_of(internal_id)
        if slot is None:
            return
        cap = self._index.capacity
        if cap > self._columnar.capacity:
            self._columnar.grow(cap)
        self._columnar.set_slot(slot, metadata)

    def _clear_columnar(self, internal_id: int) -> None:
        slot = self._index.slot_of(internal_id)
        if slot is not None and slot < self._columnar.capacity:
            self._columnar.clear_slot(slot)

    def insert_batch(self, items: Sequence[BatchInsertItem]) -> None:
        """Apply in order; stop at the first error leaving earlier inserts
        applied (reference: src/storage.rs:293-298). The only failure mode is
        a dimension mismatch, which is checked host-side, so the accepted
        prefix is bulk-loaded through the index's batched add path."""
        prefix_end = len(items)
        error: Optional[Exception] = None
        expected = self._dimension
        for i, item in enumerate(items):
            dim = item.vector.dimension
            if expected is None:
                expected = dim
            elif dim != expected:
                prefix_end = i
                error = DimensionMismatchError(expected, dim)
                break
        accepted = items[:prefix_end]
        if accepted:
            self._check_or_fix_dimension(accepted[0].vector.dimension)
            # keyed by internal id so a duplicate string ID later in the
            # batch supersedes the earlier allocation instead of leaving a
            # phantom row in the index
            pending: Dict[int, BatchInsertItem] = {}
            batch_ids: Dict[str, int] = {}
            for item in accepted:
                sid = str(item.id)
                prev_internal = batch_ids.get(sid)
                if prev_internal is not None:
                    pending.pop(prev_internal, None)
                self._remove_existing(sid)
                internal_id = self._alloc_internal(sid)
                batch_ids[sid] = internal_id
                pending[internal_id] = item
            self._index.add_batch(
                [(iid, item.vector) for iid, item in pending.items()])
            for iid, item in pending.items():
                self._record_metadata(iid, item.metadata)
        if error is not None:
            raise error

    # -- delete / lookup ----------------------------------------------------

    def delete(self, id: str) -> Vector:
        internal_id = self._id_to_internal.pop(str(id), None)
        if internal_id is None:
            raise VectorNotFoundError(str(id))
        vector = self._index.get_vector(internal_id)
        if vector is None:
            vector = Vector([])
        self._cow_inflight_id_maps()
        self._clear_columnar(internal_id)
        self._ids[internal_id] = None
        self._metadata.pop(internal_id, None)
        self._index.remove(internal_id)
        return vector

    def get(self, id: str) -> Optional[Vector]:
        internal_id = self._id_to_internal.get(str(id))
        if internal_id is None:
            return None
        return self._index.get_vector(internal_id)

    def get_metadata(self, id: str) -> Optional[Metadata]:
        internal_id = self._id_to_internal.get(str(id))
        if internal_id is None:
            return None
        return self._metadata.get(internal_id)

    def __len__(self) -> int:
        return len(self._index)

    def is_empty(self) -> bool:
        return len(self) == 0

    # -- search -------------------------------------------------------------

    def _check_query_dim(self, query: Vector) -> None:
        if self._dimension is not None and query.dimension != self._dimension:
            raise DimensionMismatchError(self._dimension, query.dimension)

    def _map_columns(self, hits: HitColumns,
                     ks: Optional[List[int]] = None,
                     id_map: Optional[np.ndarray] = None
                     ) -> List[List[SearchResult]]:
        """A call's HitColumns -> SearchResults, each query's first ``k``
        hits (all of them without ``ks``) through the id column
        (``id_map``: a frozen copy of it); ids with no string id drop. One
        gather from internal to string ids and one ``tolist()`` for the
        call, then one pass a query."""
        col = self._ids if id_map is None else id_map
        ids = hits.ids
        known = (ids >= 0) & (ids < len(col))
        sids = np.empty(ids.shape, dtype=object)
        sids[known] = col[ids[known]]
        counts = hits.counts.tolist()
        out = []
        for s, d, n, k in zip(sids.tolist(), hits.dists.tolist(), counts,
                              counts if ks is None else ks):
            s = s[:min(n, k)]
            if None in s:
                out.append([SearchResult(i, x) for i, x in zip(s, d)
                            if i is not None])
            else:
                out.append(list(map(SearchResult, s, d)))
        return out

    def search(self, query: Vector, k: int, *, ef: Optional[int] = None,
               nprobe: Optional[int] = None,
               refine: Optional[int] = None,
               filter: Optional[MetadataFilter] = None
               ) -> List[SearchResult]:
        """``ef``/``nprobe``/``refine`` are per-request recall knobs for
        HNSW/IVF/PQ indexes (reference exposes ef only at the library
        level, src/hnsw/mod.rs:45-53; here they reach the HTTP/CLI
        surfaces). Requesting a knob the index doesn't support raises
        IndexOpError. Knobs COMPOSE with ``filter``: the tuned search
        runs through the index's masked path (exact filtered results),
        so a filtered query on an ANN index stays tunable."""
        if filter is not None:
            return self.search_with_filter(query, k, filter, ef=ef,
                                           nprobe=nprobe, refine=refine)
        if self.is_empty():
            return []
        self._check_query_dim(query)
        if ef is not None or nprobe is not None or refine is not None:
            hits = HitColumns.from_rows(
                [self._tuned_search(query, k, ef, nprobe, refine)])
        else:
            hits = self._index.search_batch_submit(
                as_f32_array(query).reshape(1, -1), k).collect_columns()
        return self._map_columns(hits)[0]

    def _tuned_knob(self, ef: Optional[int], nprobe: Optional[int],
                    refine: Optional[int] = None):
        """Validate the knob set (at most one) and resolve the index
        method."""
        given = [n for n, v in (("ef", ef), ("nprobe", nprobe),
                                ("refine", refine)) if v is not None]
        if len(given) > 1:
            raise IndexOpError(
                f"{' and '.join(repr(g) for g in given)} are mutually "
                "exclusive")
        if ef is not None:
            if int(ef) < 1:
                raise IndexOpError("'ef' must be >= 1")
            fn = getattr(self._index, "search_with_ef", None)
            if fn is None:
                raise IndexOpError(
                    "'ef' requires an HNSW index (this store's index "
                    "has no search_with_ef)")
            return "ef", int(ef), fn
        if refine is not None:
            if int(refine) < 1:
                raise IndexOpError("'refine' must be >= 1")
            fn = getattr(self._index, "search_with_refine", None)
            if fn is None:
                raise IndexOpError(
                    "'refine' requires a PQ index (this store's index "
                    "has no search_with_refine)")
            return "refine", int(refine), fn
        if int(nprobe) < 1:
            raise IndexOpError("'nprobe' must be >= 1")
        fn = getattr(self._index, "search_with_nprobe", None)
        if fn is None:
            raise IndexOpError(
                "'nprobe' requires an IVF index (this store's index "
                "has no search_with_nprobe)")
        return "nprobe", int(nprobe), fn

    def _tuned_search(self, query: Vector, k: int, ef: Optional[int],
                      nprobe: Optional[int],
                      refine: Optional[int] = None
                      ) -> List[Tuple[int, float]]:
        _, value, fn = self._tuned_knob(ef, nprobe, refine)
        return fn(query, k, value)

    def search_with_filter(self, query: Vector, k: int,
                           filter: MetadataFilter, *,
                           ef: Optional[int] = None,
                           nprobe: Optional[int] = None,
                           refine: Optional[int] = None
                           ) -> List[SearchResult]:
        """Exact filtered search, optionally tuned by one recall knob.
        ``nprobe``/``refine`` ride the index's masked probed/scan paths
        (index/ivf.py:397-495, index/pq.py:454-566), so a filtered query
        on an ANN index is tunable with exact results; ``ef`` takes the
        over-fetch fallback through the tuned HNSW traversal (HNSW has
        no masked traversal)."""
        if self.is_empty():
            return []
        self._check_query_dim(query)
        knob = None
        if ef is not None or nprobe is not None or refine is not None:
            # validates the knob set against THIS index up front (the
            # same IndexOpError surface as the unfiltered tuned path)
            knob = self._tuned_knob(ef, nprobe, refine)
        # mask compilation races concurrent slot repacks (IVF train): the
        # index re-checks the layout version under its lock and raises
        # StaleSlotMaskError, and we recompile against the new layout.
        sel_fetch_k = 0
        for _ in range(_MASK_RETRIES):
            self._ensure_columnar_current()
            mask = self._columnar.compile_mask(filter) \
                if self._columnar.capacity else None
            if mask is None:
                break
            try:
                if knob is None:
                    masked = self._index.search_masked(
                        query, k, mask,
                        mask_layout_version=self._columnar_layout)
                elif knob[0] == "ef":
                    # the user's ef rides the masked traversal (which
                    # further widens it by the mask's selectivity) —
                    # _tuned_knob already guaranteed an HNSW index
                    masked = self._index.search_masked(
                        query, k, mask,
                        mask_layout_version=self._columnar_layout,
                        ef=knob[1])
                else:
                    masked = self._index.search_batch(
                        as_f32_array(query).reshape(1, -1), k,
                        slot_mask=mask,
                        mask_layout_version=self._columnar_layout,
                        **{knob[0]: knob[1]})[0]
            except StaleSlotMaskError:
                continue
            if masked is not None:
                return self._map_columns(HitColumns.from_rows([masked]))[0]
            # masked traversal came up short: remember the mask's
            # selectivity so the over-fetch below widens fetch_k to the
            # expected depth of the k-th eligible row instead of the
            # fixed 3x (a selective filter would otherwise silently
            # return < k results even when k matches exist)
            elig = int(np.asarray(mask, dtype=bool).sum())
            if elig > 0:
                sel_fetch_k = -(-k * len(self) // elig)  # ceil
            break
        # fallback: reference-style 3x over-fetch + post-filter (also the
        # terminal path if repacks keep winning the race — it reads the
        # internal-id-keyed metadata dict, which is layout-independent);
        # with a knob the over-fetch itself runs the tuned search
        fetch_k = min(max(k * 3, k, sel_fetch_k), len(self))
        if knob is not None:
            raw = knob[2](query, fetch_k, knob[1])
        else:
            raw = self._index.search(query, fetch_k)
        out: List[SearchResult] = []
        for internal_id, dist in raw:
            if len(out) == k:
                break
            if not 0 <= internal_id < len(self._ids):
                continue
            sid = self._ids[internal_id]
            if sid is None:
                continue
            meta = self._metadata.get(internal_id)
            if meta is None:
                continue
            if filter.matches(meta):
                out.append(SearchResult(id=sid, distance=dist))
        return out

    def search_radius(self, query: Vector, radius: float, *,
                      limit: int = 100,
                      filter: Optional[MetadataFilter] = None
                      ) -> List[SearchResult]:
        """All vectors within ``radius`` of the query, ascending by
        distance, capped at ``limit`` results (beyond the reference).
        Distances use this framework's smaller-is-better convention
        (DOT_PRODUCT thresholds the negated dot). With a filter, the
        radius applies after the exact filtered search. A full ``limit``
        of results means more rows may lie inside the radius — raise
        ``limit`` to see them."""
        if int(limit) < 1:
            raise IndexOpError("'limit' must be >= 1")
        if self.is_empty():
            return []
        self._check_query_dim(query)
        radius = float(radius)
        if filter is not None:
            # Delegate the boundary-precision re-threshold to
            # Index.refine_radius (one copy of the direct-form distance
            # logic; ties break on internal id like the unfiltered path).
            results = self.search_with_filter(query, int(limit), filter)
            raw = [(iid, r.distance) for r in results
                   if (iid := self._id_to_internal.get(r.id)) is not None]
            raw = self._index.refine_radius(raw, query, radius)
        else:
            raw = self._index.search_radius(query, radius, int(limit))
        return self._map_columns(HitColumns.from_rows([raw]))[0]

    def search_batch(self, queries: Sequence[Tuple[Vector, int]], *,
                     ef: Optional[int] = None,
                     nprobe: Optional[int] = None,
                     refine: Optional[int] = None
                     ) -> List[List[SearchResult]]:
        """Batched search: one fused device program for the whole batch
        (the reference loops queries sequentially, src/storage.rs:302-310)."""
        return self.search_batch_submit(queries, ef=ef, nprobe=nprobe,
                                        refine=refine).collect()

    def search_batch_submit(self, queries: Sequence[Tuple[Vector, int]], *,
                            ef: Optional[int] = None,
                            nprobe: Optional[int] = None,
                            refine: Optional[int] = None
                            ) -> "StoreSearchHandle":
        """Asynchronous ``search_batch``: launches the fused device program
        and returns a handle whose ``collect()`` blocks and maps internal
        ids to string ids. The serving front-end keeps one handle in
        flight so response formatting of batch i overlaps device compute
        of batch i+1 (server/native_http.py). Index types without an
        asynchronous search (e.g. HNSW's host traversal) and the recall
        knobs are served eagerly."""
        if not queries:
            return StoreSearchHandle.ready([])
        if self.is_empty():
            return StoreSearchHandle.ready([[] for _ in queries])
        for q, _ in queries:
            self._check_query_dim(q)
        ks = [int(k) for _, k in queries]
        kmax = max(ks)
        qmat = np.stack([as_f32_array(q) for q, _ in queries])
        if ef is not None or nprobe is not None or refine is not None:
            knob, value, fn = self._tuned_knob(ef, nprobe, refine)
            if knob == "nprobe":
                # IVF's batched probed pipeline takes nprobe directly
                raw_batches = self._index.search_batch(qmat, kmax,
                                                       nprobe=value)
            elif knob == "refine":
                # PQ's batched scan + re-rank takes refine directly
                raw_batches = self._index.search_batch(qmat, kmax,
                                                       refine=value)
            else:
                # HNSW's tuned traversal is per-query host work
                raw_batches = [fn(q, k, value) for (q, k) in queries]
            return StoreSearchHandle.ready(self._map_columns(
                HitColumns.from_rows(raw_batches), ks))
        handle = self._index.search_batch_submit(qmat, kmax)
        holder = _InflightIdMap()
        self._inflight_id_maps.append(holder)

        def _release():
            try:
                self._inflight_id_maps.remove(holder)
            except ValueError:
                pass

        def _collect():
            # a delete/upsert that landed between submit and collect froze
            # the submit-time column in the holder; results reflect the
            # same snapshot point as the index's copy-scatter device state
            return self._map_columns(handle.collect_columns(), ks,
                                     holder.map)

        return StoreSearchHandle(_collect, release=_release)

    def search_batch_with_filter(self, queries: Sequence[Tuple[Vector, int]],
                                 filter: MetadataFilter, *,
                                 ef: Optional[int] = None,
                                 nprobe: Optional[int] = None,
                                 refine: Optional[int] = None
                                 ) -> List[List[SearchResult]]:
        """Batched exact filtered search; ``nprobe``/``refine`` compose
        through the masked batched index paths, ``ef`` through the
        per-query tuned over-fetch (see search_with_filter)."""
        if not queries:
            return []
        if self.is_empty():
            return [[] for _ in queries]
        for q, _ in queries:
            self._check_query_dim(q)
        knob = None
        if ef is not None or nprobe is not None or refine is not None:
            knob = self._tuned_knob(ef, nprobe, refine)
        for _ in range(_MASK_RETRIES if (knob is None or knob[0] != "ef")
                       else 0):
            self._ensure_columnar_current()
            mask = self._columnar.compile_mask(filter) \
                if self._columnar.capacity else None
            if mask is None or not isinstance(self._index, FlatIndex):
                break
            ks = [int(k) for _, k in queries]
            kmax = max(ks)
            qmat = np.stack([as_f32_array(q) for q, _ in queries])
            try:
                if knob is None:
                    hits = self._index.search_batch_submit(
                        qmat, kmax, slot_mask=mask,
                        mask_layout_version=self._columnar_layout
                    ).collect_columns()
                else:
                    hits = HitColumns.from_rows(self._index.search_batch(
                        qmat, kmax, slot_mask=mask,
                        mask_layout_version=self._columnar_layout,
                        **{knob[0]: knob[1]}))
            except StaleSlotMaskError:
                continue
            return self._map_columns(hits, ks)
        return [self.search_with_filter(q, k, filter, ef=ef, nprobe=nprobe,
                                        refine=refine)
                for q, k in queries]

    # -- misc ---------------------------------------------------------------

    def list_ids(self) -> List[str]:
        return list(self._id_to_internal.keys())

    @property
    def metric(self) -> DistanceMetric:
        return self._index.metric

    @property
    def dimension(self) -> Optional[int]:
        return self._dimension

    @property
    def index(self) -> Index:
        return self._index

    def internal_to_string_ids(self) -> Dict[int, str]:
        return {iid: sid for iid, sid in enumerate(self._ids.tolist())
                if sid is not None}

    def restore_snapshot_chunk(self, internal_ids, string_ids,
                               rows, metadata: Dict[int, Dict[str, str]]
                               ) -> None:
        """Vectorized snapshot replay: adopt one chunk of rows under their
        ORIGINAL internal ids, with no per-row Python objects (the engine's
        recovery path). The caller guarantees ids unique across chunks and
        rows validated by the snapshot codec; ``metadata`` maps
        internal_id -> fields for the whole snapshot and is probed per
        id."""
        with annotate("vdb/store.load"):
            rows = np.ascontiguousarray(rows, dtype=np.float32)
            self._check_or_fix_dimension(int(rows.shape[1]))
            iids_arr = np.ascontiguousarray(internal_ids, dtype=np.int64)
            # quantized=True: snapshot rows ARE the stored (already
            # quantized) values, so the idempotent re-quantize is skipped
            self._index.bulk_append_matrix(iids_arr, rows, quantized=True)
            # no _cow_inflight_id_maps: this path only ADDS fresh ids
            iids = iids_arr.tolist()
            self._id_to_internal.update(zip(string_ids, iids))
            self._fit_ids(max(iids, default=-1) + 1)
            self._ids[iids_arr] = string_ids
            for iid in iids:
                fields = metadata.get(iid)
                if fields:
                    self._record_metadata(iid, Metadata(fields))
                else:
                    # one object per id: Metadata is mutable
                    self._metadata[iid] = Metadata()
            self._next_id = max(self._next_id, max(iids, default=-1) + 1)

    def reserve(self, n_rows: int, dim: "int | None" = None) -> None:
        """Pre-size the index's packed storage for ``n_rows`` rows
        (recovery: one allocation instead of chunk-by-chunk pow2 growth).
        No-op on indexes without packed storage."""
        fn = getattr(self._index, "reserve", None)
        if fn is not None:
            with annotate("vdb/store.load"):
                fn(n_rows, dim)

    @property
    def next_internal_id(self) -> int:
        """The internal ID the next insert will be assigned (the storage
        engine logs WAL entries before applying them)."""
        return self._next_id

    def restore_next_internal_id(self, value: int) -> None:
        """Raise the internal-ID counter (recovery: monotonicity across
        restarts). Never lowers it."""
        self._next_id = max(self._next_id, int(value))

    def adopt_index_state(self, id_map: Dict[int, str],
                          metadata: Dict[int, Dict[str, str]],
                          next_id: int,
                          dimension: Optional[int]) -> None:
        """Rebind store bookkeeping around an index that was restored out
        of band (e.g. an imported HNSW graph): internal<->string maps,
        metadata, dimension, and the columnar filter mirror."""
        self._cow_inflight_id_maps()
        self._id_to_internal = {sid: iid for iid, sid in id_map.items()}
        self._ids = np.empty(0, dtype=object)
        self._fit_ids(max(id_map, default=-1) + 1)
        self._ids[list(id_map)] = list(id_map.values())
        self._metadata = {iid: Metadata(fields)
                          for iid, fields in metadata.items()}
        for iid in id_map:
            self._metadata.setdefault(iid, Metadata())
        self._dimension = dimension
        self._next_id = max(self._next_id, int(next_id))
        self._columnar = ColumnarMetadata(self._index.capacity)
        for iid, meta in self._metadata.items():
            slot = self._index.slot_of(iid)
            if slot is not None:
                self._columnar.set_slot(slot, meta)
        self._columnar_layout = getattr(self._index,
                                        "slot_layout_version", 0)

    def __repr__(self) -> str:
        return (f"VectorStore(len={len(self)}, dim={self._dimension}, "
                f"metric={self.metric.value}, index={type(self._index).__name__})")
