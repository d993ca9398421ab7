"""Command-line interface.

Port of ``vectordb_tpu/cli.py`` (reference src/main.rs:10-198):
  * subcommands: insert ID --vector CSV | search QUERY -k 5 | delete ID |
    list | serve --addr 0.0.0.0:3000 (in-memory store)
  * ``--device`` picks where the index's device state lives (default
    "cuda"; asking for CUDA without a card is an error)
  * same user-facing output strings as the reference handlers

  * ``--storage f32|bf16|int8`` picks the flat index's row storage
  * ``--index pq`` serves a PQ-Flat store (PqFlatIndex: codes on the
    device, exact re-rank) and ``--index ivfpq`` an IVF-PQ store
    (IvfPqIndex: residual codes over the IVF layout, its trained state in
    ``ivfpq_state.npz`` under ``--data-dir``); each owns its device
    representation, so ``--storage`` other than f32 is refused, as the
    JAX package does
  * ``--index hnsw`` serves an HNSW store (the graph on the host, its
    device build and batched traversal on ``--device``; ``--hnsw-seed
    N``, the port's own flag, seeds it and makes its build reproducible),
    in memory, with ``--data-dir`` and under ``serve``
  * ``--index ivf`` serves an IVF-Flat store (``--storage`` f32, bf16 or
    int8), in memory, with ``--data-dir`` (its trained layout in
    ``ivf_state.npz``) and under ``serve`` and ``serve --durable-dir``
  * ``search --ef / --nprobe / --refine`` are the per-query recall knobs;
    a knob the index lacks is an error, as in the JAX package
  * ``--data-dir DIR`` runs insert, search, list and delete against a
    durable store there (persistence.StorageEngine: WAL + snapshots, the
    JAX package's files); ``serve --durable-dir DIR`` serves one over
    HTTP. ``serve`` with ``--data-dir`` is rejected, as in the reference
  * ``serve --http native|python|auto`` picks the front end (auto: the
    C++ one) and ``--batch-window-ms`` puts the query batcher behind it
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .distance import DistanceMetric
from .errors import IndexOpError, VectorDbError
from .store import VectorStore
from .vector import Vector


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vectordb-tpu-torch",
        description="A vector database with hand-written CUDA kernels "
                    "(PyTorch port of vectordb-tpu)")
    parser.add_argument("--index",
                        choices=["flat", "hnsw", "ivf", "pq", "ivfpq"],
                        default="flat",
                        help="Index type to use for search")
    parser.add_argument("--data-dir", default=None,
                        help="Data directory for persistence (if not "
                             "specified, uses in-memory storage)")
    parser.add_argument("--metric",
                        choices=[m.value for m in DistanceMetric],
                        default="euclidean", help="Distance metric")
    parser.add_argument("--search-mode", choices=["exact", "fast"],
                        default="exact",
                        help="Flat scan mode: the certified exact ladder, "
                             "or the 1-pass fast path (exact distances, "
                             "approximate ids)")
    parser.add_argument("--storage", choices=["f32", "bf16", "int8"],
                        default="f32",
                        help="Flat/IVF vector storage: f32 (default) or "
                             "bf16/int8 (quantized at insert; distances "
                             "are exact over the stored values)")
    parser.add_argument("--device", default="cuda",
                        help="Device for the index's state: cuda (default; "
                             "runs the CUDA kernels), cuda:N, or cpu (plain "
                             "PyTorch versions of the kernels)")
    parser.add_argument("--hnsw-seed", type=int, default=None,
                        help="Seed of the HNSW graph (--index hnsw): a "
                             "seeded graph builds on one thread, so the "
                             "same rows give the same graph")
    sub = parser.add_subparsers(dest="command", required=True)

    p_insert = sub.add_parser("insert", help="Insert a vector")
    p_insert.add_argument("id", help="Vector ID")
    p_insert.add_argument("-v", "--vector", required=True,
                          help='Vector data as comma-separated values '
                               '(e.g., "1.0,2.0,3.0")')

    p_search = sub.add_parser("search", help="Search for similar vectors")
    p_search.add_argument("query", help='Query vector as comma-separated '
                                        'values (e.g., "1.0,2.0,3.0")')
    p_search.add_argument("-k", type=int, default=None,
                          help="Number of results to return (default 5; "
                               "mutually exclusive with --radius)")
    p_search.add_argument("--ef", type=int, default=None,
                          help="HNSW beam width for this query "
                               "(requires --index hnsw)")
    p_search.add_argument("--radius", type=float, default=None,
                          help="Range query: return every vector within "
                               "this distance instead of the top k "
                               "(capped at --limit results)")
    p_search.add_argument("--limit", type=int, default=100,
                          help="Result cap for --radius queries")
    p_search.add_argument("--nprobe", type=int, default=None,
                          help="IVF clusters to probe for this query "
                               "(requires --index ivf)")
    p_search.add_argument("--refine", type=int, default=None,
                          help="PQ candidates to re-rank exactly for this "
                               "query (requires --index pq or ivfpq)")

    p_delete = sub.add_parser("delete", help="Delete a vector")
    p_delete.add_argument("id", help="Vector ID to delete")

    sub.add_parser("list", help="List all vector IDs")

    p_serve = sub.add_parser("serve", help="Start the HTTP API server")
    p_serve.add_argument("--addr", default="0.0.0.0:3000",
                         help="Address to bind to")
    p_serve.add_argument("--durable-dir", default=None,
                         help="Serve a WAL-backed persistent store from this "
                              "directory (every write durable before its "
                              "response; POST /checkpoint compacts)")
    p_serve.add_argument("--batch-window-ms", type=float, default=0.0,
                         help="Coalesce concurrent searches into one device "
                              "call within this window (0 = disabled; the "
                              "native backend drain-batches regardless)")
    p_serve.add_argument("--http", choices=["auto", "native", "python"],
                         default="auto",
                         help="HTTP backend: the C++ epoll front end "
                              "(native), the stdlib threaded server "
                              "(python), or auto-detect")
    return parser


def _run_commands(db, args) -> int:
    """Dispatch the in-memory verbs (reference: main.rs:65-150)."""
    if args.command == "insert":
        v = Vector.from_str(args.vector)
        db.insert(args.id, v)
        print(f"Inserted vector with ID: {args.id}")
    elif args.command == "search":
        q = Vector.from_str(args.query)
        if args.radius is not None:
            # same contract as the HTTP surface (routes.py): k and the
            # recall knobs are mutually exclusive with a range query
            if args.k is not None:
                raise IndexOpError("-k and --radius are mutually exclusive")
            if (args.ef is not None or args.nprobe is not None
                    or args.refine is not None):
                raise IndexOpError(
                    "--ef/--nprobe/--refine cannot be combined with "
                    "--radius")
            results = db.search_radius(q, args.radius, limit=args.limit)
        else:
            results = db.search(q, 5 if args.k is None else args.k,
                                ef=args.ef, nprobe=args.nprobe,
                                refine=args.refine)
        if not results:
            print("No results found (store is empty)"
                  if args.radius is None else "No results within radius")
        else:
            print(f"Top {len(results)} results:")
            for i, r in enumerate(results):
                print(f"{i + 1}. {r.id} (distance: {r.distance:.4f})")
    elif args.command == "delete":
        db.delete(args.id)
        print(f"Deleted vector with ID: {args.id}")
    elif args.command == "list":
        ids = db.list_ids()
        if not ids:
            print("No vectors in store")
        else:
            print(f"Vector IDs ({len(ids)} total):")
            for vid in ids:
                print(f"  - {vid}")
    return 0


def _refusal(args) -> Optional[str]:
    """Why this command line is refused before it runs."""
    if args.index in ("pq", "ivfpq") and args.storage != "f32":
        return (f"--index {args.index} owns its device representation "
                "(codes); --storage does not compose with it.")
    return None


def _hnsw_params(args):
    from .index.hnsw import HnswParams
    return HnswParams(seed=args.hnsw_seed)


def _engine_config(args, metric: DistanceMetric):
    from .persistence import EngineConfig
    return EngineConfig(checkpoint_interval=1000, metric=metric,
                        index_type=args.index,
                        hnsw_params=(_hnsw_params(args)
                                     if args.index == "hnsw" else None),
                        search_mode=args.search_mode,
                        storage=args.storage, device=args.device)


def _memory_store(args, metric: DistanceMetric) -> VectorStore:
    if args.index == "pq":
        from .index.pq import PqFlatIndex
        return VectorStore.with_index(PqFlatIndex(metric,
                                                  device=args.device))
    if args.index == "ivfpq":
        from .index.ivfpq import IvfPqIndex
        return VectorStore.with_index(IvfPqIndex(metric,
                                                 device=args.device))
    if args.index == "hnsw":
        from .index.hnsw import HnswIndex
        return VectorStore.with_index(HnswIndex(metric, _hnsw_params(args),
                                                device=args.device))
    if args.index == "ivf":
        from .index.ivf import IvfFlatIndex
        return VectorStore.with_index(IvfFlatIndex(metric,
                                                   storage=args.storage,
                                                   device=args.device))
    return VectorStore.with_flat_index(metric, search_mode=args.search_mode,
                                       storage=args.storage,
                                       device=args.device)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    refusal = _refusal(args)
    if refusal is not None:
        print(f"Error: {refusal}", file=sys.stderr)
        return 1
    metric = DistanceMetric.from_name(args.metric)
    try:
        if args.command == "serve":
            if args.data_dir:
                # reference main.rs:100-102 (durable serving is the
                # explicit opt-in `serve --durable-dir` extension instead)
                print("Error: Serve command is not supported with --data-dir "
                      "(persistent storage). Use in-memory mode, or "
                      "`serve --durable-dir DIR` for a WAL-backed server.",
                      file=sys.stderr)
                return 1
            if args.durable_dir:
                from .server.app import start_durable
                start_durable(args.addr, args.durable_dir,
                              _engine_config(args, metric),
                              batch_window_ms=args.batch_window_ms,
                              backend=args.http)
                return 0
            if args.index == "flat":
                from .server.app import start_flat
                start_flat(args.addr, metric,
                           batch_window_ms=args.batch_window_ms,
                           backend=args.http, search_mode=args.search_mode,
                           storage=args.storage, device=args.device)
                return 0
            if args.index == "hnsw":
                from .server.app import start_hnsw
                start_hnsw(args.addr, metric, _hnsw_params(args),
                           batch_window_ms=args.batch_window_ms,
                           backend=args.http, device=args.device)
                return 0
            from .server.app import AppState, serve
            serve(args.addr, AppState(_memory_store(args, metric)),
                  batch_window_ms=args.batch_window_ms, backend=args.http)
            return 0
        if args.data_dir:
            from .persistence import StorageEngine
            with StorageEngine.open(args.data_dir,
                                    _engine_config(args, metric)) as engine:
                return _run_commands(engine, args)
        return _run_commands(_memory_store(args, metric), args)
    except (VectorDbError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
