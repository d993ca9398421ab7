"""Command-line interface.

Port of ``vectordb_tpu/cli.py`` for the flat index (reference
src/main.rs:10-198):
  * subcommands: insert ID --vector CSV | search QUERY -k 5 | delete ID |
    list | serve --addr 0.0.0.0:3000 (in-memory store)
  * ``--device`` picks where the index's device state lives (default
    "cuda"; asking for CUDA without a card is an error)
  * same user-facing output strings as the reference handlers

  * ``--storage f32|bf16|int8`` picks the flat index's row storage
  * ``--index pq`` serves a PQ-Flat store (PqFlatIndex: codes on the
    device, exact re-rank); it owns its device representation, so
    ``--storage`` other than f32 is refused, as the JAX package does
  * ``--data-dir DIR`` runs insert, search, list and delete against a
    durable store there (persistence.StorageEngine: WAL + snapshots, the
    JAX package's files); ``serve --durable-dir DIR`` serves one over
    HTTP. ``serve`` with ``--data-dir`` is rejected, as in the reference

Refused with a clear error until their slices land (ROADMAP queue 1):
``--index`` hnsw, ivf and ivfpq, ``--http native`` and
``--batch-window-ms`` (native HTTP + batcher).
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
                        help="Index type to use for search (flat and pq "
                             "are ported so far)")
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
                        help="Flat-index vector storage: f32 (default) or "
                             "bf16/int8 (quantized at insert; search is "
                             "exact over the stored values)")
    parser.add_argument("--device", default="cuda",
                        help="Device for the index's state: cuda (default; "
                             "runs the CUDA kernels), cuda:N, or cpu (plain "
                             "PyTorch versions of the kernels)")
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
    p_search.add_argument("--radius", type=float, default=None,
                          help="Range query: return every vector within "
                               "this distance instead of the top k "
                               "(capped at --limit results)")
    p_search.add_argument("--limit", type=int, default=100,
                          help="Result cap for --radius queries")

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
                         help="Query batcher window (not ported yet; 0 = "
                              "disabled)")
    p_serve.add_argument("--http", choices=["auto", "native", "python"],
                         default="auto",
                         help="HTTP backend (only the stdlib threaded "
                              "server is ported; auto selects it)")
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
            if args.k is not None:
                raise IndexOpError("-k and --radius are mutually exclusive")
            results = db.search_radius(q, args.radius, limit=args.limit)
        else:
            results = db.search(q, 5 if args.k is None else args.k)
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
    """Why this command line needs a slice that is not ported yet."""
    if args.index not in ("flat", "pq"):
        return (f"--index {args.index} is not ported yet (ROADMAP queue 1); "
                "use --index flat or pq")
    if args.index == "pq" and args.storage != "f32":
        return (f"--index {args.index} owns its device representation "
                "(codes); --storage does not compose with it.")
    if args.command == "serve":
        if args.http == "native":
            return "--http native is not ported yet (ROADMAP queue 1 item 8)"
        if args.batch_window_ms > 0:
            return ("--batch-window-ms needs the query batcher (ROADMAP "
                    "queue 1 item 8)")
    return None


def _engine_config(args, metric: DistanceMetric):
    from .persistence import EngineConfig
    return EngineConfig(checkpoint_interval=1000, metric=metric,
                        index_type=args.index, search_mode=args.search_mode,
                        storage=args.storage, device=args.device)


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
            if args.index == "pq":
                from .index.pq import PqFlatIndex
                from .server.app import AppState, serve
                serve(args.addr,
                      AppState(VectorStore.with_index(
                          PqFlatIndex(metric, device=args.device))),
                      batch_window_ms=args.batch_window_ms,
                      backend=args.http)
                return 0
            from .server.app import start_flat
            start_flat(args.addr, metric, search_mode=args.search_mode,
                       device=args.device, storage=args.storage)
            return 0
        if args.data_dir:
            from .persistence import StorageEngine
            with StorageEngine.open(args.data_dir,
                                    _engine_config(args, metric)) as engine:
                return _run_commands(engine, args)
        if args.index == "pq":
            from .index.pq import PqFlatIndex
            store = VectorStore.with_index(PqFlatIndex(metric,
                                                       device=args.device))
        else:
            store = VectorStore.with_flat_index(metric,
                                                search_mode=args.search_mode,
                                                storage=args.storage,
                                                device=args.device)
        return _run_commands(store, args)
    except (VectorDbError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
