"""Per call: the card's idle time while Python's collector ran, the
program's ``python/gc`` span being the innermost open range (a collection
nested in ``vdb/pq.scan`` counts here, not in ``index.host_ms``), in ms."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ops or "python/gc" not in tr.idle_by_range:
        return None
    return tr.idle_by_range["python/gc"] / tr.calls * 1e3
