"""Per call: the card's idle time inside the harness's range around
``search_batch`` that no ``vdb/*`` range of the program covers: the
store's own host work (id mapping, ``SearchResult``s, query stacking),
in ms."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ops:
        return None
    from vdbbench.drivers.batch import CALL_RANGE
    return tr.idle_by_range.get(CALL_RANGE, 0.0) / tr.calls * 1e3
