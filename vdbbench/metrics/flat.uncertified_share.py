"""The share of the queries that reached the flat index's certified
ladder whose tier-1 certificate failed, so that they re-ran through tier
2: ``flat.tier2_queries / flat.queries`` of the program's counters
(``vectordb_tpu_torch.utils.profiling.counters``) over the whole run,
the warm-up included. None where the program keeps no counters, counted
no query, or the traced window holds no device operation (on the CPU the
certificate takes the plain bodies' coefficient, not the card's)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ops:
        return None
    from vectordb_tpu_torch.utils import profiling
    table = getattr(profiling, "counters", None)
    if table is None:
        return None
    got = table()
    queries = got.get("flat.queries", 0)
    if not queries:
        return None
    return got.get("flat.tier2_queries", 0) / queries
