"""Per call: the device time of the kernels that the program launched
while ``vdb/flat.submit`` was the innermost open range (tier 1 of the
flat index's certified ladder: K1, the tile selections, K2 and the
certificate), linked to their launches by the profiler's correlation
ids, in ms."""

SPAN = "vdb/flat.submit"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    ns = sum(op.end - op.start for op in tr.ops
             if op.kind == "kernel" and op.launched_in == SPAN)
    if ns == 0:
        return None
    return ns * 1e-6 / tr.calls
