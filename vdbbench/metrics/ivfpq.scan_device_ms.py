"""Per call: the device time of the kernels that the program launched
while ``vdb/pq.scan`` was the innermost open range (the residual PQ
scan; the device re-rank's own range, nested in it, is left out),
linked to their launches by the profiler's correlation ids, in ms."""


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    ns = sum(op.end - op.start for op in tr.ops
             if op.kind == "kernel" and op.launched_in == "vdb/pq.scan")
    if ns == 0:
        return None
    return ns * 1e-6 / tr.calls
