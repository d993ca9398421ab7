"""Per call: the device time of the kernels that the program launched
while ``vdb/flat.tier2`` or ``vdb/flat.tier3`` was the innermost open
range (the certified ladder's re-runs of the queries whose certificate
failed), in ms; 0.0 in a traced card window with no re-run."""

SPANS = ("vdb/flat.tier2", "vdb/flat.tier3")


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ops:
        return None
    ns = sum(op.end - op.start for op in tr.ops
             if op.kind == "kernel" and op.launched_in in SPANS)
    return ns * 1e-6 / tr.calls
