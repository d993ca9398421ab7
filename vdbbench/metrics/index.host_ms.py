"""Per call: the card's idle time inside the program's ``vdb/*`` ranges
(the index's host work: the submit, slot-to-id mapping, the PQ mapping),
in ms."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ops:
        return None
    idle = sum(s for name, s in tr.idle_by_range.items()
               if name.startswith("vdb/"))
    return idle / tr.calls * 1e3
