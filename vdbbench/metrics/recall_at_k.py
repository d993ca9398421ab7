"""Recall at the cell's own k of the kept answers against the
reference's exact top-k (the comparison's ``recall``)."""


def read(rec):
    return rec.numbers["recall"]
