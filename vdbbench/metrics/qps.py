"""Queries answered in the window over the time from the first call's
start to the last call's end (host clock)."""


def read(rec):
    w = rec.window
    return w.queries / (w.end - w.start)
