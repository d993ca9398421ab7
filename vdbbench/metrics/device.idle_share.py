"""The share of the traced window in which no kernel, copy or fill ran
on the card."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return tr.idle_s / tr.window_s
