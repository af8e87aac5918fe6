"""Share of the traced window, in %, in which the device ran no kernel and
no copy (the complement of the union of the trace's device operations)."""


def read(r):
    if not r.complete:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
