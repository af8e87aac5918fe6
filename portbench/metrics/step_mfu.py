"""The whole step's share of the card's peak, in %: every conv's operations
over the peak of the precision it runs in (``portbench.roofline``), summed
over the traced window's steps, over the window's wall time."""


def read(r):
    if not r.complete or not r.steps:
        return None
    return 100.0 * r.steps * r.totals["ops_s"] / r.window_s
