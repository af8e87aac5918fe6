"""The conv kernels' share of their roofline, in %: the least time of every
conv the window's steps ran (``portbench.roofline``: the larger of
operations over the peak of its precision and bytes over the memory
bandwidth) over the device time the trace gives the conv kernels."""

from portbench import groups, trace


def read(r):
    s = trace.device_seconds(r, lambda name, g: groups.is_conv(g))
    if not s:
        return None
    return 100.0 * r.steps * r.totals["bound_s"] / s
